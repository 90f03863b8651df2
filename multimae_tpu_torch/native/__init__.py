"""ctypes bindings for the port's native image library (fastimage.cpp,
jpeg_decode.cpp, jpeg2000_decode.cpp, pil_ops.cpp, tiff_decode.cpp,
webp_decode.cpp, ccitt_decode.cpp, zstd_decode.cpp and cielab.cpp), the
counterpart of the JAX package's multimae_tpu/native/__init__.py.
fastimage.cpp also holds the BMP run-length decoder (`bmp_rle`);
tiff_decode.cpp the TIFF LZW, PackBits and ThunderScan decoders
(`tiff_lzw`, `tiff_packbits`, `tiff_thunderscan`); ccitt_decode.cpp
libtiff's CCITT decoding (`ccitt_decode`); zstd_decode.cpp a Zstandard
frame decoder (`zstd_decode`); cielab.cpp LittleCMS's CIELab to sRGB
transform as Pillow builds it (`lab_to_rgb`); jpeg_decode.cpp the JPEG decoder of JPEG files
(`decode_jpeg`) and of JPEG-compressed TIFF strips and tiles
(`decode_jpeg_tiff`); webp_decode.cpp the WebP decoder (`decode_webp`, and
`decode_webp_planes` for the colour and alpha twins of data/image_io.py);
jpeg2000_decode.cpp the JPEG 2000 codestream decoder (`decode_jpeg2000`,
and `decode_jpeg2000_coefficients`, `jpeg2000_idwt` and `jpeg2000_colour`
for the wavelet and colour twins of data/image_io.py).

The library is built with g++ at first use:

    g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off fastimage.cpp jpeg_decode.cpp \
        pil_ops.cpp tiff_decode.cpp webp_decode.cpp jpeg2000_decode.cpp ccitt_decode.cpp \
        zstd_decode.cpp cielab.cpp -o <lib>

into build/native/<hash of the sources and the command>/ in the repository
(listed in .gitignore). The compiler writes a per-process temporary that
is moved into place with os.replace, so processes building at once never
see a partial file. -ffp-contract=off keeps every multiply and add rounded
on its own, as in the numpy twins; the source fuses with std::fma where
cv2 does. There is no fallback: where g++ fails or the library does not
load, `lib()` raises with the compiler's message, and no caller takes
the numpy twins instead.

Every wrapper checks dtypes, shapes and bounds before passing pointers and
returns a new numpy array.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastimage.cpp"
JPEG_SOURCE = SOURCE.with_name("jpeg_decode.cpp")
PIL_SOURCE = SOURCE.with_name("pil_ops.cpp")
TIFF_SOURCE = SOURCE.with_name("tiff_decode.cpp")
WEBP_SOURCE = SOURCE.with_name("webp_decode.cpp")
JPEG2000_SOURCE = SOURCE.with_name("jpeg2000_decode.cpp")
CCITT_SOURCE = SOURCE.with_name("ccitt_decode.cpp")
ZSTD_SOURCE = SOURCE.with_name("zstd_decode.cpp")
CIELAB_SOURCE = SOURCE.with_name("cielab.cpp")
SOURCES = (SOURCE, JPEG_SOURCE, PIL_SOURCE, TIFF_SOURCE, WEBP_SOURCE, JPEG2000_SOURCE,
           CCITT_SOURCE, ZSTD_SOURCE, CIELAB_SOURCE)
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off"]

_LIB: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None  # set when this process compiled the library

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_F = ctypes.c_float

# C signatures (fastimage.cpp); every pointer is void*.
_SIGNATURES = {
    "mm_crop_resize_normalize": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P, _I, _I],
    "mm_crop_resize_u8": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I],
    "mm_crop_resize_u16": [_P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I],
    "mm_pil_nearest": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I],
    "mm_pil_nearest_i16": [_P, _I, _I, _P, _I, _I],
    "mm_png_decode": [_P, _L, _I, _I, _I, _I, _P, _I, _I, _P],
    "mm_cv_resize_linear_u8": [_P, _I, _I, _I, _P, _I, _I],
    "mm_cv_resize_linear_f32": [_P, _I, _I, _I, _P, _I, _I],
    "mm_cv_resize_nearest": [_P, _I, _I, _I, _P, _I, _I],
    "mm_rgb_to_gray": [_P, _L, _P],
    "mm_rgb_to_hsv": [_P, _L, _P],
    "mm_hsv_to_rgb": [_P, _L, _I, _P],
    "mm_gaussian_blur_3x3": [_P, _I, _I, _P],
    "mm_decode_jpeg": [_P, _L, _P, _L, _P, _P, _P, _L],
    "mm_decode_jpeg_tiff": [_P, _L, _P, _L, _I, _P, _L, _P, _P, _L],
    "mm_decode_webp": [_P, _L, _I, _P, _L, _P, _P, _L],
    "mm_webp_colour": [_P, _P, _P, _I, _I, _P],
    "mm_webp_unfilter": [_P, _I, _I, _I],
    "mm_decode_jpeg2000": [_P, _L, _I, _I, _I, _I, _P, _L, _P, _L],
    "mm_jpeg2000_coefficients": [_P, _L, _I, _I, _P, _L, _P, _L, _P, _P, _L],
    "mm_jpeg2000_idwt": [_P, _I, _I, _I, _I, _P],
    "mm_jpeg2000_colour": [_P, _P, _P, _I, _I, _P, _L],
    "mm_pil_resize": [_P, _I, _I, _I, _P, _I, _I, _I],
    "mm_pil_affine": [_P, _I, _I, _I, _P, _P, _I, _P],
    "mm_pil_gray": [_P, _L, _P],
    "mm_pil_smooth": [_P, _I, _I, _I, _P],
    "mm_pil_blend": [_P, _P, _L, _F, _P],
    "mm_bmp_rle": [_P, _L, _L, _L, _I, _I, _I, _P],
    "mm_tiff_lzw": [_P, _L, _P, _L],
    "mm_tiff_packbits": [_P, _L, _P, _L],
    "mm_tiff_thunderscan": [_P, _L, _P, _L, _L, _L],
    "mm_ccitt_decode": [_P, _L, _I, _I, _I, _I, _I, _P, _P],
    "mm_zstd_decode": [_P, _L, _P, _L, _P],
    "mm_lab_to_rgb": [_P, _L, _P],
}
# The functions that return a count of bytes or pixels, not a status.
_LONG_RESULTS = ("mm_bmp_rle", "mm_tiff_lzw", "mm_tiff_packbits")


def build(sources: Union[Path, Sequence[Path]] = SOURCES, build_root: Path = BUILD_ROOT, *,
          flags: Sequence[str] = tuple(CXX_FLAGS), libs: Sequence[str] = (),
          name: str = "libmm_fastimage.so") -> Path:
    """Compile `sources` (one path or several) with g++ `flags` and linker
    `libs` into build_root/<hash>/`name` unless it is there; return its
    path. Raises RuntimeError with g++'s message when the compiler fails or
    is missing."""
    global BUILD_SECONDS
    sources = [sources] if isinstance(sources, Path) else list(sources)
    flags = list(flags)
    text = b"".join(s.read_bytes() for s in sources)
    digest = hashlib.sha256(text + " ".join(flags + list(libs)).encode()).hexdigest()[:16]
    out_dir = build_root / digest
    lib_path = out_dir / name
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{name}.{os.getpid()}.tmp"
    cmd = ["g++", *flags, *map(str, sources), "-o", str(tmp), *libs]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"{' '.join(cmd)} could not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr.strip()[-2000:]}")
    os.replace(tmp, lib_path)
    if tuple(sources) == SOURCES:
        BUILD_SECONDS = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The bound library, built first if it is not cached. Raises
    RuntimeError when it cannot be built or loaded."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = build(SOURCES, BUILD_ROOT)
    try:
        handle = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"{path} does not load: {e}") from e
    for fn_name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_long if fn_name in _LONG_RESULTS else ctypes.c_int
    _LIB = handle
    return handle


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise ValueError(f"{what}: the native call returned {rc}")


def _crop_args(shape, crop: Tuple[int, int, int, int]) -> Tuple[int, int, int, int]:
    i, j, h, w = (int(v) for v in crop)
    if i < 0 or j < 0 or h <= 0 or w <= 0 or i + h > shape[0] or j + w > shape[1]:
        raise ValueError(f"crop {crop} lies outside an image of {shape[:2]}")
    return i, j, h, w


def _size_args(size_hw: Tuple[int, int]) -> Tuple[int, int]:
    dh, dw = (int(v) for v in size_hw)
    if dh <= 0 or dw <= 0:
        raise ValueError(f"output size {size_hw} is empty")
    return dh, dw


# --- PIL's resampling ------------------------------------------------------------


def crop_resize_normalize(src: np.ndarray, crop: Tuple[int, int, int, int],
                          size_hw: Tuple[int, int], mean: Sequence[float], std: Sequence[float],
                          bicubic: bool = True, hflip: bool = False) -> np.ndarray:
    """(H, W, C) uint8 -> (dh, dw, C) float32: crop (i, j, h, w), PIL's
    antialiased bicubic (or bilinear) resize, flip, (x / 255 - mean) / std
    (the JAX package's fastimage mm_crop_resize_normalize)."""
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 3:
        raise ValueError(f"expected (H, W, C) uint8, got shape {src.shape}")
    sh, sw, c = src.shape
    i, j, h, w = _crop_args(src.shape, crop)
    dh, dw = _size_args(size_hw)
    mean = np.ascontiguousarray(np.broadcast_to(np.asarray(mean, np.float32), (c,)))
    std = np.ascontiguousarray(np.broadcast_to(np.asarray(std, np.float32), (c,)))
    dst = np.empty((dh, dw, c), np.float32)
    _check(lib().mm_crop_resize_normalize(_ptr(src), sh, sw, c, i, j, h, w, _ptr(dst), dh, dw,
                                          _ptr(mean), _ptr(std), int(bicubic), int(hflip)),
           "crop_resize_normalize")
    return dst


def crop_resize_u8(src: np.ndarray, crop: Tuple[int, int, int, int], size_hw: Tuple[int, int],
                   bicubic: bool = True, hflip: bool = False) -> np.ndarray:
    """The same resample uint8 -> uint8, rounded half away from zero."""
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 3 or not 0 < src.shape[2] <= 16:
        raise ValueError(f"expected (H, W, C <= 16) uint8, got shape {src.shape}")
    sh, sw, c = src.shape
    i, j, h, w = _crop_args(src.shape, crop)
    dh, dw = _size_args(size_hw)
    dst = np.empty((dh, dw, c), np.uint8)
    _check(lib().mm_crop_resize_u8(_ptr(src), sh, sw, c, i, j, h, w, _ptr(dst), dh, dw,
                                   int(bicubic), int(hflip)), "crop_resize_u8")
    return dst


def crop_resize_u16(src: np.ndarray, crop: Tuple[int, int, int, int],
                    size_hw: Tuple[int, int], hflip: bool = False) -> np.ndarray:
    """PIL's bicubic resize of the crop of an "I;16" image, (H, W) uint16
    -> (dh, dw) uint16, flipped if `hflip`."""
    if src.dtype != np.uint16 or src.ndim != 2:
        raise ValueError(f"expected (H, W) uint16, got {src.dtype} {src.shape}")
    src = np.ascontiguousarray(src)
    i, j, h, w = _crop_args(src.shape, crop)
    dh, dw = _size_args(size_hw)
    dst = np.empty((dh, dw), np.uint16)
    _check(lib().mm_crop_resize_u16(_ptr(src), src.shape[0], src.shape[1], i, j, h, w, _ptr(dst),
                                    dh, dw, int(hflip)), "crop_resize_u16")
    return dst


def pil_nearest(src: np.ndarray, crop: Tuple[int, int, int, int], size_hw: Tuple[int, int],
                hflip: bool = False) -> np.ndarray:
    """PIL's NEAREST resize of the crop of an (H, W, ...) array of any
    dtype to size_hw, flipped if `hflip`."""
    src = np.ascontiguousarray(src)
    if src.ndim < 2:
        raise ValueError(f"expected an image, got shape {src.shape}")
    i, j, h, w = _crop_args(src.shape, crop)
    dh, dw = _size_args(size_hw)
    dst = np.empty((dh, dw) + src.shape[2:], src.dtype)
    pixel = src.itemsize * int(np.prod(src.shape[2:], dtype=np.int64))
    _check(lib().mm_pil_nearest(_ptr(src), src.shape[0], src.shape[1], pixel, i, j, h, w,
                                _ptr(dst), dh, dw, int(hflip)), "pil_nearest")
    return dst


def pil_nearest_i16(src: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """PIL's NEAREST resize of an (H, W) uint16 image as Pillow opens a
    16-bit gray PNG ("I;16"), to size_hw: its generic transform's pixel
    centres, which differ from `pil_nearest`'s summed ones by a pixel at
    some sizes."""
    if src.dtype != np.uint16 or src.ndim != 2 or 0 in src.shape:
        raise ValueError(f"pil_nearest_i16 takes (H, W) uint16, not {src.dtype} {src.shape}")
    src = np.ascontiguousarray(src)
    dh, dw = _size_args(size_hw)
    dst = np.empty((dh, dw), np.uint16)
    _check(lib().mm_pil_nearest_i16(_ptr(src), src.shape[0], src.shape[1], _ptr(dst), dh, dw),
           "pil_nearest_i16")
    return dst


# --- PNG -------------------------------------------------------------------------

PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour types -> samples per pixel
PNG_MODES = {"samples": 0, "raw": 1, "rgb": 2}


def png_decode(raw: bytes, width: int, height: int, depth: int, color_type: int,
               palette: Optional[np.ndarray], mode: str) -> np.ndarray:
    """Inflated PNG image data -> pixels: undo the row filters, unpack
    1/2/4-bit samples (gray scaled to 0-255), 16-bit samples to native
    order. `mode` "samples": every channel; "raw": alpha dropped; "rgb":
    (H, W, 3) uint8 with palette and gray expanded (8-bit and fewer only).
    One channel comes back as (H, W). Raises ValueError on a bad size or
    filter type."""
    channels = PNG_CHANNELS[color_type]
    stride = (width * channels * depth + 7) // 8
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, expected "
                         f"{height * (stride + 1)}")
    if mode == "rgb":
        if depth == 16:
            raise ValueError("16-bit PNG files have no RGB form here")
        shape, dtype = (height, width, 3), np.uint8
    else:
        keep = channels if mode == "samples" else {4: 1, 6: 3}.get(color_type, channels)
        shape = (height, width) + ((keep,) if keep > 1 else ())
        dtype = np.uint16 if depth == 16 else np.uint8
    pal = np.zeros((0, 3), np.uint8) if palette is None else np.ascontiguousarray(palette,
                                                                                  np.uint8)
    out = np.empty(shape, dtype)
    rc = lib().mm_png_decode(raw, len(raw), width, height, depth, color_type, _ptr(pal),
                             len(pal), PNG_MODES[mode], _ptr(out))
    if rc > 0:
        row = rc - 1
        raise ValueError(f"PNG row {row} has unknown filter type {raw[row * (stride + 1)]}")
    _check(rc, "png_decode")
    return out


def bmp_rle(data: bytes, start: int, file_offset: int, rle4: bool, width: int,
            height: int) -> np.ndarray:
    """BI_RLE8 / BI_RLE4 pixel data of a BMP (from byte `start` of `data`,
    which sits at `file_offset` in its file) -> (height, width) uint8 in
    the file's row order, as PIL's BmpRleDecoder gives it
    (fastimage.cpp `mm_bmp_rle`). Raises ValueError where PIL does: the
    data ends before the bitmap does, or a delta is cut short."""
    out = np.zeros((height, width), np.uint8)
    n = lib().mm_bmp_rle(data, len(data), start, file_offset, int(rle4), width, height, _ptr(out))
    if n < 0:
        raise ValueError("BMP RLE data ends inside a delta")
    if n < width * height:
        raise ValueError(f"BMP RLE data ends after {n} of {width * height} pixels "
                         "(not enough image data)")
    return out


# --- TIFF (tiff_decode.cpp) --------------------------------------------------------

_LZW_ERRORS = {-1: "a code not yet in the table", -2: "a code past the table after a Clear code",
               -3: "corrupted table"}


def tiff_lzw(data: bytes, size: int) -> np.ndarray:
    """A TIFF strip or tile of LZW data -> its first `size` bytes, as
    libtiff 4.7 decodes it (tiff_decode.cpp `mm_tiff_lzw`). Raises
    ValueError where libtiff fails: a code not yet in the table, or data
    that ends first."""
    out = np.empty(size, np.uint8)
    n = lib().mm_tiff_lzw(data, len(data), _ptr(out), size)
    if n < 0:
        raise ValueError(f"TIFF LZW: {_LZW_ERRORS[n]}")
    if n < size:
        raise ValueError(f"TIFF LZW data ends after {n} of {size} bytes")
    return out


def tiff_packbits(data: bytes, size: int) -> np.ndarray:
    """A TIFF strip or tile of PackBits data -> its first `size` bytes, as
    libtiff's PackBitsDecode gives them (`mm_tiff_packbits`). Raises
    ValueError where the data ends first."""
    out = np.empty(size, np.uint8)
    n = lib().mm_tiff_packbits(data, len(data), _ptr(out), size)
    if n < size:
        raise ValueError(f"TIFF PackBits data ends after {n} of {size} bytes")
    return out


# CCITT kinds (ccitt_decode.cpp): compression (and 2-D rows for Group 3) -> kind.
CCITT_KINDS = {"rle": 0, "rlew": 1, "g3": 2, "g3_2d": 3, "g4": 4}


class CcittStrip:
    """What `mm_ccitt_decode` gives for one strip or tile: `rows` (its
    decoded bytes), `status` (0 success, -1 libtiff fails, -2 Group 4 data
    ends early and libtiff leaves rows undecoded), `errors` (the bad code
    words and rows of the wrong length libtiff reports and decodes past),
    `extensions` (uncompressed-mode codes among them) and `lines` decoded."""

    def __init__(self, rows: np.ndarray, status: int, errors: int, extensions: int, lines: int):
        self.rows, self.status = rows, status
        self.errors, self.extensions, self.lines = errors, extensions, lines


def ccitt_decode(data: bytes, kind: str, width: int, rowbytes: int, rows: int,
                 odd: bool) -> CcittStrip:
    """A strip or tile of CCITT data (bytes in FillOrder 1) -> `rows` rows of
    `rowbytes` bytes, 1 bits black, as libtiff 4.7's tif_fax3.c decodes it
    (ccitt_decode.cpp): `kind` one of CCITT_KINDS, `odd` where the data
    starts at an odd file offset (RLEW's 16-bit alignment)."""
    if width <= 0 or rows <= 0 or rowbytes < (width + 7) // 8:
        raise ValueError(f"CCITT strip of {rows} rows of {width} pixels in {rowbytes} bytes")
    out = np.zeros((rows, rowbytes), np.uint8)
    info = np.zeros(3, np.int64)
    status = lib().mm_ccitt_decode(data, len(data), CCITT_KINDS[kind], width, rowbytes, rows,
                                   int(odd), _ptr(out), _ptr(info))
    return CcittStrip(out, status, int(info[0]), int(info[1]), int(info[2]))


# mm_zstd_decode's failures (zstd_decode.cpp), as libtiff's ZSTDDecode meets them.
ZSTD_ERRORS = {
    -1: "the data ends inside the frame", -2: "no Zstandard frame (bad magic number)",
    -3: "a reserved frame header bit set", -4: "a window past libzstd's 128 MiB limit",
    -5: "a dictionary, which libtiff never loads", -6: "a block of the reserved type",
    -7: "a block past its size limit", -8: "a corrupt literals section",
    -9: "a corrupt Huffman table or stream", -10: "a corrupt FSE table description",
    -11: "a corrupt sequences section", -12: "an offset past the window or the data",
    -13: "content past or short of the frame's declared size",
    -14: "a content checksum that does not match",
    -15: "the frame ends before the strip is full",
    -16: "a skippable frame where libzstd wants the data's frame"}
# What the data held, counted by mm_zstd_decode into ZSTD_COUNTS where a test
# sets it (np.zeros(len(ZSTD_KINDS), np.int64)).
ZSTD_KINDS = ("raw block", "RLE block", "compressed block", "raw literals", "RLE literals",
              "Huffman literals, 1 stream", "Huffman literals, 4 streams",
              "treeless literals, 1 stream", "treeless literals, 4 streams",
              "FSE-coded Huffman weights", "direct Huffman weights", "predefined table",
              "RLE table", "FSE-compressed table", "repeated table", "repeat offset",
              "checksum", "single segment", "no sequences")
ZSTD_COUNTS: Optional[np.ndarray] = None


def zstd_decode(data: bytes, size: int) -> np.ndarray:
    """A TIFF strip or tile of Zstandard data -> its first `size` bytes, as
    libtiff 4.7's ZSTDDecode has libzstd give them (zstd_decode.cpp).
    Raises ValueError where libzstd or libtiff fails."""
    out = np.empty(size, np.uint8)
    counts = ZSTD_COUNTS
    if counts is not None and (counts.dtype != np.int64 or counts.shape != (len(ZSTD_KINDS),)):
        raise ValueError("ZSTD_COUNTS must be int64 of len(ZSTD_KINDS)")
    rc = lib().mm_zstd_decode(data, len(data), _ptr(out), size,
                              None if counts is None else _ptr(counts))
    if rc:
        raise ValueError(f"TIFF ZSTD data: {ZSTD_ERRORS.get(rc, rc)}")
    return out


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 pixels in Pillow's "LAB" storage (L, then a and b with
    128 neutral) -> RGB, as PIL's convert("RGB") gives them through
    LittleCMS 2.17 (cielab.cpp)."""
    lab = np.ascontiguousarray(lab)
    if lab.dtype != np.uint8 or lab.shape[-1:] != (3,):
        raise ValueError(f"LAB pixels must be (..., 3) uint8, not {lab.dtype} {lab.shape}")
    out = np.empty(lab.shape, np.uint8)
    _check(lib().mm_lab_to_rgb(_ptr(lab), lab.size // 3, _ptr(out)), "mm_lab_to_rgb")
    return out


def tiff_thunderscan(data: bytes, size: int, scanline: int, width: int) -> np.ndarray:
    """A TIFF strip of ThunderScan data -> its `size` bytes, rows of
    `scanline` bytes holding `width` 4-bit pixels, as libtiff's
    ThunderDecodeRow gives them (tiff_decode.cpp `mm_tiff_thunderscan`).
    Raises ValueError where a row ends short or long, which libtiff fails."""
    out = np.zeros(size, np.uint8)
    if lib().mm_tiff_thunderscan(data, len(data), _ptr(out), size, scanline, width):
        raise ValueError("TIFF ThunderScan data: a row of other than its width's pixels "
                         "(libtiff fails)")
    return out


# --- JPEG ------------------------------------------------------------------------


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, equal to PIL's
    Image.open(...).convert("RGB") (jpeg_decode.cpp). Raises ValueError
    naming what it met for damaged data and unsupported files."""
    fn = lib().mm_decode_jpeg
    h, w = ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(256)
    hp, wp = ctypes.addressof(h), ctypes.addressof(w)
    rc = fn(data, len(data), None, 0, hp, wp, msg, len(msg))
    if rc == -3:
        out = np.empty((h.value, w.value, 3), np.uint8)
        rc = fn(data, len(data), _ptr(out), out.nbytes, hp, wp, msg, len(msg))
    if rc != 0:
        raise ValueError(f"JPEG: {msg.value.decode(errors='replace')}")
    return out


# How a JPEG-in-TIFF stream's samples come out (jpeg_decode.cpp produce_tiff).
JPEG_TIFF_COLORS = {"none": 0, "rgb": 1, "planes": 2}


class JpegTiffStream:
    """A decoded JPEG-in-TIFF stream: `height`, `width`, `sampling` ((h, v)
    per component), `plane_shapes` (each component's (dh, dw), jdinput.c's
    downsampled sizes) and `pixels`: (H, W, C) uint8 for "none" and "rgb",
    a list of each component's (dh, dw) plane for "planes"."""

    def __init__(self, info):
        self.height, self.width, nc = (int(v) for v in info[:3])
        comps = info[3:3 + 4 * nc].reshape(nc, 4).tolist()
        self.sampling = [(h, v) for h, v, _, _ in comps]
        self.plane_shapes = [(dh, dw) for _, _, dh, dw in comps]
        self.pixels = None


def decode_jpeg_tiff(data: bytes, tables: Optional[bytes], color: str) -> JpegTiffStream:
    """One strip or tile of a JPEG-compressed TIFF, after its JPEGTables
    `tables` (tag 347) if any, as libtiff 4.7 has libjpeg decode it
    (jpeg_decode.cpp `mm_decode_jpeg_tiff`): `color` "none" (the samples
    as they are), "rgb" (YCbCr to RGB) or "planes" (each component at its
    own sampling). Raises ValueError naming what it met for damaged or
    unsupported data."""
    fn = lib().mm_decode_jpeg_tiff
    info = np.zeros(3 + 4 * 10, np.intc)  # height, width, components, (h, v, dh, dw) for up to 10
    msg = ctypes.create_string_buffer(256)
    tables = tables or b""
    code = JPEG_TIFF_COLORS[color]
    rc = fn(tables, len(tables), data, len(data), code, None, 0, _ptr(info), msg, len(msg))
    if rc == -3:
        stream = JpegTiffStream(info)
        channels = 3 if code == 1 else len(stream.sampling)
        need = (sum(h * w for h, w in stream.plane_shapes) if code == 2
                else stream.height * stream.width * channels)
        out = np.empty(need, np.uint8)
        rc = fn(tables, len(tables), data, len(data), code, _ptr(out), out.size, _ptr(info), msg,
                len(msg))
    if rc != 0:
        raise ValueError(f"JPEG: {msg.value.decode(errors='replace')}")
    if code == 2:
        stream.pixels, at = [], 0
        for h, w in stream.plane_shapes:
            stream.pixels.append(out[at:at + h * w].reshape(h, w))
            at += h * w
    else:
        stream.pixels = out.reshape(stream.height, stream.width, channels)
    return stream


# --- WebP (webp_decode.cpp) ------------------------------------------------------


def _webp_call(data: bytes, planes: int):
    fn = lib().mm_decode_webp
    info = np.zeros(10, np.intc)
    msg = ctypes.create_string_buffer(256)
    rc = fn(data, len(data), planes, None, 0, _ptr(info), msg, len(msg))
    if rc == -3:
        out = np.empty(int(info[9]), np.uint8)
        rc = fn(data, len(data), planes, _ptr(out), out.size, _ptr(info), msg, len(msg))
    if rc != 0:
        raise ValueError(msg.value.decode(errors="replace"))
    return info, out


def decode_webp(data: bytes) -> Tuple[str, np.ndarray]:
    """RIFF/WEBP bytes -> (PIL's mode, "RGB" or "RGBA"; the (H, W, 4) uint8
    RGBA canvas of the first frame), as PIL 12.1 with libwebp 1.6 opens the
    file (webp_decode.cpp). Raises ValueError naming what it met where PIL
    refuses the file."""
    info, out = _webp_call(data, 0)
    return ("RGBA" if info[2] else "RGB"), out.reshape(int(info[1]), int(info[0]), 4)


class WebpPlanes:
    """The first frame of a WebP file before its colour stage: `canvas_hw`,
    `mode` (PIL's), the frame's `offset` (y, x) and `shape` (h, w) on the
    canvas, and either `rgba` ((h, w, 4) uint8, a lossless frame) or `y`
    (h, w), `u` and `v` ((h + 1) // 2, (w + 1) // 2) uint8 planes and, with
    an ALPH chunk, `alpha`: its (h, w) samples before the unfiltering under
    `alpha_filter` (0-3)."""

    def __init__(self, info, out):
        cw, ch, rgba, x, y, w, h, lossless, filt = (int(v) for v in info[:9])
        self.canvas_hw, self.mode = (ch, cw), "RGBA" if rgba else "RGB"
        self.offset, self.shape, self.alpha_filter = (y, x), (h, w), filt
        self.rgba = self.y = self.u = self.v = self.alpha = None
        if lossless:
            self.rgba = out.reshape(h, w, 4)
            return
        uh, uw = (h + 1) // 2, (w + 1) // 2
        self.y = out[:h * w].reshape(h, w)
        self.u = out[h * w:h * w + uh * uw].reshape(uh, uw)
        self.v = out[h * w + uh * uw:h * w + 2 * uh * uw].reshape(uh, uw)
        if filt >= 0:
            self.alpha = out[h * w + 2 * uh * uw:].reshape(h, w)


def decode_webp_planes(data: bytes) -> WebpPlanes:
    """The first frame of RIFF/WEBP bytes up to the colour stage (see
    WebpPlanes): the same container, VP8, VP8L and ALPH decoding as
    `decode_webp`, and the same ValueErrors."""
    return WebpPlanes(*_webp_call(data, 1))


def webp_colour(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The colour stage of `decode_webp` alone: (h, w) luma and ((h + 1) //
    2, (w + 1) // 2) chroma uint8 planes -> (h, w, 4) uint8 RGBA, alpha
    255 (the native side of image_io.webp_colour_twin)."""
    y = np.ascontiguousarray(y, np.uint8)
    h, w = y.shape
    uv_shape = ((h + 1) // 2, (w + 1) // 2)
    u, v = np.ascontiguousarray(u, np.uint8), np.ascontiguousarray(v, np.uint8)
    if u.shape != uv_shape or v.shape != uv_shape or 0 in y.shape:
        raise ValueError(f"webp_colour: planes {y.shape}, {u.shape}, {v.shape}")
    out = np.empty((h, w, 4), np.uint8)
    _check(lib().mm_webp_colour(_ptr(y), _ptr(u), _ptr(v), w, h, _ptr(out)), "webp_colour")
    return out


def webp_unfilter(samples: np.ndarray, alpha_filter: int) -> np.ndarray:
    """The ALPH unfiltering of `decode_webp` alone on (h, w) uint8 samples
    (filter 0-3; the native side of image_io.alpha_unfilter_twin)."""
    out = np.array(samples, np.uint8, order="C")
    if out.ndim != 2 or 0 in out.shape:
        raise ValueError(f"webp_unfilter takes (h, w) samples, not {out.shape}")
    _check(lib().mm_webp_unfilter(_ptr(out), out.shape[1], out.shape[0], int(alpha_filter)),
           "webp_unfilter")
    return out


# --- cv2 -------------------------------------------------------------------------


def resize_linear(arr: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(arr, size_wh, interpolation=INTER_LINEAR) for uint8 and
    float32 (H, W) or (H, W, C) arrays; a single channel comes back as
    (H, W), as cv2 gives it."""
    if arr.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_linear takes uint8 or float32, not {arr.dtype}")
    src = np.ascontiguousarray(arr if arr.ndim == 3 else arr[..., None])
    h, w, c = src.shape
    dw, dh = (int(v) for v in size_wh)
    if dh <= 0 or dw <= 0 or h == 0 or w == 0 or c == 0:
        raise ValueError(f"cannot resize {arr.shape} to {size_wh}")
    dst = np.empty((dh, dw, c), arr.dtype)
    fn = (lib().mm_cv_resize_linear_u8 if arr.dtype == np.uint8
          else lib().mm_cv_resize_linear_f32)
    _check(fn(_ptr(src), h, w, c, _ptr(dst), dh, dw), "resize_linear")
    return dst[..., 0] if c == 1 else dst


def resize_nearest(arr: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(arr, size_wh, interpolation=INTER_NEAREST), any dtype; a
    single channel comes back as (H, W)."""
    src = np.ascontiguousarray(arr)
    if src.ndim not in (2, 3) or 0 in src.shape:
        raise ValueError(f"cannot resize an array of shape {arr.shape}")
    dw, dh = (int(v) for v in size_wh)
    if dh <= 0 or dw <= 0:
        raise ValueError(f"cannot resize {arr.shape} to {size_wh}")
    tail = src.shape[2:]
    dst = np.empty((dh, dw) + tail, src.dtype)
    pixel = src.itemsize * int(np.prod(tail, dtype=np.int64))
    _check(lib().mm_cv_resize_nearest(_ptr(src), src.shape[0], src.shape[1], pixel, _ptr(dst),
                                      dh, dw), "resize_nearest")
    return dst[..., 0] if tail == (1,) else dst


def _rgb_pixels(rgb: np.ndarray, what: str) -> np.ndarray:
    if rgb.dtype != np.uint8 or rgb.ndim < 2 or rgb.shape[-1] != 3:
        raise ValueError(f"{what} takes uint8 (..., 3), not {rgb.dtype} {rgb.shape}")
    return np.ascontiguousarray(rgb)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, COLOR_RGB2GRAY) on uint8 (..., 3)."""
    src = _rgb_pixels(rgb, "rgb_to_gray")
    dst = np.empty(src.shape[:-1], np.uint8)
    lib().mm_rgb_to_gray(_ptr(src), dst.size, _ptr(dst))
    return dst


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, COLOR_RGB2HSV) on uint8 (..., 3): H in [0, 180)."""
    src = _rgb_pixels(rgb, "rgb_to_hsv")
    dst = np.empty(src.shape, np.uint8)
    lib().mm_rgb_to_hsv(_ptr(src), src.size // 3, _ptr(dst))
    return dst


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) on uint8 (..., W, 3) with H in
    [0, 180); rows of W pixels (OpenCV's vector loop and scalar tail)."""
    src = _rgb_pixels(hsv, "hsv_to_rgb")
    dst = np.empty(src.shape, np.uint8)
    width = src.shape[-2]
    rows = src.size // (3 * width) if width else 0
    lib().mm_hsv_to_rgb(_ptr(src), rows, width, _ptr(dst))
    return dst


def gaussian_blur_3x3(img: np.ndarray) -> np.ndarray:
    """cv2.GaussianBlur(img, (3, 3), sigmaX=1.0) of an (H, W) float32 image,
    BORDER_REFLECT_101."""
    if img.dtype != np.float32 or img.ndim != 2 or 0 in img.shape:
        raise ValueError(f"gaussian_blur_3x3 takes (H, W) float32, not {img.dtype} "
                         f"{img.shape}")
    src = np.ascontiguousarray(img)
    dst = np.empty_like(src)
    _check(lib().mm_gaussian_blur_3x3(_ptr(src), src.shape[0], src.shape[1], _ptr(dst)),
           "gaussian_blur_3x3")
    return dst


# --- Pillow's 8-bit operations (pil_ops.cpp) --------------------------------------


def _hwc_u8(img: np.ndarray, what: str) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"{what} takes (H, W) or (H, W, C) uint8, not {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


# mm_pil_resize's filter codes.
PIL_FILTERS = {"bilinear": 0, "bicubic": 1, "lanczos": 2}


def pil_resize(img: np.ndarray, size_hw: Tuple[int, int], resample: str = "bicubic"
               ) -> np.ndarray:
    """Image.resize((w, h), resample) of (H, W) or (H, W, C) uint8, with
    `resample` "bicubic", "bilinear", "lanczos" or "nearest" (Pillow's
    NEAREST path, `pil_nearest` over the whole image)."""
    src = _hwc_u8(img, "pil_resize")
    if resample == "nearest":
        return pil_nearest(src, (0, 0, src.shape[0], src.shape[1]), size_hw)
    if resample not in PIL_FILTERS:
        raise ValueError(f"pil_resize: resample {resample!r}, not one of nearest, "
                         f"{', '.join(PIL_FILTERS)}")
    dh, dw = _size_args(size_hw)
    c = src.shape[2] if src.ndim == 3 else 1
    dst = np.empty((dh, dw) + src.shape[2:], np.uint8)
    _check(lib().mm_pil_resize(_ptr(src), src.shape[0], src.shape[1], c, _ptr(dst), dh, dw,
                               PIL_FILTERS[resample]), "pil_resize")
    return dst


def pil_affine(img: np.ndarray, matrix: Sequence[float], bicubic: bool,
               fill: Sequence[int]) -> np.ndarray:
    """Image.transform(size, AFFINE, matrix, BICUBIC or BILINEAR,
    fillcolor=fill) of (H, W, C) uint8."""
    src = _hwc_u8(img, "pil_affine")
    if src.ndim != 3:
        raise ValueError(f"pil_affine takes (H, W, C), not {src.shape}")
    m = np.ascontiguousarray(np.asarray(matrix, np.float64).reshape(6))
    fill = np.ascontiguousarray(np.broadcast_to(np.asarray(fill, np.uint8), (src.shape[2],)))
    dst = np.empty_like(src)
    _check(lib().mm_pil_affine(_ptr(src), src.shape[0], src.shape[1], src.shape[2], _ptr(dst),
                               _ptr(m), int(bicubic), _ptr(fill)), "pil_affine")
    return dst


def pil_gray(img: np.ndarray) -> np.ndarray:
    """convert("L") of (..., 3) uint8 RGB."""
    src = _rgb_pixels(img, "pil_gray")
    dst = np.empty(src.shape[:-1], np.uint8)
    lib().mm_pil_gray(_ptr(src), dst.size, _ptr(dst))
    return dst


def pil_smooth(img: np.ndarray) -> np.ndarray:
    """filter(ImageFilter.SMOOTH) of (H, W, C) uint8."""
    src = _hwc_u8(img, "pil_smooth")
    c = src.shape[2] if src.ndim == 3 else 1
    dst = np.empty_like(src)
    _check(lib().mm_pil_smooth(_ptr(src), src.shape[0], src.shape[1], c, _ptr(dst)),
           "pil_smooth")
    return dst


def pil_blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """Image.blend(a, b, alpha) of two uint8 arrays of one shape."""
    a, b = _hwc_u8(a, "pil_blend"), _hwc_u8(b, "pil_blend")
    if a.shape != b.shape:
        raise ValueError(f"pil_blend: shapes {a.shape} and {b.shape} differ")
    dst = np.empty_like(a)
    lib().mm_pil_blend(_ptr(a), _ptr(b), a.size, float(alpha), _ptr(dst))
    return dst


# --- JPEG 2000 (jpeg2000_decode.cpp) ---------------------------------------------

# PIL's modes of a JPEG 2000 image, the bands the decoder writes for each,
# and the colour spaces a JP2 container names (OpenJPEG's OPJ_CLRSPC_*).
JPEG2000_MODES = {"L": (0, 1), "LA": (1, 2), "RGB": (2, 3), "RGBA": (3, 4), "I;16": (4, 1),
                  "P": (5, 1), "PA": (6, 2), "CMYK": (7, 4)}
JPEG2000_SPACES = {"unspecified": 0, "srgb": 1, "gray": 2, "sycc": 3, "eycc": 4, "cmyk": 5}


class Jpeg2000Unsupported(Exception):
    """A codestream OpenJPEG 2.5 decodes and jpeg2000_decode.cpp does not
    (high-throughput code-blocks, Part 2 multiple component transforms)."""


def _j2k_check(rc: int, msg) -> None:
    text = msg.value.decode(errors="replace")
    if rc == -2:
        raise Jpeg2000Unsupported(text)
    if rc != 0:
        raise ValueError(f"JPEG 2000: {text}")


def _j2k_args(mode: str, space: str):
    if mode not in JPEG2000_MODES or space not in JPEG2000_SPACES:
        raise ValueError(f"JPEG 2000: mode {mode!r} or colour space {space!r} unknown")
    return JPEG2000_MODES[mode][0], JPEG2000_SPACES[space]


def jpeg2000_shape(mode: str, size_hw: Tuple[int, int]) -> Tuple[Tuple[int, ...], type]:
    """The (H, W) or (H, W, bands) shape and dtype the decoder writes for
    PIL's `mode`."""
    bands = JPEG2000_MODES[mode][1]
    shape = tuple(size_hw) + ((bands,) if bands > 1 else ())
    return shape, (np.uint16 if mode == "I;16" else np.uint8)


def decode_jpeg2000(codestream: bytes, mode: str, space: str,
                    size_hw: Tuple[int, int]) -> np.ndarray:
    """A JPEG 2000 codestream -> PIL 12.1's pixels (OpenJPEG 2.5 and
    Pillow's unpackers) in `mode`, for the colour space the container named,
on PIL's canvas of `size_hw`: (H, W) or (H, W, bands) uint8, uint16 for
    "I;16". Raises ValueError naming what it met where PIL refuses the
    file, Jpeg2000Unsupported where PIL reads it and the decoder cannot."""
    code, sp = _j2k_args(mode, space)
    shape, dtype = jpeg2000_shape(mode, size_hw)
    out = np.empty(shape, dtype)
    msg = ctypes.create_string_buffer(256)
    _j2k_check(lib().mm_decode_jpeg2000(codestream, len(codestream), code, sp, int(size_hw[1]),
                                        int(size_hw[0]), _ptr(out), out.nbytes, msg, len(msg)),
               msg)
    return out


class Jpeg2000Tile:
    """One decoded tile before the inverse wavelet transform: its
    rectangle (x0, y0, x1, y1) on the reference grid, its `mct` flag, and
    per component `qmfbid` (1: 5/3, int32 coefficients; 0: 9/7, float32),
    the resolution rectangles `rects` ((R, 4) int32) and `coef` ((h, w), in
    OpenJPEG's layout of bands)."""

    def __init__(self, rect, mct):
        self.rect, self.mct = rect, mct
        self.qmfbid, self.rects, self.coef = [], [], []


class Jpeg2000Coefficients:
    """A codestream's tiles before the inverse wavelet transform (see
    Jpeg2000Tile), with the image origin `origin` (x0, y0), the components'
    `comps` ((C, 4): dx, dy, prec, sgnd) and the Pillow unpacker that
    `mode` and the colour space select (`unpacker`, jpeg2000_decode.cpp's
    Unpacker)."""


def decode_jpeg2000_coefficients(codestream: bytes, mode: str, space: str) -> Jpeg2000Coefficients:
    """The same header, Tier-2, Tier-1 and dequantisation as
    `decode_jpeg2000`, stopped before the inverse wavelet transform, and
    the same ValueErrors."""
    code, sp = _j2k_args(mode, space)
    fn = lib().mm_jpeg2000_coefficients
    sizes = np.zeros(2, np.int64)
    msg = ctypes.create_string_buffer(256)
    rc = fn(codestream, len(codestream), code, sp, None, 0, None, 0, _ptr(sizes), msg, len(msg))
    if rc == -3:
        meta = np.empty(int(sizes[0]), np.int32)
        coef = np.empty(int(sizes[1]), np.int32)
        rc = fn(codestream, len(codestream), code, sp, _ptr(meta), meta.size, _ptr(coef),
                coef.size, _ptr(sizes), msg, len(msg))
    _j2k_check(rc, msg)
    out = Jpeg2000Coefficients()
    out.origin = (int(meta[0]), int(meta[1]))
    nc = int(meta[2])
    out.comps = meta[3:3 + 4 * nc].reshape(nc, 4).copy()
    at = 3 + 4 * nc
    out.unpacker, ntiles = int(meta[at]), int(meta[at + 1])
    at += 2
    cat = 0
    out.tiles = []
    for _ in range(ntiles):
        tile = Jpeg2000Tile(tuple(int(v) for v in meta[at:at + 4]), int(meta[at + 4]))
        at += 5
        for _ in range(nc):
            qmfbid, nres = int(meta[at]), int(meta[at + 1])
            rects = meta[at + 2:at + 2 + 4 * nres].reshape(nres, 4).copy()
            at += 2 + 4 * nres
            h, w = int(rects[-1, 3] - rects[-1, 1]), int(rects[-1, 2] - rects[-1, 0])
            block = coef[cat:cat + h * w].reshape(h, w)
            cat += h * w
            tile.qmfbid.append(qmfbid)
            tile.rects.append(rects)
            tile.coef.append(block.copy() if qmfbid == 1 else block.view(np.float32).copy())
        out.tiles.append(tile)
    return out


def jpeg2000_idwt(coef: np.ndarray, rects: np.ndarray, qmfbid: int) -> np.ndarray:
    """The inverse wavelet transform of `decode_jpeg2000` alone on one
    tile-component's (h, w) coefficients (int32 for qmfbid 1, float32 for
    0) with its (R, 4) resolution rectangles (the native side of
    image_io.jpeg2000_idwt_twin)."""
    out = np.array(coef, np.int32 if qmfbid == 1 else np.float32, order="C")
    rects = np.ascontiguousarray(rects, np.int32)
    if out.ndim != 2 or rects.ndim != 2 or rects.shape[1] != 4 or 0 in out.shape:
        raise ValueError(f"jpeg2000_idwt: coefficients {out.shape}, rectangles {rects.shape}")
    if lib().mm_jpeg2000_idwt(_ptr(out), out.shape[1], out.shape[0], int(qmfbid), len(rects),
                              _ptr(rects)) != 0:
        raise ValueError("jpeg2000_idwt: the rectangles do not end at the coefficients' size")
    return out


def jpeg2000_colour(planes: Sequence[np.ndarray], qmfbid: Sequence[int], comps: np.ndarray,
                    mct: int, mode: str, unpacker: int, origin: Tuple[int, int],
                    rect: Tuple[int, int, int, int], size_hw: Tuple[int, int]) -> np.ndarray:
    """The colour stage of `decode_jpeg2000` alone on one tile: the
    components' planes after the inverse transform (int32 or float32 by
    `qmfbid`) through the RCT or ICT, the DC level shift and clipping and
    Pillow's `unpacker` onto a zeroed canvas of `size_hw` in `mode` (the
    native side of image_io.jpeg2000_colour_twin)."""
    code = JPEG2000_MODES[mode][0]
    meta = [len(planes), code, int(unpacker), int(mct), int(origin[0]), int(origin[1]),
            *(int(v) for v in rect)]
    flat = []
    for p, q, c in zip(planes, qmfbid, comps):
        p = np.ascontiguousarray(p, np.int32 if q == 1 else np.float32)
        meta += [int(c[0]), int(c[1]), int(c[2]), int(c[3]), int(q), p.shape[1], p.shape[0]]
        flat.append(p.view(np.int32).ravel())
    meta = np.array(meta, np.int32)
    data = np.concatenate(flat) if flat else np.zeros(0, np.int32)
    shape, dtype = jpeg2000_shape(mode, size_hw)
    out = np.empty(shape, dtype)
    msg = ctypes.create_string_buffer(256)
    if lib().mm_jpeg2000_colour(_ptr(data), _ptr(meta), _ptr(out), int(size_hw[1]),
                                int(size_hw[0]), msg, len(msg)) != 0:
        raise ValueError(f"jpeg2000_colour: {msg.value.decode(errors='replace')}")
    return out
