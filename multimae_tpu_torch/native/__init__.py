"""ctypes bindings for the port's native image library (fastimage.cpp,
jpeg_decode.cpp and pil_ops.cpp), the counterpart of the JAX package's
multimae_tpu/native/__init__.py. fastimage.cpp also holds the BMP
run-length decoder (`bmp_rle`).

The library is built with g++ at first use:

    g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off fastimage.cpp jpeg_decode.cpp \
        pil_ops.cpp -o <lib>

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
SOURCES = (SOURCE, JPEG_SOURCE, PIL_SOURCE)
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
    "mm_pil_resize": [_P, _I, _I, _I, _P, _I, _I, _I],
    "mm_pil_affine": [_P, _I, _I, _I, _P, _P, _I, _P],
    "mm_pil_gray": [_P, _L, _P],
    "mm_pil_smooth": [_P, _I, _I, _I, _P],
    "mm_pil_blend": [_P, _P, _L, _F, _P],
    "mm_bmp_rle": [_P, _L, _L, _L, _I, _I, _I, _P],
}


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
        fn.restype = ctypes.c_int
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
    fn = lib().mm_bmp_rle
    fn.restype = ctypes.c_long
    n = fn(data, len(data), start, file_offset, int(rle4), width, height, _ptr(out))
    if n < 0:
        raise ValueError("BMP RLE data ends inside a delta")
    if n < width * height:
        raise ValueError(f"BMP RLE data ends after {n} of {width * height} pixels "
                         "(not enough image data)")
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
