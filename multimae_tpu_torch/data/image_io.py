"""Image files to numpy arrays, without PIL (counterpart of the JAX
package's native helper, multimae_tpu/native/__init__.py + fastimage.cpp,
and of dataset_folder.pil_loader, which opens every file with PIL).

* PNG: the standard library's zlib inflates, the port's native library
  (native/fastimage.cpp `mm_png_decode`) undoes the row filters and
  expands the samples: 8-bit gray, gray + alpha, RGB and RGBA, 16-bit
  samples, palette images (semantic segmentation maps; 1, 2, 4 or 8
  bits), every row filter of the PNG standard, and Adam7-interlaced files
  (each of the seven passes a sub-image with its own rows and filters).
  `read_png_twin` is the same reader in numpy, for tests and A/B runs; no
  loader path takes it. `write_png` writes the same kinds with filter 0,
  or choosing each row's filter as PIL and libpng do, so tests and scripts
  make their trees without PIL.
* JPEG: the port's own decoder in its native library
  (native/jpeg_decode.cpp, no libjpeg): baseline, extended, progressive
  and lossless Huffman-coded and sequential and progressive
  arithmetic-coded files, gray, YCbCr, RGB, CMYK and YCCK, with
  libjpeg-turbo's block smoothing, bit-equal to PIL's convert("RGB").
  Damaged files, and files PIL refuses too (hierarchical, 12-bit), raise
  ValueError naming what was met. Where the library cannot be built (no
  g++), decoding raises RuntimeError with g++'s message and the file's
  name; it never skips the file.
* BMP (Pillow's BmpImagePlugin): the OS/2 core header and
  BITMAPINFOHEADER up to v5; 1, 4 and 8 bits with a palette (mode "P", or
  "1" / "L" where the palette is black and white or a gray ramp, as PIL
  decides), 16, 24 and 32 bits with BI_BITFIELDS layouts PIL knows;
  BI_RLE8 and BI_RLE4 run-length decoded in the native library
  (`native.bmp_rle`, numpy twin `bmp_rle_twin`); bottom-up and top-down
  rows.
* Netpbm (Pillow's PpmImagePlugin): P1-P6, plain and raw; maxval other
  than 255 scaled as PIL scales it; gray past maxval 255 in PIL's mode "I"
  (int32).

Files PIL reads and the port cannot (TIFF, WebP, JPEG 2000) raise
`UnsupportedImage`, which is neither a ValueError nor an OSError: the
corrupt-file retries of the datasets and the loader let it through, so a
tree that holds one stops the run naming the file instead of training on
other samples than the JAX package would. A damaged file raises
ValueError, which the retries catch, as the JAX package's catch PIL's
errors.

`load_image(path, convert_rgb)` returns what PIL's loader gives the
pipeline: (H, W, 3) uint8 for convert_rgb (palette and gray expanded,
alpha dropped, 16-bit gray clipped to 255 as PIL's convert("RGB") clips
it), else the raw representation in the mode PIL opens the file in:
palette indices (H, W) uint8 ("P"), gray (H, W) uint8 ("L", and "1" as 0
or 255), uint16 ("I;16") or int32 ("I"), RGB (H, W, 3) uint8, alpha
dropped.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

from multimae_tpu_torch import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class UnsupportedImage(Exception):
    """A file that PIL reads and the port cannot decode. Not a ValueError or
    an OSError, so that no corrupt-file retry resamples it: the message
    names the file, what was met and the ROADMAP item that ports it."""


# Formats PIL reads that the port does not: (signature test, name, ROADMAP item).
UNPORTED_FORMATS = (
    (lambda d: d[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"), "a TIFF file",
     "11d"),
    (lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP", "a WebP file", "11e"),
    (lambda d: d[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or d[:4] == b"\xff\x4f\xff\x51",
     "a JPEG 2000 file", "11f"),
)

# PNG colour types -> samples per pixel, and the bit depths the standard allows
_CHANNELS = native.PNG_CHANNELS
# Adam7's passes: (first row, first column, row step, column step).
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


class PngImage:
    """A decoded PNG: `pixels` (H, W) or (H, W, C), uint8 or uint16, and
    the colour type's `palette` ((n, 3) uint8, palette images only)."""

    def __init__(self, pixels: np.ndarray, color_type: int, palette: Optional[np.ndarray]):
        self.pixels = pixels
        self.color_type = color_type
        self.palette = palette


def _unfilter_twin(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2): (height, stride) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size != height * (stride + 1):
        raise ValueError(f"PNG image data holds {data.size} bytes, expected "
                         f"{height * (stride + 1)}")
    rows = data.reshape(height, stride + 1)
    filters = rows[:, 0]
    out = np.array(rows[:, 1:])
    if not filters.any():
        return out
    prev = np.zeros(stride, np.int32)
    for y in range(height):
        f = int(filters[y])
        line = out[y].astype(np.int32)
        if f == 1:    # Sub: running sum per byte of a pixel
            line = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif f == 2:  # Up
            line = (line + prev) & 0xFF
        elif f in (3, 4):  # Average, Paeth: each byte needs the one bpp before
            cur = line.tolist()
            up = prev.tolist()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if f == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                    cur[i] = (cur[i] + pred) & 0xFF
            line = np.asarray(cur, np.int32)
        elif f != 0:
            raise ValueError(f"PNG row {y} has unknown filter type {f}")
        out[y] = line
        prev = line
    return out


class _PngFile:
    """A PNG file's header, palette and inflated image data."""

    def __init__(self, data: bytes):
        if data[:8] != PNG_SIGNATURE:
            raise ValueError("not a PNG file")
        pos, idat, palette, header = 8, [], None, None
        while pos < len(data):
            if pos + 8 > len(data):
                raise ValueError("PNG file truncated")
            length, kind = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + length]
            if len(body) != length:
                raise ValueError("PNG file truncated")
            pos += 12 + length
            if kind == b"IHDR":
                header = struct.unpack(">IIBBBBB", body)
            elif kind == b"PLTE":
                palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
        else:
            raise ValueError("PNG file truncated: no IEND chunk")
        if header is None:
            raise ValueError("PNG file has no IHDR chunk")
        self.width, self.height, self.depth, self.color_type, _, _, interlace = header
        if interlace not in (0, 1):
            raise ValueError(f"unknown PNG interlace method {interlace}")
        self.interlaced = interlace == 1
        if self.depth not in _DEPTHS.get(self.color_type, ()):
            raise ValueError(f"unsupported PNG colour type {self.color_type} at bit depth "
                             f"{self.depth}")
        if self.color_type == 3 and palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        self.palette = palette
        self.raw = zlib.decompress(b"".join(idat))

    def passes(self):
        """(raw bytes, width, height, row offset, column offset, row step,
        column step) per image: the whole image, or Adam7's seven passes
        (PNG spec 8.2) that hold pixels, each with its filter bytes."""
        if not self.interlaced:
            return [(self.raw, self.width, self.height, 0, 0, 1, 1)]
        out, at = [], 0
        bits = _CHANNELS[self.color_type] * self.depth
        for y0, x0, dy, dx in ADAM7:
            w = (self.width - x0 + dx - 1) // dx
            h = (self.height - y0 + dy - 1) // dy
            if w <= 0 or h <= 0:
                continue
            size = h * (1 + (w * bits + 7) // 8)
            out.append((self.raw[at:at + size], w, h, y0, x0, dy, dx))
            at += size
        if at != len(self.raw):
            raise ValueError(f"PNG image data holds {len(self.raw)} bytes, the seven "
                             f"passes {at}")
        return out

    def decode(self, mode: str, one=None) -> np.ndarray:
        """Every pass through `one(raw, width, height)` (the native decode
        by default), put in place."""
        one = one or (lambda raw, w, h: native.png_decode(raw, w, h, self.depth, self.color_type,
                                                          self.palette, mode))
        parts = self.passes()
        if len(parts) == 1 and not self.interlaced:
            return one(parts[0][0], self.width, self.height)
        out = None
        for raw, w, h, y0, x0, dy, dx in parts:
            px = one(raw, w, h)
            if out is None:
                out = np.zeros((self.height, self.width) + px.shape[2:], px.dtype)
            out[y0::dy, x0::dx] = px
        return out


def read_png(data: bytes) -> PngImage:
    """Decode PNG bytes: every sample (alpha included)."""
    f = _PngFile(data)
    return PngImage(f.decode("samples"), f.color_type, f.palette)


def decode_png(data: bytes, convert_rgb: bool) -> np.ndarray:
    """PNG bytes -> what `load_image` returns for them."""
    f = _PngFile(data)
    if f.depth == 16 and (convert_rgb or f.color_type != 0):  # PIL's 8-bit modes, "I;16"
        img = PngImage(f.decode("samples"), f.color_type, f.palette)
        return png_to_rgb(img) if convert_rgb else png_raw(img)
    return f.decode("rgb" if convert_rgb else "raw")


def _pixels_twin(raw: bytes, width: int, height: int, depth: int, color_type: int
                 ) -> np.ndarray:
    """One image (or Adam7 pass) of inflated data -> its samples, in numpy."""
    channels = _CHANNELS[color_type]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    rows = _unfilter_twin(raw, height, stride, max(1, bits // 8))
    if depth == 16:
        pixels = rows.view(">u2").astype(np.uint16).reshape(height, width, channels)
    elif depth == 8:
        pixels = rows.reshape(height, width, channels)
    else:  # 1, 2 or 4 bits per sample, one channel (gray or palette)
        per_byte = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        unpacked = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        pixels = unpacked.reshape(height, stride * per_byte)[:, :width, None]
        if color_type == 0:  # gray scales to the full 8-bit range
            pixels = pixels * np.uint8(255 // ((1 << depth) - 1))
    return pixels[:, :, 0] if channels == 1 else pixels


def read_png_twin(data: bytes) -> PngImage:
    """`read_png` in numpy (the rows unfiltered in a Python loop where a
    filter needs the byte before), Adam7's passes too."""
    f = _PngFile(data)
    pixels = f.decode("samples", lambda raw, w, h: _pixels_twin(raw, w, h, f.depth,
                                                                f.color_type))
    return PngImage(np.ascontiguousarray(pixels), f.color_type, f.palette)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


PNG_FILTERS = ("none", "adaptive")


def _filter_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Each row filtered with the type of least sum of |signed byte| over
    the five of PNG spec 9.2 (the heuristic of libpng and PIL): (height,
    1 + stride) uint8, the filter byte first."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    filtered = np.stack([x, x - a, x - b, x - (a + b) // 2, x - paeth]).astype(np.uint8)
    signed = np.abs(filtered.view(np.int8).astype(np.int32)).sum(axis=2)  # (5, height)
    best = np.argmin(signed, axis=0)
    chosen = filtered[best, np.arange(len(rows))]
    return np.concatenate([best.astype(np.uint8)[:, None], chosen], axis=1)


def write_png(path, pixels: np.ndarray, palette: Optional[np.ndarray] = None,
              filters: str = "none") -> np.ndarray:
    """Write (H, W) uint8 or uint16 gray, (H, W, 3) RGB or (H, W, 4) RGBA
    uint8, or (H, W) uint8 palette indices with `palette` ((n, 3) uint8).
    `filters` "none" gives every row filter 0; "adaptive" chooses each
    row's filter as libpng and PIL do, and as they do leaves palette images
    at filter 0. Returns the count of rows per filter type (5,)."""
    if filters not in PNG_FILTERS:
        raise ValueError(f"filters must be one of {PNG_FILTERS}, not {filters!r}")
    pixels = np.asarray(pixels)
    height, width = pixels.shape[:2]
    channels = 1 if pixels.ndim == 2 else pixels.shape[2]
    if palette is not None:
        if pixels.dtype != np.uint8 or channels != 1:
            raise ValueError("palette images take (H, W) uint8 indices")
        color_type = 3
    else:
        color_type = {1: 0, 3: 2, 4: 6}[channels]
    if pixels.dtype == np.uint16 and color_type == 0:
        depth, body = 16, pixels.astype(">u2").tobytes()
    elif pixels.dtype == np.uint8:
        depth, body = 8, pixels.tobytes()
    else:
        raise ValueError(f"cannot write {pixels.dtype} pixels with {channels} channels")
    stride = width * channels * depth // 8
    rows = np.frombuffer(body, np.uint8).reshape(height, stride)
    if filters == "adaptive" and color_type != 3:
        raw = _filter_rows(rows, channels * depth // 8)
    else:
        raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    out = [PNG_SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color_type, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).reshape(-1, 3).tobytes()))
    out += [_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)), _chunk(b"IEND", b"")]
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(out))
    os.replace(tmp, path)
    return np.bincount(raw[:, 0], minlength=5)


def png_to_rgb(img: PngImage) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's convert("RGB") gives it: a 16-bit gray file
    ("I;16") clipped to 255, the other 16-bit kinds by their high bytes (PIL
    opens them as 8-bit "LA", "RGB" and "RGBA")."""
    px = img.pixels
    if img.color_type == 3:
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(img.palette)] = img.palette[:256]
        return palette[px]
    if px.dtype != np.uint8:
        px = (np.minimum(px, 255) if img.color_type == 0 else px >> 8).astype(np.uint8)
    if img.color_type in (0, 4):
        gray = px if img.color_type == 0 else px[:, :, 0]
        return np.repeat(gray[:, :, None], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def png_raw(img: PngImage) -> np.ndarray:
    """Palette indices, gray or RGB samples, with alpha dropped, in the mode
    PIL opens the file in: 16-bit gray stays 16-bit ("I;16"); 16-bit RGB
    and RGBA keep their high bytes ("RGB", "RGBA"), and 16-bit gray + alpha
    becomes "RGBA" too, its gray in each of R, G and B."""
    if img.pixels.dtype == np.uint16 and img.color_type != 0:
        px = (img.pixels >> 8).astype(np.uint8)
        if img.color_type == 4:
            return np.repeat(px[:, :, :1], 3, axis=2)
        return np.ascontiguousarray(px[:, :, :3])
    if img.color_type == 4:
        return np.ascontiguousarray(img.pixels[:, :, 0])
    if img.color_type == 6:
        return np.ascontiguousarray(img.pixels[:, :, :3])
    return img.pixels


class Decoded:
    """A decoded BMP or netpbm image in the mode PIL opens it in: "P"
    (indices, with `palette` (n, 3) uint8), "1" and "L" (uint8; "1" as 0
    or 255), "I" (int32), "RGB" or "RGBA" ((H, W, 3 or 4) uint8)."""

    def __init__(self, mode: str, pixels: np.ndarray, palette: Optional[np.ndarray] = None):
        self.mode, self.pixels, self.palette = mode, pixels, palette

    def rgb(self) -> np.ndarray:
        """PIL's convert("RGB"): a palette's missing entries are black, "I"
        clips to 0-255, alpha is dropped."""
        px = self.pixels
        if self.mode == "P":
            palette = np.zeros((256, 3), np.uint8)
            palette[:len(self.palette)] = self.palette[:256]
            return palette[px]
        if self.mode == "I":
            px = np.clip(px, 0, 255).astype(np.uint8)
        if px.ndim == 2:
            return np.repeat(px[:, :, None], 3, axis=2)
        return np.ascontiguousarray(px[:, :, :3])

    def raw(self) -> np.ndarray:
        return np.ascontiguousarray(self.pixels[:, :, :3]) if self.pixels.ndim == 3 else self.pixels


# --- BMP (Pillow's BmpImagePlugin) ------------------------------------------------

_BMP_BITS = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
             24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# BI_BITFIELDS layouts PIL decodes: (bits, masks) -> raw mode (bytes in file order).
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_BITS = {"P;1": 1, "1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16, "BGR;16": 16, "BGR": 24}


def _u16(data, at):
    return struct.unpack_from("<H", data, at)[0]


def _u32(data, at):
    return struct.unpack_from("<I", data, at)[0]


def _unpack_rows(rows: np.ndarray, width: int, rawmode: str) -> np.ndarray:
    """(h, bytes) rows -> pixels, as PIL's unpacker for `rawmode`."""
    h = rows.shape[0]
    if rawmode in ("P;1", "1", "P;4"):
        bits = _RAW_BITS[rawmode]
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        px = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :width]
        return px * np.uint8(255) if rawmode == "1" else px
    if rawmode in ("P", "L"):
        return rows[:, :width]
    if rawmode in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * width].reshape(h, width, 2).astype(np.int32)
        v = v[..., 0] | (v[..., 1] << 8)
        if rawmode == "BGR;15":
            r, g, b = (v >> 10) & 31, (v >> 5) & 31, v & 31
            gmax = 31
        else:
            r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
            gmax = 63
        return np.stack([r * 255 // 31, g * 255 // gmax, b * 255 // 31], -1).astype(np.uint8)
    size = 3 if rawmode == "BGR" else 4
    px = rows[:, :size * width].reshape(h, width, size)
    order = [rawmode.index(c) for c in ("RGBA" if "A" in rawmode else "RGB")]
    return np.ascontiguousarray(px[:, :, order])


def bmp_rle_twin(data: bytes, start: int, file_offset: int, rle4: bool, width: int,
                 height: int) -> np.ndarray:
    """`native.bmp_rle` in Python: PIL's BmpRleDecoder line for line."""
    dest = width * height
    out = bytearray()
    pos, x = start, 0
    while len(out) < dest:
        if pos + 2 > len(data):
            break
        num, byte = data[pos], data[pos + 1]
        pos += 2
        if num:
            count = max(0, width - x) if x + num > width else num
            out += (bytes([byte >> 4, byte & 15]) * count)[:count] if rle4 else bytes([byte]) * count
            x += count
        elif byte == 0:
            out += bytes(-len(out) % width)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > len(data):
                break
            pos += 2
            if pos + 2 > len(data):
                raise ValueError("BMP RLE data ends inside a delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * width)
            x = len(out) % width
        else:
            count = byte // 2 if rle4 else byte
            got = data[pos:pos + count]
            pos += len(got)
            out += bytes(v for b in got for v in (b >> 4, b & 15)) if rle4 else got
            if len(got) < count:
                break
            x += byte
            if (file_offset + pos) % 2:
                pos += 1
    if len(out) < dest:
        raise ValueError(f"BMP RLE data ends after {len(out)} of {dest} pixels "
                         "(not enough image data)")
    return np.frombuffer(bytes(out[:dest]), np.uint8).reshape(height, width)


def read_bmp(data: bytes, twin: bool = False) -> Decoded:
    """A BMP file as PIL opens and loads it (BmpImagePlugin `_bitmap`, the
    raw and BmpRle decoders); `twin` decodes RLE with `bmp_rle_twin`.
    Raises ValueError where PIL raises (a header, depth, bitfields layout
    or compression it does not read; too little data)."""
    if data[:2] != b"BM" or len(data) < 18:
        raise ValueError("not a BMP file")
    offset = _u32(data, 10)
    header_size = _u32(data, 14)
    hd = data[18:14 + header_size]
    if len(hd) != max(header_size - 4, 0):
        raise ValueError("BMP file truncated in its header")
    pos = 14 + header_size
    masks = None
    if header_size == 12:  # OS/2 1.x BITMAPCOREHEADER
        width, height, bits = _u16(hd, 0), _u16(hd, 2), _u16(hd, 6)
        compression, colors, padding, direction = 0, 0, 3, -1
    elif header_size in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        direction = 1 if flip else -1
        width = _u32(hd, 0)
        height = 2**32 - _u32(hd, 4) if flip else _u32(hd, 4)
        bits, compression, colors = _u16(hd, 10), _u32(hd, 12), _u32(hd, 28)
        padding = 4
        if compression == 3:
            if len(hd) >= 48:
                masks = [_u32(hd, 36 + 4 * i) for i in range(4 if len(hd) >= 52 else 3)]
            else:
                masks = [_u32(data, pos + 4 * i) for i in range(3)]
                pos += 12
            if len(masks) == 3:
                masks.append(0)
    else:
        raise ValueError(f"unsupported BMP header type ({header_size}), as PIL refuses it")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_BITS:
        raise ValueError(f"unsupported BMP pixel depth ({bits}), as PIL refuses it")
    mode, rawmode = _BMP_BITS[bits]
    rle = None
    if compression == 3:
        key = (bits, tuple(masks) if bits == 32 else tuple(masks[:3]))
        if key not in _BMP_MASKS:
            raise ValueError(f"unsupported BMP bitfields layout {key}, as PIL refuses it")
        rawmode = _BMP_MASKS[key]
        mode = "RGBA" if "A" in rawmode else mode
    elif compression in (1, 2):
        rle = compression == 2
    elif compression != 0:
        raise ValueError(f"unsupported BMP compression ({compression}), as PIL refuses it")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"unsupported BMP palette size ({colors}), as PIL refuses it")
        table = data[pos:pos + padding * colors]
        values = (0, 255) if colors == 2 else range(colors)
        if all(table[i * padding:i * padding + 3] == bytes([v]) * 3
               for i, v in enumerate(values)):
            mode = rawmode = "1" if colors == 2 else "L"
        else:
            n = len(table) // padding
            palette = np.frombuffer(table[:n * padding], np.uint8).reshape(n, padding)[:, 2::-1]
    if width <= 0 or height <= 0 or width * height > 1 << 28:
        raise ValueError(f"a BMP of {width} x {height} pixels")
    if rle is not None:
        if mode not in ("P", "L"):
            raise ValueError(f"a run-length BMP in mode {mode}, which PIL cannot unpack")
        decode = bmp_rle_twin if twin else native.bmp_rle
        px = decode(data, offset, offset, rle, width, height)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        need = (width * _RAW_BITS.get(rawmode, 32) + 7) // 8
        if stride < need:
            raise ValueError(f"BMP rows of {stride} bytes hold no {width} pixels of {rawmode}, "
                             "as PIL refuses them")
        if offset + stride * (height - 1) + need > len(data):
            raise ValueError("BMP file truncated in its pixels")
        view = np.frombuffer(data, np.uint8, count=len(data) - offset, offset=offset)
        rows = np.lib.stride_tricks.as_strided(view, (height, need), (stride, 1))
        px = _unpack_rows(rows, width, rawmode)
    if direction == -1:
        px = px[::-1]
    return Decoded(mode, np.ascontiguousarray(px), palette)


# --- netpbm (Pillow's PpmImagePlugin) ------------------------------------------------

_WHITESPACE = b" \t\n\x0b\x0c\r"


def _ppm_token(data: bytes, pos: int):
    """PpmImageFile._read_token: (token, position after the whitespace that
    ends it); '#' starts a comment to the end of the line."""
    token = b""
    while len(token) <= 10:
        if pos >= len(data):
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        raise ValueError("netpbm file ends in its header")
    if len(token) > 10:
        raise ValueError("netpbm header token too long")
    return token, pos


def _plain_tokens(data: bytes) -> bytes:
    """PpmPlainDecoder's data with its comments (# to the end of the line)
    taken out."""
    out, at = bytearray(), 0
    while True:
        start = data.find(b"#", at)
        if start < 0:
            return bytes(out + data[at:])
        out += data[at:start]
        ends = [e for e in (data.find(b"\n", start), data.find(b"\r", start)) if e >= 0]
        if not ends:
            return bytes(out)
        at = min(ends) + 1


def read_netpbm(data: bytes) -> Decoded:
    """A P1-P6 file as PIL opens and loads it. Raises ValueError where PIL
    raises, and UnsupportedImage for Pillow's own variants (P0CMYK, Pf,
    PyP, ...) that no other reader writes."""
    magic, pos = b"", 0
    while pos < min(6, len(data)):  # PpmImageFile._read_magic
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    mode = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB"}.get(magic)
    if mode is None:
        if magic in (b"P0CMYK", b"Pf", b"PyP", b"PyRGBA", b"PyCMYK"):
            raise UnsupportedImage(f"Pillow's netpbm variant {magic.decode()}, which no "
                                   "ROADMAP item ports")
        raise ValueError("not a netpbm file")
    tok, pos = _ppm_token(data, pos)
    width = int(tok)
    tok, pos = _ppm_token(data, pos)
    height = int(tok)
    if width <= 0 or height <= 0 or width * height > 1 << 28:
        raise ValueError(f"a netpbm image of {width} x {height} pixels")
    bands = 3 if mode == "RGB" else 1
    n = width * height * bands
    if mode == "1":
        if magic == b"P1":
            tokens = b"".join(_plain_tokens(data[pos:]).split())
            if tokens.strip(b"01"):
                raise ValueError("a plain PBM holds a token other than 0 and 1")
            tokens = tokens[:n]
            if len(tokens) < n:
                raise ValueError("not enough image data")
            px = np.where(np.frombuffer(tokens, np.uint8) == ord("1"), 0, 255).astype(np.uint8)
        else:
            stride = (width + 7) // 8
            if pos + stride * height > len(data):
                raise ValueError("netpbm file truncated in its pixels")
            rows = np.frombuffer(data, np.uint8, stride * height, pos).reshape(height, stride)
            px = np.where(np.unpackbits(rows, axis=1)[:, :width], 0, 255).astype(np.uint8)
        return Decoded("1", px.reshape(height, width))
    tok, pos = _ppm_token(data, pos)
    maxval = int(tok)
    if not 0 < maxval < 65536:
        raise ValueError("maxval must be greater than 0 and less than 65536")
    if maxval > 255 and mode == "L":
        mode = "I"
    out_max = 65535 if mode == "I" else 255
    if magic in (b"P2", b"P3"):
        tokens = _plain_tokens(data[pos:]).split()[:n]
        if any(len(t) > 10 for t in tokens):
            raise ValueError("a netpbm data token too long")
        values = np.asarray([int(t) for t in tokens], np.int64)
        if len(values) and (values.min() < 0 or values.max() > maxval):
            raise ValueError("a channel value outside 0..maxval")
        if len(values) < n:
            raise ValueError("not enough image data")
        scaled = np.round(values / maxval * out_max)
    else:
        item = 1 if maxval < 256 else 2
        count = min(n, (len(data) - pos) // (item * bands) * bands)
        values = np.frombuffer(data, np.uint8 if item == 1 else ">u2", count, pos)
        if count < n:
            raise ValueError("netpbm file truncated in its pixels (not enough image data)")
        if maxval == out_max or (maxval == 65535 and mode == "I"):
            scaled = values  # PIL's raw decoder: no scaling
        else:
            scaled = np.minimum(out_max, np.round(values / maxval * out_max))
    px = scaled.astype(np.int32 if mode == "I" else np.uint8)
    return Decoded(mode, px.reshape((height, width) + ((3,) if bands == 3 else ())))


def load_image(path: str, convert_rgb: bool = True, twin: bool = False) -> np.ndarray:
    """Decode one image file (see the module docstring for what comes back);
    `twin` reads a PNG with `read_png_twin` and a run-length BMP with
    `bmp_rle_twin`. Raises UnsupportedImage, naming the file, for a file
    PIL reads that the port cannot, and ValueError for a damaged one."""
    with open(path, "rb") as f:
        data = f.read()
    for test, what, item in UNPORTED_FORMATS:
        if test(data):
            raise UnsupportedImage(f"{path}: {what}, which PIL reads and the port does not "
                                   f"yet (ROADMAP.md queue 1 item {item})")
    try:
        if data[:8] == PNG_SIGNATURE:
            if not twin:
                return decode_png(data, convert_rgb)
            img = read_png_twin(data)
            return png_to_rgb(img) if convert_rgb else png_raw(img)
        if data[:3] == b"\xff\xd8\xff":
            return native.decode_jpeg(data)
        if data[:2] == b"BM":
            img = read_bmp(data, twin)
        elif len(data) > 1 and data[:1] == b"P" and data[1:2] in b"0123456fy":
            img = read_netpbm(data)
        else:
            raise ValueError("not a PNG, JPEG, BMP or netpbm file")
        return img.rgb() if convert_rgb else img.raw()
    except UnsupportedImage as e:
        raise UnsupportedImage(f"{path}: {e}") from e
    except (ValueError, struct.error, zlib.error) as e:  # a damaged file
        raise ValueError(f"{path}: {e}") from e
    except RuntimeError as e:  # the native library did not build: not the file's fault
        raise RuntimeError(f"{path}: {e}") from e
