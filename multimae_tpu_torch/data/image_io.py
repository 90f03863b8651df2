"""Image files to numpy arrays, without PIL (counterpart of the JAX
package's native helper, multimae_tpu/native/__init__.py + fastimage.cpp,
and of dataset_folder.pil_loader).

* PNG: the standard library's zlib inflates, the port's native library
  (native/fastimage.cpp `mm_png_decode`) undoes the row filters and
  expands the samples: 8-bit gray, gray + alpha, RGB and RGBA, 16-bit
  gray (depth maps), palette images (semantic segmentation maps; 1, 2, 4
  or 8 bits), every row filter of the PNG standard. Interlaced files
  raise. `read_png_twin` is the same reader in numpy, for tests and A/B
  runs; no loader path takes it. `write_png` writes the same kinds with
  filter 0, or choosing each row's filter as PIL and libpng do, so tests
  and scripts make their trees without PIL.
* JPEG: the port's own decoder in its native library
  (native/jpeg_decode.cpp, no libjpeg): baseline, extended and progressive
  Huffman-coded files, gray, YCbCr, RGB, CMYK and YCCK, bit-equal to PIL's
  convert("RGB"). Damaged and unsupported files (arithmetic coding,
  lossless, hierarchical, 12-bit, unrefined progressive coefficients)
  raise ValueError naming what was met. Where the library cannot be built
  (no g++), decoding raises RuntimeError with g++'s message and the file's
  name; it never skips the file.

`load_image(path, convert_rgb)` returns what PIL's loader gives the
pipeline: (H, W, 3) uint8 for convert_rgb (palette and gray expanded,
alpha dropped), else the raw representation: palette indices (H, W) uint8,
gray (H, W) uint8 or uint16, RGB (H, W, 3) uint8, alpha dropped.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Optional

import numpy as np

from multimae_tpu_torch import native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# PNG colour types -> samples per pixel, and the bit depths the standard allows
_CHANNELS = native.PNG_CHANNELS
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
        if interlace:
            raise ValueError("interlaced PNG files are not supported")
        if self.depth not in _DEPTHS.get(self.color_type, ()):
            raise ValueError(f"unsupported PNG colour type {self.color_type} at bit depth "
                             f"{self.depth}")
        if self.color_type == 3 and palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        self.palette = palette
        self.raw = zlib.decompress(b"".join(idat))

    def decode(self, mode: str) -> np.ndarray:
        return native.png_decode(self.raw, self.width, self.height, self.depth,
                                 self.color_type, self.palette, mode)


def read_png(data: bytes) -> PngImage:
    """Decode PNG bytes: every sample (alpha included)."""
    f = _PngFile(data)
    return PngImage(f.decode("samples"), f.color_type, f.palette)


def decode_png(data: bytes, convert_rgb: bool) -> np.ndarray:
    """PNG bytes -> what `load_image` returns for them."""
    return _PngFile(data).decode("rgb" if convert_rgb else "raw")


def read_png_twin(data: bytes) -> PngImage:
    """`read_png` in numpy (the rows unfiltered in a Python loop where a
    filter needs the byte before)."""
    f = _PngFile(data)
    width, height, depth, color_type = f.width, f.height, f.depth, f.color_type
    channels = _CHANNELS[color_type]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    rows = _unfilter_twin(f.raw, height, stride, max(1, bits // 8))
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
    if channels == 1:
        pixels = pixels[:, :, 0]
    return PngImage(np.ascontiguousarray(pixels), color_type, f.palette)


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
    """(H, W, 3) uint8, as PIL's convert("RGB") gives it."""
    px = img.pixels
    if img.color_type == 3:
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(img.palette)] = img.palette[:256]
        return palette[px]
    if px.dtype != np.uint8:
        raise ValueError("16-bit PNG files have no RGB form here")
    if img.color_type in (0, 4):
        gray = px if img.color_type == 0 else px[:, :, 0]
        return np.repeat(gray[:, :, None], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def png_raw(img: PngImage) -> np.ndarray:
    """Palette indices, gray or RGB samples, with alpha dropped."""
    if img.color_type == 4:
        return np.ascontiguousarray(img.pixels[:, :, 0])
    if img.color_type == 6:
        return np.ascontiguousarray(img.pixels[:, :, :3])
    return img.pixels


def load_image(path: str, convert_rgb: bool = True, twin: bool = False) -> np.ndarray:
    """Decode one image file (see the module docstring for what comes back);
    `twin` reads a PNG with `read_png_twin`."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data[:8] == PNG_SIGNATURE:
            if not twin:
                return decode_png(data, convert_rgb)
            img = read_png_twin(data)
            return png_to_rgb(img) if convert_rgb else png_raw(img)
        if data[:3] == b"\xff\xd8\xff":
            return native.decode_jpeg(data)
    except (ValueError, struct.error, zlib.error) as e:  # a damaged file
        raise ValueError(f"{path}: {e}") from e
    except RuntimeError as e:  # the native library did not build: not the file's fault
        raise RuntimeError(f"{path}: {e}") from e
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
