"""Image files to numpy arrays, without PIL (counterpart of the JAX
package's native helper, multimae_tpu/native/__init__.py + fastimage.cpp,
and of dataset_folder.pil_loader).

* PNG: a reader in numpy and the standard library's zlib: 8-bit gray,
  gray + alpha, RGB and RGBA, 16-bit gray (depth maps), palette images
  (semantic segmentation maps; 1, 2, 4 or 8 bits), every row filter of
  the PNG standard. Interlaced files raise. `write_png` writes the same
  kinds with filter 0, so tests and scripts make their trees without PIL.
* JPEG: libjpeg through the port's own copy of the JAX helper's decoder
  (multimae_tpu_torch/native/jpeg_decode.cpp), built with g++ at first use
  into build/native/ in the repository. Where that cannot be built (no
  g++, no libjpeg), decoding a .jpg raises an error that names the file
  and what is missing; it never skips the file.

`load_image(path, convert_rgb)` returns what PIL's loader gives the
pipeline: (H, W, 3) uint8 for convert_rgb (palette and gray expanded,
alpha dropped), else the raw representation: palette indices (H, W) uint8,
gray (H, W) uint8 or uint16, RGB (H, W, 3) uint8, alpha dropped.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import zlib
from pathlib import Path
from typing import Optional

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SOURCE = Path(__file__).resolve().parent.parent / "native" / "jpeg_decode.cpp"
NATIVE_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"

# PNG colour types -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PngImage:
    """A decoded PNG: `pixels` (H, W) or (H, W, C), uint8 or uint16, and
    the colour type's `palette` ((n, 3) uint8, palette images only)."""

    def __init__(self, pixels: np.ndarray, color_type: int, palette: Optional[np.ndarray]):
        self.pixels = pixels
        self.color_type = color_type
        self.palette = palette


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
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


def read_png(data: bytes) -> PngImage:
    """Decode PNG bytes."""
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
    width, height, depth, color_type, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG files are not supported")
    if color_type not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"unsupported PNG colour type {color_type} at bit depth {depth}")
    if color_type == 3 and palette is None:
        raise ValueError("palette PNG without a PLTE chunk")
    channels = _CHANNELS[color_type]
    bits = channels * depth
    stride = (width * bits + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride, max(1, bits // 8))
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
    return PngImage(np.ascontiguousarray(pixels), color_type, palette)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, pixels: np.ndarray, palette: Optional[np.ndarray] = None) -> None:
    """Write (H, W) uint8 or uint16 gray, (H, W, 3) RGB or (H, W, 4) RGBA
    uint8, or (H, W) uint8 palette indices with `palette` ((n, 3) uint8),
    every row with filter 0."""
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
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()
    out = [PNG_SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color_type, 0, 0, 0))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).reshape(-1, 3).tobytes()))
    out += [_chunk(b"IDAT", zlib.compress(raw, 6)), _chunk(b"IEND", b"")]
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(out))
    os.replace(tmp, path)


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


# --- JPEG through libjpeg ------------------------------------------------------

_JPEG_LIB = None
_JPEG_ERROR: Optional[str] = None


def _jpeg_lib():
    """The ctypes-bound decoder, built at first use; raises with the reason
    where it cannot be built or loaded."""
    global _JPEG_LIB, _JPEG_ERROR
    if _JPEG_LIB is not None:
        return _JPEG_LIB
    if _JPEG_ERROR is None:
        src = JPEG_SOURCE.read_bytes()
        out_dir = NATIVE_BUILD_ROOT / hashlib.sha256(src).hexdigest()[:16]
        lib_path = out_dir / "libmm_jpeg.so"
        try:
            if not lib_path.exists():
                out_dir.mkdir(parents=True, exist_ok=True)
                tmp = out_dir / f"lib.{os.getpid()}.so"
                cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(JPEG_SOURCE),
                       "-o", str(tmp), "-ljpeg"]
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
                if proc.returncode != 0:
                    raise OSError(f"{' '.join(cmd)} failed: {proc.stderr.strip()[-400:]}")
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
        except (OSError, subprocess.SubprocessError) as e:
            _JPEG_ERROR = (f"the JPEG decoder needs g++ and libjpeg (its headers and "
                           f"library), and could not be built: {e}")
        else:
            lib.mm_decode_jpeg.restype = ctypes.c_int
            lib.mm_decode_jpeg.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            _JPEG_LIB = lib
            return lib
    raise RuntimeError(_JPEG_ERROR)


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB (libjpeg, islow DCT)."""
    lib = _jpeg_lib()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.mm_decode_jpeg(data, len(data), None, 0, ctypes.byref(h), ctypes.byref(w))
    if rc == -3:
        out = np.empty((h.value, w.value, 3), np.uint8)
        rc = lib.mm_decode_jpeg(data, len(data), out.ctypes.data, out.nbytes,
                                ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(f"JPEG decode failed (libjpeg code {rc})")
    return out


def load_image(path: str, convert_rgb: bool = True) -> np.ndarray:
    """Decode one image file (see the module docstring for what comes back)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if data[:8] == PNG_SIGNATURE:
            img = read_png(data)
            return png_to_rgb(img) if convert_rgb else png_raw(img)
        if data[:3] == b"\xff\xd8\xff":
            return decode_jpeg(data)
    except (ValueError, struct.error, zlib.error) as e:  # a damaged file
        raise ValueError(f"{path}: {e}") from e
    except RuntimeError as e:  # no decoder on this machine: not the file's fault
        raise RuntimeError(f"{path}: {e}") from e
    raise ValueError(f"{path}: neither a PNG nor a JPEG file")
