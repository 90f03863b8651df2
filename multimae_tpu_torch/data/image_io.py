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
* TIFF (Pillow's TiffImagePlugin, `read_tiff`): the first image of a
  classic or BigTIFF file, in strips or tiles, chunky or planar, mode and
  raw mode from a copy of Pillow's OPEN_INFO: 1-bit (MinIsBlack,
  MinIsWhite, FillOrder 2), 2-, 4- and 8-bit gray, 16-bit gray in either
  byte order and signed, 32-bit int and float, palettes of 1-8 bits, gray
  + alpha, 8- and 16-bit RGB with ExtraSamples 0, 1 (alpha divided out as
  Pillow does) and 2, CMYK; its Orientation applied as PIL's load applies
  it. Uncompressed files as Pillow's raw decoder reads them; LZW (and the
  old bit-reversed LZW), Deflate and PackBits as libtiff 4.7 decodes them
  for Pillow (native `tiff_lzw` and `tiff_packbits` in tiff_decode.cpp,
  numpy twins `lzw_twin` and `packbits_twin`; Deflate through zlib), with
  the horizontal and floating-point predictors. JPEG-compressed TIFF
  (item 11g) as libtiff and libjpeg give it to Pillow: new-style JPEG
  (compression 7) strip by strip or tile by tile through the native
  decoder's JPEG-in-TIFF entry (`native.decode_jpeg_tiff`: JPEGTables
  first, YCbCr to RGB forced or no colour transform, libtiff's checks);
  old-style JPEG (compression 6) as one stream rebuilt as libtiff's codec
  rebuilds it, its planes unupsampled (tiles past a frame one column of
  tiles tall repeating its last MCU row, as libtiff's raw reads do);
  compressed YCbCr through libtiff's RGBA reader in numpy (data units,
  chroma repeated, TIFFYCbCrtoRGB with YCbCrCoefficients and
  ReferenceBlackWhite, its 4 x 4 quirks). The last codecs (item 11h) as
  libtiff 4.7.1 decodes them for Pillow: CCITT RLE, Group 3 (1-D and 2-D,
  fill bits), Group 4 and RLEW through libtiff's tif_fax3.c state machine,
  its bad code words decoded as libtiff decodes them (native
  `ccitt_decode`, twin `ccitt_twin`); LZMA through the standard library's
  lzma; ZSTD through the port's RFC 8878 decoder (`native.zstd_decode`);
  ThunderScan (`native.tiff_thunderscan`, twin `thunderscan_twin`); the
  predictor after LZMA and ZSTD too. CIELab in mode "LAB", its
  convert("RGB") LittleCMS 2.17's resampled transform (`native.lab_to_rgb`,
  twin `lab_to_rgb_twin`); a planar "P" file with an extra sample as
  Pillow's "PX" unpacker reads its first plane's tiles.
  `write_tiff` writes uncompressed, PackBits and Deflate files for tests
  and trees.
* WebP (Pillow's WebPImagePlugin over libwebp's WebPAnimDecoder,
  `read_webp`): simple and extended files, VP8 lossy (4:2:0 with libwebp's
  fancy upsampling and fixed-point YUV to RGB) and VP8L lossless frames,
  ALPH alpha (raw or VP8L-coded, each filter), ICC, EXIF and XMP chunks
  skipped, and an animation's first frame on its zeroed canvas, in PIL's
  mode "RGB" or "RGBA", all in the native decoder (native/webp_decode.cpp);
  `webp_colour_twin` and `alpha_unfilter_twin` are its colour and alpha
  stages in numpy, which `read_webp(twin=True)` takes.
* JPEG 2000 (Pillow's Jpeg2KImagePlugin over OpenJPEG 2.5, `read_jpeg2000`):
  a JP2 file (signature, ftyp, jp2h with ihdr, colr, pclr, cmap, cdef and
  res, then jp2c) or a raw J2K codestream, in the mode Pillow's plugin
  gives it ("L", "LA", "RGB", "RGBA", "I;16", "P" from a pclr palette,
  "PA" or "CMYK"); the codestream in the native decoder
  (native/jpeg2000_decode.cpp, no OpenJPEG): the markers of Part 1, all
  five progression orders with POC, PPM and PPT, SOP and EPH, the six
  code-block style switches, ROI maxshift, reversible 5/3 and irreversible
  9/7 in OpenJPEG's single-precision lifting, RCT and ICT, the DC level
  shift with OpenJPEG's rounding, and Pillow's unpackers (precision other
  than 8 or 16 bits, signed and sub-sampled components, sYCC to RGB).
  `jpeg2000_idwt_twin` and `jpeg2000_colour_twin` are its wavelet and
  colour stages in numpy, which `read_jpeg2000(twin=True)` takes.

Files PIL reads and the port cannot (JPEG 2000 high-throughput code-blocks
and Part 2 colour transforms, item 11f-b; Pillow's own netpbm variants and
old-style JPEG TIFF in separate planes, which no item ports) raise
`UnsupportedImage`, which is neither a ValueError nor an OSError: the corrupt-file retries of the
datasets and the loader let it through, so a tree that holds one stops the
run naming the file instead of training on other samples than the JAX
package would. A damaged file, and one PIL refuses (SGILog and
WebP-in-TIFF among them), raises ValueError, which the retries catch, as
the JAX package's catch PIL's errors.

`load_image(path, convert_rgb)` returns what PIL's loader gives the
pipeline: (H, W, 3) uint8 for convert_rgb (palette and gray expanded,
alpha dropped, 16-bit gray clipped to 255 as PIL's convert("RGB") clips
it), else the raw representation in the mode PIL opens the file in:
palette indices (H, W) uint8 ("P", "PA"), gray (H, W) uint8 ("L", "LA",
and "1" as 0 or 255), uint16 ("I;16", and "I;16B" in native byte order),
int32 ("I"), float32 ("F"), RGB (H, W, 3) uint8, alpha dropped, or CMYK
(H, W, 4) uint8.
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


# Formats PIL reads that the port does not, told by their first bytes:
# (signature test, name, ROADMAP item). None is left; the files the port
# cannot read inside a format it reads raise UnsupportedImage from its reader.
UNPORTED_FORMATS = ()


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
    """A decoded BMP, netpbm, TIFF or WebP image in the mode PIL opens it in: "P"
    (indices, with `palette` (n, 3) uint8) and "PA" (indices, alpha), "1"
    and "L" (uint8; "1" as 0 or 255), "LA", "I;16" (uint16, "I;16B" in
    native order), "I" (int32), "F" (float32), "RGB", "RGBA" or "CMYK"
    ((H, W, 3 or 4) uint8)."""

    def __init__(self, mode: str, pixels: np.ndarray, palette: Optional[np.ndarray] = None,
                 twin: bool = False):
        self.mode, self.pixels, self.palette, self.twin = mode, pixels, palette, twin

    def rgb(self) -> np.ndarray:
        """PIL's convert("RGB"): a palette's missing entries are black, "I"
        and "I;16" clip to 0-255, "F" clips and truncates, CMYK goes through
        Pillow's cmyk2rgb, "LAB" through LittleCMS's transform
        (`native.lab_to_rgb`, or `lab_to_rgb_twin` for a twin read), alpha is
        dropped."""
        px = self.pixels
        if self.mode == "LAB":  # numpy's view of "LAB" flips a and b against Pillow's storage
            stored = px ^ np.array([0, 128, 128], np.uint8)
            return (lab_to_rgb_twin if self.twin else native.lab_to_rgb)(stored)
        if self.mode in ("P", "PA"):
            palette = np.zeros((256, 3), np.uint8)
            palette[:len(self.palette)] = self.palette[:256]
            return palette[px if px.ndim == 2 else px[:, :, 0]]
        if self.mode in ("I", "I;16"):
            px = np.clip(px, 0, 255).astype(np.uint8)
        elif self.mode == "F":
            with np.errstate(invalid="ignore"):
                px = np.where(px >= 255, 255, np.where(px > 0, px, 0)).astype(np.uint8)
        elif self.mode == "LA":
            px = px[:, :, 0]
        elif self.mode == "CMYK":  # cmyk2rgb: nk - MULDIV255(c, nk), per channel
            nk = 255 - px[:, :, 3:].astype(np.int32)
            t = px[:, :, :3].astype(np.int32) * nk + 128
            return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
        if px.ndim == 2:
            return np.repeat(px[:, :, None], 3, axis=2)
        return np.ascontiguousarray(px[:, :, :3])

    def raw(self) -> np.ndarray:
        """The samples with alpha dropped ("LA" and "PA" their first band,
        RGBA its RGB); CMYK keeps its four."""
        px = self.pixels
        if self.mode in ("LA", "PA"):
            return np.ascontiguousarray(px[:, :, 0])
        if px.ndim == 3 and self.mode != "CMYK":
            return np.ascontiguousarray(px[:, :, :3])
        return px


# --- CIELab to RGB: PIL's convert("RGB") through LittleCMS 2.17 ---------------------
# (native/cielab.cpp says how lcms2 builds and evaluates the transform; this is
# the same table and interpolation in Python and numpy, with libm's pow for the
# sRGB curve and no numpy transcendental function, whose SIMD paths differ by
# CPU.)

_LAB_GRID = 33
_LAB_TABLE: Optional[np.ndarray] = None


def _lcms_floor(val: float) -> int:
    """_cmsQuickFloor: the low word of val + 1.5 * 2^36, upper half."""
    low = struct.unpack("<q", struct.pack("<d", val + 103079215104.0))[0] & 0xFFFFFFFF
    return (low - (1 << 32) if low >> 31 else low) >> 16


def _lcms_word(d: float) -> int:
    """_cmsQuickSaturateWord."""
    d += 0.5
    if d <= 0:
        return 0
    if d >= 65535.0:
        return 0xFFFF
    return _lcms_floor(d - 32767.0) + 32767


def _mat_inverse(a):
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mat_product(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)]
            for i in range(3)]


def _mat_apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def lab_table() -> np.ndarray:
    """lcms2's resampled transform: (33, 33, 33, 3) 16-bit RGB at the Lab
    nodes (cielab.cpp's Table), computed once."""
    global _LAB_TABLE
    if _LAB_TABLE is not None:
        return _LAB_TABLE
    import math

    f32 = lambda x: float(np.float32(x))  # noqa: E731  a float stage's rounding
    d50 = (0.9642, 1.0, 0.8249)
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.6400, 0.3300), (0.3000, 0.6000), (0.1500, 0.0600)
    res = _mat_inverse([[xr, xg, xb], [yr, yg, yb], [(1 - xr - yr), (1 - xg - yg), (1 - xb - yb)]])
    coef = _mat_apply(res, [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    rgb_xyz = [[coef[0] * xr, coef[1] * xg, coef[2] * xb],
               [coef[0] * yr, coef[1] * yg, coef[2] * yb],
               [coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)]]
    chad = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367], [0.0389, -0.0685, 1.0296]]
    src, dst = _mat_apply(chad, [(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0]), \
        _mat_apply(chad, list(d50))
    cone = [[dst[0] / src[0], 0.0, 0.0], [0.0, dst[1] / src[1], 0.0], [0.0, 0.0, dst[2] / src[2]]]
    adapted = _mat_product(_mat_product(_mat_inverse(chad), _mat_product(cone, chad)), rgb_xyz)
    adj = 1.0 + 32767.0 / 32768.0
    inv = [[x * adj for x in row] for row in _mat_inverse(adapted)]
    p = (2.4, 1. / 1.055, 0.055 / 1.055, 1. / 12.92, 0.04045)
    disc = math.pow(p[1] * p[4] + p[2], p[0])

    def f_1(t):
        return (108.0 / 841.0) * (t - (16.0 / 116.0)) if t <= (24.0 / 116.0) else t * t * t

    axis = [f32(_lcms_word(v * 65535. / (_LAB_GRID - 1)) / 65535.0) for v in range(_LAB_GRID)]
    table = np.empty((_LAB_GRID,) * 3 + (3,), np.int64)
    for i, fl in enumerate(axis):
        y = (fl * 100.0 + 16.0) / 116.0
        for j, fa in enumerate(axis):
            x = y + 0.002 * (fa * 255.0 - 128.0)
            for k, fb in enumerate(axis):
                z = y - 0.005 * (fb * 255.0 - 128.0)
                xyz = (f32(f_1(x) * d50[0] / adj), f32(f_1(y) * d50[1] / adj),
                       f32(f_1(z) * d50[2] / adj))
                for r in range(3):
                    acc = 0.0
                    for c in range(3):
                        acc += xyz[c] * inv[r][c]
                    v = f32(acc)
                    v = (math.pow(v, 1.0 / p[0]) - p[2]) / p[1] if v >= disc else v / p[3]
                    table[i, j, k, r] = _lcms_word(f32(v) * 65535.0)
    _LAB_TABLE = table
    return table


def lab_to_rgb_twin(lab: np.ndarray) -> np.ndarray:
    """`native.lab_to_rgb` in numpy: TetrahedralInterp16 of `lab_table`,
    then FROM_16_TO_8."""
    lab = np.asarray(lab)
    if lab.dtype != np.uint8 or lab.shape[-1:] != (3,):
        raise ValueError(f"LAB pixels must be (..., 3) uint8, not {lab.dtype} {lab.shape}")
    n = _LAB_GRID
    table = lab_table().reshape(-1)
    v = np.arange(256, dtype=np.int64)
    a = v * 257 * (n - 1)
    fx = a + (a + 0x7FFF) // 0xFFFF  # _cmsToFixedDomain
    x0, rest = fx >> 16, fx & 0xFFFF
    flat = lab.reshape(-1, 3)
    out = np.empty(flat.shape, np.uint8)
    for s in range(0, len(flat), 1 << 20):
        px = flat[s:s + (1 << 20)].astype(np.int64)
        L, A, B = px[:, 0], px[:, 1], px[:, 2]
        rx, ry, rz = rest[L], rest[A], rest[B]
        x1 = np.where(L == 255, 0, 3 * n * n)
        y1 = np.where(A == 255, 0, 3 * n)
        z1 = np.where(B == 255, 0, 3)
        base = x0[L] * 3 * n * n + x0[A] * 3 * n + x0[B] * 3
        # the tetrahedron of (rx, ry, rz): which corners, in lcms2's test order
        cases = [(rx >= ry) & (ry >= rz), (rx >= ry) & (ry < rz) & (rz >= rx),
                 (rx >= ry) & (ry < rz) & (rz < rx), (rx < ry) & (rx >= rz),
                 (rx < ry) & (rx < rz) & (ry >= rz)]
        for ch in range(3):
            t = lambda off: table[base + ch + off]  # noqa: E731
            c0 = t(0)
            cx, cy, cz = t(x1), t(y1), t(z1)
            cxy, cxz, cyz, cxyz = t(x1 + y1), t(x1 + z1), t(y1 + z1), t(x1 + y1 + z1)
            c1 = np.select(cases, [cx - c0, cxz - cz, cx - c0, cxy - cy, cxyz - cyz], cxyz - cyz)
            c2 = np.select(cases, [cxy - cx, cxyz - cxz, cxyz - cxz, cy - c0, cy - c0], cyz - cz)
            c3 = np.select(cases, [cxyz - cxy, cz - c0, cxz - cx, cxyz - cxy, cyz - cy], cz - c0)
            r = c1 * rx + c2 * ry + c3 * rz + 0x8001
            o = (c0 + ((r + (r >> 16)) >> 16)) & 0xFFFF
            out[s:s + len(px), ch] = (o * 65281 + 8388608) >> 24
    return out.reshape(lab.shape)


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


# --- TIFF (Pillow's TiffImagePlugin: its raw decoder for uncompressed files,
# libtiff 4.7 for the compressed ones) -----------------------------------------------

# Headers PIL accepts (TiffImagePlugin.PREFIXES): classic, BigTIFF, and two with
# the version word in the other byte order.
TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                 b"II\x2b\x00")
# Pillow's COMPRESSION_INFO: the codes PIL knows.
TIFF_COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
                     6: "tiff_jpeg", 7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                     32773: "packbits", 32809: "tiff_thunderscan", 32946: "tiff_deflate",
                     34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                     50001: "webp"}
# libtiff's CCITT codecs (tif_fax3.c) by compression.
_CCITT = {2: "rle", 3: "g3", 4: "g4", 32771: "rlew"}
# The codecs that take libtiff's Predictor tag: LZW, Deflate, LZMA and ZSTD.
_PREDICTED = (5, 8, 32946, 34925, 50000)
# The ones PIL 12.1 opens and fails to decode: SGILog and SGILog24 are read
# only under the LogL and LogLuv photometrics, which its OPEN_INFO lacks
# (libtiff's LogLuvSetupDecode refuses every other), and the wheel's libtiff
# has no WebP codec.
TIFF_PIL_REFUSED = {34676: "libtiff's SGILog codec decodes only LogL and LogLuv images",
                    34677: "libtiff's SGILog codec decodes only LogL and LogLuv images",
                    50001: "Pillow's libtiff has no WebP codec"}
# YCbCrSubsampling (tag 530) pairs libtiff's RGBA reader has a routine for
# (tif_getimage.c PickContigCase); a 4 x 4 data unit's right-hand skew
# advances 10 bytes a unit, not 18, as putcontig8bitYCbCr44tile does.
_YCBCR_PUTS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))


def _tiff_open_info():
    """The rows of Pillow 12.1's OPEN_INFO (TiffImagePlugin.py:151) the port
    decodes: (byte order, photometric, sample format, fill order, bits per
    sample, extra samples) -> (mode, raw mode). YCbCr's "RGBX" row is the
    raw decoder's for an uncompressed file; a compressed one comes out of
    libjpeg (compression 7) or libtiff's RGBA reader as RGB
    (`_TiffFile.setup`)."""
    both = [  # the same row for b"II" and b"MM"
        (0, 1, (1,), (), "1", "1;I"), (0, 2, (1,), (), "1", "1;IR"),
        (1, 1, (1,), (), "1", "1"), (1, 2, (1,), (), "1", "1;R"),
        (0, 1, (2,), (), "L", "L;2I"), (0, 2, (2,), (), "L", "L;2IR"),
        (1, 1, (2,), (), "L", "L;2"), (1, 2, (2,), (), "L", "L;2R"),
        (0, 1, (4,), (), "L", "L;4I"), (0, 2, (4,), (), "L", "L;4IR"),
        (1, 1, (4,), (), "L", "L;4"), (1, 2, (4,), (), "L", "L;4R"),
        (0, 1, (8,), (), "L", "L;I"), (0, 2, (8,), (), "L", "L;IR"),
        (1, 1, (8,), (), "L", "L"), (1, 2, (8,), (), "L", "L;R"),
        (1, 1, (8, 8), (2,), "LA", "LA"),
        (2, 1, (8, 8, 8), (), "RGB", "RGB"), (2, 2, (8, 8, 8), (), "RGB", "RGB;R"),
        (2, 1, (8, 8, 8, 8), (), "RGBA", "RGBA"), (2, 1, (8, 8, 8, 8), (0,), "RGB", "RGBX"),
        (2, 1, (8,) * 5, (0, 0), "RGB", "RGBXX"), (2, 1, (8,) * 6, (0, 0, 0), "RGB", "RGBXXX"),
        (2, 1, (8, 8, 8, 8), (1,), "RGBA", "RGBa"), (2, 1, (8,) * 5, (1, 0), "RGBA", "RGBaX"),
        (2, 1, (8,) * 6, (1, 0, 0), "RGBA", "RGBaXX"), (2, 1, (8, 8, 8, 8), (2,), "RGBA", "RGBA"),
        (2, 1, (8,) * 5, (2, 0), "RGBA", "RGBAX"), (2, 1, (8,) * 6, (2, 0, 0), "RGBA", "RGBAXX"),
        (2, 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA"),
        (3, 1, (1,), (), "P", "P;1"), (3, 2, (1,), (), "P", "P;1R"),
        (3, 1, (2,), (), "P", "P;2"), (3, 2, (2,), (), "P", "P;2R"),
        (3, 1, (4,), (), "P", "P;4"), (3, 2, (4,), (), "P", "P;4R"),
        (3, 1, (8,), (), "P", "P"), (3, 1, (8, 8), (0,), "P", "PX"),
        (3, 1, (8, 8), (2,), "PA", "PA"), (3, 2, (8,), (), "P", "P;R"),
        (5, 1, (8, 8, 8, 8), (), "CMYK", "CMYK"), (5, 1, (8,) * 5, (0,), "CMYK", "CMYKX"),
        (5, 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX"),
    ]
    table = {}
    for photo, fill, bits, extra, mode, raw in both:
        for order in (b"II", b"MM"):
            table[(order, photo, (1,), fill, bits, extra)] = (mode, raw)
    for order in (b"II", b"MM"):
        table[(order, 1, (2,), 1, (8,), ())] = ("L", "L")
        # YCbCr: uncompressed, PIL's raw decoder reads it as these raw modes
        table[(order, 6, (1,), 1, (8,), ())] = ("L", "L")
        table[(order, 6, (1,), 1, (8, 8, 8), ())] = ("RGB", "RGBX")
    big_little = [  # rows whose raw mode follows the byte order: (II raw mode, MM raw mode)
        (1, (2,), (16,), (), "I", ("I;16S", "I;16BS")),
        (0, (3,), (32,), (), "F", ("F;32F", "F;32BF")),
        (1, (2,), (32,), (), "I", ("I;32S", "I;32BS")),
        (1, (3,), (32,), (), "F", ("F;32F", "F;32BF")),
        (2, (1,), (16, 16, 16), (), "RGB", ("RGB;16L", "RGB;16B")),
        (2, (1,), (16,) * 4, (), "RGBA", ("RGBA;16L", "RGBA;16B")),
        (2, (1,), (16,) * 4, (0,), "RGB", ("RGBX;16L", "RGBX;16B")),
        (2, (1,), (16,) * 4, (1,), "RGBA", ("RGBa;16L", "RGBa;16B")),
        (2, (1,), (16,) * 4, (2,), "RGBA", ("RGBA;16L", "RGBA;16B")),
        (5, (1,), (16,) * 4, (), "CMYK", ("CMYK;16L", "CMYK;16B")),
    ]
    for photo, fmt, bits, extra, mode, raws in big_little:
        for order, raw in zip((b"II", b"MM"), raws):
            table[(order, photo, fmt, 1, bits, extra)] = (mode, raw)
    table[(b"II", 1, (1,), 1, (12,), ())] = ("I;16", "I;12")
    table[(b"II", 0, (1,), 1, (16,), ())] = ("I;16", "I;16")
    table[(b"II", 1, (1,), 1, (16,), ())] = ("I;16", "I;16")
    table[(b"MM", 1, (1,), 1, (16,), ())] = ("I;16B", "I;16B")
    table[(b"II", 1, (1,), 2, (16,), ())] = ("I;16", "I;16R")
    table[(b"II", 1, (1,), 1, (32,), ())] = ("I", "I;32N")
    for order in (b"II", b"MM"):  # CIELab: L, then a and b as stored
        table[(order, 8, (1,), 1, (8, 8, 8), ())] = ("LAB", "LAB")
    return table


TIFF_OPEN_INFO = _tiff_open_info()
_TIFF_MAX_SAMPLES = max(len(k[4]) for k in TIFF_OPEN_INFO)
# Raw modes of TIFF_OPEN_INFO that Pillow has no unpacker for: PIL refuses such
# an uncompressed file (a compressed one reads under the fill order 1 row).
_PIL_LACKS = ("L;IR", "P;1R", "P;2R", "P;4R")
_REVERSE_BITS = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)
# Tag types PIL loads as numbers: type -> (struct code, size).
_TIFF_TYPES = {3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2), 9: ("i", 4),
               13: ("I", 4), 16: ("Q", 8)}
# Types PIL loads as something else: BYTE as a bytes object, which no tag here
# takes; the rest unused.
_TIFF_SKIPPED_TYPES = {1: 1, 2: 1, 5: 8, 7: 1, 10: 8, 11: 4, 12: 8}
# The tags the reader takes from a directory, which libtiff checks too.
_LIBTIFF_TAGS = (256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320, 322, 323,
                 324, 325, 338, 339)
# PIL's Image.transpose after exif_transpose's table, by Orientation.
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1),
           7: lambda a: a[::-1, ::-1].swapaxes(0, 1), 8: lambda a: np.rot90(a, 1)}
# Pillow's "mode" of an image -> the samples' numpy dtype and its bands.
_MODE_STORAGE = {"1": (np.uint8, 1), "L": (np.uint8, 1), "P": (np.uint8, 1), "LA": (np.uint8, 2),
                 "PA": (np.uint8, 2), "I;16": (np.uint16, 1), "I;16B": (np.uint16, 1),
                 "I": (np.int32, 1), "F": (np.float32, 1), "RGB": (np.uint8, 3),
                 "RGBA": (np.uint8, 4), "CMYK": (np.uint8, 4), "LAB": (np.uint8, 3)}
# Each band of a mode, by the letter PIL's one-band raw modes use.
_BAND = {"RGB": "RGB", "RGBA": "RGBA", "CMYK": "CMYK", "L": "L", "P": "P", "1": "1", "I": "I",
         "F": "F", "LAB": "LAB"}


def _raw_bits(rawmode: str) -> int:
    """Bits per pixel of a raw mode, as its Pillow unpacker reads them."""
    if rawmode.startswith(("1", "P;1")):
        return 1
    if rawmode.startswith(("L;2", "P;2")):
        return 2
    if rawmode.startswith(("L;4", "P;4")):
        return 4
    if rawmode == "I;12":
        return 12
    base, _, suffix = rawmode.partition(";")
    if suffix.startswith("16"):
        return 16 * (len(base) if base != "I" else 1)
    if suffix.startswith("32") or base in ("I", "F"):
        return 32
    return 8 * len(base)


def _tiff_unpack(rows: np.ndarray, width: int, rawmode: str) -> np.ndarray:
    """(h, bytes) rows -> (h, width[, bands]) samples in the image mode's
    storage, as Pillow's unpacker for `rawmode` gives them (Unpack.c)."""
    h = rows.shape[0]
    if rawmode in ("I", "F"):  # one plane of a planar file: native 32-bit samples
        return rows[:, :4 * width].copy().view("=i4" if rawmode == "I" else "=f4")
    if rawmode in ("L", "P", "PX", "LA", "PA") or rawmode in tuple("RGBACMYK"):
        step = {"PX": 2, "LA": 2, "PA": 2}.get(rawmode, 1)
        px = rows[:, :step * width].reshape(h, width, step)
        return px if rawmode in ("LA", "PA") else px[:, :, 0]
    base, _, suffix = rawmode.partition(";")
    if base in ("1", "L", "P") and "16" not in suffix:
        if "R" in suffix:
            rows = _REVERSE_BITS[rows]
        bits = _raw_bits(rawmode)
        if bits == 8:
            px = rows[:, :width]
        else:
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            px = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :width]
            if base != "P":
                px = px * np.uint8(255 // ((1 << bits) - 1))
        return ~px if "I" in suffix and base != "P" else np.ascontiguousarray(px)
    if rawmode == "I;12":
        need = (3 * width + 1) // 2
        b = np.zeros((h, need + 1), np.uint16)
        b[:, :need] = rows[:, :need]
        pairs = b[:, :3 * ((width + 1) // 2)].reshape(h, -1, 3)
        out = np.stack([(pairs[..., 0] << 4) | (pairs[..., 1] >> 4),
                        ((pairs[..., 1] & 15) << 8) | pairs[..., 2]], -1)
        return np.ascontiguousarray(out.reshape(h, -1)[:, :width])
    if base == "I" and suffix in ("16", "16N", "16B", "16R", "16S", "16BS"):
        if suffix == "16R":
            rows = _REVERSE_BITS[rows]
        order = ">" if "B" in suffix else "<" if suffix != "16N" else "="
        kind = "i2" if "S" in suffix else "u2"
        px = rows[:, :2 * width].copy().view(order + kind)
        return px.astype(np.int32 if "S" in suffix else np.uint16)
    if base in ("I", "F") and suffix.startswith("32"):
        order = ">" if "B" in suffix else "=" if suffix == "32N" else "<"
        kind = "f4" if base == "F" else "u4" if suffix == "32N" else "i4"
        px = rows[:, :4 * width].copy().view(order + kind)
        return px.astype(np.float32 if base == "F" else np.int32, casting="unsafe")
    # RGB, RGBA, CMYK and their extra and 16-bit forms: bands in file order.
    if "R" in suffix and "16" not in suffix:
        rows = _REVERSE_BITS[rows]
    size = 2 if suffix.startswith("16") else 1
    high = 0 if suffix.endswith("B") else 1 if size == 2 else 0
    px = rows[:, :size * len(base) * width].reshape(h, width, len(base), size)[..., high]
    keep = [i for i, c in enumerate(base) if c != "X"]
    px = px[:, :, keep] if len(base) > 1 else px[:, :, 0]
    if "a" in base:  # premultiplied alpha: Pillow divides it out in integers
        a = px[:, :, 3:4].astype(np.int32)
        rgb = np.minimum(px[:, :, :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 255, px[:, :, :3], np.where(a == 0, 0, rgb))
        px = np.concatenate([rgb, np.where(a == 0, 0, a)], -1).astype(np.uint8)
    return np.ascontiguousarray(px)


class _TiffFile:
    """The header and first image file directory of a TIFF, read as PIL
    reads them: the tags PIL keeps (numbers as tuples), the mode and raw
    mode its OPEN_INFO gives, and the strips or tiles."""

    def __init__(self, data: bytes):
        if data[:4] not in TIFF_PREFIXES:
            raise ValueError("not a TIFF file")
        self.data = data
        self.prefix = data[:2]
        self.order = "<" if self.prefix == b"II" else ">"
        big = data[2] == 43  # PIL's test: a big-endian BigTIFF reads as classic
        if len(data) < (16 if big else 8):
            raise ValueError("TIFF file truncated in its header")
        start = self._unpack("Q" if big else "I", 8 if big else 4)[0]
        self.tags, self.types = {}, {}
        # PIL stops at an entry cut short or a value past the end and keeps the
        # tags before it; libtiff refuses such a directory (`short`), and a
        # tag of its own in a type that holds no integers (`odd`).
        self.short, self.odd = True, set()
        entry, slot = (20, 8) if big else (12, 4)
        if start + (8 if big else 2) > len(data):
            return
        count = self._unpack("Q" if big else "H", start)[0]
        at = start + (8 if big else 2)
        for _ in range(count):
            if at + entry > len(data):
                return
            tag, typ = self._unpack("HH", at)
            n = self._unpack("Q" if big else "I", at + 4)[0]
            value_at = at + (12 if big else 8)
            at += entry
            if typ in _TIFF_TYPES:
                code, size = _TIFF_TYPES[typ]
            elif typ in _TIFF_SKIPPED_TYPES:
                code, size = None, _TIFF_SKIPPED_TYPES[typ]
                self.odd.add(tag)
            else:
                self.odd.add(tag)
                continue  # PIL skips a type it does not know
            if n * size > slot:
                value_at = self._unpack("Q" if big else "I", value_at)[0]
                if value_at + n * size > len(data):
                    return
            if n:
                self.tags[tag] = (self._unpack(code * n, value_at) if code
                                  else data[value_at:value_at + n * size])
                self.types[tag] = typ
            else:
                self.odd.add(tag)  # PIL drops an empty tag, libtiff refuses it
        self.short = False

    def _unpack(self, fmt: str, at: int):
        return struct.unpack_from(self.order + fmt, self.data, at)

    def values(self, tag: int, default=None) -> tuple:
        """The numbers of `tag` (ValueError where PIL's value is no number)."""
        value = self.tags.get(tag, default)
        if value is None:
            raise ValueError(f"TIFF tag {tag} is missing")
        if not isinstance(value, tuple):
            raise ValueError(f"TIFF tag {tag} holds no numbers, as PIL reads it")
        return value

    def floats(self, tag: int, default) -> np.ndarray:
        """A tag's values as libtiff reads a float array (RATIONAL as
        float(num) / float(den), 0 where den is 0), float32; `default`
        where it is missing or its count is not len(default)."""
        value, typ = self.tags.get(tag), self.types.get(tag)
        if isinstance(value, tuple):
            out = np.asarray(value, np.float64).astype(np.float32)
        elif typ in (5, 10):
            pairs = np.frombuffer(value, self.order + ("u4" if typ == 5 else "i4")).reshape(-1, 2)
            num, den = pairs[:, 0].astype(np.float32), pairs[:, 1].astype(np.float32)
            with np.errstate(divide="ignore", invalid="ignore"):
                out = np.where(den == 0, np.float32(0), num / np.where(den == 0, 1, den))
        elif typ in (11, 12):
            out = np.frombuffer(value, self.order + ("f4" if typ == 11 else "f8")).astype(
                np.float32)
        else:
            out = None
        if out is None or len(out) != len(default):
            return np.asarray(default, np.float32)
        return out.astype(np.float32)

    def scalar(self, tag: int, default=None):
        value = self.values(tag, None if default is None else (default,))
        if len(value) != 1:
            raise ValueError(f"TIFF tag {tag} holds {len(value)} values")
        return value[0]

    def setup(self):
        """TiffImageFile._setup: sets compression, photometric, fill order,
        planar, size, bits, extra samples, mode and raw mode. Raises
        ValueError where PIL raises and UnsupportedImage for a file PIL
        reads through libtiff that the port does not."""
        self.compression = self.scalar(259, 1)
        if self.compression not in TIFF_COMPRESSIONS:
            raise ValueError(f"unknown TIFF compression {self.compression}, as PIL refuses it")
        self.planar = self.scalar(284, 1)
        photo = self.scalar(262, 0)
        if self.compression == 6:
            photo = 6
        self.photometric = photo
        self.fill = self.scalar(266, 1)
        if 256 not in self.tags or 257 not in self.tags:
            raise ValueError("TIFF file without its dimensions")
        self.width, self.height = self.scalar(256), self.scalar(257)
        fmt = self.values(339, (1,))
        if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
            fmt = (1,)
        bits = self.values(258, (1,))
        self.extra = self.values(338, ())
        self.bands = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(self.extra)
        spp = self.scalar(277, 3 if self.compression == 6 and photo in (2, 6) else 1)
        if spp > _TIFF_MAX_SAMPLES:
            raise ValueError(f"TIFF of {spp} samples per pixel, as PIL refuses it")
        if spp < len(bits):
            bits = bits[:spp]
        elif spp > len(bits) == 1:
            bits = bits * spp
        if len(bits) != spp:
            raise ValueError("unknown TIFF data organization")
        self.bits, self.spp = bits, spp
        # Pillow's _decodeAsRGBA: compressed YCbCr goes through libtiff's RGBA
        # reader, but for new-style JPEG in one plane, where libjpeg converts.
        self.rgba = photo == 6 and self.compression not in (1, 7) or (
            photo == 6 and self.compression == 7 and self.planar != 1)
        key = (self.prefix, photo, fmt, self.fill, bits, self.extra)
        if key not in TIFF_OPEN_INFO:
            raise ValueError(f"unknown TIFF pixel mode {key[1:]}, as PIL refuses it")
        if self.compression in TIFF_PIL_REFUSED:
            raise ValueError(f"a TIFF with {TIFF_COMPRESSIONS[self.compression]} compression "
                             f"({self.compression}), which PIL refuses: "
                             f"{TIFF_PIL_REFUSED[self.compression]}")
        if self.compression in _CCITT and bits != (1,):
            raise ValueError(f"a {TIFF_COMPRESSIONS[self.compression]} TIFF of {bits}-bit "
                             "samples: libtiff's CCITT codecs take 1 bit")
        if self.compression == 32809 and bits[0] != 4:
            raise ValueError(f"a ThunderScan TIFF of {bits}-bit samples: libtiff's decoder "
                             "takes 4 bits")
        self.mode, self.rawmode = TIFF_OPEN_INFO[key]
        if self.compression != 1:  # libtiff's own fill order and native byte order
            if self.fill == 2:
                self.mode, self.rawmode = TIFF_OPEN_INFO[key[:3] + (1,) + key[4:]]
            if photo == 6 and self.compression == 7 and self.planar == 1:
                self.rawmode = "RGB"  # libjpeg's YCbCr to RGB (JPEGCOLORMODE_RGB)
            elif self.rawmode == "I;16":
                self.rawmode = "I;16N"
            elif self.rawmode.endswith((";16B", ";16L")):
                self.rawmode = self.rawmode[:-1] + "N"
        if self.mode in ("P", "PA"):
            if 320 not in self.tags:
                raise ValueError("palette TIFF without a ColorMap")
            cmap = np.asarray(self.values(320), np.int64) // 256
            n = len(cmap) // 3
            self.palette = cmap[:3 * n].reshape(3, n).T.astype(np.uint8)
        else:
            self.palette = None
        if 273 in self.tags:
            self.offsets = self.values(273)
            self.counts = self.values(279) if 279 in self.tags else None
            self.tiled = False
            self.chunk_w, self.chunk_h = self.width, self.scalar(278, self.height)
        elif 324 in self.tags:
            self.offsets = self.values(324)
            self.counts = self.values(325) if 325 in self.tags else None
            self.tiled = True
            if 322 not in self.tags or 323 not in self.tags:
                raise ValueError("TIFF tiles without their dimensions")
            self.chunk_w, self.chunk_h = self.scalar(322), self.scalar(323)
        else:
            raise ValueError("TIFF without strips or tiles")
        if self.width <= 0 or self.height <= 0 or self.width * self.height > 1 << 28:
            raise ValueError(f"a TIFF of {self.width} x {self.height} pixels")
        if self.chunk_w <= 0 or self.chunk_h <= 0:
            raise ValueError(f"TIFF strips or tiles of {self.chunk_w} x {self.chunk_h} pixels")

    def decode_raw(self) -> np.ndarray:
        """Pillow's raw decoder over each strip or tile (ImageFile.load with
        TiffImageFile._setup's tile list): rows from the offsets alone, one
        band per plane of a planar file under the raw mode's letter."""
        dtype, nb = _MODE_STORAGE[self.mode]
        W, H = self.width, self.height
        out = np.zeros((H, W) + ((nb,) if nb > 1 else ()), dtype)
        w, h = self.chunk_w, self.chunk_h
        offsets = self.offsets
        if self.rawmode in _PIL_LACKS and self.planar != 2:
            raise ValueError(f"an uncompressed TIFF in raw mode {self.rawmode}, which PIL "
                             "refuses")
        if w == W and h == H and self.planar != 2:
            offsets = offsets[-1:]  # one strip or tile covers the image: PIL reads the last
        x = y = layer = 0
        for offset in offsets:
            stride = w * sum(self.bits) / 8 if x + w > W else 0
            rawmode, band = self.rawmode, None
            if self.planar == 2:
                if layer >= len(self.rawmode):
                    raise ValueError("a planar TIFF with more planes than its mode has bands")
                rawmode = self.rawmode[layer]
                stride /= self.bands
                if rawmode not in _BAND.get(self.mode, ""):
                    raise ValueError(f"no raw mode {rawmode} for a planar {self.mode} TIFF, "
                                     "as PIL refuses it")
                band = _BAND[self.mode].index(rawmode) if nb > 1 else None
            x1, y1 = min(x + w, W), min(y + h, H)
            ew, eh = x1 - x, y1 - y
            row = (ew * _raw_bits(rawmode) + 7) // 8
            pitch = int(stride) or row
            if pitch < row:
                raise ValueError("TIFF tile rows shorter than their pixels")
            if offset + pitch * (eh - 1) + row > len(self.data):
                raise ValueError("TIFF file truncated in its pixels")
            view = np.frombuffer(self.data, np.uint8, count=len(self.data) - offset, offset=offset)
            rows = np.lib.stride_tricks.as_strided(view, (eh, row), (pitch, 1))
            px = _tiff_unpack(rows, ew, rawmode)
            if self.mode == "LAB" and band:  # Pillow's "A" and "B" band unpackers flip a, b
                px = px ^ np.uint8(128)
            if band is None:
                out[y:y1, x:x1] = px
            else:
                out[y:y1, x:x1, band] = px
            x += w
            if x >= W:
                x, y = 0, y + h
                if y >= H:
                    y, layer = 0, layer + 1
        return out

    def decode_libtiff(self, twin: bool) -> np.ndarray:
        """What libtiff hands Pillow's TiffDecode.c for a compressed file:
        each strip or tile decompressed (its bytes' bits reversed first
        under FillOrder 2), the predictor undone, samples in native order;
        Pillow unpacks the rows it needs, one plane after another."""
        if self.short:
            raise ValueError("TIFF directory cut short, which libtiff refuses")
        if self.odd & set(_LIBTIFF_TAGS):
            raise ValueError(f"TIFF tags {sorted(self.odd & set(_LIBTIFF_TAGS))} empty or in a "
                             "type that libtiff refuses")
        if self.palette is not None and len(self.tags[320]) != 3 << self.bits[0]:
            raise ValueError(f"a TIFF ColorMap of {len(self.tags[320])} entries for "
                             f"{self.bits[0]}-bit samples, which libtiff refuses")
        if (322 in self.tags or 323 in self.tags) != self.tiled:
            raise ValueError("TIFF tile dimensions beside strips, or tiles without them, which "
                             "libtiff refuses")
        for tag, allowed in ((266, (1, 2)), (284, (1, 2)), (338, (0, 1, 2)), (339, (1, 2, 3))):
            if not set(self.tags.get(tag, allowed[:1])) <= set(allowed):
                raise ValueError(f"TIFF tag {tag} holds {self.tags[tag]}, which libtiff refuses")
        if self.compression == 7:
            self._jpeg_setup()
            self._jpeg_buffer = None
        if self.rgba:
            return self.decode_rgba(twin)
        dtype, nb = _MODE_STORAGE[self.mode]
        W, H = self.width, self.height
        out = np.zeros((H, W) + ((nb,) if nb > 1 else ()), dtype)
        bps, spp = self.bits[0], self.spp
        h = self.chunk_h
        if not self.tiled and h != 0xFFFFFFFF and h * ((W * bps * spp + 7) // 8) > 0x7FFFFFFF:
            raise ValueError(f"TIFF strips of {h} rows, past Pillow's libtiff decoder's buffer")
        # A planar file: Pillow reads one plane per band of the mode, plane i
        # through its one-band unpacker R, G, B or A (a 16-bit sample's high
        # byte) into byte i of its 4-byte pixels, where LA and PA keep their
        # alpha in byte 3: it stays 0.
        bands = nb if self.planar == 2 else 1
        if self.planar == 2 and spp > bands:
            if not self.tiled:
                raise ValueError(f"a planar {self.mode} TIFF in strips with {spp - bands} extra "
                                 "samples, which Pillow's libtiff decoder refuses")
            if bands == 1:
                return self._one_band_planar(out, twin)
        rawmodes = ([c + (";16N" if bps == 16 else "") for c in "RGBA"[:bands]] if bands > 1
                    else [self.rawmode])
        for plane, y0, x0, chunk in self._segments(bands, twin):
            y1, x1 = min(y0 + len(chunk), H), min(x0 + self.chunk_w, W)
            px = _tiff_unpack(chunk[:y1 - y0], x1 - x0, rawmodes[plane])
            if bands == 1:
                out[y0:y1, x0:x1] = px
            elif not (nb == 2 and plane == 1):
                out[y0:y1, x0:x1, plane] = px ^ np.uint8(128 if self.mode == "LAB" and plane
                                                         else 0)
        if bands == 4 and self.mode == "RGBA" and self.extra[:1] != (2,):
            out = _tiff_unpack(out.reshape(H, -1), W, "RGBa")  # Pillow divides alpha out
        return out

    def _one_band_planar(self, out: np.ndarray, twin: bool) -> np.ndarray:
        """A planar "P" TIFF with an extra sample ("PX"), in tiles: Pillow
        reads the first plane's tiles alone, each row through the "PX"
        unpacker, 2 bytes a pixel, from where that row starts in the plane
        (a tile's width in bytes apart): a row's pixels come from every
        other byte of it and the rows below. Pixels whose bytes lie past the
        tile are whatever Pillow's heap holds there: ValueError."""
        W, H = self.width, self.height
        tw, step = self.chunk_w, _raw_bits(self.rawmode) // 8
        for _, y0, x0, chunk in self._segments(1, twin):
            buf = chunk.reshape(-1)
            rows, cw = min(len(chunk), H - y0), min(tw, W - x0)
            at = tw * np.arange(rows)[:, None] + step * np.arange(cw)
            if at.max() >= len(buf):
                raise ValueError(f"a planar {self.mode} TIFF of {self.spp} samples in {tw}-pixel "
                                 "tiles: Pillow's unpacker reads past the tile, where its "
                                 "buffer holds what the heap held")
            out[y0:y0 + rows, x0:x0 + cw] = buf[at]
        return out

    def _segments(self, planes: int, twin: bool):
        """Strip by strip or tile by tile, over the first `planes` planes:
        (plane, y0, x0, rows), `rows` the segment's (rows, scanline) bytes
        decompressed with the predictor undone, all of a tile's rows and a
        strip's inside the image."""
        W, H = self.width, self.height
        w, h = self.chunk_w, self.chunk_h
        if self.tiled:
            across, down = -(-W // w), -(-H // h)
        else:
            h = min(h, H)
            across, down = 1, -(-H // h)
        bps = self.bits[0]
        per_pixel = 1 if self.planar == 2 else self.spp
        scanline = (w * bps * per_pixel + 7) // 8
        total = across * down * (self.spp if self.planar == 2 else 1)
        if self.counts is None or min(len(self.offsets), len(self.counts)) < total:
            raise ValueError("TIFF strip or tile offsets or byte counts missing")
        predictor = self._predictor()
        for plane in range(planes):
            for ty in range(down):
                for tx in range(across):
                    rows = h if self.tiled else min(h, H - ty * h)
                    chunk = self._chunk((plane * down + ty) * across + tx, rows * scanline, twin,
                                        (rows, w, per_pixel))
                    yield plane, ty * h, tx * w, _tiff_predict(
                        chunk.reshape(rows, scanline), predictor, bps, per_pixel, self.order)

    def _chunk(self, index: int, size: int, twin: bool, segment=None) -> np.ndarray:
        """Strip or tile `index` decompressed to `size` bytes; a JPEG one
        decoded as the (rows, width, samples) `segment` it stands for."""
        offset, count = self.offsets[index], self.counts[index]
        if count <= 0 or offset + count > len(self.data):
            raise ValueError(f"TIFF strip or tile {index} of {count} bytes at {offset} lies "
                             "outside the file")
        raw = self.data[offset:offset + count]
        if self.compression == 7:  # libtiff's JPEG codec reverses no bits
            return self._jpeg_chunk(index, raw, segment)
        if self.fill == 2:
            raw = _REVERSE_BITS[np.frombuffer(raw, np.uint8)].tobytes()
        if self.compression in _CCITT:
            return self._ccitt_chunk(index, raw, offset, segment, twin)
        if self.compression == 5:
            out = lzw_twin(raw, size) if twin else native.tiff_lzw(raw, size)
        elif self.compression == 32773:
            out = packbits_twin(raw, size) if twin else native.tiff_packbits(raw, size)
        elif self.compression == 50000:
            out = native.zstd_decode(raw, size)
        elif self.compression == 32809:  # rows of the image's width, as libtiff decodes them
            line = (self.width * 4 + 7) // 8
            out = (thunderscan_twin if twin else native.tiff_thunderscan)(raw, size, line,
                                                                          self.width)
        elif self.compression == 34925:
            out = _lzma_strip(raw, size)
        else:  # 8, 32946: Deflate
            d = zlib.decompressobj()
            try:
                out = d.decompress(raw, size)
            except zlib.error as e:
                raise ValueError(f"TIFF Deflate data: {e}") from e
            if len(out) < size:
                raise ValueError(f"TIFF Deflate data ends after {len(out)} of {size} bytes")
            out = np.frombuffer(out, np.uint8)
        return out

    def _ccitt_chunk(self, index: int, raw: bytes, offset: int, segment, twin: bool) -> np.ndarray:
        """A CCITT strip or tile as libtiff's tif_fax3.c decodes it (the
        rows of a bad code word as libtiff fills them). Raises ValueError
        where libtiff fails, where Group 4 data ends with rows undecoded
        (libtiff leaves Pillow's buffer there as it was) and on
        uncompressed-mode codes, which libtiff does not decode."""
        rows, w, _ = segment
        kind = _CCITT[self.compression]
        if kind == "g3" and self.scalar(292, 0) & 1:
            kind = "g3_2d"
        decode = ccitt_twin if twin else native.ccitt_decode
        strip = decode(raw, kind, w, (w + 7) // 8, rows, bool(offset & 1))
        what = f"TIFF {TIFF_COMPRESSIONS[self.compression]} strip or tile {index}"
        if strip.status == -1:
            raise ValueError(f"{what}: the data ends or overruns libtiff's run arrays in row "
                             f"{strip.lines} of {rows} (libtiff fails)")
        if strip.status == -2:
            raise ValueError(f"{what}: the Group 4 data ends after {strip.lines} of {rows} rows; "
                             "libtiff leaves the rest of Pillow's buffer as it was")
        if strip.extensions:
            raise ValueError(f"{what}: uncompressed mode, which libtiff does not decode")
        return strip.rows.reshape(-1)

    # --- JPEG (compression 7), libtiff's tif_jpeg.c ---------------------------------

    def _jpeg_setup(self):
        """JPEGSetupDecode and JPEGFixupTags: the JPEGTables, the colour
        handling and the sampling factors each stream must have. Without a
        YCbCrSubsampling tag, libtiff takes a YCbCr file's from the first
        stream's frame header where TIFF has an equivalent."""
        tables = self.tags.get(347)
        self.jpeg_tables = tables if isinstance(tables, bytes) and tables else None
        ycbcr = self.photometric == 6 and self.planar == 1
        self.jpeg_color = "rgb" if ycbcr else "none"
        self.subsampling = tuple(self.values(530, (2, 2))[:2]) if self.photometric == 6 else (1, 1)
        if ycbcr and self.spp == 3 and 530 not in self.tags:
            self.subsampling = self._jpeg_fixup_subsampling() or self.subsampling
        if self.photometric == 6 and any(v not in (1, 2, 4) for v in self.subsampling):
            raise ValueError(f"TIFF YCbCrSubsampling {self.subsampling}, which libtiff refuses")

    def _jpeg_fixup_subsampling(self):
        """tif_jpeg.c JPEGFixupTagsSubsamplingSec over the first strip or
        tile: its first frame header's sampling factors, or None where
        libtiff keeps the default (2, 2)."""
        if not self.offsets or not self.counts or self.offsets[0] >= len(self.data):
            return None
        d = self.data[self.offsets[0]:self.offsets[0] + self.counts[0]]
        pos = 0
        while True:
            while pos < len(d) and d[pos] != 0xFF:
                pos += 1
            while pos < len(d) and d[pos] == 0xFF:
                pos += 1
            if pos >= len(d):
                return None
            m = d[pos]
            pos += 1
            if m == 0xD8:
                continue
            if m in (0xFE, 0xDB, 0xDA, 0xC4, 0xDD) or 0xE0 <= m <= 0xEF:
                if pos + 2 > len(d) or struct.unpack_from(">H", d, pos)[0] < 2:
                    return None
                pos += struct.unpack_from(">H", d, pos)[0]
                continue
            if m not in (0xC0, 0xC1, 0xC2, 0xC9, 0xCA):
                return None
            if pos + 2 > len(d) or struct.unpack_from(">H", d, pos)[0] != 8 + 3 * self.spp:
                return None
            comps = d[pos + 8:pos + 8 + 3 * self.spp]
            if len(comps) < 3 * self.spp:
                return None
            if any(comps[3 * i + 1] != 0x11 for i in range(1, self.spp)):
                return None
            hv = (comps[1] >> 4, comps[1] & 15)
            return hv if all(v in (1, 2, 4) for v in hv) else None

    def _jpeg_chunk(self, index: int, raw: bytes, segment) -> np.ndarray:
        """JPEGPreDecode's checks and JPEGDecode's rows: one stream decoded
        (after the JPEGTables) and cut to its segment's rows, as bytes."""
        rows, w, per_pixel = segment
        color = self.jpeg_color
        stream = native.decode_jpeg_tiff(raw, self.jpeg_tables, color)
        # `rows`: a strip's rows in the image, a tile's all. A last strip's
        # stream may run past the image's end (libtiff warns).
        strips = -(-self.height // min(self.chunk_h, self.height))
        last = not self.tiled and index % strips + 1 == strips
        if stream.width > w or stream.height > rows and (not last or stream.width != w):
            raise ValueError(f"TIFF JPEG stream {index} of {stream.width} x {stream.height} "
                             f"exceeds its {w} x {rows} segment, which libtiff refuses")
        if len(stream.sampling) != per_pixel:
            raise ValueError(f"TIFF JPEG stream {index} of {len(stream.sampling)} components for "
                             f"{per_pixel} samples (improper JPEG component count)")
        want = [self.subsampling if color == "rgb" else (1, 1)] + [(1, 1)] * (per_pixel - 1)
        if stream.sampling != want:
            raise ValueError(f"TIFF JPEG stream {index} sampled {stream.sampling}, libtiff "
                             f"wants {want} (improper JPEG sampling factors)")
        # JPEGDecode writes the stream's rows and columns into Pillow's strip
        # buffer, which keeps the rest from the strip or tile before.
        prev = self._jpeg_buffer
        hh, ww = min(stream.height, rows), stream.width * stream.pixels.shape[2]
        if (hh < rows or stream.width < w) and (prev is None or self.planar == 2):
            raise ValueError(f"TIFF JPEG stream {index} of {stream.width} x {stream.height} for a "
                             f"{w} x {rows} segment: libtiff leaves the rest of Pillow's buffer "
                             "as it was")
        buf = prev.copy() if prev is not None else np.zeros(
            (self.chunk_h if self.tiled else min(self.chunk_h, self.height), w * per_pixel
             if color == "none" else w * 3), np.uint8)
        buf[:hh, :ww] = stream.pixels[:hh].reshape(hh, ww)
        self._jpeg_buffer = buf
        return buf[:rows].reshape(-1)

    # --- libtiff's RGBA reader (tif_getimage.c) on YCbCr ---------------------------

    def decode_rgba(self, twin: bool) -> np.ndarray:
        """Compressed YCbCr as Pillow's _decodeAsRGBA has libtiff's RGBA
        reader give it, strip by strip or tile by tile: the data units of
        YCbCrSubsampling (h x v luma samples, then Cb and Cr) unpacked by
        the put routine of their size (chroma repeated over the unit, edge
        units cut), then TIFFYCbCrtoRGB with YCbCrCoefficients and
        ReferenceBlackWhite. Old-style JPEG decodes the whole image as one
        stream first (`_ojpeg`)."""
        if self.compression == 6:
            return self._ojpeg()
        if self.spp != 3 or self.bits != (8, 8, 8):
            raise ValueError(f"a YCbCr TIFF of {self.spp} samples of {self.bits} bits, which "
                             "libtiff's RGBA reader cannot handle")
        tables = self._ycbcr_tables()
        W, H = self.width, self.height
        hs, vs = tuple(self.values(530, (2, 2))[:2])
        if self.planar == 2:
            if (hs, vs) != (1, 1):
                raise ValueError(f"a planar YCbCr TIFF subsampled {hs} x {vs}, which libtiff's "
                                 "RGBA reader cannot handle")
            planes = np.zeros((3, H, W), np.uint8)  # gtStripSeparate, gtTileSeparate
            for plane, y0, x0, chunk in self._segments(3, twin):
                part = chunk[:H - y0, :W - x0]
                planes[plane, y0:y0 + part.shape[0], x0:x0 + part.shape[1]] = part
            return ycbcr_to_rgb(planes[0], planes[1], planes[2], tables)
        if (hs, vs) not in _YCBCR_PUTS:
            raise ValueError(f"YCbCr subsampled {hs} x {vs}, which libtiff's RGBA reader "
                             "cannot handle")
        unit = hs * vs + 2
        w, h = self.chunk_w, self.chunk_h
        ys, cbs, crs = (np.zeros((H, W), np.uint8) for _ in range(3))
        if self.tiled:
            across, down = -(-W // w), -(-H // h)
            size = -(-w // hs) * unit * -(-h // vs)  # TIFFTileSize
            if self.counts is None or min(len(self.offsets), len(self.counts)) < across * down:
                raise ValueError("TIFF strip or tile offsets or byte counts missing")
            for ty in range(down):
                for tx in range(across):
                    buf = self._ycbcr_predict(self._chunk(ty * across + tx, size, twin), 3 * w, 3)
                    y0, x0 = ty * h, tx * w
                    ew, eh = min(w, W - x0), min(h, H - y0)
                    parts = _ycbcr_units(buf, eh, ew, hs, vs, w - ew)
                    for a, p in zip((ys, cbs, crs), parts):
                        a[y0:y0 + eh, x0:x0 + ew] = p
        else:
            h = min(h, H)
            down = -(-H // h)
            if self.counts is None or min(len(self.offsets), len(self.counts)) < down:
                raise ValueError("TIFF strip or tile offsets or byte counts missing")
            row_units = -(-W // hs) * unit
            scanline = row_units // vs  # TIFFScanlineSize, rounded down
            for ty in range(down):
                rows = min(h, H - ty * h)
                # gtStripContig reads whole units of rows, scanline bytes a row:
                # a 4 x 4 unit row loses its last bytes to the rounding.
                n = min(-(-rows // vs) * row_units, -(-rows // vs) * vs * scanline)
                buf = np.zeros(-(-h // vs) * row_units, np.uint8)
                buf[:n] = self._ycbcr_predict(self._chunk(ty, n, twin), scanline, 3)
                parts = _ycbcr_units(buf, rows, W, hs, vs, 0)
                for a, p in zip((ys, cbs, crs), parts):
                    a[ty * h:ty * h + rows] = p
        return ycbcr_to_rgb(ys, cbs, crs, tables)

    def _ycbcr_tables(self):
        return ycbcr_tables(self.floats(529, (0.299, 0.587, 0.114)),
                            self.floats(532, (0, 255, 128, 255, 128, 255)))

    def _predictor(self) -> int:
        """The Predictor tag where libtiff's codec takes one (LZW, Deflate),
        checked as PredictorSetup checks it."""
        predictor = self.scalar(317, 1) if self.compression in _PREDICTED else 1
        bps = self.bits[0]
        if predictor == 2 and bps not in (8, 16, 32, 64):
            raise ValueError(f"TIFF horizontal predictor on {bps}-bit samples, which libtiff "
                             "refuses")
        if predictor == 3 and self.tags.get(339, (1,))[0] != 3:
            raise ValueError("TIFF floating-point predictor on integer samples, which libtiff "
                             "refuses")
        if predictor not in (1, 2, 3):
            raise ValueError(f"TIFF predictor {predictor}, which libtiff refuses")
        return predictor

    def _ycbcr_predict(self, buf: np.ndarray, rowsize: int, stride: int) -> np.ndarray:
        """PredictorDecodeTile over a strip or tile of YCbCr data: horAcc8
        over each `rowsize` bytes, `stride` bytes a pixel; libtiff stops at
        the first row whose size is no whole pixels (or where the data is
        no whole rows), leaving the rest as coded, which the RGBA reader
        then shows."""
        if self._predictor() != 2 or len(buf) % rowsize:
            return buf
        if rowsize % stride:
            return buf
        return _tiff_predict(buf.reshape(-1, rowsize), 2, 8, stride, self.order).reshape(-1)

    # --- old-style JPEG (compression 6), libtiff's tif_ojpeg.c ----------------------

    def _ojpeg(self) -> np.ndarray:
        """The stream libtiff's old-style JPEG codec feeds libjpeg
        (`_ojpeg_stream`), decoded whole. Three samples go through the RGBA
        reader: each component's plane as the IDCT gives it (raw_data_out,
        no upsampling), chroma repeated over its data unit, TIFFYCbCrtoRGB;
        where the stream's sampling has no TIFF equivalent, libjpeg
        upsamples inside the decompression and the units are 1 x 1. One
        sample is the gray plane itself. Whatever the file's photometric
        tag says, libtiff and Pillow read it so. Strip or tile k is the k-th
        band of the stream's rows, as tall as a strip or tile, put in its
        place."""
        if self.planar != 1:
            raise UnsupportedImage("an old-style JPEG TIFF in separate planes, which the port "
                                   "does not read and no ROADMAP item ports: no such file PIL "
                                   "reads is known")
        if self.spp not in (1, 3) or set(self.bits) != {8}:
            raise ValueError(f"an old-style JPEG TIFF of {self.spp} samples of {self.bits} bits, "
                             "which libtiff refuses")
        # libtiff's OJPEG hacks (tif_dirread.c): no photometric tag, or RGB,
        # reads as YCbCr. Pillow then decodes three samples through the
        # RGBA reader and one sample of MinIsBlack or MinIsWhite as they are.
        photo = self.tags.get(262, (6,))[0] if isinstance(self.tags.get(262), tuple) else 6
        photo = 6 if photo == 2 else photo
        if photo != (6 if self.spp == 3 else 0) and not (self.spp == 1 and photo == 1):
            raise ValueError(f"an old-style JPEG TIFF of {self.spp} samples and photometric "
                             f"{photo}, which Pillow's libtiff decoder refuses")
        stream, (hs, vs), inside = _ojpeg_stream(self)
        gray = self.spp == 1
        decoded = native.decode_jpeg_tiff(stream, None, "none" if inside or gray else "planes")
        if gray:
            px = decoded.pixels[..., 0]
        elif inside:
            px = decoded.pixels
            px = ycbcr_to_rgb(px[..., 0], px[..., 1], px[..., 2], self._ycbcr_tables())
        else:
            y, cb, cr = decoded.pixels
            rep = lambda c: np.repeat(np.repeat(c, vs, 0), hs, 1)[:y.shape[0], :y.shape[1]]  # noqa
            px = ycbcr_to_rgb(y, rep(cb), rep(cr), self._ycbcr_tables())
        W, H = self.width, self.height
        w, h = (self.chunk_w, self.chunk_h) if self.tiled else (W, min(self.chunk_h, H))
        across = -(-W // w)
        out = np.empty((H, W) + px.shape[2:], np.uint8)
        # Rows past the frame (tiles side by side, the frame one column of
        # them tall): libjpeg gives no more lines. In raw-data mode libtiff
        # repeats its last MCU row; reading scanlines, it writes nothing and
        # Pillow's tile buffer keeps the tile before.
        frame, mcu = px.shape[0], 8 * vs
        raw_data = not (inside or gray)
        buf = np.zeros((h, w) + px.shape[2:], np.uint8)
        for k in range(across * -(-H // h)):
            (ty, tx), top = divmod(k, across), k * h
            eh, ew = min(h, H - ty * h), min(w, W - tx * w)
            if ew > px.shape[1]:
                raise ValueError(f"old-style JPEG strip or tile {k} lies past the stream's "
                                 f"{px.shape[1]} x {px.shape[0]}")
            lines = top + np.arange(h)
            inside_frame = lines < frame
            buf[inside_frame, :px.shape[1]] = px[lines[inside_frame], :w]
            if raw_data and not inside_frame[:eh].all():
                if frame < mcu or frame % mcu:
                    raise ValueError(f"old-style JPEG tile {k} lies past a frame of {frame} rows, "
                                     f"no whole MCU rows of {mcu}")
                past = lines[~inside_frame]
                buf[~inside_frame, :px.shape[1]] = px[frame - mcu + (past - frame) % mcu, :w]
            out[ty * h:ty * h + eh, tx * w:tx * w + ew] = buf[:eh, :ew]
        return out


_OJPEG_SKIPPED = (0xFE,) + tuple(range(0xE0, 0xF0))


def _ojpeg_stream(f: "_TiffFile"):
    """(stream, (h, v) sampling, upsampled inside) as tif_ojpeg.c builds it:
    the header read from JPEGInterchangeFormat (tags 513/514) and on into
    the strips (OJPEGReadHeaderInfoSec), or made from the JPEGQTables,
    JPEGDCTables and JPEGACTables (519-521) at YCbCrSubsampling where no
    frame header came; then SOI, the tables, DRI, SOF and SOS written anew,
    the compressed data after the header, an RST marker after each strip
    but the last, and EOI. Raises ValueError where libtiff does."""
    data, spp = f.data, f.spp
    offsets = f.offsets
    counts = f.counts or (0,) * len(offsets)
    sources = []
    jif = f.tags.get(513, (0,))[0] if isinstance(f.tags.get(513), tuple) else 0
    if jif and jif < len(data):
        length = f.tags.get(514, (0,))[0] if isinstance(f.tags.get(514), tuple) else 0
        if not length or jif + length > len(data):
            length = len(data) - jif
        sources.append(data[jif:jif + length])
    strips, missing = [], []
    # The strips, or the tiles (one column of them), each a restart interval
    # of one image as wide as a strip and as tall as all of them.
    width, length = f.chunk_w, f.chunk_h if f.tiled else min(f.chunk_h, f.height)
    total = -(-f.height // length) * length if f.tiled else f.height
    count = -(-f.height // length) * (-(-f.width // width) if f.tiled else 1)
    for i in range(count):  # a strip or tile at 0 or past the end is none
        at = offsets[i] if i < len(offsets) else 0
        n = counts[i] if i < len(counts) else 0
        if at == 0 or at >= len(data):
            missing.append(f"strip {i} at {at}")
        strips.append(b"" if missing and missing[-1].startswith(f"strip {i} ") else
                      data[at:at + n] if n and at + n <= len(data) else data[at:])
    sources += strips
    first_strip = len(sources) - len(strips)
    hs, vs = tuple(f.values(530, (2, 2))[:2]) if spp == 3 else (1, 1)
    # OJPEGSubsamplingCorrect and OJPEGReadHeaderInfoSec over the same bytes.
    reader = _SourceReader(sources)
    q, dc, ac, sof, sos, dri = {}, {}, {}, None, None, None
    inside = False
    while reader.peek() == 0xFF:
        reader.take(1)
        m = reader.byte()
        while m == 0xFF:
            m = reader.byte()
        if m == 0xD8:
            continue
        if m in _OJPEG_SKIPPED:
            n = reader.word()
            if n < 2:
                raise ValueError("old-style JPEG: corrupt JPEG data")
            reader.take(n - 2)
        elif m == 0xDD:
            if reader.word() != 4:
                raise ValueError("old-style JPEG: corrupt DRI marker")
            dri = reader.word()
        elif m == 0xDB:
            n = reader.word() - 2
            if n <= 0 or n % 65:
                raise ValueError("old-style JPEG: corrupt DQT marker")
            for _ in range(n // 65):
                body = reader.take(65)
                if body[0] > 3:
                    raise ValueError("old-style JPEG: corrupt DQT marker")
                q[body[0]] = b"\xff\xdb\x00\x43" + body
        elif m == 0xC4:
            n = reader.word() - 2
            if n <= 0:
                raise ValueError("old-style JPEG: corrupt DHT marker")
            body = reader.take(n)
            at = 0
            while at < n:
                if at + 17 > n:
                    raise ValueError("old-style JPEG: corrupt DHT marker")
                cls, index = body[at] >> 4, body[at] & 15
                size = 17 + sum(body[at + 1:at + 17])
                if cls > 1 or index > 3 or at + size > n:
                    raise ValueError("old-style JPEG: corrupt DHT marker")
                part = body[at:at + size]
                (ac if cls else dc)[index] = (b"\xff\xc4" + struct.pack(">H", size + 2) + part)
                at += size
        elif m in (0xC0, 0xC1, 0xC3):
            if sof is not None:
                raise ValueError("old-style JPEG: corrupt JPEG data (two SOF markers)")
            n = reader.word()
            if n < 11 or (n - 8) % 3 or (n - 8) // 3 != spp:
                raise ValueError("old-style JPEG: SOF marker of an unexpected size")
            body = reader.take(n - 2)
            if body[0] != 8:
                raise ValueError("old-style JPEG: JPEG data of other than 8-bit samples")
            sof_y, sof_x = struct.unpack_from(">HH", body, 1)
            if (sof_y < min(f.height, total) or sof_x < min(f.width, width)
                    or sof_x > width):
                raise ValueError(f"old-style JPEG: a frame of {sof_x} x {sof_y} for a "
                                 f"{f.width} x {f.height} image in strips or tiles {width} "
                                 "wide")
            comps = [body[6 + 3 * i:9 + 3 * i] for i in range(spp)]
            hv0 = (comps[0][1] >> 4, comps[0][1] & 15)
            if spp == 1 and comps[0][1] != 0x11:
                raise ValueError("old-style JPEG: unexpected subsampling values")
            inside = spp == 3 and (any(v not in (1, 2, 4) for v in hv0)
                                   or any(c[1] != 0x11 for c in comps[1:]))
            if spp == 3:
                hs, vs = (1, 1) if inside else hv0
            sof = (m, sof_y, sof_x, comps)
        elif m == 0xDA:
            if sof is None:
                raise ValueError("old-style JPEG: corrupt SOS marker in JPEG data")
            if reader.word() != 6 + 2 * spp or reader.byte() != spp:
                raise ValueError("old-style JPEG: SOS marker of an unexpected size")
            sos = reader.take(2 * spp)
            reader.take(3)
            break
        else:
            raise ValueError(f"old-style JPEG: unknown marker type {m} in JPEG data")
    restart = f.tags.get(515, (0,))[0]
    if length < f.height:  # OJPEGReadHeaderInfo: a strip is a restart interval
        if hs not in (1, 2, 4) or vs not in (1, 2, 4):
            raise ValueError(f"old-style JPEG subsampled {hs} x {vs}, which libtiff refuses")
        if length % (8 * vs):
            raise ValueError("old-style JPEG strips of rows that are no whole MCU rows "
                             "(incompatible vertical subsampling and strip length)")
        restart = -(-width // (8 * hs)) * (length // (8 * vs))
    restart = restart if dri is None else dri
    if missing:
        raise ValueError(f"old-style JPEG {missing[0]}, outside the file")
    if sof is None:
        header = _ojpeg_tables(f, hs, vs, (width, total))
    else:
        if sos is None:
            raise ValueError("old-style JPEG: a frame header without its scan header")
        m, sof_y, sof_x, comps = sof
        header = (b"".join(q[k] for k in sorted(q)) + b"".join(dc[k] for k in sorted(dc))
                  + b"".join(ac[k] for k in sorted(ac)))
        header += (bytes([0xFF, m]) + struct.pack(">HBHHB", 8 + 3 * spp, 8, sof_y, sof_x, spp)
                   + b"".join(comps))
        header += (b"\xff\xda" + struct.pack(">HB", 6 + 2 * spp, spp) + sos
                   + bytes([0, 63, 0]))
    if restart:
        header = _with_dri(header, restart)
    out = [b"\xff\xd8", header]
    rst = 0
    k, at = reader.source, reader.at
    for i in range(k, len(sources)):
        out.append(sources[i][at if i == k else 0:])
        if i >= first_strip and i + 1 < len(sources):
            out.append(bytes([0xFF, 0xD0 + rst]))
            rst = (rst + 1) % 8
    out.append(b"\xff\xd9")
    return b"".join(out), (hs, vs), inside


def _with_dri(header: bytes, restart: int) -> bytes:
    """The tables, a DRI segment, then the frame and scan headers."""
    sof = max(header.rfind(b"\xff" + bytes([m])) for m in (0xC0, 0xC1, 0xC3))
    return header[:sof] + b"\xff\xdd\x00\x04" + struct.pack(">H", restart) + header[sof:]


def _ojpeg_tables(f: "_TiffFile", hs: int, vs: int, size) -> bytes:
    """OJPEGReadHeaderInfoSecTables*: DQT and DHT segments from the table
    tags (component i takes tables i), the frame (SOF0 of `size`: the
    strips' width, the image's height or the tiles' in all) and scan
    headers."""
    spp, data = f.spp, f.data
    out = []
    for tag, what in ((519, "JPEGQTables"), (520, "JPEGDCTables"), (521, "JPEGACTables")):
        value = f.tags.get(tag)
        if not isinstance(value, tuple) or len(value) != spp:
            raise ValueError(f"old-style JPEG without its {what} (tag {tag})")
        for i, at in enumerate(value):
            if tag == 519:
                body = data[at:at + 64]
                if len(body) != 64:
                    raise ValueError(f"old-style JPEG: {what} {i} lies outside the file")
                out.append(b"\xff\xdb\x00\x43" + bytes([i]) + body)
                continue
            counts = data[at:at + 16]
            n = sum(counts)
            if len(counts) != 16 or n > (16 if tag == 520 else 256) or at + 16 + n > len(data):
                raise ValueError(f"old-style JPEG: {what} {i} is corrupt or outside the file")
            out.append(b"\xff\xc4" + struct.pack(">HB", 19 + n, i | (16 if tag == 521 else 0))
                       + data[at:at + 16 + n])
    # libtiff writes every DQT, then every DC table, then every AC table
    out = out[0::3] + out[1::3] + out[2::3]
    comps = b"".join(bytes([i, (hs << 4 | vs) if i == 0 else 0x11, i]) for i in range(spp))
    out.append(b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * spp, 8, size[1], size[0], spp)
               + comps)
    out.append(b"\xff\xda" + struct.pack(">HB", 6 + 2 * spp, spp)
               + b"".join(bytes([i, i << 4 | i]) for i in range(spp)) + bytes([0, 63, 0]))
    return b"".join(out)


class _SourceReader:
    """Bytes read across a list of sources, one after another (OJPEG's
    in_buffer over JPEGInterchangeFormat and the strips)."""

    def __init__(self, sources):
        self.sources, self.source, self.at = sources, 0, 0

    def _settle(self):
        while self.source < len(self.sources) and self.at >= len(self.sources[self.source]):
            self.source, self.at = self.source + 1, 0

    def peek(self):
        self._settle()
        return self.sources[self.source][self.at] if self.source < len(self.sources) else None

    def take(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            self._settle()
            if self.source >= len(self.sources):
                raise ValueError("old-style JPEG: the data ends in its header")
            src = self.sources[self.source]
            part = src[self.at:self.at + n - len(out)]
            out += part
            self.at += len(part)
        return bytes(out)

    def byte(self) -> int:
        return self.take(1)[0]

    def word(self) -> int:
        return struct.unpack(">H", self.take(2))[0]


def ycbcr_tables(luma, refbw):
    """tif_color.c TIFFYCbCrToRGBInit in float32 as libtiff computes it:
    (Y, Cr->R, Cb->B) int16 tables over 0-255 and the (Cb, Cr) -> G
    offset, (Cb_g_tab[cb] + Cr_g_tab[cr]) >> 16, as a (256, 256) int16
    table. Raises ValueError where initYCbCrConversion does."""
    f32 = np.float32
    luma = np.asarray(luma, f32)
    refbw = np.asarray(refbw, f32)
    if np.isnan(luma).any() or abs(float(luma[1])) < 1e-10:
        raise ValueError("invalid values for the YCbCrCoefficients tag, which libtiff refuses")
    if not ((refbw > f32(-0x7FFFFFFF + 128)) & (refbw < f32(0x7FFFFFFF))).all():
        raise ValueError("invalid values for the ReferenceBlackWhite tag, which libtiff refuses")

    def fix(x):  # FIX(): float times 65536, plus 0.5 in double, truncated
        x = min(max(x, f32(0)), f32(2))
        return int(float(f32(x * f32(65536))) + 0.5)

    lr, lg, lb = luma
    f1 = f32(f32(2) - f32(f32(2) * lr))
    f3 = f32(f32(2) - f32(f32(2) * lb))
    d1, d2 = fix(f1), -fix(f32(f32(lr * f1) / lg))
    d3, d4 = fix(f3), -fix(f32(f32(lb * f3) / lg))
    x = np.arange(-128, 128)

    def code2v(c, rb, rw, cr):  # Code2V, then CLAMPw to +-4096, cast to int32
        den = f32(rw - rb)
        den = den if den != 0 else f32(1)
        v = (np.asarray(c - np.trunc(rb), np.int64).astype(f32) * f32(cr)) / den
        return np.trunc(np.clip(v, f32(-4096), f32(4096))).astype(np.int64)

    cr = code2v(x, refbw[4] - f32(128), refbw[5] - f32(128), 127)
    cb = code2v(x, refbw[2] - f32(128), refbw[3] - f32(128), 127)
    y = code2v(x + 128, refbw[0], refbw[1], 255)
    g = ((d4 * cb + 32768)[:, None] + (d2 * cr)[None, :]) >> 16
    return tuple(t.astype(np.int16) for t in (y, (d1 * cr + 32768) >> 16,
                                              (d3 * cb + 32768) >> 16, g))


def ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, tables) -> np.ndarray:
    """TIFFYCbCrtoRGB over (H, W) uint8 planes -> (H, W, 3) uint8 (every
    sum fits int16)."""
    yt, cr_r, cb_b, g = tables
    luma = yt[y]
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = np.clip(luma + cr_r[cr], 0, 255)
    out[..., 1] = np.clip(luma + g[cb, cr], 0, 255)
    out[..., 2] = np.clip(luma + cb_b[cb], 0, 255)
    return out


def _ycbcr_units(buf: np.ndarray, h: int, w: int, hs: int, vs: int, fromskew: int):
    """putcontig8bitYCbCr{hs}{vs}tile over one strip or tile: (Y, Cb, Cr)
    of its h x w pixels, each unit's chroma repeated over it; a unit row
    holds ceil(w / hs) units, then `fromskew` pixels' worth skipped."""
    unit = hs * vs + 2
    skew_unit = 10 if (hs, vs) == (4, 4) else unit
    uw, uh = -(-w // hs), -(-h // vs)
    row = uw * unit + fromskew // hs * skew_unit
    index = (np.arange(uh)[:, None, None] * row + np.arange(uw)[None, :, None] * unit
             + np.arange(unit)[None, None, :])
    if index.size and index[-1, -1, -1] >= len(buf):
        raise ValueError("TIFF YCbCr data units past the end of their strip or tile")
    u = np.asarray(buf)[index]
    y = u[..., :hs * vs].reshape(uh, uw, vs, hs).transpose(0, 2, 1, 3).reshape(uh * vs, uw * hs)
    rep = lambda c: np.repeat(np.repeat(c, vs, 0), hs, 1)[:h, :w]  # noqa: E731
    return y[:h, :w], rep(u[..., -2]), rep(u[..., -1])


def _tiff_predict(rows: np.ndarray, predictor: int, bps: int, per_pixel: int,
                  order: str) -> np.ndarray:
    """(rows, scanline) decoded bytes -> the same bytes with libtiff's
    predictor undone and 16- or 32-bit samples in native order."""
    if predictor == 3:  # fpAcc: bytes summed a pixel apart, then the byte planes joined
        size = bps // 8
        b = np.cumsum(rows.reshape(len(rows), -1, per_pixel), axis=1, dtype=np.uint8)
        b = np.ascontiguousarray(b.reshape(len(rows), size, -1).transpose(0, 2, 1))
        return b.view(f">u{size}").astype(f"=u{size}").view(np.uint8).reshape(len(rows), -1)
    if bps in (16, 32):
        samples = rows.view(f"{order}u{bps // 8}").astype(f"=u{bps // 8}")
    elif bps == 8:
        samples = rows
    else:
        return rows
    if predictor == 2:  # horAcc: each sample plus the one a pixel before, wrapping
        s = samples.reshape(len(rows), -1, per_pixel)
        samples = np.cumsum(s, axis=1, dtype=s.dtype).reshape(len(rows), -1)
    return samples.view(np.uint8)


def _lzma_strip(data: bytes, size: int) -> np.ndarray:
    """libtiff's LZMADecode: one .xz stream (no concatenated streams, any
    memory), decoded until `size` bytes are out; an error or the stream's
    end before then fails the strip, and nothing past them is read."""
    import lzma

    d = lzma.LZMADecompressor(format=lzma.FORMAT_XZ)
    try:
        out = d.decompress(data, max_length=size)
    except lzma.LZMAError as e:
        raise ValueError(f"TIFF LZMA data: {e}") from e
    if len(out) < size:
        raise ValueError(f"TIFF LZMA data ends after {len(out)} of {size} bytes")
    return np.frombuffer(out, np.uint8)


def thunderscan_twin(data: bytes, size: int, scanline: int, width: int) -> np.ndarray:
    """`native.tiff_thunderscan` in Python: libtiff's ThunderDecodeRow, each
    byte a 2-bit code and 6 bits of data (a run of the last pixel, three
    2-bit or two 3-bit deltas from it, or a raw pixel). Raises ValueError
    where a row ends short or long."""
    two, three = (0, 1, 0, -1), (0, 1, 2, 3, 0, -3, -2, -1)
    out = np.zeros(size, np.uint8)
    if scanline <= 0 or size % scanline:
        raise ValueError("TIFF ThunderScan data: fractional scanlines")
    bp = 0
    for row in range(0, size, scanline):
        op, last, npx = row, 0, 0

        def put(v):  # SETPIXEL
            nonlocal op, last, npx
            last = v & 15
            if npx < width:
                if npx & 1:
                    out[op] |= last
                    op += 1
                else:
                    out[op] = last << 4
                npx += 1

        while bp < len(data) and npx < width:
            n = data[bp]
            bp += 1
            code = n & 0xC0
            if code == 0x00:
                if npx & 1:
                    out[op] |= last
                    last = int(out[op])
                    op += 1
                    npx += 1
                    n -= 1
                else:
                    last |= last << 4
                npx += n
                if npx <= width:
                    while n > 0:
                        out[op] = last
                        op += 1
                        n -= 2
                if n == -1:
                    op -= 1
                    out[op] &= 0xF0
                last &= 15
            elif code == 0x40:
                for shift in (4, 2, 0):
                    if (n >> shift) & 3 != 2:
                        put(last + two[(n >> shift) & 3])
            elif code == 0x80:
                for shift in (3, 0):
                    if (n >> shift) & 7 != 4:
                        put(last + three[(n >> shift) & 7])
            else:
                put(n)
        if npx != width:
            raise ValueError("TIFF ThunderScan data: a row of other than its width's pixels "
                             "(libtiff fails)")
    return out


def packbits_twin(data: bytes, size: int) -> np.ndarray:
    """`native.tiff_packbits` in Python: libtiff's PackBitsDecode. Raises
    ValueError where the data ends before `size` bytes."""
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n and len(out) < size:
        c = data[pos]
        pos += 1
        if c >= 128:
            if c == 128:
                continue
            count = min(257 - c, size - len(out))
            if pos >= n:
                break
            out += bytes([data[pos]]) * count
            pos += 1
        else:
            count = min(c + 1, size - len(out))
            if n - pos < count:
                break
            out += data[pos:pos + count]
            pos += count
    if len(out) < size:
        raise ValueError(f"TIFF PackBits data ends after {len(out)} of {size} bytes")
    return np.frombuffer(bytes(out), np.uint8)


def lzw_twin(data: bytes, size: int) -> np.ndarray:
    """`native.tiff_lzw` in Python: libtiff 4.7's LZWDecode (codes of 9-12
    bits, MSB-first, widened one code early) or, for a stream that starts
    with the old bit-reversed codes, its LZWDecodeCompat (LSB-first,
    widened on time). Stops once `size` bytes are out; raises ValueError
    where libtiff fails: a code not yet in the table, or data that ends
    first (out of bits reads as an EOI code)."""
    compat = len(data) >= 2 and data[0] == 0 and data[1] & 1
    total = 8 * len(data)
    bits = int.from_bytes(data, "little" if compat else "big")
    at, nbits, maxcode = 0, 9, 0
    # libtiff's free entry starts before its table: only a Clear code is valid
    free, old = -1, 0
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()

    def next_code():
        nonlocal at
        if total - at < nbits:
            return 257
        shift = at if compat else total - at - nbits
        at += nbits
        return (bits >> shift) & ((1 << nbits) - 1)

    while len(out) < size:
        code = next_code()
        if code == 257:
            break
        if code == 256:
            while code == 256:
                free, nbits = 258, 9
                maxcode = 511 if compat else 510
                del table[258:]
                code = next_code()
            if code == 257:
                break
            if code > 256:
                raise ValueError("TIFF LZW: a code past the table after a Clear code")
            out.append(code)
            old = code
            continue
        if compat:
            if not 0 <= free < 4096:
                raise ValueError("TIFF LZW: corrupted table")
        elif code > free or (code >= 258 and code == free and free < 0):
            raise ValueError("TIFF LZW: a code not yet in the table")
        prev = table[old]
        table.append(prev + (table[code][:1] if code < free else prev[:1]))
        if code > free:  # the old coding: an entry of length 0
            raise ValueError("TIFF LZW: a code not yet in the table")
        free += 1
        if free > maxcode:
            nbits = min(nbits + 1, 12)
            maxcode = (1 << nbits) - (1 if compat else 2)
            if not compat and free >= 4096:
                free = -1  # only a Clear code or an EOI code may follow
        old = code
        out += table[code]
    if len(out) < size:
        raise ValueError(f"TIFF LZW data ends after {len(out)} of {size} bytes")
    return np.frombuffer(bytes(out[:size]), np.uint8)


# --- CCITT (compressions 2, 3, 4, 32771), libtiff's tif_fax3.c --------------------------

_FAX_NULL, _FAX_PASS, _FAX_HORIZ, _FAX_V0, _FAX_VR, _FAX_VL, _FAX_EXT, _FAX_TERMW, _FAX_TERMB, \
    _FAX_MAKEUPW, _FAX_MAKEUPB, _FAX_MAKEUP, _FAX_EOL = range(13)
# The T.4 codes, most significant bit first (ccitt_decode.cpp lists the same).
_FAX_TERM_W = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 "
    "110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 "
    "0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 00010100 "
    "00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 00101101 00000100 "
    "00000101 00001010 00001011 01010010 01010011 01010100 01010101 00100100 00100101 01011000 "
    "01011001 01011010 01011011 01001010 01001011 00110010 00110011 00110100").split()
_FAX_MAKEUP_W = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 "
    "011001101 011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 "
    "011011010 011011011 010011000 010011001 010011010 011000 010011011").split()
_FAX_TERM_B = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 "
    "00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 "
    "00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 000011010010 000011010011 "
    "000011010100 000011010101 000011010110 000011010111 000001101100 000001101101 000011011010 "
    "000011011011 000001010100 000001010101 000001010110 000001010111 000001100100 000001100101 "
    "000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 000000101000 "
    "000001011000 000001011001 000000101011 000000101100 000001011010 000001100110 "
    "000001100111").split()
_FAX_MAKEUP_B = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
    "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
    "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
    "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101").split()
_FAX_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
               "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
               "000000011111").split()


def _fax_tables():
    """tif_fax3sm.c's TIFFFaxMainTable, TIFFFaxWhiteTable and
    TIFFFaxBlackTable as mkg3states.c fills them: (state, width, param) at
    every index whose low `width` bits are a code read least significant
    bit first, later fills overwriting earlier ones."""
    main, white, black = ([(_FAX_NULL, 0, 0)] * (1 << n) for n in (7, 12, 13))

    def fill(table, size, codes, state):
        for bits, param in codes:
            for c in range(int(bits[::-1], 2), 1 << size, 1 << len(bits)):
                table[c] = (state, len(bits), param)

    fill(main, 7, [("0001", 0)], _FAX_PASS)
    fill(main, 7, [("001", 0)], _FAX_HORIZ)
    fill(main, 7, [("1", 0)], _FAX_V0)
    fill(main, 7, [("011", 1), ("000011", 2), ("0000011", 3)], _FAX_VR)
    fill(main, 7, [("010", 1), ("000010", 2), ("0000010", 3)], _FAX_VL)
    fill(main, 7, [("0000001", 0)], _FAX_EXT)
    fill(main, 7, [("0000000", 0)], _FAX_EOL)
    for table, size, makeup, term, states in (
            (white, 12, _FAX_MAKEUP_W, _FAX_TERM_W, (_FAX_MAKEUPW, _FAX_TERMW)),
            (black, 13, _FAX_MAKEUP_B, _FAX_TERM_B, (_FAX_MAKEUPB, _FAX_TERMB))):
        fill(table, size, [(c, 64 * (i + 1)) for i, c in enumerate(makeup)], states[0])
        fill(table, size, [(c, 1792 + 64 * i) for i, c in enumerate(_FAX_MAKEUP)], _FAX_MAKEUP)
        fill(table, size, [(c, i) for i, c in enumerate(term)], states[1])
        fill(table, size, [("0" * 11, 0)], _FAX_EOL)
    return main, white, black


_FAX_TABLES = None


class _FaxEnd(Exception):
    """The data ran out (libtiff's eoflab)."""


class _FaxFail(Exception):
    """libtiff's decode returns -1 (its run arrays would overflow)."""


def _i32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >> 31 else v


class _Fax:
    """One strip of tif_fax3.c's decoding: its state (DECLARE_STATE) and
    macros as methods; goto targets as exceptions and return values."""

    def __init__(self, data: bytes, kind: str, width: int, rows: int, rowbytes: int, odd: bool):
        global _FAX_TABLES
        if _FAX_TABLES is None:
            _FAX_TABLES = _fax_tables()
        self.main, self.white, self.black = _FAX_TABLES
        self.data = _REVERSE_BITS[np.frombuffer(data, np.uint8)].tolist()
        self.cp, self.odd, self.lastx = 0, odd, width
        self.acc = self.avail = self.eolcnt = 0
        self.errors = self.extensions = 0
        nruns = -(-(width + 1) // 32) * 32 * (2 if kind in ("g3_2d", "g4") else 1)
        self.nruns = nruns
        self.runs = [0] * (2 * nruns + 1)  # fillruns may write one past the last run
        self.cur, self.ref = 0, nruns
        self.runs[nruns] = width
        self.out = np.zeros((rows, rowbytes), np.uint8)

    # NeedBits8 / NeedBits16 / GetBits / ClrBits, LOOKUP8 / LOOKUP16
    def need(self, n: int, two: bool):
        if self.avail >= n:
            return
        for k in range(2 if two else 1):
            if self.cp >= len(self.data):
                if k == 0 and self.avail == 0:
                    raise _FaxEnd
                self.avail = n
                return
            self.acc |= self.data[self.cp] << self.avail
            self.cp += 1
            self.avail += 8
            if self.avail >= n:
                return

    def clr(self, n: int):
        self.avail -= n
        self.acc >>= n

    def lookup(self, wid: int, table, two: bool = True):
        self.need(wid, two)
        entry = table[self.acc & ((1 << wid) - 1)]
        self.clr(entry[1])
        return entry

    # SETVALUE, CLEANUP_RUNS, CHECK_b1
    def setvalue(self, x: int):
        if self.pa >= self.thisrun + self.nruns:
            raise _FaxFail
        self.runs[self.pa] = (self.rl + x) & 0xFFFFFFFF
        self.pa += 1
        self.a0 = _i32(self.a0 + x)
        self.rl = 0

    def cleanup(self):
        if self.rl:
            self.setvalue(0)
        if self.a0 != self.lastx:
            self.errors += 1
            while self.a0 > self.lastx and self.pa > self.thisrun:
                self.pa -= 1
                self.a0 = _i32(self.a0 - self.runs[self.pa])
            if self.a0 < self.lastx:
                self.a0 = max(self.a0, 0)
                if (self.pa - self.thisrun) & 1:
                    self.setvalue(0)
                self.setvalue(self.lastx - self.a0)
            elif self.a0 > self.lastx:
                self.setvalue(self.lastx)
                self.setvalue(0)

    def check_b1(self):
        if self.pa != self.thisrun:
            while self.b1 <= self.a0 and self.b1 < self.lastx:
                if self.pb + 1 >= self.ref + self.nruns:
                    raise _FaxFail
                self.b1 = _i32(self.b1 + self.runs[self.pb] + self.runs[self.pb + 1])
                self.pb += 2

    def sync_eol(self):
        if self.eolcnt == 0:
            while True:
                self.need(11, True)
                if self.acc & 0x7FF == 0:
                    break
                self.clr(1)
        while True:
            self.need(8, False)
            if self.acc & 0xFF:
                break
            self.clr(8)
        while self.acc & 1 == 0:
            self.clr(1)
        self.clr(1)
        self.eolcnt = 0

    def color_run(self, black: bool) -> bool:
        """One run's makeup and terminating codes (EXPAND1D's and
        EXPAND2D's loops); False on an EOL or a bad code word (reported
        unless an EOL: `eol` tells which)."""
        table, wid, term = ((self.black, 13, _FAX_TERMB) if black
                            else (self.white, 12, _FAX_TERMW))
        while True:
            state, _, param = self.lookup(wid, table)
            if state == term:
                self.setvalue(param)
                return True
            if state in (_FAX_MAKEUPW if not black else _FAX_MAKEUPB, _FAX_MAKEUP):
                self.a0 = _i32(self.a0 + param)
                self.rl += param
                continue
            self.eol = state == _FAX_EOL
            return False

    def expand1d(self):
        """EXPAND1D; raises _FaxEnd after its clean-up where the data ends."""
        try:
            while True:
                for black in (False, True):
                    if not self.color_run(black):
                        if self.eol:
                            self.eolcnt = 1
                        else:
                            self.errors += 1
                        raise StopIteration
                    if self.a0 >= self.lastx:
                        raise StopIteration
                if self.runs[self.pa - 1] == 0 and self.runs[self.pa - 2] == 0:
                    self.pa -= 2
        except StopIteration:
            self.cleanup()
        except _FaxEnd:
            self.cleanup()
            raise

    def expand2d(self):
        """EXPAND2D; raises _FaxEnd after its clean-up where the data ends."""
        try:
            if self._expand2d_body():
                if self.rl:
                    bad = False
                    if self.rl + self.a0 < self.lastx:  # a final V0
                        self.need(1, False)
                        bad = not self.acc & 1
                        if not bad:
                            self.clr(1)
                    if bad:
                        self.errors += 1
                    else:
                        self.setvalue(0)
        except _FaxEnd:
            self.cleanup()
            raise
        self.cleanup()

    def _expand2d_body(self) -> bool:
        """EXPAND2D's loop: True where it ends with the row, False on a goto
        eol2d."""
        while self.a0 < self.lastx:
            if self.pa >= self.thisrun + self.nruns:
                raise _FaxFail
            state, _, param = self.lookup(7, self.main, False)
            if state == _FAX_PASS:
                self.check_b1()
                if self.pb + 1 >= self.ref + self.nruns:
                    raise _FaxFail
                self.b1 = _i32(self.b1 + self.runs[self.pb])
                self.rl += self.b1 - self.a0
                self.a0 = self.b1
                self.b1 = _i32(self.b1 + self.runs[self.pb + 1])
                self.pb += 2
            elif state == _FAX_HORIZ:
                first = bool((self.pa - self.thisrun) & 1)
                for black in (first, not first):
                    if not self.color_run(black):
                        self.errors += 1
                        return False
                self.check_b1()
            elif state in (_FAX_V0, _FAX_VR):
                self.check_b1()
                self.setvalue(self.b1 - self.a0 + param)
                if self.pb >= self.ref + self.nruns:
                    raise _FaxFail
                self.b1 = _i32(self.b1 + self.runs[self.pb])
                self.pb += 1
            elif state == _FAX_VL:
                self.check_b1()
                if self.b1 < _i32(self.a0 + param):
                    self.errors += 1
                    return False
                self.setvalue(self.b1 - self.a0 - param)
                self.pb -= 1
                self.b1 = _i32(self.b1 - self.runs[self.pb])
            elif state in (_FAX_EXT, _FAX_EOL):
                self.runs[self.pa] = (self.lastx - self.a0) & 0xFFFFFFFF
                self.pa += 1
                if state == _FAX_EXT:
                    self.errors += 1
                    self.extensions += 1
                    return False
                self.need(4, False)
                if self.acc & 15:
                    self.errors += 1
                self.clr(4)
                self.eolcnt = 1
                return False
            else:
                self.errors += 1
                return False
        return True

    def fill(self, row: int):
        """_TIFFFax3fillruns into output row `row` (runs cut at lastx)."""
        runs, start, end = self.runs, self.thisrun, self.pa
        if (end - start) & 1:
            runs[end] = 0
            end += 1
        bits = np.zeros(self.out.shape[1] * 8, np.uint8)
        x = 0
        for i in range(start, end):
            run = runs[i]
            if (x + run) & 0xFFFFFFFF > self.lastx or run > self.lastx:
                run = runs[i] = self.lastx - x
            if run:
                bits[x:x + run] = (i - start) & 1
                x += run
        self.out[row] = np.packbits(bits)

    def decode(self, kind: str):
        """Fax3DecodeRLE, Fax3Decode1D, Fax3Decode2D or Fax4Decode over the
        strip: (status, rows decoded), status as mm_ccitt_decode's."""
        rows = self.out.shape[0]
        for line in range(rows):
            self.a0 = self.rl = 0
            self.pa = self.thisrun = self.cur
            self.pb, self.b1 = self.ref + 1, self.runs[self.ref]
            try:
                if kind in ("rle", "rlew"):
                    self.expand1d()
                elif kind == "g4":
                    self.expand2d()
                    if self.eolcnt:
                        raise _FaxEnd
                else:
                    try:
                        self.sync_eol()
                        one_d = True
                        if kind == "g3_2d":
                            self.need(1, False)
                            one_d = self.acc & 1
                            self.clr(1)
                    except _FaxEnd:
                        self.cleanup()
                        raise
                    if one_d:
                        try:
                            self.expand1d()
                        except _FaxEnd:
                            if kind == "g3":
                                self.cleanup()
                            raise
                    else:
                        self.expand2d()
            except _FaxEnd:
                if kind == "g4":
                    self.need_eofb()
                self.fill(line)
                if kind != "g4" or line == 0:
                    return -1, line
                return (-2 if line + 1 < rows else 0), line + 1
            self.fill(line)
            if kind in ("g3_2d", "g4"):
                if kind == "g4" or self.pa < self.thisrun + self.nruns:
                    self.setvalue(0)
                self.cur, self.ref = self.ref, self.cur
            elif kind == "rle":
                self.clr(self.avail % 8)
            elif kind == "rlew":
                self.clr(self.avail % 16)
                if self.avail == 0 and (self.cp + self.odd) % 2:
                    self.cp += 1
        return 0, rows

    def need_eofb(self):
        try:
            self.need(13, True)
        except _FaxEnd:
            pass
        self.clr(13)


def ccitt_twin(data: bytes, kind: str, width: int, rowbytes: int, rows: int,
               odd: bool) -> native.CcittStrip:
    """`native.ccitt_decode` in Python: libtiff 4.7's tif_fax3.c over one
    strip or tile, its bad code words and run clean-up included."""
    if width <= 0 or rows <= 0 or rowbytes < (width + 7) // 8:
        raise ValueError(f"CCITT strip of {rows} rows of {width} pixels in {rowbytes} bytes")
    fax = _Fax(data, kind, width, rows, rowbytes, odd)
    try:
        status, lines = fax.decode(kind)
    except _FaxFail:
        status, lines = -1, 0
    return native.CcittStrip(fax.out, status, fax.errors, fax.extensions, lines)


def read_tiff(data: bytes, twin: bool = False) -> "Decoded":
    """The first image of a TIFF as PIL opens and loads it (TiffImagePlugin
    with libtiff for compressed files), its Orientation applied as PIL's
    load applies it; `twin` decompresses LZW, PackBits, CCITT and
    ThunderScan with `lzw_twin`, `packbits_twin`, `ccitt_twin` and
    `thunderscan_twin`, and gives CIELab's RGB form by `lab_to_rgb_twin`.
    Raises ValueError where PIL raises (or where libtiff leaves Pillow's
    buffer as it was, or Pillow reads past it) and UnsupportedImage for
    old-style JPEG in separate planes."""
    f = _TiffFile(data)
    f.setup()
    px = f.decode_raw() if f.compression == 1 else f.decode_libtiff(twin)
    orientation = f.tags.get(274, ())
    if isinstance(orientation, tuple) and len(orientation) == 1 and orientation[0] in _ORIENT:
        px = np.ascontiguousarray(_ORIENT[orientation[0]](px))
    mode = {"I;16B": "I;16"}.get(f.mode, f.mode)
    return Decoded(mode, px, f.palette, twin)


TIFF_WRITE_COMPRESSIONS = {"none": 1, "packbits": 32773, "deflate": 8}


def _packbits(data: bytes) -> bytes:
    """PackBits: runs of 3-128 equal bytes as (257 - n, byte), the bytes
    between as literal runs of up to 128."""
    a = np.frombuffer(data, np.uint8)
    starts = np.flatnonzero(np.diff(a, prepend=a[:1].astype(np.int16) + 1) != 0)
    lengths = np.diff(np.append(starts, len(a)))
    out, literal = bytearray(), bytearray()

    def flush():
        for i in range(0, len(literal), 128):
            piece = literal[i:i + 128]
            out.append(len(piece) - 1)
            out.extend(piece)
        literal.clear()

    for start, n in zip(starts.tolist(), lengths.tolist()):
        if n < 3:
            literal.extend(data[start:start + n])
            continue
        flush()
        while n >= 3:
            run = min(n, 128)
            out.extend((257 - run, data[start]))
            n -= run
        literal.extend(data[start:start + n])
    flush()
    return bytes(out)


def write_tiff(path, pixels: np.ndarray, palette: Optional[np.ndarray] = None,
               compression: str = "none", predictor: int = 1, byteorder: str = "<",
               tile: Optional[tuple] = None) -> None:
    """Write (H, W) uint8 or uint16 gray, (H, W, 3) uint8 RGB, or (H, W)
    uint8 palette indices with `palette` ((n <= 256, 3) uint8), as a TIFF:
    `compression` "none", "packbits" or "deflate" (with `predictor` 2,
    horizontal differencing, or 1), `byteorder` "<" or ">", in one strip or
    in (th, tw) tiles (multiples of 16; the edge tiles padded with
    zeros)."""
    if compression not in TIFF_WRITE_COMPRESSIONS:
        raise ValueError(f"compression must be one of {tuple(TIFF_WRITE_COMPRESSIONS)}")
    if predictor not in (1, 2) or (predictor == 2 and compression != "deflate"):
        raise ValueError("predictor 2 goes with Deflate (libtiff ignores it otherwise)")
    if byteorder not in ("<", ">"):
        raise ValueError(f"byteorder must be '<' or '>', not {byteorder!r}")
    px = np.asarray(pixels)
    px = px[:, :, None] if px.ndim == 2 else px
    h, w, c = px.shape
    if not (px.dtype == np.uint8 and c in (1, 3) or px.dtype == np.uint16 and c == 1) or (
            palette is not None and (c != 1 or px.dtype != np.uint8)):
        raise ValueError(f"cannot write {px.dtype} pixels with {c} channels as a TIFF")
    if tile is not None and (tile[0] % 16 or tile[1] % 16 or min(tile) <= 0):
        raise ValueError(f"tiles of {tile}: TIFF wants multiples of 16")
    th, tw = tile or (h, w)
    if tile:
        padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, c), px.dtype)
        padded[:h, :w] = px
        parts = [padded[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        parts = [px[y:y + th] for y in range(0, h, th)]
    chunks = []
    for part in parts:
        if predictor == 2:
            part = part.copy()
            part[:, 1:] -= part[:, :-1].copy()
        raw = part.astype(byteorder + part.dtype.str[1:]).tobytes()
        if compression == "packbits":
            raw = _packbits(raw)
        elif compression == "deflate":
            raw = zlib.compress(raw, 6)
        chunks.append(raw)
    photometric = 3 if palette is not None else 1 if c == 1 else 2
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [px.dtype.itemsize * 8] * c),
               (259, 3, [TIFF_WRITE_COMPRESSIONS[compression]]), (262, 3, [photometric]),
               (277, 3, [c]), (284, 3, [1])]
    if predictor == 2:
        entries.append((317, 3, [2]))
    if palette is not None:
        cmap = np.zeros((256, 3), np.int64)
        cmap[:len(palette)] = np.asarray(palette, np.int64)[:256] * 257
        entries.append((320, 3, cmap.T.reshape(-1).tolist()))
    offsets, at = [], 8
    for chunk in chunks:
        offsets.append(at)
        at += len(chunk) + len(chunk) % 2
    counts = [len(x) for x in chunks]
    entries += ([(322, 3, [tw]), (323, 3, [th]), (324, 4, offsets), (325, 4, counts)] if tile
                else [(273, 4, offsets), (278, 4, [th]), (279, 4, counts)])
    entries.sort(key=lambda e: e[0])
    ifd_at = at
    spill_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, spill = bytearray(struct.pack(byteorder + "H", len(entries))), bytearray()
    for tag, typ, values in entries:
        value = struct.pack(byteorder + ("H" if typ == 3 else "I") * len(values), *values)
        ifd += struct.pack(byteorder + "HHI", tag, typ, len(values))
        if len(value) <= 4:
            ifd += value + bytes(4 - len(value))
        else:
            ifd += struct.pack(byteorder + "I", spill_at + len(spill))
            spill += value
    ifd += bytes(4)
    head = (b"II" if byteorder == "<" else b"MM") + struct.pack(byteorder + "HI", 42, ifd_at)
    body = b"".join(chunk + bytes(len(chunk) % 2) for chunk in chunks)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(head + body + bytes(ifd) + bytes(spill))
    os.replace(tmp, path)


# --- WebP (Pillow's WebPImagePlugin, libwebp 1.6) ------------------------------------


def _mult_hi(v: np.ndarray, coeff: int) -> np.ndarray:
    return (v * coeff) >> 8


def _yuv_clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def _upsample_rows(near: np.ndarray, far: np.ndarray, width: int) -> np.ndarray:
    """libwebp's UpsampleRgbaLinePair for output rows between the chroma
    rows `near` (weight 3) and `far` (weight 1), (n, uw) int64 each: a
    sample pair's (9a + 3b + 3c + d + 8) / 16 rounded as the packed-pair
    arithmetic rounds it, the first column (and an even width's last) from
    its own column alone."""
    n, uw = near.shape
    out = np.empty((n, width), np.int64)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    k = np.arange(1, (width - 1) // 2 + 1)
    if k.size:
        tl, t, l, c = near[:, k - 1], near[:, k], far[:, k - 1], far[:, k]
        avg = tl + t + l + c + 8
        out[:, 2 * k - 1] = (((avg + 2 * (t + l)) >> 3) + tl) >> 1
        out[:, 2 * k] = (((avg + 2 * (tl + c)) >> 3) + t) >> 1
    if width % 2 == 0:
        out[:, width - 1] = (3 * near[:, uw - 1] + far[:, uw - 1] + 2) >> 2
    return out


def webp_colour_twin(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     alpha: Optional[np.ndarray] = None) -> np.ndarray:
    """libwebp's colour stage for a lossy frame (io_dec.c EmitFancyRGB):
    the (h, w) luma and ((h + 1) // 2, (w + 1) // 2) chroma planes ->
    (h, w, 4) uint8 RGBA, the chroma upsampled between the two nearest rows
    (output row 0 from chroma row 0 alone, an even height's last row from
    the last), then yuv.h's VP8YUVToR/G/B (14-bit products, 6 fractional
    bits, clipped); alpha 255 where `alpha` ((h, w) uint8) is None. The
    numpy twin of webp_decode.cpp's planes_to_rgb."""
    h, w = y.shape
    uh = u.shape[0]
    r = np.arange(h)
    near = np.where(r % 2 == 1, (r - 1) // 2, r // 2)
    far = np.where(r == 0, 0, np.where(r % 2 == 1, np.minimum((r + 1) // 2, uh - 1), r // 2 - 1))
    uu = _upsample_rows(u.astype(np.int64)[near], u.astype(np.int64)[far], w)
    vv = _upsample_rows(v.astype(np.int64)[near], v.astype(np.int64)[far], w)
    yy = _mult_hi(y.astype(np.int64), 19077)
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = _yuv_clip8(yy + _mult_hi(vv, 26149) - 14234)
    out[..., 1] = _yuv_clip8(yy - _mult_hi(uu, 6419) - _mult_hi(vv, 13320) + 8708)
    out[..., 2] = _yuv_clip8(yy + _mult_hi(uu, 33050) - 17685)
    out[..., 3] = 255 if alpha is None else alpha
    return out


def alpha_unfilter_twin(samples: np.ndarray, alpha_filter: int) -> np.ndarray:
    """libwebp's WebPUnfilters on an ALPH plane, (h, w) uint8 -> (h, w)
    uint8: filter 0 none, 1 horizontal, 2 vertical, 3 gradient; the first
    row is predicted from the left (0 before it) under every filter but 0,
    the first column from the pixel above. The numpy twin of
    webp_decode.cpp's unfilter_alpha (the gradient along anti-diagonals)."""
    if alpha_filter == 0:
        return np.array(samples, np.uint8)
    a = samples.astype(np.int64)
    h, w = a.shape
    if alpha_filter == 1:  # column 0 down the rows, then each row from the left
        rows = np.concatenate([np.zeros((h, 1), np.int64), np.cumsum(a[:, 1:], axis=1)], 1)
        return ((np.cumsum(a[:, 0])[:, None] + rows) & 255).astype(np.uint8)
    out = a.copy()
    out[0] = np.cumsum(a[0])
    if alpha_filter == 2:
        out = np.cumsum(out, axis=0)
    else:
        out &= 255
        for d in range(1, h + w - 1):
            ys = np.arange(max(1, d - w + 1), min(h - 1, d) + 1)
            if not ys.size:
                continue
            xs = d - ys
            xm = np.maximum(xs - 1, 0)
            grad = np.clip(out[ys, xm] + out[ys - 1, xs] - out[ys - 1, xm], 0, 255)
            out[ys, xs] = (np.where(xs == 0, out[ys - 1, xs], grad) + a[ys, xs]) & 255
    return (out & 255).astype(np.uint8)


def read_webp(data: bytes, twin: bool = False) -> Decoded:
    """A RIFF/WEBP file as PIL 12.1 (libwebp 1.6) opens it: the first
    frame on its canvas, mode "RGBA" or "RGB" as PIL decides. The native
    decoder does it all; with `twin` it stops before the colour stage and
    `webp_colour_twin` and `alpha_unfilter_twin` finish a lossy frame (a
    lossless one has no twin). Raises ValueError where PIL refuses the
    file."""
    if not twin:
        mode, rgba = native.decode_webp(data)
    else:
        f = native.decode_webp_planes(data)
        mode = f.mode
        if f.rgba is not None:
            frame = f.rgba
        else:
            alpha = None if f.alpha is None else alpha_unfilter_twin(f.alpha, f.alpha_filter)
            frame = webp_colour_twin(f.y, f.u, f.v, alpha)
        rgba = np.zeros(f.canvas_hw + (4,), np.uint8)
        (top, left), (h, w) = f.offset, f.shape
        rgba[top:top + h, left:left + w] = frame
    return Decoded(mode, rgba if mode == "RGBA" else rgba[:, :, :3])


# --- JPEG 2000 (Pillow's Jpeg2KImagePlugin over OpenJPEG 2.5) ---------------------

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
_JP2_SPACES = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}
_MAX_PIXELS = 2 * 89478485  # PIL refuses images past 2 * Image.MAX_IMAGE_PIXELS


def _boxes(data: bytes, start: int, end: int):
    """The boxes in data[start:end]: (type, payload start, payload end); the
    jp2c box's length of 0 runs to `end` (any other box's is refused, as
    Pillow's BoxReader refuses it)."""
    pos = start
    while pos < end:
        if pos + 8 > end:
            raise ValueError("truncated JP2 box header")
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        head = 8
        if lbox == 1:
            if pos + 16 > end:
                raise ValueError("truncated JP2 box header")
            lbox, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif lbox == 0 and tbox == b"jp2c":
            lbox = end - pos
        if lbox < head or pos + lbox > end:
            raise ValueError(f"JP2 box {tbox!r} has a bad length")
        yield tbox, pos + head, pos + lbox
        pos += lbox


def _jp2_palette(data: bytes, a: int, b: int):
    """A pclr box as Pillow reads it: ImagePalette.getcolor over the entries
    (a colour met before keeps its first index), or None where a column is
    deeper than 8 bits. Returns (palette bytes, bytes per entry)."""
    if b - a < 3:
        raise ValueError("short pclr box")
    ne, npc = struct.unpack_from(">HB", data, a)
    if b - a < 3 + npc:
        raise ValueError("short pclr box")
    depths = data[a + 3:a + 3 + npc]
    if max(depths, default=0) > 8:
        return None
    if b - a < 3 + npc + ne * npc:
        raise ValueError("short pclr box")
    width = 4 if npc == 4 else 3
    colors, palette = {}, bytearray()
    at = a + 3 + npc
    for _ in range(ne):
        color = tuple(data[at:at + npc])
        at += npc
        if width == 3 and len(color) == 4:
            if color[3] != 255:
                raise ValueError("pclr: cannot add non-opaque RGBA color to RGB palette")
            color = color[:3]
        elif width == 4 and len(color) == 3:
            color += (255,)
        if color in colors:
            continue
        index = len(palette) // width
        if index >= 256:
            raise ValueError("pclr: cannot allocate more than 256 colors")
        colors[color] = index
        if index * width < len(palette):
            palette[index * width:index * width + width] = bytes(color)
        else:
            palette += bytes(color)
    return bytes(palette), width


def _jp2_header(data: bytes, a: int, b: int):
    """The jp2h box: Pillow's size, mode and palette (Jpeg2KImagePlugin.
    _parse_jp2_header) and the colour space OpenJPEG takes from the first
    colr box, with OpenJPEG's checks of ihdr, colr, pclr, cmap and cdef."""
    size = mode = nc = None
    palette = None
    # an ICC profile, an unknown method or enumeration, or no colr box leave
    # the colour space unspecified, for Pillow to guess from the components
    space, has_colr, has_pclr, has_cdef = "unspecified", False, False, False
    for i, (t, pa, pb) in enumerate(_boxes(data, a, b)):
        n = pb - pa
        if i == 0 and t != b"ihdr":
            raise ValueError("the jp2h box does not start with ihdr")
        if t == b"ihdr":
            if n != 14:
                raise ValueError("bad ihdr box size")
            height, width, nc, bpc = struct.unpack_from(">IIHB", data, pa)
            if nc == 0 or nc > 16384:
                raise ValueError("bad component count in ihdr")
            size = (width, height)
            mode = {1: "I;16" if (bpc & 0x7F) > 8 else "L", 2: "LA", 3: "RGB",
                    4: "RGBA"}.get(nc, mode)
        elif t == b"colr":
            if n < 3:
                raise ValueError("bad colr box size")
            meth = data[pa]
            if meth == 1 and n < 7:
                raise ValueError("bad colr box size")
            if nc == 4 and meth == 1 and struct.unpack_from(">I", data, pa + 3)[0] == 12:
                mode = "CMYK"
            if not has_colr:
                has_colr = True
                if meth == 1:
                    enumcs = struct.unpack_from(">I", data, pa + 3)[0]
                    space = _JP2_SPACES.get(enumcs, "unspecified")
        elif t == b"pclr":
            if has_pclr:
                raise ValueError("two pclr boxes")
            has_pclr = True
            if n < 3 or not 0 < struct.unpack_from(">H", data, pa)[0] <= 1024 or data[pa + 2] == 0:
                raise ValueError("bad pclr box")
            ne, npc = struct.unpack_from(">HB", data, pa)
            need = 3 + npc + sum(ne * (((d & 0x7F) + 8) // 8) for d in data[pa + 3:pa + 3 + npc])
            if n < 3 + npc or n < need:
                raise ValueError("bad pclr box")
            if mode in ("L", "LA"):
                palette = _jp2_palette(data, pa, pb)
                if palette is not None:
                    mode = "P" if mode == "L" else "PA"
        elif t == b"cmap":
            if not has_pclr:
                raise ValueError("a cmap box before the pclr box")
        elif t == b"cdef":
            if has_cdef or n < 2:
                raise ValueError("bad cdef box")
            has_cdef = True
            count = struct.unpack_from(">H", data, pa)[0]
            if count == 0 or n < 2 + 6 * count:
                raise ValueError("bad cdef box")
    if size is None or mode is None:
        raise ValueError("malformed JP2 header")
    return size, mode, space, palette


def _jpeg2000_container(data: bytes):
    """(codestream, PIL's mode, PIL's (width, height), colour space, palette)
    of a JP2 file or a raw J2K codestream, as Pillow's plugin and
    OpenJPEG's JP2 reader take them; ValueError where either refuses."""
    if data[:4] == J2K_SIGNATURE:
        if len(data) < 6:
            raise ValueError("truncated SIZ marker")
        lsiz = struct.unpack_from(">H", data, 4)[0]
        siz = data[4:4 + lsiz]
        if len(siz) < 40:
            raise ValueError("truncated SIZ marker")
        xsiz, ysiz, xosiz, yosiz = struct.unpack_from(">IIII", siz, 4)
        csiz = struct.unpack_from(">H", siz, 36)[0]
        if csiz == 1:
            if len(siz) < 39:
                raise ValueError("truncated SIZ marker")
            mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
        elif 2 <= csiz <= 4:
            mode = ("LA", "RGB", "RGBA")[csiz - 2]
        else:
            raise ValueError("unable to determine J2K image mode")
        return data, mode, (xsiz - xosiz, ysiz - yosiz), "unspecified", None
    header = codestream = None
    for i, (t, a, b) in enumerate(_boxes(data, 0, len(data))):
        if i == 0 and (t != b"jP  " or b - a != 4 or data[a:b] != b"\r\n\x87\n"):
            raise ValueError("bad JP2 signature box")
        if i == 1 and (t != b"ftyp" or b - a < 8 or (b - a - 8) % 4):
            raise ValueError("the JP2 ftyp box is not second")
        if t == b"jp2h":
            if header is not None:
                raise ValueError("two jp2h boxes")
            header = _jp2_header(data, a, b)
        elif t == b"jp2c":
            if header is None:
                raise ValueError("a jp2c box before the jp2h box")
            codestream = data[a:b]
            break
    if header is None or codestream is None:
        raise ValueError("no jp2h or jp2c box")
    size, mode, space, palette = header
    return codestream, mode, size, space, palette


def read_jpeg2000(data: bytes, twin: bool = False) -> Decoded:
    """A JP2 file or a raw J2K codestream as PIL 12.1 (OpenJPEG 2.5) opens
    it, in PIL's mode ("L", "LA", "RGB", "RGBA", "I;16", "P" with its
    palette, "PA" or "CMYK"). The native decoder does it all; with `twin`
    it stops before the inverse wavelet transform, and
    `jpeg2000_idwt_twin` and `jpeg2000_colour_twin` finish each tile.
    Raises ValueError where PIL refuses the file, and UnsupportedImage
    for high-throughput code-blocks and Part 2 multiple component
    transforms (item 11f-b)."""
    codestream, mode, (width, height), space, palette = _jpeg2000_container(data)
    if width * height > _MAX_PIXELS or width <= 0 or height <= 0:
        raise ValueError(f"image of {width} x {height} pixels, which PIL refuses")
    try:
        if not twin:
            px = native.decode_jpeg2000(codestream, mode, space, (height, width))
        else:
            co = native.decode_jpeg2000_coefficients(codestream, mode, space)
    except native.Jpeg2000Unsupported as e:
        raise UnsupportedImage(f"a JPEG 2000 file with {e}, which PIL reads and the port does "
                               f"not yet (ROADMAP.md queue 1 item 11f-b)") from e
    if twin:
        shape, dtype = native.jpeg2000_shape(mode, (height, width))
        px = np.zeros(shape, dtype)
        for tile in co.tiles:
            planes = [jpeg2000_idwt_twin(c, r, q)
                      for c, r, q in zip(tile.coef, tile.rects, tile.qmfbid)]
            jpeg2000_colour_twin(px, planes, tile.qmfbid, co.comps, tile.mct, mode,
                                 co.unpacker, co.origin, tile.rect)
    pal = None
    if palette is not None:
        raw, width_ = palette
        pal = np.frombuffer(raw[:len(raw) // width_ * width_], np.uint8).reshape(-1, width_)[:, :3]
    return Decoded(mode, px, pal)


_K97, _TWO_INVK = np.float32(1.230174105), np.float32(1.625732422)
_LIFTS = (np.float32(-0.443506852), np.float32(-0.882911075), np.float32(0.052980118),
          np.float32(1.586134342))


def _idwt53_lines(x: np.ndarray, cas: int) -> np.ndarray:
    """The reversible 5/3 synthesis along axis 1 of interleaved int32 lines
    (column i low-pass where i + cas is even), whole-sample symmetric
    extension; a line of one sample is kept, or halved toward 0 at an odd
    origin."""
    n = x.shape[1]
    if n == 1:  # C's x / 2, toward 0
        return x if cas == 0 else (x - (x >> 31)) >> 1
    idx = np.arange(n)
    left = np.abs(idx - 1)
    right = np.where(idx + 1 >= n, 2 * (n - 1) - (idx + 1), idx + 1)
    lo, hi = idx[cas::2], idx[1 - cas::2]
    x = x.copy()
    x[:, lo] = x[:, lo] - ((x[:, left[lo]] + x[:, right[lo]] + np.int32(2)) >> 2)
    x[:, hi] = x[:, hi] + ((x[:, left[hi]] + x[:, right[hi]]) >> 1)
    return x


def _idwt97_lines(x: np.ndarray, cas: int) -> np.ndarray:
    """OpenJPEG 2.5's 9/7 synthesis along axis 1 of interleaved float32
    lines: low-pass times K, high-pass times 2/K, then the four lifting
    steps x + (left + right) * c, a missing neighbour replaced by the one
    on the other side; a line of one sample is kept as it is."""
    n = x.shape[1]
    if n == 1:
        return x
    idx = np.arange(n)
    left = np.where(idx == 0, 1, idx - 1)
    right = np.where(idx + 1 >= n, idx - 1, idx + 1)
    lo, hi = idx[cas::2], idx[1 - cas::2]
    x = x.copy()
    x[:, lo] = x[:, lo] * _K97
    x[:, hi] = x[:, hi] * _TWO_INVK
    for k, c in enumerate(_LIFTS):
        at = lo if k % 2 == 0 else hi
        x[:, at] = x[:, at] + ((x[:, left[at]] + x[:, right[at]]) * c)
    return x


def jpeg2000_idwt_twin(coef: np.ndarray, rects: np.ndarray, qmfbid: int) -> np.ndarray:
    """The inverse wavelet transform of one tile-component in numpy, the twin
    of jpeg2000_decode.cpp's idwt2d: (h, w) coefficients in OpenJPEG's
    layout and the (R, 4) resolution rectangles -> (h, w) int32 (5/3) or
    float32 (9/7) samples; each resolution's rows, then its columns, the
    parity of each line from the resolution's origin."""
    a = np.array(coef, np.int32 if qmfbid == 1 else np.float32)
    lines = _idwt53_lines if qmfbid == 1 else _idwt97_lines
    for r in range(1, len(rects)):
        x0, y0, x1, y1 = (int(v) for v in rects[r])
        px0, py0, px1, py1 = (int(v) for v in rects[r - 1])
        rw, rh, sw, sh = x1 - x0, y1 - y0, px1 - px0, py1 - py0
        if rw > 0 and rh > 0:
            part = a[:rh, :rw]
            inter = np.empty_like(part)
            inter[:, x0 % 2::2] = part[:, :sw]
            inter[:, 1 - x0 % 2::2] = part[:, sw:]
            a[:rh, :rw] = lines(inter, x0 % 2)
            part = a[:rh, :rw].T
            inter = np.empty_like(part)
            inter[:, y0 % 2::2] = part[:, :sh]
            inter[:, 1 - y0 % 2::2] = part[:, sh:]
            a[:rh, :rw] = lines(inter, y0 % 2).T
    return a


# Pillow's unpackers (jpeg2000_decode.cpp's Unpacker) and YCbCr -> RGB tables
# (ConvertYCbCr.c: (int)((i - 128) * k * 64 + 0.5)).
_J2K_GRAY_L, _J2K_GRAY_I, _J2K_GRAYA_LA, _J2K_GRAY_RGB, _J2K_SRGB_RGB, _J2K_SYCC_RGB, \
    _J2K_SRGBA, _J2K_SYCCA = range(8)
_YCC = {k: np.trunc((np.arange(256) - 128) * v * 64 + 0.5).astype(np.int64)
        for k, v in (("rcr", 1.402), ("gcb", -0.34414), ("gcr", -0.71414), ("bcb", 1.772))}


def jpeg2000_colour_twin(canvas: np.ndarray, planes, qmfbid, comps: np.ndarray, mct: int,
                         mode: str, unpacker: int, origin, rect) -> None:
    """The colour stage of one tile in numpy, the twin of
    jpeg2000_decode.cpp's colour and unpack_tile, writing into `canvas`
    (PIL's image in `mode`, as native.decode_jpeg2000 returns it): the RCT
    (int32) or ICT (float32, x + v * 1.402 and so on, each product rounded)
    on the first three components under `mct`, the DC level shift with
    lrintf's rounding half to even and clipping to each component's range;
    then Pillow's unpacker over the tile buffer OpenJPEG hands it (each
    component in (prec + 7) // 8 bytes, 3 taken as 4, one after the other,
    read as if it held (w // dx) x (h // dy) samples), samples shifted to 8
    (16 for I;16) bits with Pillow's offset and rounding and truncated to
    the pixel's width, sYCC through Pillow's YCbCr tables."""
    planes = [np.array(p) for p in planes]
    nc = len(planes)
    if mct and nc >= 3:
        a, b, c = planes[:3]
        if not (a.shape == b.shape == c.shape):
            raise ValueError("components of different sizes under a multiple component transform")
        if not qmfbid[0] == qmfbid[1] == qmfbid[2]:
            raise ValueError("reversible and irreversible components under one transform")
        if qmfbid[0] == 1:
            g = a - ((b + c) >> 2)
            planes[:3] = [c + g, g, b + g]
        else:
            planes[:3] = [a + (c * np.float32(1.402)),
                          a - (b * np.float32(0.34413)) - (c * np.float32(0.71414)),
                          a + (b * np.float32(1.772))]
    samples = []
    for p, q, (dx, dy, prec, sgnd) in zip(planes, qmfbid, comps.tolist()):
        lo = -(1 << (prec - 1)) if sgnd else 0
        hi = (1 << (prec - 1)) - 1 if sgnd else (1 << prec) - 1
        shift = 0 if sgnd else 1 << (prec - 1)
        if q == 1:
            v = np.clip(p.astype(np.int64) + shift, lo, hi)
        else:
            with np.errstate(invalid="ignore"):
                r = np.rint(p.astype(np.float32)).astype(np.int64)
            v = np.clip(r + shift, lo, hi)
            v = np.where(p > np.float32(2 ** 31), hi, np.where(p < np.float32(-2 ** 31), lo, v))
        samples.append(v.astype(np.int64).ravel())
    # the tile buffer
    x0, y0, x1, y1 = (int(v) for v in rect)
    w, h = x1 - x0, y1 - y0
    ox, oy = x0 - int(origin[0]), y0 - int(origin[1])
    if w <= 0 or h <= 0 or ox < 0 or oy < 0 or ox + w > canvas.shape[1] or oy + h > canvas.shape[0]:
        raise ValueError("tile outside the image PIL allocated")
    csiz = [(int(c[2]) + 7) >> 3 for c in comps]
    csiz = [4 if z == 3 else z for z in csiz]
    chunks = [(s & ((1 << (8 * z)) - 1)).astype("<u8").view(np.uint8).reshape(-1, 8)[:, :z].ravel()
              for s, z in zip(samples, csiz)]
    buf = np.concatenate(chunks) if chunks else np.zeros(0, np.uint8)
    minimum = w * h * sum(csiz)
    if buf.size < minimum:
        buf = np.concatenate([buf, np.zeros(minimum - buf.size, np.uint8)])
    used = {_J2K_GRAY_L: 1, _J2K_GRAY_I: 1, _J2K_GRAY_RGB: 1, _J2K_GRAYA_LA: 2,
            _J2K_SRGB_RGB: 3, _J2K_SYCC_RGB: 3}.get(unpacker, 4)
    one = unpacker in (_J2K_GRAY_L, _J2K_GRAY_I, _J2K_GRAY_RGB)
    outbits = 16 if unpacker == _J2K_GRAY_I else 8
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    start, vals = 0, []
    for n in range(used):
        dx, dy, prec, sgnd = (int(v) for v in comps[n])
        z = csiz[n]
        sh = outbits - prec
        off = (1 << (prec - 1)) if sgnd else 0
        if sh < 0:
            off += 1 << (-sh - 1)
        if one:
            idx = ys * w + xs
        else:
            idx = (ys // dy) * (w // dx) + xs // dx
        pos = start + z * idx
        word = np.zeros((h, w), np.uint64)
        for k in range(z):
            word |= buf[pos + k].astype(np.uint64) << np.uint64(8 * k)
        word = (word + np.uint64(off)) & np.uint64(0xFFFFFFFF)
        word = word >> np.uint64(-sh) if sh < 0 else (word << np.uint64(sh)) & np.uint64(0xFFFFFFFF)
        vals.append(word)
        start += z * (w // dx) * (h // dy)
    region = canvas[oy:oy + h, ox:ox + w]
    if unpacker == _J2K_GRAY_I:
        region[...] = (vals[0] & np.uint64(0xFFFF)).astype(np.uint16)
        return
    v8 = [(v & np.uint64(0xFF)).astype(np.int64) for v in vals]
    if unpacker in (_J2K_GRAY_L, _J2K_GRAY_RGB):
        rgba = [v8[0], v8[0], v8[0], np.full((h, w), 255)]
    elif unpacker == _J2K_GRAYA_LA:
        rgba = [v8[0], v8[0], v8[0], v8[1]]
    else:
        rgba = v8[:3] + [v8[3] if used == 4 else np.full((h, w), 255)]
    if unpacker in (_J2K_SYCC_RGB, _J2K_SYCCA):
        y, cb, cr = rgba[:3]
        rgba[:3] = [np.clip(y + (_YCC["rcr"][cr] >> 6), 0, 255),
                    np.clip(y + ((_YCC["gcb"][cb] + _YCC["gcr"][cr]) >> 6), 0, 255),
                    np.clip(y + (_YCC["bcb"][cb] >> 6), 0, 255)]
    bands = {"L": [0], "P": [0], "LA": [0, 3], "PA": [0, 3], "RGB": [0, 1, 2]}.get(
        mode, [0, 1, 2, 3])
    out = np.stack([rgba[b] for b in bands], -1).astype(np.uint8)
    region[...] = out[..., 0] if canvas.ndim == 2 else out


def load_image(path: str, convert_rgb: bool = True, twin: bool = False) -> np.ndarray:
    """Decode one image file (see the module docstring for what comes back);
    `twin` reads a PNG with `read_png_twin`, a run-length BMP with
    `bmp_rle_twin`, LZW, PackBits, CCITT and ThunderScan TIFF strips with
    `lzw_twin`, `packbits_twin`, `ccitt_twin` and `thunderscan_twin` (and a
    CIELab TIFF's RGB form with `lab_to_rgb_twin`), a lossy WebP frame's
    colour and alpha stages with `webp_colour_twin` and
    `alpha_unfilter_twin`, and a JPEG 2000 tile's inverse wavelet transform
    and colour stage with `jpeg2000_idwt_twin` and `jpeg2000_colour_twin`
    (JPEG data, ZSTD strips and the WebP and JPEG 2000 entropy decoders
    have no twin: they take the native decoder either way; LZMA strips
    take the standard library's lzma). Raises UnsupportedImage, naming the file, for a file PIL reads
    that the port cannot, and ValueError for a damaged one."""
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
        elif data[:4] in TIFF_PREFIXES:
            img = read_tiff(data, twin)
        elif len(data) > 1 and data[:1] == b"P" and data[1:2] in b"0123456fy":
            img = read_netpbm(data)
        elif data[:4] == b"RIFF" and data[8:12] == b"WEBP":
            img = read_webp(data, twin)
        elif data[:4] == J2K_SIGNATURE or data[:12] == JP2_SIGNATURE:
            img = read_jpeg2000(data, twin)
        else:
            raise ValueError("not a PNG, JPEG, BMP, TIFF, netpbm, WebP or JPEG 2000 file")
        return img.rgb() if convert_rgb else img.raw()
    except UnsupportedImage as e:
        raise UnsupportedImage(f"{path}: {e}") from e
    except (ValueError, struct.error, zlib.error) as e:  # a damaged file
        raise ValueError(f"{path}: {e}") from e
    except RuntimeError as e:  # the native library did not build: not the file's fault
        raise RuntimeError(f"{path}: {e}") from e
