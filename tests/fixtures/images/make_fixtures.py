"""Write the PNG, BMP and netpbm fixtures that tests/test_torch_image_formats.py
and chip_smoke.py hold the port's readers (multimae_tpu_torch/data/image_io.py)
against, and expected.json: for each file the mode PIL opens it in, and the
shape and SHA-256 of PIL's convert("RGB") pixels and of its raw pixels
(np.asarray of the image, "1" as 0 / 255, alpha dropped: the port's raw
form).

    python tests/fixtures/images/make_fixtures.py

PIL writes none of these: Adam7-interlaced PNG comes from numpy and zlib
(`png_adam7`, every colour type and bit depth, each pass's rows under
filters drawn from a seed), the BMPs from `bmp` (the core, info, V3, V4, V5
and OS/2 2.x headers, palettes PIL reads as "P", "1" and "L", 16-, 24- and
32-bit pixels with the bitfields layouts PIL knows, BI_RLE8 and BI_RLE4
with every escape, bottom-up and top-down rows) and the netpbm files from
`netpbm` (P1-P6, plain and raw, maxval 1, 15, 100, 255, 1000 and 65535,
comments in the header and the data). The TIFF writers (`tiff`,
`jpeg_tiff`, `ojpeg_tiff`, `ycbcr_tiff`) write what PIL does not, the JPEG
ones with streams from PIL's JPEG encoder (`jpeg_stream`, which imports
PIL); PIL writes the rest of the TIFF files and the JPEG 2000 one, and
gives the digests in `main` (tests/fixtures/webp/ holds the WebP files).
Re-running rewrites every file; the pixels come from fixed seeds.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _filter(rows: np.ndarray, bpp: int, kinds: np.ndarray) -> bytes:
    """Each row of (h, stride) uint8 under its filter type (PNG spec 9.2)."""
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int32)
    for row, kind in zip(rows.astype(np.int32), kinds):
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - a
        elif kind == 2:
            f = row - b
        elif kind == 3:
            f = row - (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            f = row - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out += bytes([int(kind)]) + (f & 0xFF).astype(np.uint8).tobytes()
        prev = row
    return bytes(out)


def _pack(px: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, stride) bytes at `depth` bits."""
    h = px.shape[0]
    if depth == 16:
        return px.astype(">u2").reshape(h, -1).view(np.uint8)
    if depth == 8:
        return px.astype(np.uint8).reshape(h, -1)
    flat = px.reshape(h, -1).astype(np.uint8)
    per = 8 // depth
    pad = (-flat.shape[1]) % per
    flat = np.concatenate([flat, np.zeros((h, pad), np.uint8)], 1).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (flat << shifts).sum(-1).astype(np.uint8)


def png_adam7(px: np.ndarray, depth: int, color_type: int, palette=None, seed: int = 0,
              interlace: bool = True) -> bytes:
    """A PNG of samples `px` ((H, W) or (H, W, C), in range for `depth`),
    Adam7-interlaced (or not), each pass's rows filtered with types drawn
    from `seed` (palette and sub-byte images with filter 0, as encoders
    write them)."""
    rng = np.random.default_rng(seed)
    px = px[..., None] if px.ndim == 2 else px
    h, w = px.shape[:2]
    bpp = max(1, CHANNELS[color_type] * depth // 8)
    raw = b""
    for y0, x0, dy, dx in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack(sub, depth)
        kinds = (np.zeros(len(rows), np.int64) if depth < 8 or color_type == 3
                 else rng.integers(0, 5, len(rows)))
        raw += _filter(rows, bpp, kinds)
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                                       int(interlace)))]
    if palette is not None:
        out.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    out += [_chunk(b"IDAT", zlib.compress(raw, 9)), _chunk(b"IEND", b"")]
    return b"".join(out)


def _bmp_rows(px: np.ndarray, bits: int) -> bytes:
    """Bottom-up rows of packed pixels, each padded to 4 bytes."""
    h = px.shape[0]
    if bits < 8:
        rows = _pack(px[..., None], bits)
    else:
        rows = px.reshape(h, -1).astype(np.uint8)
    stride = ((px.shape[1] * bits + 31) >> 3) & ~3
    rows = np.concatenate([rows, np.zeros((h, stride - rows.shape[1]), np.uint8)], 1)
    return rows.tobytes()


def bmp(body: bytes, width: int, height: int, bits: int, header: int = 40,
        compression: int = 0, palette=None, masks=(), top_down: bool = False,
        colors: int = 0) -> bytes:
    """A BMP of `body` (the pixel data as stored) behind a `header`-byte
    info header (12: OS/2 core; 40, 52, 56, 64, 108, 124), a palette of
    (n, 3) RGB entries and BI_BITFIELDS `masks` (in the header from 52
    bytes on, after a 40-byte one)."""
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
        table = b"" if palette is None else b"".join(bytes([b, g, r]) for r, g, b in palette)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                           bits, compression, len(body), 2835, 2835, colors, 0)
        extra = b"".join(struct.pack("<I", m) for m in masks)
        if header == 40:
            info += extra
        else:
            info += (extra + bytes(header - 40))[:header - 40]
        table = b"" if palette is None else b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    offset = 14 + len(info) + len(table)
    return struct.pack("<2sIHHI", b"BM", offset + len(body), 0, 0, offset) + info + table + body


def rle8(rows, width: int) -> bytes:
    """BI_RLE8 of index rows (bottom-up as given): runs of equal pixels as
    encoded runs, others as absolute runs (padded to 16 bits), an end of
    line after each row and an end of bitmap."""
    out = bytearray()
    for row in rows:
        x = 0
        while x < width:
            run = 1
            while x + run < width and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 3 or width - x < 3:
                out += bytes([run, row[x]])
                x += run
                continue
            n = 3
            while x + n < width and n < 255 and not (
                    x + n + 2 < width and row[x + n] == row[x + n + 1] == row[x + n + 2]):
                n += 1
            out += bytes([0, n]) + bytes(row[x:x + n]) + (b"\x00" if n % 2 else b"")
            x += n
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def netpbm(magic: str, px: np.ndarray, maxval: int = 255, comment: bool = False) -> bytes:
    """A netpbm file of `px` ((H, W) or (H, W, 3), values in 0..maxval; 0/1
    bits for P1 and P4, 1 black): plain (P1-P3) or raw (P4-P6)."""
    h, w = px.shape[:2]
    head = f"{magic}\n" + ("# written by make_fixtures\n" if comment else "") + f"{w} {h}\n"
    if magic not in ("P1", "P4"):
        head += f"{maxval}\n"
    if magic == "P4":
        return head.encode() + np.packbits(px.astype(np.uint8), axis=1).tobytes()
    if magic in ("P5", "P6"):
        return head.encode() + px.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    lines = []
    for r, row in enumerate(px.reshape(h, -1)):
        text = (" " if magic != "P1" else "").join(str(int(v)) for v in row)
        lines.append(text + (" # row %d" % r if comment and r % 3 == 1 else ""))
    return head.encode() + "\n".join(lines).encode() + b"\n"


# --- TIFF: a hand writer for the files PIL does not write (tiles, planar 2,
# FillOrder 2, BigTIFF, big-endian compressed files, predictor 3, old-style
# LZW), with its own LZW and PackBits encoders --------------------------------------

REVERSE_BITS = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


def lzw_encode(data: bytes, compat: bool = False) -> bytes:
    """TIFF LZW as libtiff writes it: a Clear code, codes of 9-12 bits
    MSB-first, widened one code early, a Clear code where the table fills
    and an EOI code. `compat` writes the old LSB-first codes, widened on
    time, that libtiff still reads."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, nbits):
        nonlocal acc, nacc
        if compat:
            acc |= code << nacc
        else:
            acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            if compat:
                out.append(acc & 0xFF)
                acc >>= 8
            else:
                out.append((acc >> (nacc - 8)) & 0xFF)
                acc &= (1 << (nacc - 8)) - 1
            nacc -= 8

    def grow(next_code, nbits):  # the width after an entry is added
        if next_code == 4094:
            put(256, nbits)
            return 9, True
        limit = (1 << nbits) if compat else (1 << nbits) - 1
        return (nbits + 1 if next_code > limit else nbits), False

    table, nbits, next_code, prefix = {}, 9, 258, None
    put(256, nbits)
    for c in data:
        if prefix is None:
            prefix = c
            continue
        code = table.get((prefix, c))
        if code is not None:
            prefix = code
            continue
        put(prefix, nbits)
        table[(prefix, c)] = next_code
        next_code += 1
        prefix = c
        nbits, cleared = grow(next_code, nbits)
        if cleared:
            table, next_code = {}, 258
    if prefix is not None:
        put(prefix, nbits)
        nbits, _ = grow(next_code + 1, nbits)
    put(257, nbits)
    if nacc:
        out.append((acc if compat else acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3-128 equal bytes as (257 - n, byte), the rest as
    literal runs of up to 128 bytes."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 3:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _tiff_rows(px: np.ndarray, bits: int, order: str, predictor: int) -> np.ndarray:
    """(h, w, c) samples -> (h, row bytes) as a TIFF stores them, after the
    predictor (2: each sample less the one a pixel before; 3: libtiff's
    byte planes of each row, most significant first, then bytes less the
    one a pixel before)."""
    h, w, c = px.shape
    if predictor == 2:
        u = px.view(px.dtype.str.replace("i", "u")) if px.dtype.kind == "i" else px
        d = u.copy()
        d[:, 1:] = u[:, 1:] - u[:, :-1]
        px = d.view(px.dtype)
    if bits < 8:
        return _pack(px, bits)
    if bits == 12:  # two samples in three bytes, most significant first
        flat = px.reshape(h, -1).astype(np.uint32)
        flat = np.concatenate([flat, np.zeros((h, flat.shape[1] % 2), np.uint32)], 1)
        pairs = (flat[:, 0::2] << 12) | flat[:, 1::2]
        out = np.stack([pairs >> 16, pairs >> 8, pairs], -1).astype(np.uint8).reshape(h, -1)
        return out[:, :(w * c * 12 + 7) // 8]
    if predictor == 3:
        size = px.dtype.itemsize
        planes = px.astype(">" + px.dtype.str[1:]).reshape(h, w * c).view(np.uint8)
        planes = planes.reshape(h, w * c, size).transpose(0, 2, 1).reshape(h, -1)
        out = planes.copy()
        out[:, c:] = planes[:, c:] - planes[:, :-c]
        return out
    return px.astype(order + px.dtype.str[1:]).reshape(h, -1).view(np.uint8)


def tiff(px: np.ndarray, photometric: int, *, bits: int = 0, order: str = "<",
         bigtiff: bool = False, compression: int = 1, predictor: int = 1, planar: int = 1,
         fillorder: int = 1, tile=None, rows_per_strip: int = 0, extra=(), sample_format=None,
         colormap=None, orientation: int = 0, lzw_compat: bool = False, tags=(),
         chunks=None) -> bytes:
    """A TIFF of samples `px` ((H, W) or (H, W, C); uint8/16/32, int16/32 or
    float32; `bits` 1, 2 or 4 for packed uint8 samples, 12 for uint16): byte `order` "<"
    or ">", classic or BigTIFF, in strips of `rows_per_strip` rows (all by
    default) or (th, tw) tiles (the edge tiles padded), chunky or planar,
    compression 1 (none), 5 (LZW), 8 or 32946 (Deflate) or 32773
    (PackBits), predictor 1, 2 or 3, FillOrder 2 reversing every stored
    byte's bits; `tags` extra (tag, type, values) entries (type 5, RATIONAL,
    takes numerators and denominators in turn; type 7, UNDEFINED, bytes).
    `chunks` gives the strips or tiles' stored bytes instead (`px` then
    only sizes the image)."""
    px = np.asarray(px)
    px = px[..., None] if px.ndim == 2 else px
    h, w, c = px.shape
    bits = bits or px.dtype.itemsize * 8
    planes = [px[..., i:i + 1] for i in range(c)] if planar == 2 else [px]
    th, tw = tile or (rows_per_strip or h, w)
    given, chunks = chunks, []
    for plane in planes if given is None else ():
        if tile:
            padded = np.zeros((-(-h // th) * th, -(-w // tw) * tw, plane.shape[2]), plane.dtype)
            padded[:h, :w] = plane
            parts = [padded[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
        else:
            parts = [plane[y:y + th] for y in range(0, h, th)]
        for part in parts:
            raw = _tiff_rows(np.ascontiguousarray(part), bits, order, predictor).tobytes()
            if compression == 5:
                raw = lzw_encode(raw, lzw_compat)
            elif compression in (8, 32946):
                raw = zlib.compress(raw, 6)
            elif compression == 32773:
                raw = packbits_encode(raw)
            if fillorder == 2:
                raw = REVERSE_BITS[np.frombuffer(raw, np.uint8)].tobytes()
            chunks.append(raw)
    chunks = chunks if given is None else list(given)
    head = 16 if bigtiff else 8
    offsets, at = [], head
    for chunk in chunks:
        offsets.append(at)
        at += len(chunk) + len(chunk) % 2
    kind = 16 if bigtiff else 4
    fmt = {1: 1, "u": 1, "i": 2, "f": 3}
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * c), (259, 3, [compression]),
               (262, 3, [photometric]), (277, 3, [c]), (284, 3, [planar])]
    if sample_format is not None or px.dtype.kind != "u":
        entries.append((339, 3, list(sample_format or [fmt[px.dtype.kind]] * c)))
    if fillorder != 1:
        entries.append((266, 3, [fillorder]))
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    if orientation:
        entries.append((274, 3, [orientation]))
    if extra:
        entries.append((338, 3, list(extra)))
    if colormap is not None:
        entries.append((320, 3, [int(v) for v in np.asarray(colormap).T.reshape(-1)]))
    if tile:
        entries += [(322, 3, [tw]), (323, 3, [th]), (324, kind, offsets),
                    (325, kind, [len(x) for x in chunks])]
    else:
        entries += [(273, kind, offsets), (278, 4, [th]), (279, kind, [len(x) for x in chunks])]
    entries = sorted(entries + list(tags), key=lambda e: e[0])
    codes = {3: "H", 4: "I", 5: "I", 16: "Q"}
    slot, count_fmt = (8, "Q") if bigtiff else (4, "I")
    ifd_at = at
    size = (8 if bigtiff else 2) + len(entries) * (20 if bigtiff else 12) + slot
    values_at = ifd_at + size
    body, spill = bytearray(), bytearray()
    body += struct.pack(order + ("Q" if bigtiff else "H"), len(entries))
    for tag, typ, values in entries:
        data = (bytes(values) if typ == 7
                else struct.pack(order + codes[typ] * len(values), *values))
        count = len(values) // 2 if typ == 5 else len(values)
        body += struct.pack(order + "HH" + count_fmt, tag, typ, count)
        if len(data) <= slot:
            body += data + bytes(slot - len(data))
        else:
            body += struct.pack(order + count_fmt, values_at + len(spill))
            spill += data + bytes(len(data) % 2)
    body += bytes(slot)
    magic = b"II" if order == "<" else b"MM"
    header = (magic + struct.pack(order + "HHHQ", 43, 8, 0, ifd_at) if bigtiff
              else magic + struct.pack(order + "HI", 42, ifd_at))
    data = bytearray(header)
    for chunk in chunks:
        data += chunk + bytes(len(chunk) % 2)
    return bytes(data + body + spill)


def jpeg_stream(px: np.ndarray, subsampling: int = 2, quality: int = 85, keep_rgb: bool = False,
                restart_rows: int = 0) -> bytes:
    """PIL's JPEG encoder (imported here alone) on (H, W) gray, (H, W, 3)
    RGB (YCbCr components, or with `keep_rgb` the samples as they are,
    Adobe transform 0) or (H, W, 4) CMYK uint8: `subsampling` 0 (4:4:4),
    1 (4:2:2) or 2 (4:2:0), a restart marker every `restart_rows` MCU
    rows."""
    from PIL import Image

    px = np.ascontiguousarray(px, np.uint8)
    mode = "L" if px.ndim == 2 else {3: "RGB", 4: "CMYK"}[px.shape[2]]
    kw = {"quality": quality, "subsampling": subsampling}
    if keep_rgb:
        kw["keep_rgb"] = True
    if restart_rows:
        kw["restart_marker_rows"] = restart_rows
    buf = io.BytesIO()
    Image.fromarray(px, mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def jpeg_segments(stream: bytes):
    """The marker segments of a JPEG stream up to its first SOS, as
    (marker, whole segment) pairs, and the rest from that SOS on."""
    out, pos = [], 2
    while stream[pos + 1] != 0xDA:
        length = struct.unpack_from(">H", stream, pos + 2)[0]
        out.append((stream[pos + 1], stream[pos:pos + 2 + length]))
        pos += 2 + length
    return out, stream[pos:]


def split_jpeg(stream: bytes, keep_app: bool = False):
    """(tables-only stream, abbreviated stream) of a JPEG: its DQT and DHT
    segments between SOI and EOI, and the rest (APPn segments dropped,
    as libtiff writes none, unless `keep_app`)."""
    segments, rest = jpeg_segments(stream)
    tables = b"".join(seg for m, seg in segments if m in (0xDB, 0xC4))
    image = b"".join(seg for m, seg in segments
                     if m not in (0xDB, 0xC4) and (keep_app or not 0xE0 <= m <= 0xEF))
    return b"\xff\xd8" + tables + b"\xff\xd9", b"\xff\xd8" + image + rest


SUBSAMPLING = {0: (1, 1), 1: (2, 1), 2: (2, 2)}  # PIL's subsampling -> YCbCrSubsampling


def jpeg_tiff(px: np.ndarray, photometric: int = 6, *, subsampling: int = 2, quality: int = 85,
              rows_per_strip: int = 0, tile=None, tables: bool = True, keep_app: bool = False,
              planar: int = 1, sampling_tag: bool = True, order: str = "<", tags=()) -> bytes:
    """A JPEG-compressed TIFF (compression 7) of uint8 `px`, each strip
    (the last one as tall as its rows) or (th, tw) tile (edge tiles padded
    by repeating the edge) its own stream from PIL's encoder: photometric
    6 (YCbCr components, YCbCrSubsampling from `subsampling` unless not
    `sampling_tag`), 2 (RGB samples as they are, 4:4:4), 1 (gray) or 5
    (CMYK); planar 2 codes each sample plane as a gray stream. With
    `tables` the DQT and DHT segments go to JPEGTables (tag 347), one copy
    for the file, and the streams are abbreviated."""
    px = np.asarray(px, np.uint8)
    px3 = px[..., None] if px.ndim == 2 else px
    h, w, c = px3.shape
    th, tw = tile or (rows_per_strip or h, w)
    planes = [px3[..., i:i + 1] for i in range(c)] if planar == 2 else [px3]
    streams = []
    for plane in planes:
        if tile:
            padded = np.pad(plane, ((0, -h % th), (0, -w % tw), (0, 0)), mode="edge")
            parts = [padded[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
        else:
            parts = [plane[y:y + th] for y in range(0, h, th)]
        for part in parts:
            part = part[..., 0] if part.shape[2] == 1 else part
            streams.append(jpeg_stream(part, subsampling if photometric == 6 else 0, quality,
                                       keep_rgb=photometric == 2))
    tg = list(tags)
    if tables:
        pairs = [split_jpeg(s, keep_app) for s in streams]
        table_streams = {t for t, _ in pairs}
        assert len(table_streams) == 1, "the streams differ in their tables"
        tg.append((347, 7, table_streams.pop()))
        streams = [image for _, image in pairs]
    if photometric == 6 and sampling_tag:
        tg.append((530, 3, list(SUBSAMPLING[subsampling])))
    return tiff(px3, photometric, order=order, compression=7, planar=planar, tile=tile,
                rows_per_strip=rows_per_strip, tags=tg, chunks=streams)


def patch_tiff_tag(data: bytes, tag: int, values) -> bytes:
    """A little-endian classic TIFF with the LONG values of `tag` (as
    many as it holds) replaced, where they sit inline or elsewhere."""
    data = bytearray(data)
    at = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, at)[0]):
        entry = at + 2 + 12 * i
        if struct.unpack_from("<H", data, entry)[0] == tag:
            count = struct.unpack_from("<I", data, entry + 4)[0]
            where = entry + 8 if count == 1 else struct.unpack_from("<I", data, entry + 8)[0]
            struct.pack_into(f"<{count}I", data, where, *values)
            return bytes(data)
    raise KeyError(tag)


def _scan_pieces(rest: bytes):
    """The SOS segment of a JPEG's scan and its entropy-coded data cut at
    each RST marker (the markers dropped), up to EOI."""
    sos = rest[:2 + struct.unpack_from(">H", rest, 2)[0]]
    scan, pieces, start, i = rest[len(sos):], [], 0, 0
    while i < len(scan) - 1:
        if scan[i] == 0xFF and 0xD0 <= scan[i + 1] <= 0xD9:
            pieces.append(scan[start:i])
            if scan[i + 1] == 0xD9:
                break
            start = i = i + 2
        else:
            i += 1
    return sos, pieces


def ojpeg_tiff(px: np.ndarray, *, subsampling: int = 2, rows_per_strip: int = 16,
               form: str = "tables", sampling_tag: bool = True, quality: int = 85,
               photometric: int = 6, tile=None) -> bytes:
    """An old-style JPEG TIFF (compression 6) of (H, W, 3) RGB or (H, W)
    gray uint8: one stream from PIL's encoder for the whole image with a
    restart marker after each strip's MCU rows; each strip holds the
    entropy-coded data of its restart interval. `form` "tables" gives the
    tables in JPEGQTables, JPEGDCTables and JPEGACTables (519-521, one per
    component) with JPEGProc and JPEGRestartInterval; "jif" points
    JPEGInterchangeFormat (513/514) at the whole stream; "jif_header" at
    its header alone (SOI to SOS). With `tile` (th, tw) the stream is the
    tiles one above the other in their order, as wide as one, the image
    padded to them by repeating its edge, each a restart interval (the
    tables form, whose frame libtiff makes as tall as one column of
    tiles, only for one column)."""
    px = np.asarray(px, np.uint8)
    gray = px.ndim == 2
    h, w = px.shape[:2]
    hs, vs = (1, 1) if gray else SUBSAMPLING[subsampling]
    rows_per_strip = tile[0] if tile else rows_per_strip
    coded = px
    if tile:
        th, tw = tile
        pad = ((0, -h % th), (0, -w % tw)) + (() if gray else ((0, 0),))
        padded = np.pad(px, pad, mode="edge")
        coded = np.concatenate([padded[y:y + th, x:x + tw] for y in range(0, h, th)
                                for x in range(0, w, tw)], 0)
    full = jpeg_stream(coded, 0 if gray else subsampling, quality,
                       restart_rows=rows_per_strip // (8 * vs))
    segments, rest = jpeg_segments(full)
    sos, pieces = _scan_pieces(rest)
    spp = 1 if gray else 3
    tags = [(530, 3, [hs, vs])] if sampling_tag and not gray else []
    if form == "tables":
        tags += [(512, 3, [1]), (515, 3, [-(-coded.shape[1] // (8 * hs))
                                          * (rows_per_strip // (8 * vs))]),
                 (519, 4, [0] * spp), (520, 4, [0] * spp), (521, 4, [0] * spp)]
    else:
        tags += [(513, 4, [0]), (514, 4, [0])]
    data = tiff(px, photometric if not gray else 1, compression=6, tile=tile,
                rows_per_strip=0 if tile else rows_per_strip, tags=tags, chunks=pieces)
    base = len(data)
    if form == "tables":
        q, dc, ac = {}, {}, {}
        for marker, seg in segments:
            body, at = seg[4:], 0
            while marker in (0xDB, 0xC4) and at < len(body):
                if marker == 0xDB:
                    q[body[at] & 15] = body[at + 1:at + 65]
                    at += 65
                else:
                    n = 17 + sum(body[at + 1:at + 17])
                    (ac if body[at] >> 4 else dc)[body[at] & 15] = body[at + 1:at + n]
                    at += n
        sof = next(seg for marker, seg in segments if marker == 0xC0)
        blobs, offsets = b"", {519: [], 520: [], 521: []}
        for k in range(spp):
            table = 0 if k == 0 else 1  # PIL codes chroma with tables 1
            for tag, blob in ((519, q[sof[12 + 3 * k]]), (520, dc[table]), (521, ac[table])):
                offsets[tag].append(base + len(blobs))
                blobs += blob
        data += blobs
        for tag, values in offsets.items():
            data = patch_tiff_tag(data, tag, values)
        return data
    jif = full if form == "jif" else b"\xff\xd8" + b"".join(s for _, s in segments) + sos
    return patch_tiff_tag(patch_tiff_tag(data + jif, 513, [base]), 514, [len(jif)])


def rgb_to_ycbcr(rgb: np.ndarray, hs: int, vs: int):
    """(Y, Cb, Cr) uint8 of RGB by the JPEG (CCIR 601) formulas, chroma
    averaged over each hs x vs unit (edge units over the pixels they
    hold)."""
    x = rgb.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    cb = 128 + (x[..., 2] - y) / 1.772
    cr = 128 + (x[..., 0] - y) / 1.402
    h, w = y.shape
    uh, uw = -(-h // vs), -(-w // hs)

    def down(c):
        sums = np.zeros((uh, uw))
        counts = np.zeros((uh, uw))
        np.add.at(sums, (np.arange(h)[:, None] // vs, np.arange(w)[None, :] // hs), c)
        np.add.at(counts, (np.arange(h)[:, None] // vs, np.arange(w)[None, :] // hs), 1)
        return sums / counts

    to8 = lambda a: np.clip(np.round(a), 0, 255).astype(np.uint8)  # noqa: E731
    return to8(y), to8(down(cb)), to8(down(cr))


def ycbcr_units(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int) -> bytes:
    """TIFF's packed YCbCr data units of an image or tile: per unit hs x vs
    luma samples row by row, then Cb and Cr; partial units padded by
    repeating the edge."""
    h, w = y.shape
    uh, uw = -(-h // vs), -(-w // hs)
    yp = np.pad(y, ((0, uh * vs - h), (0, uw * hs - w)), mode="edge")
    blocks = yp.reshape(uh, vs, uw, hs).transpose(0, 2, 1, 3).reshape(uh, uw, hs * vs)
    return np.concatenate([blocks, cb[:uh, :uw, None], cr[:uh, :uw, None]], -1).tobytes()


def ycbcr_tiff(rgb: np.ndarray, hs: int, vs: int, *, compression: int = 5,
               rows_per_strip: int = 0, tile=None, predictor: int = 1, tags=(),
               step: int = 1) -> bytes:
    """A YCbCr TIFF (photometric 6, YCbCrSubsampling hs x vs) of (H, W, 3)
    RGB uint8 in data units (`ycbcr_units`; samples rounded down to
    multiples of `step`, which compress), compressed with LZW (5),
    Deflate (8) or PackBits (32773), horizontal differencing over each
    scanline's bytes three apart with `predictor` 2 (where libtiff undoes
    it: scanlines of whole pixels that tile the data). A 530 entry in `tags`
    stands in for the YCbCrSubsampling tag the units were made for."""
    y, cb, cr = (c // step * step for c in rgb_to_ycbcr(np.asarray(rgb, np.uint8), hs, vs))
    h, w = y.shape
    parts = []
    if tile:
        th, tw = tile
        hp, wp = -(-h // th) * th, -(-w // tw) * tw
        y = np.pad(y, ((0, hp - h), (0, wp - w)), mode="edge")
        cb, cr = (np.pad(c, ((0, hp // vs - len(c)), (0, wp // hs - c.shape[1])), mode="edge")
                  for c in (cb, cr))
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                tile_c = [c[ty // vs:(ty + th) // vs, tx // hs:(tx + tw) // hs] for c in (cb, cr)]
                parts.append((ycbcr_units(y[ty:ty + th, tx:tx + tw], *tile_c, hs, vs), 3 * tw))
    else:
        rps = rows_per_strip or h
        uw = -(-w // hs)
        for ty in range(0, h, rps):
            parts.append((ycbcr_units(y[ty:ty + rps], cb[ty // vs:], cr[ty // vs:], hs, vs),
                          uw * (hs * vs + 2) // vs))
    chunks = []
    for raw, rowsize in parts:
        if predictor == 2 and len(raw) % rowsize == 0 and rowsize % 3 == 0:
            rows = np.frombuffer(raw, np.uint8).reshape(-1, rowsize).astype(np.int16)
            rows[:, 3:] = rows[:, 3:] - rows[:, :-3].copy()
            raw = rows.astype(np.uint8).tobytes()
        chunks.append(lzw_encode(raw) if compression == 5 else zlib.compress(raw, 6)
                      if compression == 8 else packbits_encode(raw))
    extra = ([] if any(t[0] == 530 for t in tags) else [(530, 3, [hs, vs])])
    extra += [(317, 3, [2])] if predictor == 2 else []
    return tiff(np.zeros((h, w, 3), np.uint8), 6, compression=compression, tile=tile,
                rows_per_strip=0 if tile else rows_per_strip, tags=extra + list(tags),
                chunks=chunks)


def photo(hw, seed, noise=8.0):
    """A smooth photo-like RGB image with a little noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (5 + 3 * c) + yy / (7 + 2 * c) + c) for c in range(3)],
                 -1)
    return np.clip(a + rng.normal(0, noise, a.shape), 0, 255).astype(np.uint8)


def files(tree_hw=(48, 64)):
    """{name: bytes} of every fixture (the TIFF and JPEG 2000 ones
    aside). The `tree_*` files share the size `tree_hw`, so that
    chip_smoke.py builds a pretraining tree of them."""
    rng = np.random.default_rng(0)
    out = {}
    # Adam7 PNG: every colour type and depth, sizes with empty passes.
    for i, (ct, depth) in enumerate([(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
                                     (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
                                     (6, 16)]):
        hw = [(33, 47), (1, 1), (3, 5), (9, 2)][i % 4] if i < 12 else (17, 19)
        top = (1 << depth) - 1
        px = rng.integers(0, top + 1, hw + ((CHANNELS[ct],) if CHANNELS[ct] > 1 else ()))
        palette = rng.integers(0, 256, (min(256, top + 1) - (i % 2), 3)) if ct == 3 else None
        out[f"adam7_ct{ct}_d{depth}.png"] = png_adam7(px, depth, ct, palette, seed=i)
    out["tree_adam7_rgb.png"] = png_adam7(photo(tree_hw, 1), 8, 2, seed=20)

    # BMP: headers, depths, palettes, bitfields, RLE, row order.
    hw = (13, 22)
    h, w = hw
    idx8 = rng.integers(0, 200, hw)
    pal = rng.integers(0, 256, (200, 3))
    rgb = photo(hw, 2)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    flip = lambda a: a[::-1]  # noqa: E731  bottom-up rows
    out["bmp_core_24.bmp"] = bmp(_bmp_rows(flip(bgr), 24), w, h, 24, header=12)
    out["bmp_core_p8.bmp"] = bmp(_bmp_rows(flip(idx8), 8), w, h, 8, header=12,
                                 palette=np.concatenate([pal, np.zeros((56, 3), int)]))
    out["bmp_p8.bmp"] = bmp(_bmp_rows(flip(idx8), 8), w, h, 8, palette=pal, colors=200)
    out["bmp_p8_top_down.bmp"] = bmp(_bmp_rows(idx8, 8), w, h, 8, palette=pal, colors=200,
                                     top_down=True)
    idx4 = rng.integers(0, 16, hw)
    out["bmp_p4.bmp"] = bmp(_bmp_rows(flip(idx4), 4), w, h, 4, palette=pal[:16])
    out["bmp_p4_short_palette.bmp"] = bmp(_bmp_rows(flip(idx4), 4), w, h, 4, palette=pal[:5],
                                          colors=5)
    idx1 = rng.integers(0, 2, hw)
    out["bmp_p1.bmp"] = bmp(_bmp_rows(flip(idx1), 1), w, h, 1, palette=pal[:2])
    out["bmp_mode1.bmp"] = bmp(_bmp_rows(flip(idx1), 1), w, h, 1,
                               palette=[(0, 0, 0), (255, 255, 255)])
    gray = np.arange(256)[:, None].repeat(3, 1)
    out["bmp_gray_l.bmp"] = bmp(_bmp_rows(flip(idx8), 8), w, h, 8, palette=gray)
    # A gray-ramp palette makes PIL read 4-bit pixels a byte each: 4 pixels
    # fit a row of 4 bytes; 22 do not, and PIL refuses the file.
    out["bmp_gray4_narrow.bmp"] = bmp(_bmp_rows(flip(idx4[:, :4]), 4), 4, h, 4,
                                      palette=gray[:16])
    out["refused_bmp_gray4_wide.bmp"] = bmp(_bmp_rows(flip(idx4), 4), w, h, 4, palette=gray[:16])
    v16 = rng.integers(0, 1 << 16, hw)
    rows16 = lambda a: _bmp_rows(flip(a.astype("<u2").view(np.uint8).reshape(h, -1)), 8)  # noqa
    out["bmp_16_555.bmp"] = bmp(rows16(v16), w, h, 16)
    out["bmp_16_565_bitfields.bmp"] = bmp(rows16(v16), w, h, 16, compression=3,
                                          masks=(0xF800, 0x7E0, 0x1F))
    out["bmp_16_555_v3.bmp"] = bmp(rows16(v16), w, h, 16, header=56, compression=3,
                                   masks=(0x7C00, 0x3E0, 0x1F, 0))
    out["bmp_24.bmp"] = bmp(_bmp_rows(flip(bgr), 24), w, h, 24)
    out["bmp_24_os2v2.bmp"] = bmp(_bmp_rows(flip(bgr), 24), w, h, 24, header=64)
    alpha = rng.integers(0, 256, hw + (1,))
    for name, masks, order in [
            ("bmp_32.bmp", None, "BGRX"),
            ("bmp_32_bgra_v4.bmp", (0xFF0000, 0xFF00, 0xFF, 0xFF000000), "BGRA"),
            ("bmp_32_abgr_v5.bmp", (0xFF000000, 0xFF0000, 0xFF00, 0xFF), "ABGR"),
            ("bmp_32_rgba_v5.bmp", (0xFF, 0xFF00, 0xFF0000, 0xFF000000), "RGBA"),
            ("bmp_32_xbgr_bitfields.bmp", (0xFF000000, 0xFF0000, 0xFF00), "XBGR")]:
        chans = {"R": rgb[..., 0:1], "G": rgb[..., 1:2], "B": rgb[..., 2:3], "A": alpha,
                 "X": np.zeros_like(alpha)}
        px = np.concatenate([chans[c] for c in order], -1)
        header = 124 if "v5" in name else 108 if "v4" in name else 40
        out[name] = bmp(_bmp_rows(flip(px), 32), w, h, 32, header=header,
                        compression=0 if masks is None else 3, masks=masks or ())
    # Run-length: encoded and absolute runs, end of line, delta, end of bitmap.
    runs = np.repeat(rng.integers(0, 200, (h, 6)), [2, 5, 1, 7, 3, 4], axis=1)[:, :w]
    out["bmp_rle8.bmp"] = bmp(rle8(flip(runs), w), w, h, 8, compression=1, palette=pal)
    out["bmp_rle8_gray.bmp"] = bmp(rle8(flip(runs), w), w, h, 8, compression=1, palette=gray)
    # Every escape, laid out as PIL reads it: an odd absolute run and its
    # pad byte, end of line, a delta (PIL reads two bytes before the pair
    # it uses), an encoded run past the row's end (cut there).
    escapes = bytes([4, 7, 0, 3, 1, 2, 3, 0, 0, 0,
                     3, 9, 0, 2, 9, 9, 2, 0, 30, 11, 0, 0,
                     0, 4, 1, 2, 3, 4, 2, 5, 0, 0,
                     8, 6, 0, 1])
    out["bmp_rle8_escapes.bmp"] = bmp(escapes, 8, 4, 8, compression=1, palette=pal)
    # RLE4: PIL reads an absolute run of n pixels as n // 2 bytes.
    rle4 = bytes([5, 0x12, 0, 5, 0x34, 0x56, 0, 0,
                  6, 0xAB, 0, 2, 0, 0, 2, 0, 3, 0xCD, 0, 0,
                  0, 4, 0xEF, 0x12, 6, 0x9A, 0, 1])
    out["bmp_rle4.bmp"] = bmp(rle4, 10, 3, 4, compression=2, palette=pal[:16])
    # An end of bitmap before the last row: PIL refuses it (not enough data).
    out["refused_bmp_rle8_early_end.bmp"] = bmp(escapes[:-4] + bytes([0, 1]), 8, 4, 8,
                                                compression=1, palette=pal)
    tree_idx = np.repeat(rng.integers(0, 200, (tree_hw[0], tree_hw[1] // 8)), 8, axis=1)
    out["tree_bmp_rle8.bmp"] = bmp(rle8(flip(tree_idx), tree_hw[1]), tree_hw[1], tree_hw[0], 8,
                                   compression=1, palette=pal)
    tree_bgr = np.ascontiguousarray(photo(tree_hw, 3)[..., ::-1])
    out["tree_bmp_24.bmp"] = bmp(_bmp_rows(flip(tree_bgr), 24), tree_hw[1], tree_hw[0], 24)

    # Netpbm: plain and raw, the maxvals PIL scales, 16-bit gray as "I".
    g = rng.integers(0, 256, (9, 14))
    bits = rng.integers(0, 2, (9, 13))
    c = photo((9, 14), 4)
    out["pbm_plain.pbm"] = netpbm("P1", bits, comment=True)
    out["pbm_raw.pbm"] = netpbm("P4", bits)
    out["pgm_plain_15.pgm"] = netpbm("P2", g % 16, 15, comment=True)
    out["pgm_plain_1000.pgm"] = netpbm("P2", g * 3, 1000)
    out["pgm_raw_1.pgm"] = netpbm("P5", g % 2, 1)
    out["pgm_raw_100.pgm"] = netpbm("P5", g % 101, 100, comment=True)
    out["pgm_raw_255.pgm"] = netpbm("P5", g)
    out["pgm_raw_1000.pgm"] = netpbm("P5", g * 3, 1000)
    out["pgm_raw_65535.pgm"] = netpbm("P5", g * 257, 65535)
    out["ppm_plain_100.ppm"] = netpbm("P3", c % 101, 100, comment=True)
    out["ppm_raw_50.ppm"] = netpbm("P6", c % 51, 50)
    out["ppm_raw_255.ppm"] = netpbm("P6", c)
    out["ppm_raw_65535.ppm"] = netpbm("P6", c.astype(np.int64) * 257 + 3, 65535)
    out["tree_ppm.ppm"] = netpbm("P6", photo(tree_hw, 5))
    # Damaged files, which PIL refuses too.
    out["refused_bmp_truncated.bmp"] = out["bmp_24.bmp"][:-100]
    out["refused_bmp_rle8_short.bmp"] = out["bmp_rle8.bmp"][:900]
    out["refused_pgm_plain_past_maxval.pgm"] = netpbm("P2", g, 100)
    out["refused_pgm_raw_truncated.pgm"] = out["pgm_raw_255.pgm"][:-7]
    return out


def tree_photo(hw, seed):
    """`photo` in steps of 16 levels: the TIFF tree's rgb images, which
    compress to a few KB each."""
    return photo(hw, seed, noise=1) // 16 * 16


def tiff_files(tree_hw=(48, 64)):
    """{name: bytes} of the TIFF fixtures PIL does not write, from `tiff`:
    BigTIFF, tiles, planar 2, FillOrder 2, big-endian compressed files,
    predictor 3, old-style LZW, MinIsWhite, 2- and 4-bit gray and 1-, 2-
    and 4-bit palettes, associated alpha, 16-bit RGB, an Orientation; and
    the `tree_*.tif` rgb images of chip_smoke.py's TIFF tree."""
    rng = np.random.default_rng(11)
    out = {}
    hw = (9, 14)
    c = photo(hw, 12, noise=3)
    g = rng.integers(0, 256, hw, dtype=np.uint8)
    out["tiff_bigtiff_lzw.tif"] = tiff(c, 2, bigtiff=True, compression=5, predictor=2,
                                       rows_per_strip=4)
    out["tiff_bigtiff_raw.tif"] = tiff(c, 2, bigtiff=True, rows_per_strip=4)
    out["tiff_tiles_raw.tif"] = tiff(photo((17, 20), 13, noise=3), 2, tile=(16, 16))
    out["tiff_planar_raw.tif"] = tiff(c, 2, planar=2, rows_per_strip=4)
    out["tiff_planar_rgba_lzw.tif"] = tiff(rng.integers(0, 256, hw + (4,), dtype=np.uint8), 2,
                                           planar=2, compression=5, extra=(1,))
    bits = rng.integers(0, 2, hw, dtype=np.uint8)
    out["tiff_1bit_black_raw.tif"] = tiff(bits, 1, bits=1)
    out["tiff_1bit_white_lzw.tif"] = tiff(bits, 0, bits=1, compression=5)
    out["tiff_1bit_fill2_raw.tif"] = tiff(bits, 1, bits=1, fillorder=2)
    out["tiff_1bit_fill2_packbits.tif"] = tiff(bits, 0, bits=1, fillorder=2, compression=32773)
    out["tiff_rgb_fill2_lzw.tif"] = tiff(c, 2, fillorder=2, compression=5, predictor=2)
    for b in (2, 4):
        v = rng.integers(0, 1 << b, hw, dtype=np.uint8)
        out[f"tiff_gray{b}_raw.tif"] = tiff(v, 1, bits=b)
        out[f"tiff_gray{b}_white_deflate.tif"] = tiff(v, 0, bits=b, compression=8)
    out["tiff_gray8_white_packbits.tif"] = tiff(g, 0, compression=32773)
    for b in (1, 2, 4):
        v = rng.integers(0, 1 << b, hw, dtype=np.uint8)
        cmap = rng.integers(0, 65536, (1 << b, 3))
        out[f"tiff_pal{b}_raw.tif"] = tiff(v, 3, bits=b, colormap=cmap)
        out[f"tiff_pal{b}_lzw.tif"] = tiff(v, 3, bits=b, colormap=cmap, compression=5)
    g16 = (np.add.outer(np.arange(9), np.arange(14)) * 3001 % 65536).astype(np.uint16)
    out["tiff_gray16_be_lzw_pred.tif"] = tiff(g16, 1, order=">", compression=5, predictor=2)
    out["tiff_gray16_be_raw.tif"] = tiff(g16, 1, order=">")
    out["tiff_gray16_fill2_raw.tif"] = tiff(g16, 1, fillorder=2)
    s16 = (g16.astype(np.int32) - 30000).astype(np.int16)
    out["tiff_gray16_signed_deflate.tif"] = tiff(s16, 1, compression=8, predictor=2)
    out["tiff_gray16_signed_be_raw.tif"] = tiff(s16, 1, order=">")
    i32 = (g16.astype(np.int32) - 30000) * 70001
    out["tiff_int32_be_raw.tif"] = tiff(i32, 1, order=">")
    out["tiff_int32_be_lzw.tif"] = tiff(i32, 1, order=">", compression=5)
    f32 = (g16.astype(np.float32) / 100 - 50).astype(np.float32)
    out["tiff_float32_lzw_pred3.tif"] = tiff(f32, 1, compression=5, predictor=3)
    out["tiff_float32_be_deflate_pred3.tif"] = tiff(f32, 1, order=">", compression=32946,
                                                    predictor=3)
    out["tiff_float32_be_raw.tif"] = tiff(f32, 1, order=">")
    out["tiff_rgb16_be_deflate.tif"] = tiff(c.astype(np.uint16) * 257 + 3, 2, order=">",
                                            compression=8, predictor=2)
    out["tiff_rgbx_lzw_compat.tif"] = tiff(np.concatenate([c, g[..., None]], -1), 2,
                                           extra=(0,), compression=5, lzw_compat=True)
    out["tiff_orientation6_lzw.tif"] = tiff(c, 2, compression=5, orientation=6)
    out["tiff_orientation8_raw.tif"] = tiff(c, 2, orientation=8)

    # The TIFF tree's rgb images: one per layout chip_smoke.py feeds the CLI.
    tree = [tree_photo(tree_hw, 20 + i) for i in range(4)]
    alpha = np.clip(160 + 90 * np.sin(np.arange(tree_hw[1]) / 7), 0, 255).astype(np.uint8)
    alpha = np.broadcast_to(alpha, tree_hw)[..., None]
    premultiplied = (tree[2].astype(np.int32) * alpha // 255).astype(np.uint8)
    out["tree_tiff_tiled.tif"] = tiff(tree[0], 2, tile=(16, 16), compression=5, predictor=2)
    out["tree_tiff_planar.tif"] = tiff(tree[1], 2, planar=2, compression=8, rows_per_strip=16)
    out["tree_tiff_assoc_alpha.tif"] = tiff(np.concatenate([premultiplied, alpha], -1), 2,
                                            extra=(1,), compression=5, predictor=2)
    out["tree_tiff_rgb16.tif"] = tiff(tree[3].astype(np.uint16) * 257, 2, compression=8,
                                      predictor=2, rows_per_strip=16)
    return out


def jpeg_tiff_files(tree_hw=(48, 64)):
    """{name: bytes} of the JPEG-compressed and YCbCr TIFF fixtures, from
    `jpeg_tiff` (new-style JPEG, compression 7: YCbCr at 4:2:0, 4:2:2 and
    4:4:4 in strips and tiles, abbreviated streams after JPEGTables or
    whole ones, no YCbCrSubsampling tag, a last stream taller than its
    strip, one shorter, progressive streams, RGB, gray, MinIsWhite and
    CMYK samples, planar files), `ojpeg_tiff` (old-style JPEG,
    compression 6, in its three forms, gray, a file that says RGB) and
    `ycbcr_tiff` (LZW, Deflate and PackBits YCbCr at every subsampling
    libtiff's RGBA reader handles, tiles, a predictor, YCbCrCoefficients
    and ReferenceBlackWhite); and the `tree_tiff_*jpeg*` / `ycbcr` rgb
    images of chip_smoke.py's TIFF tree. Needs PIL (its JPEG encoder)."""
    out = {}
    px = photo((29, 37), 40, noise=2)
    gray = photo((29, 37), 41, noise=2)[..., 1]
    steps = photo((21, 37), 43, noise=1)
    out["tiff_jpeg_ycbcr420_strips.tif"] = jpeg_tiff(px, 6, subsampling=2, rows_per_strip=16)
    out["tiff_jpeg_ycbcr422_tiles.tif"] = jpeg_tiff(px, 6, subsampling=1, tile=(32, 32))
    out["tiff_jpeg_ycbcr444_full_streams.tif"] = jpeg_tiff(px, 6, subsampling=0,
                                                           rows_per_strip=16, tables=False)
    out["tiff_jpeg_ycbcr420_no_sampling_tag.tif"] = jpeg_tiff(px, 6, subsampling=2,
                                                              rows_per_strip=32,
                                                              sampling_tag=False)
    out["tiff_jpeg_ycbcr422_jfif_markers.tif"] = jpeg_tiff(px, 6, subsampling=1,
                                                           rows_per_strip=16, keep_app=True)
    out["tiff_jpeg_ycbcr420_orientation6.tif"] = jpeg_tiff(px, 6, rows_per_strip=16,
                                                           tags=[(274, 3, [6])])
    out["tiff_jpeg_ycbcr_planar.tif"] = jpeg_tiff(px, 6, subsampling=0, rows_per_strip=16,
                                                  planar=2)
    out["tiff_jpeg_rgb.tif"] = jpeg_tiff(px, 2, rows_per_strip=16, keep_app=True)
    out["tiff_jpeg_rgb_planar_tiles.tif"] = jpeg_tiff(px, 2, tile=(16, 32), planar=2)
    out["tiff_jpeg_gray.tif"] = jpeg_tiff(gray, 1, rows_per_strip=24)
    out["tiff_jpeg_gray_white.tif"] = jpeg_tiff(gray, 0, rows_per_strip=24, order=">")
    out["tiff_jpeg_cmyk.tif"] = jpeg_tiff(np.concatenate([px, gray[..., None]], -1), 5,
                                          rows_per_strip=16)
    # A last strip's stream as tall as the others (libtiff cuts it), and a
    # stream of 8 rows for a strip of 16 (Pillow keeps the strip before's
    # rows below it).
    streams = [jpeg_stream(px[:16], 2),
               jpeg_stream(np.pad(px[16:], ((0, 3), (0, 0), (0, 0)), mode="edge"), 2)]
    out["tiff_jpeg_ycbcr420_tall_last_strip.tif"] = tiff(
        px, 6, compression=7, rows_per_strip=16, tags=[(530, 3, [2, 2])], chunks=streams)
    streams[1] = jpeg_stream(px[16:24], 2)
    out["tiff_jpeg_ycbcr420_short_strip.tif"] = tiff(
        px, 6, compression=7, rows_per_strip=16, tags=[(530, 3, [2, 2])], chunks=streams)
    from PIL import Image

    prog = []
    for y in (0, 16):
        buf = io.BytesIO()
        Image.fromarray(px[y:y + 16]).save(buf, "JPEG", quality=80, progressive=True)
        prog.append(buf.getvalue())
    out["tiff_jpeg_ycbcr420_progressive.tif"] = tiff(
        px, 6, compression=7, rows_per_strip=16, tags=[(530, 3, [2, 2])], chunks=prog)
    out["tiff_ojpeg_420_tables.tif"] = ojpeg_tiff(px, subsampling=2, rows_per_strip=16)
    out["tiff_ojpeg_422_jif.tif"] = ojpeg_tiff(px, subsampling=1, rows_per_strip=8, form="jif")
    out["tiff_ojpeg_444_jif_header.tif"] = ojpeg_tiff(px, subsampling=0, rows_per_strip=16,
                                                      form="jif_header")
    out["tiff_ojpeg_420_says_rgb.tif"] = ojpeg_tiff(px, subsampling=2, rows_per_strip=48,
                                                    form="jif", photometric=2)
    out["tiff_ojpeg_gray.tif"] = ojpeg_tiff(gray, rows_per_strip=16)
    out["tiff_ojpeg_420_tiles.tif"] = ojpeg_tiff(px, form="jif_header", tile=(16, 16))
    out["tiff_ojpeg_422_tile_column.tif"] = ojpeg_tiff(px, subsampling=1, tile=(16, 48))
    # The tables form with tiles side by side: libtiff's frame is one column
    # of tiles tall, and the tiles past it repeat its last MCU row.
    out["unported_ojpeg_tiles_tables.tif"] = ojpeg_tiff(px, tile=(16, 16))
    for (hs, vs), kw in [((1, 1), {"compression": 5, "rows_per_strip": 8}),
                         ((1, 2), {"compression": 8, "tile": (16, 32)}),
                         ((2, 1), {"compression": 32773, "rows_per_strip": 7}),
                         ((2, 2), {"compression": 5, "tile": (32, 16)}),
                         ((4, 1), {"compression": 8, "rows_per_strip": 16, "predictor": 2}),
                         ((4, 2), {"compression": 5, "rows_per_strip": 10}),
                         ((4, 4), {"compression": 8, "tile": (16, 48)})]:
        name = {5: "lzw", 8: "deflate", 32773: "packbits"}[kw["compression"]]
        out[f"tiff_ycbcr{hs}{vs}_{name}.tif"] = ycbcr_tiff(steps, hs, vs, step=8, **kw)
    out["tiff_ycbcr22_lzw_pred.tif"] = ycbcr_tiff(steps, 2, 2, rows_per_strip=16, predictor=2,
                                                  step=8)
    rec709 = (529, 5, [2126, 10000, 7152, 10000, 722, 10000])  # YCbCrCoefficients
    video = (532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])  # ReferenceBlackWhite
    out["tiff_ycbcr22_coefficients.tif"] = ycbcr_tiff(steps, 2, 2, rows_per_strip=16, step=8,
                                                      tags=[rec709, video])
    tree = [tree_photo(tree_hw, 40 + i) for i in range(4)]
    out["tree_tiff_jpeg420_strips.tif"] = jpeg_tiff(tree[0], 6, subsampling=2, rows_per_strip=16)
    out["tree_tiff_jpeg420_tiles.tif"] = jpeg_tiff(tree[1], 6, subsampling=2, tile=(32, 32))
    out["tree_tiff_ojpeg420.tif"] = ojpeg_tiff(tree[2], subsampling=2, rows_per_strip=16)
    out["tree_tiff_ycbcr22_lzw.tif"] = ycbcr_tiff(tree[3], 2, 2, rows_per_strip=16, step=16)
    return out


def refused_jpeg_tiff_files():
    """Damaged JPEG-compressed and YCbCr TIFFs that PIL refuses too:
    YCbCrSubsampling 2 x 1 over 4:2:0 streams, a stream wider than its
    strip, gray streams in an RGB file, a scan in JPEGTables, abbreviated
    streams without JPEGTables, an old-style file without its JPEGQTables,
    old-style strips of rows that are no whole MCU rows, YCbCr subsampled
    2 x 4."""
    px = photo((32, 20), 42, noise=4)
    streams = [split_jpeg(jpeg_stream(px[y:y + 16], 2))[1] for y in (0, 16)]
    tables = split_jpeg(jpeg_stream(px[:16], 2))[0]
    ycbcr = lambda **kw: {"compression": 7, "rows_per_strip": 16, **kw}  # noqa: E731
    wide = np.pad(px[:16], ((0, 0), (0, 8), (0, 0)), mode="edge")
    no_q = ojpeg_tiff(px, rows_per_strip=16)
    return {
        "refused_tiff_jpeg_sampling.tif": jpeg_tiff(px, 6, rows_per_strip=16, sampling_tag=False,
                                                    tags=[(530, 3, [2, 1])]),
        "refused_tiff_jpeg_wide_stream.tif": tiff(
            px, 6, tags=[(530, 3, [2, 2])], chunks=[jpeg_stream(wide, 2), jpeg_stream(px[16:], 2)],
            **ycbcr()),
        "refused_tiff_jpeg_components.tif": tiff(
            px, 2, chunks=[jpeg_stream(px[y:y + 16, :, 0], 0) for y in (0, 16)], **ycbcr()),
        "refused_tiff_jpeg_bogus_tables.tif": tiff(
            px, 6, tags=[(530, 3, [2, 2]), (347, 7, jpeg_stream(px[:16], 2))], chunks=streams,
            **ycbcr()),
        "refused_tiff_jpeg_no_tables.tif": tiff(px, 6, tags=[(530, 3, [2, 2])], chunks=streams,
                                                **ycbcr()),
        "refused_tiff_jpeg_tables_not_jpeg.tif": tiff(
            px, 6, tags=[(530, 3, [2, 2]), (347, 7, tables[2:])], chunks=streams, **ycbcr()),
        "refused_tiff_ojpeg_no_qtables.tif": patch_tiff_tag(no_q, 519, [len(no_q)] * 3),
        "refused_tiff_ojpeg_strip_rows.tif": set_tiff_tag(ojpeg_tiff(px, rows_per_strip=16),
                                                          278, 12),
        "refused_tiff_ycbcr_subsampling.tif": ycbcr_tiff(px, 2, 2, tags=[(530, 3, [2, 4])]),
    }


def pil_tiff_files(tree_hw=(48, 64)):
    """{name: bytes} of the TIFF fixtures PIL writes (its own writer for
    uncompressed files, libtiff 4.7 for the rest), the tree's LZW,
    Deflate and PackBits rgb images, JPEG-compressed RGB, YCbCr (PIL writes
    4:4:4 only), gray and CMYK files, Deflate and LZW YCbCr ones, and the
    files the port refuses: a CCITT Group 4 1-bit one, an LZMA and a ZSTD
    one. Needs PIL. PIL writes no subsampled JPEG-compressed TIFF: asked
    for one (tag 530 under JPEG), its encoder fails and the process
    aborts, so `jpeg_tiff` writes those."""
    from PIL import Image, TiffImagePlugin

    rng = np.random.default_rng(12)

    def save(img, **kw):
        buf = io.BytesIO()
        if "predictor" in kw:
            info = TiffImagePlugin.ImageFileDirectory_v2()
            info[317] = kw.pop("predictor")
            kw["tiffinfo"] = info
        img.save(buf, "TIFF", **kw)
        return buf.getvalue()

    hw = (9, 14)
    rgba = np.concatenate([photo(hw, 14, noise=3), rng.integers(0, 256, hw + (1,))], -1)
    rgba = Image.fromarray(rgba.astype(np.uint8), "RGBA")
    out = {"tiff_pil_rgb_raw.tif": save(rgba.convert("RGB")),
           "tiff_pil_rgb_lzw.tif": save(rgba.convert("RGB"), compression="tiff_lzw"),
           "tiff_pil_rgba_deflate_pred.tif": save(rgba, compression="tiff_adobe_deflate",
                                                  predictor=2),
           "tiff_pil_rgbx_packbits.tif": save(rgba.convert("RGBX"), compression="packbits"),
           "tiff_pil_cmyk_lzw.tif": save(rgba.convert("CMYK"), compression="tiff_lzw"),
           "tiff_pil_la_raw.tif": save(rgba.convert("LA")),
           "tiff_pil_l_deflate_pred.tif": save(rgba.convert("L"), compression="tiff_deflate",
                                               predictor=2),
           "tiff_pil_1bit_packbits.tif": save(rgba.convert("1"), compression="packbits"),
           "tiff_pil_p_lzw.tif": save(rgba.convert("RGB").quantize(40), compression="tiff_lzw"),
           "tiff_pil_pa_raw.tif": save(rgba.convert("RGB").quantize(40).convert("PA"))}
    g16 = (np.add.outer(np.arange(9), np.arange(14)) * 4099 % 65536).astype(np.uint16)
    out["tiff_pil_i16_raw.tif"] = save(Image.fromarray(g16))
    out["tiff_pil_i16_lzw_pred.tif"] = save(Image.fromarray(g16), compression="tiff_lzw",
                                            predictor=2)
    out["tiff_pil_i16b_raw.tif"] = save(Image.frombytes("I;16B", hw[::-1],
                                                        g16.astype(">u2").tobytes()))
    out["tiff_pil_i32_deflate.tif"] = save(Image.fromarray(g16.astype(np.int32) * 3 - 100000),
                                           compression="tiff_deflate")
    out["tiff_pil_f32_raw.tif"] = save(Image.fromarray(g16.astype(np.float32) / 200 - 20))
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[274] = 3
    out["tiff_pil_orientation3_lzw.tif"] = save(rgba.convert("RGB"), compression="tiff_lzw",
                                                tiffinfo=info)
    tree = [Image.fromarray(tree_photo(tree_hw, 30 + i)) for i in range(3)]
    out["tree_tiff_lzw_pred.tif"] = save(tree[0], compression="tiff_lzw", predictor=2)
    out["tree_tiff_deflate.tif"] = save(tree[1], compression="tiff_adobe_deflate")
    out["tree_tiff_packbits.tif"] = save(tree[2], compression="packbits")
    small = Image.fromarray(photo((16, 24), 6))
    out["tiff_pil_jpeg_rgb.tif"] = save(small, compression="jpeg")
    out["tiff_pil_ycbcr_deflate.tif"] = save(small.convert("YCbCr"),
                                             compression="tiff_adobe_deflate")
    out["tiff_pil_jpeg_ycbcr.tif"] = save(small.convert("YCbCr"), compression="jpeg", quality=60)
    out["tiff_pil_jpeg_l.tif"] = save(small.convert("L"), compression="jpeg")
    out["tiff_pil_jpeg_cmyk.tif"] = save(small.convert("CMYK"), compression="jpeg")
    out["tiff_pil_ycbcr_lzw.tif"] = save(small.convert("YCbCr"), compression="tiff_lzw")
    out["unported_ccitt.tif"] = save(small.convert("1"), compression="group4")
    out["unported_lzma.tif"] = save(small, compression="lzma")
    out["unported_zstd.tif"] = save(small, compression="zstd")
    return out


# The words of the port's ValueError for each refused file.
REFUSED = {"refused_bmp_gray4_wide.bmp": "hold no", "refused_bmp_truncated.bmp": "truncated",
           "refused_bmp_rle8_short.bmp": "not enough image data",
           "refused_bmp_rle8_early_end.bmp": "not enough image data",
           "refused_pgm_plain_past_maxval.pgm": "outside",
           "refused_pgm_raw_truncated.pgm": "truncated",
           "refused_tiff_lzw_no_clear.tif": "not yet in the table",
           "refused_tiff_strip_past_end.tif": "outside the file",
           "refused_tiff_deflate_short.tif": "Deflate data ends",
           "refused_tiff_jpeg_sampling.tif": "improper JPEG sampling factors",
           "refused_tiff_jpeg_wide_stream.tif": "exceeds",
           "refused_tiff_jpeg_components.tif": "improper JPEG component count",
           "refused_tiff_jpeg_bogus_tables.tif": "JPEGTables holds a frame",
           "refused_tiff_jpeg_no_tables.tif": "no quantisation table",
           "refused_tiff_jpeg_tables_not_jpeg.tif": "JPEGTables: not a JPEG stream",
           "refused_tiff_ojpeg_no_qtables.tif": "JPEGQTables",
           "refused_tiff_ojpeg_strip_rows.tif": "no whole MCU rows",
           "refused_tiff_ycbcr_subsampling.tif": "cannot handle"}
# The files the port refused with UnsupportedImage until the ROADMAP item
# given ported them; they keep their names, and expected.json gives the item.
UNPORTED = {"unported_ccitt.tif": "11h", "unported_lzma.tif": "11h", "unported_zstd.tif": "11h",
            "unported_ojpeg_tiles_tables.tif": "11g"}


def set_tiff_tag(data: bytes, tag: int, value: int) -> bytes:
    """A little-endian classic TIFF with the one inline value of `tag`
    replaced."""
    at = struct.unpack_from("<I", data, 4)[0]
    for i in range(struct.unpack_from("<H", data, at)[0]):
        entry = at + 2 + 12 * i
        if struct.unpack_from("<H", data, entry)[0] == tag:
            typ = struct.unpack_from("<H", data, entry + 2)[0]
            return (data[:entry + 8] + struct.pack("<H2x" if typ == 3 else "<I", value)
                    + data[entry + 12:])
    raise KeyError(tag)


def refused_tiff_files():
    """Damaged TIFFs that PIL refuses too: an LZW strip whose first code is
    no Clear code, a strip whose byte count runs past the end of the file,
    a Deflate strip whose stream ends rows early."""
    c = photo((9, 14), 15, noise=3)
    lzw = bytearray(tiff(c, 2, compression=5))
    lzw[8] ^= 0x40  # the first code: 256 -> 384, past the table
    past = tiff(c, 2, compression=32773)
    full = tiff(c, 2, compression=8)
    count = struct.unpack_from("<I", set_tiff_tag(full, 279, 0), 4)[0] - 8
    short = zlib.compress(c[:5].tobytes(), 6)
    return {"refused_tiff_lzw_no_clear.tif": bytes(lzw),
            "refused_tiff_strip_past_end.tif": set_tiff_tag(past, 279, len(past)),
            "refused_tiff_deflate_short.tif": full[:8] + short + bytes(count - len(short))
            + full[8 + count:]}


def timing_files(hw=(480, 640)):
    """{name: bytes} of 640 x 480 photo-like files in each new format, for
    decode times (time_decode.py): Adam7 PNG, 24-bit and 8-bit palette
    BMP, BI_RLE8 BMP (the palette indices in runs of 8), raw PPM, 16-bit
    PGM, RGB TIFF in strips of 16 rows uncompressed, LZW and Deflate with
    predictor 2, and PackBits (pixels in runs of 4); JPEG-compressed TIFF
    at 4:2:0 in strips of 8 and 64 rows and in 256 x 256 tiles, old-style
    JPEG at 4:2:0 in strips of 16 rows, and LZW YCbCr at 2 x 2."""
    rng = np.random.default_rng(7)
    h, w = hw
    rgb = photo(hw, 8)
    pal = rng.integers(0, 256, (256, 3))
    idx = (rgb[..., 1] // 32 * 32 + rgb[..., 0] // 64 * 4 + rgb[..., 2] // 128).astype(np.uint8)
    runs = np.repeat(idx[:, ::8], 8, axis=1)[:, :w]
    flip = lambda a: a[::-1]  # noqa: E731  bottom-up rows
    return {
        "adam7_rgb_640.png": png_adam7(rgb, 8, 2, seed=9),
        "bmp_24_640.bmp": bmp(_bmp_rows(flip(np.ascontiguousarray(rgb[..., ::-1])), 24), w, h,
                              24),
        "bmp_p8_640.bmp": bmp(_bmp_rows(flip(idx), 8), w, h, 8, palette=pal),
        "bmp_rle8_640.bmp": bmp(rle8(flip(runs), w), w, h, 8, compression=1, palette=pal),
        "ppm_raw_640.ppm": netpbm("P6", rgb),
        "pgm_raw_16bit_640.pgm": netpbm("P5", rgb[..., 0].astype(np.int64) * 257, 65535),
        "tiff_raw_640.tif": tiff(rgb, 2, rows_per_strip=16),
        "tiff_lzw_pred_640.tif": tiff(rgb, 2, compression=5, predictor=2, rows_per_strip=16),
        "tiff_deflate_pred_640.tif": tiff(rgb, 2, compression=8, predictor=2,
                                          rows_per_strip=16),
        "tiff_packbits_640.tif": tiff(np.repeat(rgb[:, ::4], 4, axis=1), 2, compression=32773,
                                      rows_per_strip=16),
        "tiff_jpeg420_strips8_640.tif": jpeg_tiff(rgb, 6, subsampling=2, rows_per_strip=8),
        "tiff_jpeg420_strips64_640.tif": jpeg_tiff(rgb, 6, subsampling=2, rows_per_strip=64),
        "tiff_jpeg420_tiles256_640.tif": jpeg_tiff(rgb, 6, subsampling=2, tile=(256, 256)),
        "tiff_ojpeg420_640.tif": ojpeg_tiff(rgb, subsampling=2, rows_per_strip=16),
        "tiff_ycbcr22_lzw_640.tif": ycbcr_tiff(rgb, 2, 2, rows_per_strip=16),
    }


def pil_digests(data: bytes) -> dict:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    rgb = np.asarray(img.convert("RGB"))
    raw = np.asarray(img)
    if raw.dtype == bool:
        raw = raw.astype(np.uint8) * 255
    if img.mode in ("LA", "PA"):
        raw = np.ascontiguousarray(raw[..., 0])
    elif raw.ndim == 3 and img.mode != "CMYK":
        raw = np.ascontiguousarray(raw[..., :3])
    raw = raw.astype(raw.dtype.newbyteorder("="))  # "I;16B" in native order, as the port's
    return {"mode": img.mode, "shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "raw_shape": list(raw.shape), "raw_dtype": str(raw.dtype),
            "raw_sha256": hashlib.sha256(raw.tobytes()).hexdigest()}


def main():
    from PIL import Image

    written = {**files(), **tiff_files(), **refused_tiff_files(), **jpeg_tiff_files(),
               **refused_jpeg_tiff_files(), **pil_tiff_files()}
    expected = {}
    for name, data in sorted(written.items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        if name in REFUSED:
            try:
                Image.open(io.BytesIO(data)).convert("RGB")
            except (OSError, SyntaxError, ValueError):
                expected[name] = {"error": REFUSED[name]}
                continue
            raise SystemExit(f"{name}: PIL reads it, so the port must too")
        expected[name] = pil_digests(data)
        if name in UNPORTED:
            expected[name]["ported_in"] = UNPORTED[name]
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(v) for v in written.values())
    print(f"wrote {len(expected)} files, {total} bytes, and expected.json")


if __name__ == "__main__":
    main()
