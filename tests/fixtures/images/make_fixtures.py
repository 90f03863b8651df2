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
comments in the header and the data). The writers need only numpy; PIL is
imported in `main` alone, for the digests. The TIFF, WebP and JPEG 2000
files that the port refuses come from PIL. Re-running rewrites every file;
the pixels come from fixed seeds.
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


def photo(hw, seed):
    """A smooth photo-like RGB image with a little noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (5 + 3 * c) + yy / (7 + 2 * c) + c) for c in range(3)],
                 -1)
    return np.clip(a + rng.normal(0, 8, a.shape), 0, 255).astype(np.uint8)


def files(tree_hw=(48, 64)):
    """{name: bytes} of every fixture (the TIFF, WebP and JPEG 2000 ones
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


# The words of the port's ValueError for each refused file.
REFUSED = {"refused_bmp_gray4_wide.bmp": "hold no", "refused_bmp_truncated.bmp": "truncated",
           "refused_bmp_rle8_short.bmp": "not enough image data",
           "refused_bmp_rle8_early_end.bmp": "not enough image data",
           "refused_pgm_plain_past_maxval.pgm": "outside",
           "refused_pgm_raw_truncated.pgm": "truncated"}


def timing_files(hw=(480, 640)):
    """{name: bytes} of 640 x 480 photo-like files in each new format, for
    decode times (time_decode.py): Adam7 PNG, 24-bit and 8-bit palette
    BMP, BI_RLE8 BMP (the palette indices in runs of 8), raw PPM and 16-bit
    PGM."""
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
    }


def pil_digests(data: bytes) -> dict:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    rgb = np.asarray(img.convert("RGB"))
    raw = np.asarray(img)
    if raw.dtype == bool:
        raw = raw.astype(np.uint8) * 255
    if img.mode == "LA":
        raw = np.ascontiguousarray(raw[..., 0])
    elif raw.ndim == 3:
        raw = np.ascontiguousarray(raw[..., :3])
    return {"mode": img.mode, "shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "raw_shape": list(raw.shape), "raw_dtype": str(raw.dtype),
            "raw_sha256": hashlib.sha256(raw.tobytes()).hexdigest()}


def main():
    from PIL import Image

    written = files()
    unported = {}
    a = photo((16, 24), 6)
    for name, fmt in (("unported.tif", "TIFF"), ("unported.webp", "WEBP"),
                      ("unported.jpx", "JPEG2000")):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, fmt)
        unported[name] = buf.getvalue()
        Image.open(io.BytesIO(unported[name])).convert("RGB")  # PIL reads it back
    expected = {}
    for name, data in sorted({**written, **unported}.items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        if name in REFUSED:
            try:
                Image.open(io.BytesIO(data)).convert("RGB")
            except (OSError, SyntaxError, ValueError):
                expected[name] = {"error": REFUSED[name]}
                continue
            raise SystemExit(f"{name}: PIL reads it, so the port must too")
        expected[name] = {"unported": True} if name in unported else pil_digests(data)
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(v) for v in written.values()) + sum(len(v) for v in unported.values())
    print(f"wrote {len(expected)} files, {total} bytes, and expected.json")


if __name__ == "__main__":
    main()
