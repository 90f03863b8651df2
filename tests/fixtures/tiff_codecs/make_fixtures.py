"""Write the TIFF fixtures of the last codecs PIL reads through libtiff
(CCITT RLE, Group 3, Group 4 and RLEW, LZMA, ZSTD, ThunderScan), of CIELab
and of the one-band planar file, which tests/test_torch_tiff_codecs.py and
chip_smoke.py hold the port's TIFF reader against, and expected.json: for
each file the mode PIL 12.1 (libtiff 4.7.1, LittleCMS 2.17) opens it in, the
shape and SHA-256 of its convert("RGB") pixels and of its raw pixels, and
the codec; or, for a damaged file, the words of the port's ValueError.

    python tests/fixtures/tiff_codecs/make_fixtures.py

PIL writes RLE, Group 3 (1-D), Group 4, LZMA and ZSTD files. The rest come
from the encoders here: CCITT rows (`mh_row`, `read_row`; `ccitt` puts them
together as RLE, RLEW with 16-bit-aligned rows, Group 3 with EOLs, 2-D rows
and fill bits, or Group 4), ThunderScan (`thunderscan`; PIL's own encoder
is not implemented and kills the process), Zstandard frames (PIL's, with
the checksum, content size, single-segment form, dictionary ID and a
skippable frame written into them by hand, and one of RLE literals built
whole), and the TIFF container (tests/fixtures/images/make_fixtures.py
`tiff`). `SIZE_BUDGET` bounds the files' bytes. Re-running rewrites every
file; the pixels come from fixed seeds.
"""

from __future__ import annotations

import importlib.util
import io
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "images_make_fixtures", os.path.join(os.path.dirname(HERE), "images", "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)  # the TIFF writer and PIL's digests
_spec.loader.exec_module(mf)

SIZE_BUDGET = 100_000
TREE_HW = (48, 64)

# --- CCITT (ITU-T T.4 / T.6) -----------------------------------------------------------

# Terminating codes 0-63 and make-up codes 64-1728 (white, black), then the
# make-up codes 1792-2560 both colours share; most significant bit first.
TERM_W = ("00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 "
          "000011 110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 "
          "0000100 0101000 0101011 0010011 0100100 0011000 00000010 00000011 00011010 "
          "00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 00101001 "
          "00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 "
          "01010011 01010100 01010101 00100100 00100101 01011000 01011001 01011010 01011011 "
          "01001010 01001011 00110010 00110011 00110100").split()
MAKEUP_W = ("11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 "
            "011001100 011001101 011010010 011010011 011010100 011010101 011010110 011010111 "
            "011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
            "010011011").split()
TERM_B = ("0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 "
          "00000100 00000111 000011000 0000010111 0000011000 0000001000 00001100111 "
          "00001101000 00001101100 00000110111 00000101000 00000010111 00000011000 "
          "000011001010 000011001011 000011001100 000011001101 000001101000 000001101001 "
          "000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 "
          "000011010110 000011010111 000001101100 000001101101 000011011010 000011011011 "
          "000001010100 000001010101 000001010110 000001010111 000001100100 000001100101 "
          "000001010010 000001010011 000000100100 000000110111 000000111000 000000100111 "
          "000000101000 000001011000 000001011001 000000101011 000000101100 000001011010 "
          "000001100110 000001100111").split()
MAKEUP_B = ("0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 "
            "000000110101 0000001101100 0000001101101 0000001001010 0000001001011 "
            "0000001001100 0000001001101 0000001110010 0000001110011 0000001110100 "
            "0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 "
            "0000001010100 0000001010101 0000001011010 0000001011011 0000001100100 "
            "0000001100101").split()
MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
          "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
          "000000011111").split()
EOL = "000000000001"
PASS, HORIZ = "0001", "001"
VERTICAL = {-3: "0000011", -2: "000011", -1: "011", 0: "1", 1: "010", 2: "000010",
            3: "0000010"}  # b1 - a1 -> code (VR for a1 right of b1, VL left)


def run_code(run: int, black: bool) -> str:
    """One run's make-up codes (the largest first, 2560 at most each) and
    its terminating code."""
    term, makeup = (TERM_B, MAKEUP_B) if black else (TERM_W, MAKEUP_W)
    out = ""
    while run >= 64:
        m = min(run // 64 * 64, 2560)
        out += makeup[m // 64 - 1] if m <= 1728 else MAKEUP[(m - 1792) // 64]
        run -= m
    return out + term[run]


def changes(row: np.ndarray) -> list:
    """Positions where a row's colour changes, from an imaginary white pixel
    before it, then the width twice (libtiff's finddiff ends there)."""
    row = np.asarray(row, np.int8)
    at = np.flatnonzero(np.diff(np.concatenate([[0], row])))
    return at.tolist() + [len(row), len(row)]


def mh_codes(row: np.ndarray) -> list:
    """A row of 0 (white) / 1 (black) pixels in Modified Huffman runs, white
    first: (code, width of the table libtiff looks it up in: 12 white, 13
    black) each."""
    codes, x, black = [], 0, False
    for c in changes(row)[:-2] + [len(row)]:
        run = run_code(c - x, black)
        term, makeup = (TERM_B, MAKEUP_B) if black else (TERM_W, MAKEUP_W)
        while run:  # split the run back into its codes
            for code in sorted(set(term + makeup + MAKEUP), key=len):
                if run.startswith(code):
                    codes.append((code, 13 if black else 12))
                    run = run[len(code):]
                    break
        x, black = c, not black
    return codes


def mh_row(row: np.ndarray) -> str:
    return "".join(code for code, _ in mh_codes(row))


def rlew(px: np.ndarray) -> bytes:
    """RLEW rows as libtiff's Fax3DecodeRLE reads them back: after a row it
    drops the bits of its accumulator past a 16-bit multiple and, when that
    empties it at an odd address, skips a byte. Its accumulator fetches a
    byte or two whenever a lookup wants more bits than it holds, so each
    row is padded with zeros to where the decoder will resume (the strip
    starting at an even offset)."""
    bits, avail, cp = "", 0, 0
    for row in px:
        for code, wid in mh_codes(row):
            for _ in range(2):  # NeedBits16
                if avail < wid:
                    cp += 1
                    avail += 8
            avail -= len(code)
            bits += code
        if avail >= 16:
            resume = 8 * cp - 16
        else:
            cp += cp % 2
            resume = 8 * cp
        avail = 16 if avail >= 16 else 0
        bits += "0" * (resume - len(bits))
    return _pack_bits(bits)


def read_row(row: np.ndarray, ref: np.ndarray) -> str:
    """A row 2-D coded against `ref` (libtiff's Fax3Encode2DRow: pass,
    horizontal and vertical modes)."""
    w = len(row)
    px = lambda r, i: int(r[i]) if i < w else 0  # noqa: E731

    def finddiff(r, start, color):
        i = start
        while i < w and int(r[i]) == color:
            i += 1
        return i

    finddiff2 = lambda r, start, color: finddiff(r, start, color) if start < w else w  # noqa
    bits = ""
    a0 = 0
    a1 = 0 if px(row, 0) else finddiff(row, 0, 0)
    b1 = 0 if px(ref, 0) else finddiff(ref, 0, 0)
    while True:
        b2 = finddiff2(ref, b1, px(ref, b1))
        if b2 >= a1:
            d = b1 - a1
            if not -3 <= d <= 3:
                a2 = finddiff2(row, a1, px(row, a1))
                white_first = a0 + a1 == 0 or px(row, a0) == 0
                bits += HORIZ + run_code(a1 - a0, not white_first) + run_code(a2 - a1, white_first)
                a0 = a2
            else:
                bits += VERTICAL[d]
                a0 = a1
        else:
            bits += PASS
            a0 = b2
        if a0 >= w:
            return bits
        color = px(row, a0)
        a1 = finddiff(row, a0, color)
        b1 = finddiff(ref, finddiff(ref, a0, 1 - color), color)


def _pack_bits(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def ccitt(px: np.ndarray, kind: str, k: int = 1, fill: bool = False, eofb: bool = False) -> bytes:
    """A strip of (h, w) 0 / 1 pixels (1 black) as `kind`: "rle" (byte-
    aligned Modified Huffman rows), "rlew" (16-bit-aligned), "g3" (an EOL
    before each row; `k` > 1 codes every k-th row 1-D and the rest 2-D,
    each EOL followed by its tag bit; `fill` pads each EOL to end on a byte
    boundary), "g4" (2-D rows, `eofb` adds the end-of-facsimile block)."""
    bits = ""
    ref = np.zeros(px.shape[1], np.uint8)
    for i, row in enumerate(px):
        if kind == "rlew":
            return rlew(px)
        if kind == "rle":
            bits += mh_row(row)
            bits += "0" * (-len(bits) % 8)
        elif kind == "g3":
            if fill:
                bits += "0" * ((4 - len(bits)) % 8)
            bits += EOL
            if k > 1:
                bits += "1" if i % k == 0 else "0"
            bits += mh_row(row) if k == 1 or i % k == 0 else read_row(row, ref)
        else:
            bits += read_row(row, ref)
        ref = row
    if kind == "g4" and eofb:
        bits += EOL * 2
    return _pack_bits(bits)


def ccitt_tiff(px: np.ndarray, kind: str, *, white: bool = False, fillorder: int = 1,
               rows_per_strip: int = 0, tile=None, k: int = 1, fill: bool = False,
               eofb: bool = False, **kw) -> bytes:
    """A CCITT TIFF of (h, w) 0 / 1 pixels (1 black): MinIsWhite (the fax
    convention) with `white`, MinIsBlack storing the inverted bits
    otherwise; strips of `rows_per_strip` rows or (th, tw) tiles."""
    h, w = px.shape
    th, tw = tile or (rows_per_strip or h, w)
    bits = np.asarray(px, np.uint8) if white else 1 - np.asarray(px, np.uint8)
    parts = []
    if tile:
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw), np.uint8)
        pad[:h, :w] = px
        parts = [pad[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        parts = [px[y:y + th] for y in range(0, h, th)]
    chunks = [ccitt(p, kind, k, fill, eofb) for p in parts]
    if fillorder == 2:
        chunks = [mf.REVERSE_BITS[np.frombuffer(c, np.uint8)].tobytes() for c in chunks]
    compression = {"rle": 2, "g3": 3, "g4": 4, "rlew": 32771}[kind]
    tags = list(kw.pop("tags", ()))
    options = (1 if k > 1 else 0) | (4 if fill else 0)
    if kind == "g3" and options:
        tags.append((292, 4, [options]))
    return mf.tiff(bits, 0 if white else 1, bits=1, compression=compression, fillorder=fillorder,
                   rows_per_strip=0 if tile else rows_per_strip, tile=tile, chunks=chunks,
                   tags=tags, **kw)


def bilevel(hw, seed: int) -> np.ndarray:
    """A document-like 0 / 1 image (1 black): text-like strokes and blocks,
    with long white and black runs."""
    rng = np.random.default_rng(seed)
    h, w = hw
    px = np.zeros(hw, np.uint8)
    for _ in range(max(1, h * w // 150)):
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        px[y:y + int(rng.integers(1, 4)), x:x + int(rng.integers(1, 12))] = 1
    px[h // 3:h // 3 + 2, :] = 1
    px[:, w // 2:w // 2 + int(rng.integers(1, 4))] ^= 1
    return px


# --- ThunderScan ---------------------------------------------------------------------------


def thunderscan(px: np.ndarray) -> bytes:
    """(h, w) 4-bit values as ThunderScan codes, row by row from a last
    pixel of 0: runs of the last pixel (up to 63), three 2-bit deltas (-1,
    0, 1; 2 for none), two 3-bit deltas (-3..3; 4 for none), or raw."""
    out = bytearray()
    two = {0: 0, 1: 1, -1: 3}
    for row in np.asarray(px, np.int64):
        last, i, w = 0, 0, len(row)
        while i < w:
            run = 0
            while i + run < w and row[i + run] == last and run < 63:
                run += 1
            if run >= 2:
                out.append(run)
                i += run
                continue
            k, cur, codes = i, last, []
            while k < w and len(codes) < 3 and row[k] - cur in two:
                codes.append(two[row[k] - cur])
                cur, k = row[k], k + 1
            if len(codes) >= 2:
                codes += [2] * (3 - len(codes))
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                i, last = k, cur
                continue
            k, cur, codes = i, last, []
            while k < w and len(codes) < 2 and -3 <= row[k] - cur <= 3:
                codes.append((row[k] - cur) % 8)
                cur, k = row[k], k + 1
            if codes:
                codes += [4] * (2 - len(codes))
                out.append(0x80 | codes[0] << 3 | codes[1])
                i, last = k, cur
                continue
            out.append(0xC0 | int(row[i]))
            last, i = row[i], i + 1
    return bytes(out)


def thunder_tiff(px: np.ndarray, *, white: bool = False, rows_per_strip: int = 0) -> bytes:
    """A ThunderScan TIFF of (h, w) 4-bit values (0 black under MinIsBlack)."""
    h = px.shape[0]
    rps = rows_per_strip or h
    chunks = [thunderscan(px[y:y + rps]) for y in range(0, h, rps)]
    return mf.tiff(15 - px if white else px, 0 if white else 1, bits=4, compression=32809,
                   rows_per_strip=rps, chunks=chunks)


def gray4(hw, seed: int) -> np.ndarray:
    """4-bit values that mostly step by small deltas, with flat runs and
    jumps (so that every ThunderScan code occurs)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    steps = rng.choice([-3, -1, 0, 0, 0, 1, 2, 7], (h, w))
    px = np.cumsum(steps, 1) % 16
    px[:, w // 3:w // 3 + 9] = px[:, w // 3:w // 3 + 1]
    return px.astype(np.uint8)


# --- Zstandard and LZMA --------------------------------------------------------------------


_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5, _M64 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5, (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xxh_round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data`, whose low 32 bits are a Zstandard frame's content
    checksum (RFC 8878 section 3.1.1)."""
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        while p + 32 <= n:
            v = [_xxh_round(a, int.from_bytes(data[p + 8 * k:p + 8 * k + 8], "little"))
                 for k, a in enumerate(v)]
            p += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for a in v:
            h = ((h ^ _xxh_round(0, a)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _xxh_round(0, int.from_bytes(data[p:p + 8], "little"))
        h, p = (_rotl(h, 27) * _P1 + _P4) & _M64, p + 8
    if p + 4 <= n:
        h ^= int.from_bytes(data[p:p + 4], "little") * _P1 & _M64
        h, p = (_rotl(h, 23) * _P2 + _P3) & _M64, p + 4
    for b in data[p:]:
        h = _rotl(h ^ (b * _P5 & _M64), 11) * _P1 & _M64
    h = (h ^ (h >> 33)) * _P2 & _M64
    h = (h ^ (h >> 29)) * _P3 & _M64
    return h ^ (h >> 32)


def pil_zstd(raw: bytes) -> bytes:
    """The Zstandard frame PIL's writer (libtiff's ZSTD codec at its default
    level) makes of `raw`: the one strip of a one-row "L" image."""
    from PIL import Image

    data = pil_save(Image.frombytes("L", (len(raw), 1), raw), compression="zstd")
    tags = Image.open(io.BytesIO(data)).tag_v2
    (offset,), (count,) = tags[273], tags[279]
    return data[offset:offset + count]


def zstd_frames(raw: bytes, *, checksum: bool = False, size: bool = False,
                single: bool = False, dict_id: int = 0, skippable: bool = False) -> bytes:
    """PIL's Zstandard frame of `raw` (`pil_zstd`) with what libtiff's writer
    leaves out put into its header by hand (RFC 8878 section 3.1.1): the
    content checksum, the content size in its shortest field, the
    single-segment form (no window descriptor, the content size given),
    a dictionary ID; then a skippable frame after it when asked."""
    frame = pil_zstd(raw)
    assert frame[4] == 0, frame[4]  # libtiff's header: a window descriptor, nothing else
    n = len(raw)
    fhd = checksum << 2 | single << 5
    header = b"" if single else frame[5:6]
    if dict_id:
        fhd |= 3
        header += dict_id.to_bytes(4, "little")
    if single or size:
        if n < 256 and single:
            header += bytes([n])
        elif 256 <= n < 65792:
            fhd |= 1 << 6
            header += (n - 256).to_bytes(2, "little")
        else:
            fhd |= 2 << 6
            header += n.to_bytes(4, "little")
    frame = frame[:4] + bytes([fhd]) + header + frame[6:]
    if checksum:
        frame += (xxh64(raw) & 0xFFFFFFFF).to_bytes(4, "little")
    if skippable:
        frame += (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"tiffz"
    return frame


def rle_literals_frame(byte: int, n: int) -> bytes:
    """A Zstandard frame by hand: single segment with its content size, one
    compressed block of `n` RLE literals and no sequences (256 <= n < 2^20)."""
    header = (0xFD2FB528).to_bytes(4, "little") + bytes([0x60]) + (n - 256).to_bytes(2, "little")
    body = bytes([1 | 3 << 2 | (n & 15) << 4, (n >> 4) & 0xFF, n >> 12, byte, 0])
    return header + (1 | 2 << 1 | len(body) << 3).to_bytes(3, "little") + body


def codec_tiff(px: np.ndarray, photometric: int, compression: int, encode, *,
               rows_per_strip: int = 0, predictor: int = 1, tile=None, **kw) -> bytes:
    """An LZMA or ZSTD TIFF whose strips or (th, tw) tiles (the edge ones
    padded with zeros) `encode` (bytes -> bytes) writes, after the
    horizontal predictor when asked."""
    px3 = px[..., None] if px.ndim == 2 else px
    h, w = px3.shape[:2]
    if tile:
        th, tw = tile
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw, px3.shape[2]), px3.dtype)
        pad[:h, :w] = px3
        parts = [pad[y:y + th, x:x + tw] for y in range(0, h, th) for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        parts = [px3[y:y + rps] for y in range(0, h, rps)]
    chunks = []
    for part in parts:
        raw = mf._tiff_rows(np.ascontiguousarray(part), part.dtype.itemsize * 8, "<", predictor)
        chunks.append(encode(raw.tobytes()))
    return mf.tiff(px, photometric, compression=compression, tile=tile,
                   rows_per_strip=0 if tile else (rows_per_strip or h), predictor=predictor,
                   chunks=chunks, **kw)


def pil_save(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def files() -> dict:
    """{name: (bytes, codec)} of every fixture. The `tree_*` files share
    TREE_HW, so that chip_smoke.py builds a pretraining tree of them."""
    from PIL import Image, TiffImagePlugin
    import lzma

    def pil_info(**tags):
        info = TiffImagePlugin.ImageFileDirectory_v2()
        for k, v in tags.items():
            info[int(k[1:])] = v
        return info

    out = {}
    doc = bilevel((40, 56), 1)
    one = Image.fromarray((1 - doc) * 255).convert("1")  # PIL's "1": 255 white
    # CCITT: PIL's writer for RLE, Group 3 1-D and Group 4; RLEW as PIL
    # writes it (rows that are no 16-bit words, which libtiff decodes as bad
    # code words: the digests are its garbage) and word-aligned.
    out["ccitt_rle_pil.tif"] = (pil_save(one, compression="tiff_ccitt"), "ccitt")
    out["ccitt_g3_pil.tif"] = (pil_save(one, compression="group3",
                                        tiffinfo=pil_info(t278=15)), "ccitt")
    out["ccitt_g4_pil.tif"] = (pil_save(one, compression="group4"), "ccitt")
    out["ccitt_rlew_pil.tif"] = (pil_save(one, compression="tiff_raw_16"), "ccitt")
    out["ccitt_rlew.tif"] = (ccitt_tiff(doc, "rlew", rows_per_strip=13), "ccitt")
    out["ccitt_rle_white.tif"] = (ccitt_tiff(doc, "rle", white=True), "ccitt")
    out["ccitt_g3_2d.tif"] = (ccitt_tiff(doc, "g3", k=4, rows_per_strip=17), "ccitt")
    out["ccitt_g3_2d_fill.tif"] = (ccitt_tiff(doc, "g3", k=2, fill=True, white=True), "ccitt")
    out["ccitt_g3_fill2.tif"] = (ccitt_tiff(doc, "g3", fillorder=2, rows_per_strip=9), "ccitt")
    out["ccitt_g4_white.tif"] = (ccitt_tiff(doc, "g4", white=True, eofb=True), "ccitt")
    out["ccitt_g4_fill2_strips.tif"] = (ccitt_tiff(doc, "g4", fillorder=2, rows_per_strip=11),
                                        "ccitt")
    out["ccitt_g4_tiles.tif"] = (ccitt_tiff(doc, "g4", tile=(16, 32)), "ccitt")
    long_runs = np.zeros((6, 2700), np.uint8)  # runs past 2560: several make-up codes
    long_runs[2, 5:2690] = 1
    long_runs[4, 1800:1900] = 1
    out["ccitt_g4_long_runs.tif"] = (ccitt_tiff(long_runs, "g4"), "ccitt")
    out["ccitt_g3_long_runs.tif"] = (ccitt_tiff(long_runs, "g3", k=3), "ccitt")
    # LZMA and ZSTD: PIL's writer, and Zstandard frames with what libtiff's
    # writer never puts in (checksum, content size, single segment, skippable
    # frame after).
    photo = mf.photo((36, 44), 5)
    out["lzma_rgb_pil.tif"] = (pil_save(Image.fromarray(photo), compression="lzma",
                                        tiffinfo=pil_info(t317=2, t278=12)), "lzma")
    g16 = (np.add.outer(np.arange(20), np.arange(30)) * 2111 % 65536).astype(np.uint16)
    out["lzma_gray16_pil.tif"] = (pil_save(Image.fromarray(g16), compression="lzma"), "lzma")
    out["zstd_rgb_pil.tif"] = (pil_save(Image.fromarray(photo), compression="zstd",
                                        tiffinfo=pil_info(t278=16)), "zstd")
    out["zstd_l_pred_pil.tif"] = (pil_save(Image.fromarray(photo[..., 1]), compression="zstd",
                                           tiffinfo=pil_info(t317=2)), "zstd")
    noisy = np.random.default_rng(6).integers(0, 256, (24, 40, 3), dtype=np.uint8)
    mixed = photo[:24, :40].copy()
    mixed[::4] = noisy[::4]
    mixed[5:9] = 77
    out["zstd_checksum_size.tif"] = (codec_tiff(
        mixed, 2, 50000, lambda r: zstd_frames(r, checksum=True, size=True, skippable=True),
        rows_per_strip=8), "zstd")
    # One strip past 128 KiB (libzstd's block size): a frame of several blocks
    blocks = np.full((120, 440, 3), 200, np.uint8)
    blocks[:36, :44], blocks[80:116, 300:344] = photo, photo[::-1]
    out["zstd_blocks.tif"] = (codec_tiff(
        blocks, 2, 50000, lambda r: zstd_frames(r, checksum=True)), "zstd")
    out["zstd_noise_pred.tif"] = (codec_tiff(
        noisy, 2, 50000, lambda r: zstd_frames(r, single=True), predictor=2), "zstd")
    # Strips chosen so that most literals and table kinds of RFC 8878 occur
    # (the treeless ones need frames past 128 KiB, which the tests write):
    # skewed values below 10 (a four-stream Huffman tree with direct
    # weights), word-like text (a one-stream tree with FSE-coded weights),
    # a hand-made frame of RLE literals, and 200 bytes (a one-stream tree
    # with direct weights, predefined tables).
    krng = np.random.default_rng(10)
    skew = krng.choice(10, 9000, p=0.5 ** np.arange(10) / (0.5 ** np.arange(10)).sum())
    words = b" ".join(bytes(krng.choice(list(b"etaoinshr"), int(krng.integers(2, 8))))
                      for _ in range(4000))
    strips = [skew.astype(np.uint8).tobytes(), words[:9000], words[9000:18000], b"\x57" * 9000,
              skew[:200].astype(np.uint8).tobytes()]
    chunks = [zstd_frames(strips[0]), zstd_frames(strips[1], size=True),
              zstd_frames(strips[2], single=True), rle_literals_frame(0x57, 9000),
              zstd_frames(strips[4], single=True, checksum=True)]
    out["zstd_kinds.tif"] = (mf.tiff(np.frombuffer(b"".join(strips), np.uint8).reshape(-1, 100), 1,
                                     compression=50000, rows_per_strip=90, chunks=chunks), "zstd")
    out["lzma_xz_check.tif"] = (codec_tiff(
        mixed, 2, 34925, lambda r: lzma.compress(r, format=lzma.FORMAT_XZ,
                                                 check=lzma.CHECK_SHA256),
        rows_per_strip=12), "lzma")
    # ThunderScan
    g4 = gray4((30, 45), 7)
    out["thunderscan.tif"] = (thunder_tiff(g4, rows_per_strip=11), "thunderscan")
    out["thunderscan_white.tif"] = (thunder_tiff(g4[:17], white=True), "thunderscan")
    # CIELab: chunky and planar, raw and compressed, a LittleCMS conversion each
    lab = np.random.default_rng(8).integers(0, 256, (14, 18, 3), dtype=np.uint8)
    lab[:, :6] = np.stack([np.arange(6) * 40, np.full(6, 128), np.full(6, 128)], -1)
    out["cielab_raw.tif"] = (mf.tiff(lab, 8), "cielab")
    out["cielab_planar_deflate.tif"] = (mf.tiff(lab, 8, compression=8, planar=2,
                                                rows_per_strip=5), "cielab")
    out["cielab_lzw_tiles.tif"] = (mf.tiff(lab, 8, compression=5, tile=(16, 16)), "cielab")
    out["cielab_zstd_pil.tif"] = (pil_save(Image.frombytes("LAB", (18, 14), lab.tobytes()),
                                           compression="zstd"), "cielab")
    # The one-band planar file: "P" with an extra sample, planes in tiles
    pal_rng = np.random.default_rng(9)
    px2 = pal_rng.integers(0, 256, (20, 40, 2), dtype=np.uint8)
    cmap = pal_rng.integers(0, 65536, (256, 3))
    out["planar_px_tiles.tif"] = (mf.tiff(px2, 3, extra=(0,), colormap=cmap, planar=2,
                                          compression=8, tile=(32, 32)), "planar")
    # The pretraining tree's rgb files, one of each codec
    tree = mf.photo(TREE_HW, 40, noise=2)
    tree_doc = (tree[..., 1] > 140).astype(np.uint8)
    out["tree_g4.tif"] = (ccitt_tiff(tree_doc, "g4", white=True), "ccitt")
    out["tree_g3_2d.tif"] = (ccitt_tiff(1 - tree_doc, "g3", k=4, rows_per_strip=16), "ccitt")
    out["tree_lzma.tif"] = (pil_save(Image.fromarray(tree // 8 * 8), compression="lzma",
                                     tiffinfo=pil_info(t317=2)), "lzma")
    out["tree_zstd.tif"] = (pil_save(Image.fromarray(tree // 8 * 8), compression="zstd",
                                     tiffinfo=pil_info(t317=2)), "zstd")
    out["tree_thunderscan.tif"] = (thunder_tiff(tree[..., 0] // 16), "thunderscan")
    t = tree.astype(np.int64)
    tree_lab = np.stack([t[..., 1], (t[..., 0] // 4 - 32) % 256, (t[..., 2] // 4 - 32) % 256],
                        -1).astype(np.uint8)
    out["tree_cielab.tif"] = (mf.tiff(tree_lab, 8, compression=8, rows_per_strip=16), "cielab")
    # Damaged files the port refuses, as libtiff fails (or leaves Pillow's
    # buffer as it was) on them.
    g4_data = out["ccitt_g4_pil.tif"][0]
    out["refused_g4_early_end.tif"] = (mf.set_tiff_tag(g4_data, 279, 40), "ccitt")
    zs = codec_tiff(mixed, 2, 50000, lambda r: zstd_frames(r, checksum=True)[:-4] + b"\0\0\0\0",
                    rows_per_strip=8)
    out["refused_zstd_checksum.tif"] = (zs, "zstd")
    out["refused_thunderscan_long_row.tif"] = (mf.tiff(
        g4[:2], 1, bits=4, compression=32809, chunks=[b"\xc3" * 40 + b"\x3f"]), "thunderscan")
    return out


def timing_files(hw=(480, 640)):
    """{name: bytes} of 640 x 480 files for decode times
    (tests/fixtures/images/time_decode.py): a scanned page as Group 4, a
    photo-like RGB image as LZMA and as ZSTD (PIL's writer, predictor 2,
    strips of 16 rows) and as uncompressed CIELab."""
    import lzma

    from PIL import Image, TiffImagePlugin

    rgb = mf.photo(hw, 8)
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[317], info[278] = 2, 16
    lab = np.stack([rgb[..., 1], rgb[..., 0] - np.uint8(128), rgb[..., 2] - np.uint8(128)], -1)
    return {
        "tiff_g4_640.tif": ccitt_tiff(bilevel(hw, 11), "g4", white=True),
        "tiff_lzma_pred_640.tif": codec_tiff(
            rgb, 2, 34925, lambda r: lzma.compress(r, format=lzma.FORMAT_XZ), rows_per_strip=16,
            predictor=2),
        "tiff_zstd_pred_640.tif": pil_save(Image.fromarray(rgb), compression="zstd",
                                           tiffinfo=info),
        "tiff_cielab_640.tif": mf.tiff(lab, 8, rows_per_strip=16),
    }


# The words of the port's ValueError for each refused file.
REFUSED = {"refused_g4_early_end.tif": "Group 4 data ends",
           "refused_zstd_checksum.tif": "checksum",
           "refused_thunderscan_long_row.tif": "a row of other than its width"}


def main():
    from PIL import Image

    written = files()
    expected = {}
    for name, (data, codec) in sorted(written.items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        if name in REFUSED:
            expected[name] = {"error": REFUSED[name], "codec": codec}
            continue
        Image.open(io.BytesIO(data)).convert("RGB")
        expected[name] = {**mf.pil_digests(data), "codec": codec}
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(d) for d, _ in written.values())
    assert total <= SIZE_BUDGET, total
    print(f"wrote {len(expected)} files, {total} bytes, and expected.json")


if __name__ == "__main__":
    main()
