"""Write the WebP fixtures that tests/test_torch_webp.py and chip_smoke.py
hold the port's decoder (multimae_tpu_torch/native/webp_decode.cpp)
against, and expected.json: for each file PIL's mode and the shape and
SHA-256 of its convert("RGB") pixels and of its raw pixels (np.asarray of
the image, alpha dropped: the port's raw form), or for a file PIL refuses,
the words the port's ValueError names.

    python tests/fixtures/webp/make_fixtures.py

PIL (12.1, with libwebp 1.6) writes the lossy files (quality 0-100, method
0-6, sizes from 1 x 1 to 70 x 50), lossy files with alpha, lossless ones
(each method, with and without `exact`, palettes of 2, 4, 16 and 256
colours), animations (frames at offsets, `allow_mixed`, `kmin`/`kmax`) and
files with ICC, EXIF and XMP chunks. Pillow's writer exposes only
lossless, quality, alpha_quality, method, exact and the animation options,
so what libwebp's defaults never emit is written here:

* `vp8_frame`: VP8 key frames from RFC 6386's boolean encoder, with the
  frame header's every option (segments with and without a map, the simple
  and the normal loop filter, sharpness, loop-filter deltas, 1, 2, 4 or 8
  token partitions, quantiser deltas, the skip probability, coefficient
  probability updates, the ignored scale and clamping bits) and
  macroblocks drawn from a seed: 16 x 16 and 4 x 4 intra modes and
  coefficient tokens, large ones included (`extreme` makes sums that leave
  16 bits in the inverse transform);
* `alph_chunk`: raw ALPH data under each of the four filters;
* `vp8l_stream`: VP8L images with simple prefix codes (one or two symbols),
  normal codes, a colour cache and backward references.

The probability tables of the VP8 writer are read from the decoder's
source. The refused files are fixtures with their container or bitstream
patched; the script checks that PIL refuses each. The `tree_*` files share
chip_smoke.py's LOADER_HW (48 x 64). Re-running it rewrites every file;
the pixels come from fixed seeds.
"""

from __future__ import annotations

import hashlib
import heapq
import io
import json
import os
import re
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DECODER = os.path.join(HERE, "..", "..", "..", "multimae_tpu_torch", "native", "webp_decode.cpp")
TREE_HW = (48, 64)
SIZE_BUDGET = 100_000  # bytes, for every file of this directory together


def _table(name, shape):
    """A uint8 table of the decoder's source, as an array of `shape`."""
    with open(DECODER) as f:
        text = f.read()
    body = re.search(rf"{name}\[[^=]*= \{{(.*?)\n\}};", text, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"\d+", body)], np.int64).reshape(shape)


COEFFS_PROBA = _table("kCoeffsProba0", (4, 8, 3, 11))
UPDATE_PROBA = _table("kCoeffsUpdateProba", (4, 8, 3, 11))
BMODES_PROBA = _table("kBModesProba", (10, 10, 9))
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CATS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
        (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
B_DC, B_TM, B_VE, B_HE = 0, 1, 2, 3  # the 4 x 4 modes 0-9; the 16 x 16 ones share these four


def photo(hw, seed, noise=8.0, channels=3):
    """A smooth photo-like image with a little noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 100 * np.sin(xx / (5 + 3 * c) + yy / (7 + 2 * c) + c)
                  for c in range(channels)], -1)
    return np.clip(a + rng.normal(0, noise, a.shape), 0, 255).astype(np.uint8)


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def chunk(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def vp8x(width, height, flags) -> bytes:
    return chunk(b"VP8X", struct.pack("<I", flags) + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little"))


def chunks_of(data: bytes) -> list:
    """[(tag, payload)] of a RIFF/WEBP file's chunks."""
    out, at = [], 12
    while at + 8 <= len(data):
        tag, size = data[at:at + 4], struct.unpack_from("<I", data, at + 4)[0]
        out.append((tag, data[at + 8:at + 8 + size]))
        at += 8 + size + (size & 1)
    return out


def pil_webp(pixels, mode="RGB", **options) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels, mode).save(buf, "WEBP", **options)
    return buf.getvalue()


def pil_animation(frames, **options) -> bytes:
    from PIL import Image

    ims = [Image.fromarray(f, "RGBA") for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, "WEBP", save_all=True, append_images=ims[1:], duration=40, **options)
    return buf.getvalue()


# --- VP8 --------------------------------------------------------------------------


class BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.range, self.bottom, self.bit_count, self.out = 255, 0, 24, bytearray()

    def put(self, bit, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):  # carry into the bytes out
                i = len(self.out) - 1
                while self.out[i] == 255:
                    self.out[i] = 0
                    i -= 1
                self.out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if self.bit_count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v, n):
        for i in reversed(range(n)):
            self.put((v >> i) & 1, 128)

    def signed(self, v, n):
        self.value(abs(v), n)
        self.put(int(v < 0), 128)

    def optional(self, v, n, signed=True):
        """A flag, then the value where it is not zero."""
        self.put(int(v != 0), 128)
        if v:
            self.signed(v, n) if signed else self.value(v, n)

    def finish(self) -> bytes:
        for _ in range(32):  # push the last bits out, as libvpx's encoder does
            self.put(0, 128)
        return bytes(self.out)


def _large_value(bw, v, p):
    """GetLargeValue's tree for v >= 2, under the probabilities p."""
    if v <= 4:
        bw.put(0, p[3])
        bw.put(int(v > 2), p[4])
        if v > 2:
            bw.put(v - 3, p[5])
    elif v <= 10:
        bw.put(1, p[3])
        bw.put(0, p[6])
        if v <= 6:
            bw.put(0, p[7])
            bw.put(v - 5, 159)
        else:
            bw.put(1, p[7])
            bw.put((v - 7) >> 1, 165)
            bw.put((v - 7) & 1, 145)
    else:
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        bw.put(1, p[3])
        bw.put(1, p[6])
        bw.put(cat >> 1, p[8])
        bw.put(cat & 1, p[9 + (cat >> 1)])
        extra, tab = v - 3 - (8 << cat), CATS[cat]
        for i, prob in enumerate(tab):
            bw.put((extra >> (len(tab) - 1 - i)) & 1, prob)


def _tokens(bw, proba, ctx, zz, first):
    """One block's coefficients (zigzag order) from `first` on; returns
    what the decoder's GetCoeffs returns."""
    nonzero = [i for i in range(first, 16) if zz[i]]
    last = nonzero[-1] if nonzero else -1
    n = first
    p = proba[BANDS[n]][ctx]
    while n < 16:
        bw.put(int(n <= last), p[0])
        if n > last:
            return n
        while zz[n] == 0:
            bw.put(0, p[1])
            n += 1
            p = proba[BANDS[n]][0]
        bw.put(1, p[1])
        v = abs(int(zz[n]))
        bw.put(int(v > 1), p[2])
        if v > 1:
            _large_value(bw, v, p)
        bw.put(int(zz[n] < 0), 128)
        p = proba[BANDS[n + 1]][1 if v == 1 else 2]
        n += 1
    return 16


def _block(rng, first, big):
    """Coefficients of one block in zigzag order: a few small ones, and
    with `big` some of every size category."""
    zz = np.zeros(16, np.int64)
    count = int(rng.integers(0, 6))
    for i in rng.choice(np.arange(first, 16), size=min(count, 16 - first), replace=False):
        zz[i] = int(rng.integers(1, 4))
    if big and rng.random() < 0.5:
        i = int(rng.integers(first, 16))
        zz[i] = int(rng.choice([5, 9, 15, 30, 60, 500, 2114]))
    return zz * rng.choice([-1, 1], 16)


def vp8_frame(hw, seed, *, simple=False, level=20, sharpness=0, lf_deltas=None, segments=None,
              parts=1, q=40, q_deltas=(0, 0, 0, 0, 0), skip_prob=None, updates=0, big=True,
              extreme=False, scale_bits=0, clamp=0) -> bytes:
    """A VP8 key frame (the payload of a "VP8 " chunk) of hw pixels whose
    modes and coefficients are drawn from `seed`. `lf_deltas`: (ref, mode)
    deltas sent with the header; `segments`: dict(update_map, absolute,
    quant (4), filter (4), probs (3)); `updates`: how many coefficient
    probabilities the header replaces; `extreme`: one block of each
    macroblock gets coefficients whose inverse transform leaves 16 bits."""
    rng = np.random.default_rng(seed)
    h, w = hw
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    proba = COEFFS_PROBA.copy()
    bw = BoolEncoder()
    bw.put(0, 128)  # colour space
    bw.put(clamp, 128)
    seg = segments or {}
    bw.put(int(bool(seg)), 128)
    if seg:
        bw.put(int(seg["update_map"]), 128)
        bw.put(1, 128)  # update data
        bw.put(int(seg["absolute"]), 128)
        for v in seg["quant"]:
            bw.optional(v, 7)
        for v in seg["filter"]:
            bw.optional(v, 6)
        if seg["update_map"]:
            for v in seg["probs"]:
                bw.optional(v, 8, signed=False)
    bw.put(int(simple), 128)
    bw.value(level, 6)
    bw.value(sharpness, 3)
    bw.put(int(lf_deltas is not None), 128)
    if lf_deltas is not None:
        bw.put(1, 128)  # update the deltas
        for v in lf_deltas[0]:
            bw.optional(v, 6)
        for v in lf_deltas[1]:
            bw.optional(v, 6)
    bw.value({1: 0, 2: 1, 4: 2, 8: 3}[parts], 2)
    bw.value(q, 7)
    for v in q_deltas:
        bw.optional(v, 4)
    bw.put(0, 128)  # refresh entropy probabilities
    chosen = set(int(i) for i in rng.choice(4 * 8 * 3 * 11, size=updates, replace=False))
    for i in range(4 * 8 * 3 * 11):
        t, b, c, k = np.unravel_index(i, (4, 8, 3, 11))
        bw.put(int(i in chosen), int(UPDATE_PROBA[t, b, c, k]))
        if i in chosen:
            proba[t, b, c, k] = int(rng.integers(1, 256))
            bw.value(int(proba[t, b, c, k]), 8)
    bw.put(int(skip_prob is not None), 128)
    if skip_prob is not None:
        bw.value(skip_prob, 8)

    tokens = [BoolEncoder() for _ in range(parts)]
    intra_t = np.zeros(4 * mb_w, np.int64)
    top_y, top_u, top_v = (np.zeros((mb_w, k), np.int64) for k in (4, 2, 2))
    top_dc = np.zeros(mb_w, np.int64)
    seg_probs = seg.get("probs", (255, 255, 255)) if seg.get("update_map") else None
    for mb_y in range(mb_h):
        tb = tokens[mb_y & (parts - 1)]
        intra_l = np.zeros(4, np.int64)
        left_y, left_u, left_v = (np.zeros(k, np.int64) for k in (4, 2, 2))
        left_dc = 0
        for mb_x in range(mb_w):
            if seg_probs is not None:
                s = int(rng.integers(0, 4))
                bw.put(int(s >= 2), seg_probs[0] or 255)
                bw.put(s & 1, (seg_probs[2] if s >= 2 else seg_probs[1]) or 255)
            skip = int(skip_prob is not None and rng.random() < 0.3)
            if skip_prob is not None:
                bw.put(skip, skip_prob)
            i4 = bool(rng.random() < 0.5)
            bw.put(int(not i4), 145)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if not i4:
                ymode = int(rng.choice([B_DC, B_VE, B_HE, B_TM]))
                bw.put(int(ymode in (B_HE, B_TM)), 156)
                bw.put(int(ymode in (B_VE, B_TM)), 163 if ymode in (B_DC, B_VE) else 128)
                top[:] = ymode
                intra_l[:] = ymode
            else:
                for y in range(4):
                    ymode = int(intra_l[y])
                    for x in range(4):
                        p = BMODES_PROBA[top[x], ymode]
                        ymode = int(rng.integers(0, 10))
                        # the tree: DC | TM | VE | (HE | (RD | VR)) | (LD | (VL | (HD | HU)))
                        path = {0: [(0, 0)], 1: [(1, 0), (0, 1)], 2: [(1, 0), (1, 1), (0, 2)],
                                3: [(1, 0), (1, 1), (1, 2), (0, 3), (0, 4)],
                                4: [(1, 0), (1, 1), (1, 2), (0, 3), (1, 4), (0, 5)],
                                5: [(1, 0), (1, 1), (1, 2), (0, 3), (1, 4), (1, 5)],
                                6: [(1, 0), (1, 1), (1, 2), (1, 3), (0, 6)],
                                7: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (0, 7)],
                                8: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (1, 7), (0, 8)],
                                9: [(1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (1, 7), (1, 8)]}
                        for bit, k in path[ymode]:
                            bw.put(bit, int(p[k]))
                        top[x] = ymode
                    intra_l[y] = ymode
            uvmode = int(rng.choice([B_DC, B_VE, B_HE, B_TM]))
            bw.put(int(uvmode != B_DC), 142)
            if uvmode != B_DC:
                bw.put(int(uvmode != B_VE), 114)
                if uvmode != B_VE:
                    bw.put(int(uvmode == B_TM), 183)
            if skip:
                top_y[mb_x] = left_y[:] = 0
                top_u[mb_x] = left_u[:] = top_v[mb_x] = left_v[:] = 0
                if not i4:
                    top_dc[mb_x] = left_dc = 0
                continue
            first = 0
            if not i4:
                dc = _block(rng, 0, big)
                if extreme:
                    dc[:] = 0
                    dc[0], dc[2] = 2000, -2000
                nz = _tokens(tb, proba[1], int(top_dc[mb_x] + left_dc), dc, 0)
                top_dc[mb_x] = left_dc = int(nz > 0)
                first = 1
            ac = proba[0] if not i4 else proba[3]
            for y in range(4):
                for x in range(4):
                    zz = _block(rng, first, big)
                    if extreme and i4 and x == y == 0:  # in[0] + in[8] past 32767 at q 127
                        zz[:] = 0
                        zz[0], zz[1], zz[3] = 200, 100, 110
                    nz = _tokens(tb, ac, int(left_y[y] + top_y[mb_x, x]), zz, first)
                    left_y[y] = top_y[mb_x, x] = int(nz > first)
            for top_c, left_c in ((top_u, left_u), (top_v, left_v)):
                for y in range(2):
                    for x in range(2):
                        nz = _tokens(tb, proba[2], int(left_c[y] + top_c[mb_x, x]),
                                     _block(rng, 0, big), 0)
                        left_c[y] = top_c[mb_x, x] = int(nz > 0)
    part0 = bw.finish()
    data = [t.finish() for t in tokens]
    tag = (1 << 4) | (len(part0) << 5)  # key frame, profile 0, shown
    header = (struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a"
              + struct.pack("<HH", w | (scale_bits << 14), h | (scale_bits << 14)))
    sizes = b"".join(len(d).to_bytes(3, "little") for d in data[:-1])
    return header + part0 + sizes + b"".join(data)


# --- ALPH -------------------------------------------------------------------------


def alph_chunk(alpha: np.ndarray, filt: int, pre_processing: int = 0) -> bytes:
    """A raw (uncompressed) ALPH chunk of the (h, w) uint8 plane, filtered
    by libwebp's filter `filt` (0 none, 1 horizontal, 2 vertical, 3
    gradient)."""
    a = alpha.astype(np.int64)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]  # the first row: from the left, 0 before it
    if filt == 1:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = a[1:, :-1]
    elif filt == 2:
        pred[1:] = a[:-1]
    elif filt == 3:
        pred[1:, 0] = a[:-1, 0]
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    deltas = (a - pred) & 255 if filt else a
    return chunk(b"ALPH", bytes([(pre_processing << 4) | (filt << 2)])
                 + deltas.astype(np.uint8).tobytes())


# --- VP8L -------------------------------------------------------------------------


class BitWriter:
    """LSB-first bits."""

    def __init__(self):
        self.acc, self.n, self.out = 0, 0, bytearray()

    def bits(self, v, n):
        self.acc |= int(v) << self.n
        self.n += n
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def finish(self) -> bytes:
        if self.n:
            self.out.append(self.acc & 255)
        return bytes(self.out)


def huffman_lengths(freqs, max_len):
    """Code lengths of a Huffman code of `freqs` no longer than max_len (the
    frequencies flattened until it fits)."""
    freqs = [int(f) for f in freqs]
    while True:
        used = [(f, s) for s, f in enumerate(freqs) if f]
        lengths = [0] * len(freqs)
        if len(used) == 1:
            lengths[used[0][1]] = 1
            return lengths
        heap = [(f, i, [s]) for i, (f, s) in enumerate(used)]
        heapq.heapify(heap)
        tie = len(heap)
        while len(heap) > 1:
            fa, _, sa = heapq.heappop(heap)
            fb, _, sb = heapq.heappop(heap)
            for s in sa + sb:
                lengths[s] += 1
            heapq.heappush(heap, (fa + fb, tie, sa + sb))
            tie += 1
        if max(lengths) <= max_len:
            return lengths
        freqs = [(f + 1) // 2 if f else 0 for f in freqs]


def canonical(lengths):
    """{symbol: (code, length)}, the canonical code VP8L and deflate use."""
    codes, code = {}, 0
    order = sorted((n, s) for s, n in enumerate(lengths) if n)
    prev = order[0][0] if order else 0
    for n, s in order:
        code <<= n - prev
        prev = n
        codes[s] = (code, n)
        code += 1
    return codes


def _emit(bw, codes, symbol):
    if len(codes) == 1:  # a code of one symbol takes no bits
        return
    code, n = codes[symbol]
    for i in reversed(range(n)):
        bw.bits((code >> i) & 1, 1)


CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def write_code(bw, freqs, force_normal=False, invalid=False):
    """The prefix code of an alphabet with these symbol counts: a simple
    code where at most two symbols below 256 occur, else a normal one
    (its code lengths as literals of a code-length code). `invalid` writes
    lengths that form no complete code. Returns {symbol: (code, length)}."""
    used = [s for s, f in enumerate(freqs) if f]
    if not used:
        used = [0]
    if len(used) <= 2 and max(used) < 256 and not force_normal and not invalid:
        bw.bits(1, 1)
        bw.bits(len(used) - 1, 1)
        bw.bits(int(used[0] >= 2), 1)
        bw.bits(used[0], 8 if used[0] >= 2 else 1)
        if len(used) == 2:
            bw.bits(used[1], 8)
        return canonical([1 if s in used else 0 for s in range(max(used) + 1)])
    lengths = huffman_lengths([f if f else 0 for f in freqs], 15)
    if invalid:
        lengths = [0] * len(freqs)
        lengths[0], lengths[1] = 1, 2  # over half the code space left open
    cl_freqs = [0] * 19
    for n in lengths:
        cl_freqs[n] += 1
    cl_lengths = huffman_lengths(cl_freqs, 7)
    num = max(4, max(i for i, s in enumerate(CODE_LENGTH_ORDER) if cl_lengths[s]) + 1)
    bw.bits(0, 1)
    bw.bits(num - 4, 4)
    for s in CODE_LENGTH_ORDER[:num]:
        bw.bits(cl_lengths[s], 3)
    bw.bits(0, 1)  # every symbol's length follows
    cl_codes = canonical(cl_lengths)
    for n in lengths:
        _emit(bw, cl_codes, n)
    return canonical(lengths)


def _prefix(value):
    """(symbol, extra bits, extra value) of a VP8L length or distance."""
    v = value - 1
    if v < 4:
        return v, 0, 0
    hb = v.bit_length() - 1
    second = (v >> (hb - 1)) & 1
    return 2 * hb + second, hb - 1, v & ((1 << (hb - 1)) - 1)


def vp8l_stream(argb: np.ndarray, cache_bits=0, backrefs=True, subtract_green=False,
                alpha_hint=True, invalid_code=False) -> bytes:
    """A VP8L bitstream of the (h, w) uint32 ARGB pixels: no transform (or
    subtract-green), a colour cache of `cache_bits`, one prefix-code group;
    where a row repeats the one above from some column on, a backward
    reference at distance code 1 copies it."""
    h, w = argb.shape
    px = argb.reshape(-1).astype(np.uint64)
    if subtract_green:
        g = (px >> 8) & 255
        px = (px & 0xFF00FF00) | ((((px >> 16) - g) & 255) << 16) | (((px & 255) - g) & 255)
    px = [int(v) for v in px]
    cache = [0] * (1 << cache_bits) if cache_bits else None
    syms, i = [], 0  # ("lit", argb) | ("cache", key) | ("copy", length)

    def insert(v):
        if cache is not None:
            cache[((v * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache_bits)] = v

    while i < len(px):
        run = 0
        if backrefs and i >= w:
            while i + run < len(px) and px[i + run] == px[i + run - w] and run < 4096:
                run += 1
        if run >= 3:
            syms.append(("copy", run))
            for k in range(run):
                insert(px[i + k])
            i += run
            continue
        v = px[i]
        key = ((v * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - cache_bits) if cache_bits else None
        syms.append(("cache", key) if cache is not None and cache[key] == v else ("lit", v))
        insert(v)
        i += 1
    green = [0] * (280 + (1 << cache_bits if cache_bits else 0))
    red, blue, alpha, dist = [0] * 256, [0] * 256, [0] * 256, [0] * 40
    for kind, v in syms:
        if kind == "lit":
            green[(v >> 8) & 255] += 1
            red[(v >> 16) & 255] += 1
            blue[v & 255] += 1
            alpha[v >> 24] += 1
        elif kind == "cache":
            green[280 + v] += 1
        else:
            green[256 + _prefix(v)[0]] += 1
            dist[_prefix(1)[0]] += 1
    bw = BitWriter()
    bw.bits(0x2F, 8)
    bw.bits(w - 1, 14)
    bw.bits(h - 1, 14)
    bw.bits(int(alpha_hint), 1)
    bw.bits(0, 3)
    if subtract_green:
        bw.bits(1, 1)
        bw.bits(2, 2)
    bw.bits(0, 1)  # no more transforms
    bw.bits(int(cache_bits > 0), 1)
    if cache_bits:
        bw.bits(cache_bits, 4)
    bw.bits(0, 1)  # no meta prefix codes
    cg = write_code(bw, green, force_normal=True)
    cr = write_code(bw, red, invalid=invalid_code)
    cb, ca, cd = write_code(bw, blue), write_code(bw, alpha), write_code(bw, dist)
    if invalid_code:  # the decoder stops at the code
        return bw.finish() + bytes(16)
    for kind, v in syms:
        if kind == "lit":
            _emit(bw, cg, (v >> 8) & 255)
            _emit(bw, cr, (v >> 16) & 255)
            _emit(bw, cb, v & 255)
            _emit(bw, ca, v >> 24)
        elif kind == "cache":
            _emit(bw, cg, 280 + v)
        else:
            sym, nbits, extra = _prefix(v)
            _emit(bw, cg, 256 + sym)
            bw.bits(extra, nbits)
            _emit(bw, cd, _prefix(1)[0])
    return bw.finish()


def argb_of(rgba: np.ndarray) -> np.ndarray:
    a = rgba.astype(np.uint32)
    return (a[..., 3] << 24) | (a[..., 0] << 16) | (a[..., 1] << 8) | a[..., 2]


# --- the fixtures -----------------------------------------------------------------


def pil_files():
    """{name: bytes} of the files PIL writes."""
    out = {}
    lossy = [((1, 1), 50, 4), ((1, 7), 80, 0), ((7, 1), 20, 6), ((2, 3), 100, 2),
             ((13, 17), 0, 0), ((31, 45), 25, 1), ((50, 70), 100, 6), ((33, 33), 75, 2),
             ((16, 64), 90, 3), ((48, 48), 5, 5), ((64, 16), 60, 6), ((70, 50), 95, 4)]
    for i, (hw, q, m) in enumerate(lossy):
        out[f"lossy_{hw[0]}x{hw[1]}_q{q}_m{m}.webp"] = pil_webp(photo(hw, 10 + i), quality=q,
                                                               method=m)
    for i, (hw, aq, m) in enumerate([((23, 29), 0, 0), ((40, 33), 50, 4), ((17, 64), 100, 6),
                                     ((2, 2), 30, 2)]):
        rgba = photo(hw, 30 + i, channels=4)
        rgba[::3, ::2, 3] = 0  # transparent pixels, their colour kept or not by the encoder
        out[f"alpha_{hw[0]}x{hw[1]}_aq{aq}_m{m}.webp"] = pil_webp(
            rgba, "RGBA", quality=70, alpha_quality=aq, method=m)
    for m in range(7):
        rgba = photo((21 + 3 * m, 34 - 2 * m), 40 + m, channels=4)
        rgba[..., 3] = np.where(rgba[..., 0] > 150, 0, rgba[..., 3])
        exact = m % 2 == 1
        out[f"lossless_m{m}{'_exact' if exact else ''}.webp"] = pil_webp(
            rgba, "RGBA", lossless=True, method=m, exact=exact, quality=(15 * m) % 101)
    for n in (2, 4, 16, 256):
        from PIL import Image

        im = Image.fromarray(photo((27, 38), 50 + n)).quantize(n).convert("RGB")
        out[f"palette_{n}.webp"] = pil_webp(np.asarray(im), lossless=True)
    # animations: frame 0 at an offset (what differs from a transparent
    # background), lossy and lossless frames mixed, key frames forced
    a = np.zeros((36, 44, 4), np.uint8)
    a[7:25, 10:31] = photo((18, 21), 60, channels=4)
    b = a.copy()
    b[20:34, 2:40] = photo((14, 38), 61, channels=4)
    out["anim_offset_lossless.webp"] = pil_animation([a, b], lossless=True, background=(0,) * 4)
    out["anim_offset_lossy.webp"] = pil_animation([a, b, a], quality=60, background=(0,) * 4)
    out["anim_mixed_kmin.webp"] = pil_animation([b, a, b], allow_mixed=True, kmin=1, kmax=2,
                                                quality=40)
    # metadata chunks in a VP8X file
    from PIL import Image

    im = Image.fromarray(photo((19, 23), 70))
    buf = io.BytesIO()
    im.save(buf, "WEBP", quality=80, exif=b"Exif\0\0MM\0*\0\0\0\x08\0\0",
            icc_profile=b"\0" * 128, xmp=b"<x:xmpmeta/>")
    out["vp8x_iccp_exif_xmp.webp"] = buf.getvalue()
    return out


def hand_files():
    """{name: bytes} of the files written here."""
    out = {}
    seg = dict(update_map=True, absolute=False, quant=(-8, 0, 12, 30), filter=(-10, 5, 0, 20),
               probs=(120, 0, 200))
    vp8 = {
        "vp8_simple_filter.webp": dict(simple=True, level=30),
        "vp8_simple_sharp_deltas.webp": dict(simple=True, level=40, sharpness=5,
                                             lf_deltas=((7, 0, 0, 0), (-9, 0, 0, 0))),
        "vp8_normal_sharp3_deltas.webp": dict(level=50, sharpness=3,
                                              lf_deltas=((-5, 1, 2, 3), (12, 0, 0, 0))),
        "vp8_2_partitions.webp": dict(parts=2, q=10),
        "vp8_4_partitions_skip.webp": dict(parts=4, skip_prob=90, level=10),
        "vp8_8_partitions_updates.webp": dict(parts=8, updates=60, q=90),
        "vp8_segments_map.webp": dict(segments=seg, level=25),
        "vp8_segments_no_map.webp": dict(segments=dict(seg, update_map=False, absolute=True,
                                                       quant=(50, 1, 2, 3),
                                                       filter=(33, 0, 0, 0)), level=0),
        "vp8_q_deltas.webp": dict(q=127, q_deltas=(15, -15, 7, 12, -8), level=63, sharpness=7),
        "vp8_q0_no_filter.webp": dict(q=0, q_deltas=(-3, 0, 0, -4, 0), level=0),
        "vp8_extreme_coeffs.webp": dict(q=127, q_deltas=(15, 15, 15, 0, 0), extreme=True,
                                        big=False, level=0),
        "vp8_scale_clamp_bits.webp": dict(scale_bits=2, clamp=1),
    }
    sizes = [(33, 47), (40, 40), (45, 21), (70, 50), (135, 24), (44, 44), (48, 64), (30, 50),
             (29, 31), (17, 18), (32, 32), (23, 37)]
    for i, (name, options) in enumerate(vp8.items()):
        out[name] = riff(chunk(b"VP8 ", vp8_frame(sizes[i], 100 + i, **options)))
    # raw ALPH under each filter, before a PIL-written lossy frame
    rgb = photo((26, 35), 80)
    frame = chunks_of(pil_webp(rgb, quality=70))[0][1]
    alpha = photo((26, 35), 81, channels=1)[..., 0]
    alpha[5:9] = 0
    for filt, what in enumerate(("none", "horizontal", "vertical", "gradient")):
        out[f"alph_raw_{what}.webp"] = riff(vp8x(35, 26, 0x10), alph_chunk(alpha, filt, filt & 1),
                                            chunk(b"VP8 ", frame))
    # alpha without the flag is dropped; the flag without alpha gives 255
    out["alph_without_flag.webp"] = riff(vp8x(35, 26, 0), alph_chunk(alpha, 3),
                                         chunk(b"VP8 ", frame))
    out["alpha_flag_without_alph.webp"] = riff(vp8x(35, 26, 0x10), chunk(b"VP8 ", frame))
    out["vp8_trailing_chunk.webp"] = riff(chunk(b"VP8 ", frame), chunk(b"JUNK", b"12345"))
    # VP8L: simple codes, a colour cache, backward references
    rng = np.random.default_rng(90)
    few = np.array([[255, 10, 200, 30], [255, 10, 90, 30]], np.uint8)
    rgba = few[rng.integers(0, 2, (19, 27))]
    out["vp8l_simple_codes.webp"] = riff(chunk(b"VP8L", vp8l_stream(argb_of(rgba))))
    pal = rng.integers(0, 256, (12, 4), dtype=np.uint8)
    rgba = pal[rng.integers(0, 12, (25, 31))]
    rgba[10:] = rgba[:15]  # rows that repeat
    out["vp8l_cache_backrefs.webp"] = riff(chunk(b"VP8L", vp8l_stream(argb_of(rgba),
                                                                      cache_bits=4)))
    rgba = photo((22, 26), 91, channels=4)
    out["vp8l_cache11_subtract_green.webp"] = riff(chunk(b"VP8L", vp8l_stream(
        argb_of(rgba), cache_bits=11, subtract_green=True, alpha_hint=False)))
    # a VP8L-coded alpha plane whose last symbol runs past its chunk, which
    # libwebp's 8-bit alpha path takes
    rgba = photo((23, 29), 202, channels=4)
    rgba[..., 3] = np.where(rgba[..., 0] > 128, 255, 0)
    parts = dict(chunks_of(pil_webp(rgba, "RGBA", quality=70, alpha_quality=100)))
    out["alpha_vp8l_last_symbol_short.webp"] = riff(
        chunk(b"VP8X", parts[b"VP8X"]), chunk(b"ALPH", parts[b"ALPH"][:-1]),
        chunk(b"VP8 ", parts[b"VP8 "]))
    return out


def refused_files(base):
    """{name: (bytes, the words of the port's error)} of files PIL refuses."""
    lossy, lossless = base["lossy_31x45_q25_m1.webp"], base["lossless_m2.webp"]
    out = {}
    out["refused_truncated.webp"] = (lossy[:len(lossy) // 2], "runs past")
    out["refused_riff_size.webp"] = (lossy[:4] + struct.pack("<I", len(lossy) + 92) + lossy[8:],
                                     "runs past")
    frame = chunks_of(lossy)[0][1]
    out["refused_canvas_size.webp"] = (riff(vp8x(46, 31, 0), chunk(b"VP8 ", frame)),
                                       "invalid container")
    out["refused_not_key_frame.webp"] = (riff(chunk(b"VP8 ", bytes([frame[0] | 1]) + frame[1:])),
                                         "invalid container")
    vl = chunks_of(lossless)[0][1]
    out["refused_vp8l_version.webp"] = (riff(chunk(b"VP8L", vl[:4] + bytes([vl[4] | 0x20])
                                                   + vl[5:])), "invalid container")
    out["refused_unknown_chunk.webp"] = (lossy[:12] + b"VP8Y" + lossy[16:], "PIL cannot identify")
    out["refused_alph_after_vp8.webp"] = (riff(vp8x(45, 31, 0x10), chunk(b"VP8 ", frame),
                                               alph_chunk(np.zeros((31, 45), np.uint8), 0)),
                                          "invalid container")
    cut = frame[:int(len(frame) * 0.6)]
    out["refused_tokens_cut.webp"] = (riff(chunk(b"VP8 ", cut)), "premature end")
    out["refused_vp8l_prefix_code.webp"] = (riff(chunk(b"VP8L", vp8l_stream(
        argb_of(photo((9, 12), 95, channels=4)), invalid_code=True))), "invalid prefix code")
    out["refused_alph_method.webp"] = (riff(vp8x(45, 31, 0x10), chunk(b"ALPH", b"\x02\0\0"),
                                            chunk(b"VP8 ", frame)), "ALPH: compression")
    small = chunks_of(base["anim_offset_lossy.webp"])
    anmf = next(p for t, p in small if t == b"ANMF")
    out["refused_bomb_canvas.webp"] = (riff(vp8x(13400, 13400, 0x12),
                                            chunk(b"ANIM", b"\0" * 6), chunk(b"ANMF", anmf)),
                                       "decompression-bomb")
    return out


def tree_files(hw=TREE_HW):
    """The rgb images of chip_smoke.py's pretraining tree, all of hw."""
    h, w = hw
    rgba = photo(hw, 120, channels=4)
    rgba[..., 3] = np.where((np.arange(w) // 8) % 2 == 0, 255, 40)
    a = np.zeros((h, w, 4), np.uint8)
    a[6:40, 9:57] = photo((34, 48), 121, channels=4)
    a[6:40, 9:57, 3] = 255
    b = a.copy()
    b[:20] = photo((20, w), 122, channels=4)
    return {"tree_webp_lossy420.webp": pil_webp(photo(hw, 123), quality=90),
            "tree_webp_alpha.webp": pil_webp(rgba, "RGBA", quality=85),
            "tree_webp_lossless.webp": pil_webp(photo(hw, 124), lossless=True),
            "tree_webp_anim.webp": pil_animation([a, b], quality=80, background=(0,) * 4)}


def timing_files(hw=(480, 640)):
    """{name: bytes} of 640 x 480 photo-like WebP files for decode times
    (tests/fixtures/images/time_decode.py): lossy at quality 90, lossy with
    alpha, lossless."""
    rgba = photo(hw, 130, channels=4)
    rgba[..., 3] = np.clip(rgba[..., 3].astype(int) + 60, 0, 255)
    return {"webp_lossy_q90_640.webp": pil_webp(photo(hw, 131), quality=90),
            "webp_alpha_640.webp": pil_webp(rgba, "RGBA", quality=90),
            "webp_lossless_640.webp": pil_webp(photo(hw, 132), lossless=True)}


def pil_digests(data: bytes) -> dict:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    rgb = np.asarray(img.convert("RGB"))
    raw = np.asarray(img)
    raw = np.ascontiguousarray(raw[..., :3])
    return {"mode": img.mode, "shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "raw_shape": list(raw.shape), "raw_dtype": str(raw.dtype),
            "raw_sha256": hashlib.sha256(raw.tobytes()).hexdigest()}


def main():
    from PIL import Image

    files = {**pil_files(), **hand_files(), **tree_files()}
    refused = refused_files(files)
    expected = {}
    for name, (data, words) in refused.items():
        try:
            Image.open(io.BytesIO(data)).convert("RGB")
        except Exception:  # noqa: BLE001 - the JAX loader's retry catches every Exception
            expected[name] = {"error": words}
            files[name] = data
            continue
        raise SystemExit(f"{name}: PIL reads it, so the port must too")
    for name in sorted(os.listdir(HERE)):
        if name.endswith(".webp"):
            os.remove(os.path.join(HERE, name))
    for name, data in sorted(files.items()):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        if name not in expected:
            expected[name] = pil_digests(data)
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(dict(sorted(expected.items())), f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(v) for v in files.values())
    print(f"wrote {len(files)} files, {total} bytes, and expected.json")
    if total > SIZE_BUDGET:
        raise SystemExit(f"{total} bytes: past the directory's budget of {SIZE_BUDGET}")


if __name__ == "__main__":
    main()
