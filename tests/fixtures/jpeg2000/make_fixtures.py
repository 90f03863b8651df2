"""Write the JPEG 2000 fixtures that tests/test_torch_jpeg2000.py and
chip_smoke.py hold the port's decoder (multimae_tpu_torch/native/
jpeg2000_decode.cpp, data/image_io.py `read_jpeg2000`) against, and
expected.json: for each file PIL's mode and the shape and SHA-256 of its
convert("RGB") pixels and of its raw pixels (np.asarray of the image, alpha
dropped: the port's raw form), or for a file PIL refuses, the words the
port's ValueError names.

    python tests/fixtures/jpeg2000/make_fixtures.py

PIL (12.1, with OpenJPEG 2.5.4) writes JP2 and J2K files over its writer's
options: reversible and irreversible, 1 to 7 resolutions, tiles with odd
sizes and offsets, the five progression orders, several quality layers in
both quality modes, non-square code-blocks, precincts, the MCT on and off,
signed samples, PLT, a comment, modes L, LA, RGB, RGBA and I;16 and sizes
down to 1 x 1. Pillow's writer exposes nothing else, so what OpenJPEG's
writer never emits for it is written here by `encode`, a reversible 5/3
encoder of its own (the MQ coder of Annex C, the coding passes of Annex D,
tag trees and packet headers of Annex B):

* every code-block style switch and their mixes (bypass, context reset,
  termination on each pass, vertically causal contexts, predictable
  termination, segmentation symbols);
* SOP and EPH markers, packed packet headers in PPM and PPT, progression
  order changes (POC), several tile-parts per tile, COC and QCC;
* ROI maxshift (RGN), with the shift at and past the background's bits;
* sub-sampled components, precision from 1 to 16 bits, signed components;
* JP2 boxes: sYCC, eYCC, CMYK and greyscale colr boxes, a pclr palette with
  cmap (mode "P" and "PA"), cdef, and res.

Each file `encode` writes is checked here: PIL must decode the lossless
ones to the very samples encoded, so the encoder is held to OpenJPEG before
the port's decoder is held to PIL. The refused files are fixtures with
their container or codestream patched; the script checks that PIL refuses
each. The `tree_*` files share chip_smoke.py's LOADER_HW (48 x 64).
Re-running it rewrites every file; the pixels come from fixed seeds.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TREE_HW = (48, 64)
SIZE_BUDGET = 100_000  # bytes, for every file of this directory together
GUARD_BITS = 2  # the hand-written codestreams' guard bits, but where QCC sets them


def photo(hw, seed, channels=3, noise=8.0):
    """A smooth photo-like uint8 image with a little noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for c in range(channels):
        fx, fy, ph = rng.uniform(0.05, 0.3), rng.uniform(0.05, 0.3), rng.uniform(0, 6.3)
        v = 128 + 90 * np.sin(fx * x + ph) * np.cos(fy * y - ph) + rng.normal(0, noise, (h, w))
        out.append(v)
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


def pil_j2k(pixels, mode=None, **options) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(pixels, mode).save(buf, "JPEG2000", **options)
    return buf.getvalue()


# --- the MQ coder (Annex C) ------------------------------------------------------------

QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001,
      0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801,
      0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1,
      0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009,
      0x0005, 0x0001, 0x5601)
NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
        25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16, 17, 18, 19, 19, 20,
        21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42,
        43, 46)
SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32
CTX_ZC, CTX_SC, CTX_MAG, CTX_AGG, CTX_UNI, NCTX = 0, 9, 14, 17, 18, 19


class Contexts:
    def __init__(self):
        self.reset()

    def reset(self):
        self.st = [0] * NCTX
        self.mps = [0] * NCTX
        self.st[CTX_UNI], self.st[CTX_AGG], self.st[CTX_ZC] = 46, 3, 4


class MQEncoder:
    """One terminated MQ code-word segment (INITENC ... FLUSH)."""

    def __init__(self, ctx: Contexts):
        self.ctx = ctx
        self.a, self.c, self.ct = 0x8000, 0, 12
        self.out = bytearray([0])  # out[0] stands for the byte before the segment

    def _byteout(self):
        if self.out[-1] == 0xFF:
            self.out.append((self.c >> 20) & 0xFF)
            self.c &= 0xFFFFF
            self.ct = 7
        elif not self.c & 0x8000000:
            self.out.append((self.c >> 19) & 0xFF)
            self.c &= 0x7FFFF
            self.ct = 8
        else:  # the carry goes into the byte before
            self.out[-1] += 1
            if self.out[-1] == 0xFF:
                self.c &= 0x7FFFFFF
                self.out.append((self.c >> 20) & 0xFF)
                self.c &= 0xFFFFF
                self.ct = 7
            else:
                self.out.append((self.c >> 19) & 0xFF)
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self):
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, d: int, cx: int):
        cs = self.ctx
        s = cs.st[cx]
        qe = QE[s]
        self.a -= qe
        if d == cs.mps[cx]:
            if self.a & 0x8000 == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                cs.st[cx] = NMPS[s]
                self._renorm()
            else:
                self.c += qe
        else:
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if SWITCH[s]:
                cs.mps[cx] = 1 - cs.mps[cx]
            cs.st[cx] = NLPS[s]
            self._renorm()

    def flush(self) -> bytes:
        temp = self.c + self.a
        self.c |= 0xFFFF
        if self.c >= temp:
            self.c -= 0x8000
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        data = bytes(self.out[1:])
        return data[:-1] if data.endswith(b"\xff") else data


class RawEncoder:
    """A raw (bypass) segment: bits most significant first, seven in the byte
    after an 0xFF."""

    def __init__(self):
        self.out = bytearray()
        self.bits, self.n, self.room = 0, 0, 8

    def encode(self, d: int, cx: int = 0):
        self.bits = (self.bits << 1) | d
        self.n += 1
        if self.n == self.room:
            self.out.append(self.bits)
            self.room = 7 if self.bits == 0xFF else 8
            self.bits, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.out.append(self.bits << (self.room - self.n))
        return bytes(self.out)


# --- Tier-1 (Annex D): the coding passes of one code-block --------------------------


class CodeBlock:
    """The three coding passes over one code-block's integer coefficients,
    with the decoder's context rules (jpeg2000_decode.cpp's T1): `segments`
    lists (passes, bytes) as the code-block style splits them."""

    def __init__(self, coef: np.ndarray, orient: int, style: int, roishift: int, mb: int):
        self.v = coef.astype(np.int64)
        self.h, self.w = coef.shape
        self.orient, self.style = orient, style
        self.vsc = bool(style & 8)
        mag = np.abs(self.v)
        self.nbits = int(mag.max()).bit_length() if mag.size else 0
        self.numbps = self.nbits - roishift  # the decoder's Mb - P
        self.zero_planes = roishift + mb - self.nbits
        if self.zero_planes < 0:
            raise ValueError("coefficients deeper than the band's bit-planes")
        self.sig = np.zeros((self.h + 2, self.w + 2), np.uint8)
        self.chi = np.zeros_like(self.sig)
        self.pi = np.zeros_like(self.sig)
        self.mu = np.zeros_like(self.sig)
        self.segments = []
        if self.nbits:
            self._code()

    def _south_hidden(self, y):
        return self.vsc and y % 4 == 3

    def _counts(self, x, y):
        s, i, j = self.sig, y + 1, x + 1
        south = not self._south_hidden(y)
        hh = int(s[i, j - 1]) + int(s[i, j + 1])
        vv = int(s[i - 1, j]) + (int(s[i + 1, j]) if south else 0)
        dd = int(s[i - 1, j - 1]) + int(s[i - 1, j + 1]) + (
            int(s[i + 1, j - 1]) + int(s[i + 1, j + 1]) if south else 0)
        return hh, vv, dd

    def _zc(self, x, y):
        hh, vv, dd = self._counts(x, y)
        if self.orient == 1:
            hh, vv = vv, hh
        if self.orient == 3:
            hv = hh + vv
            if dd >= 3:
                return 8
            if dd == 2:
                return 7 if hv >= 1 else 6
            if dd == 1:
                return 5 if hv >= 2 else (4 if hv == 1 else 3)
            return 2 if hv >= 2 else hv
        if hh == 2:
            return 8
        if hh == 1:
            return 7 if vv >= 1 else (6 if dd >= 1 else 5)
        if vv == 2:
            return 4
        if vv == 1:
            return 3
        return 2 if dd >= 2 else dd

    def _sc(self, x, y):
        i, j = y + 1, x + 1

        def contrib(a, b):
            return (-1 if self.chi[a, b] else 1) if self.sig[a, b] else 0

        hc = contrib(i, j - 1) + contrib(i, j + 1)
        vc = contrib(i - 1, j) + (0 if self._south_hidden(y) else contrib(i + 1, j))
        hc, vc = max(-1, min(1, hc)), max(-1, min(1, vc))
        xorbit = 0
        if hc < 0 or (hc == 0 and vc < 0):
            hc, vc, xorbit = -hc, -vc, 1
        if hc == 0:
            ctx = CTX_SC + (1 if vc == 1 else 0)
        else:
            ctx = CTX_SC + (4 if vc == 1 else (3 if vc == 0 else 2))
        return ctx, xorbit

    def _mag(self, x, y):
        if self.mu[y + 1, x + 1]:
            return CTX_MAG + 2
        return CTX_MAG + 1 if sum(self._counts(x, y)) else CTX_MAG

    def _bit(self, x, y, p):
        return (abs(int(self.v[y, x])) >> p) & 1

    def _significant(self, coder, x, y, raw):
        neg = int(self.v[y, x] < 0)
        if raw:
            coder.encode(neg)
        else:
            ctx, xorbit = self._sc(x, y)
            coder.encode(neg ^ xorbit, ctx)
        self.sig[y + 1, x + 1] = 1
        self.chi[y + 1, x + 1] = neg

    def _columns(self):
        for k in range(0, self.h, 4):
            for x in range(self.w):
                for y in range(k, min(k + 4, self.h)):
                    yield x, y

    def _sigpass(self, coder, p, raw):
        for x, y in self._columns():
            if self.sig[y + 1, x + 1] or self.pi[y + 1, x + 1] or not sum(self._counts(x, y)):
                continue
            b = self._bit(x, y, p)
            coder.encode(b, 0 if raw else self._zc(x, y))
            if b:
                self._significant(coder, x, y, raw)
            self.pi[y + 1, x + 1] = 1

    def _refpass(self, coder, p, raw):
        for x, y in self._columns():
            if not self.sig[y + 1, x + 1] or self.pi[y + 1, x + 1]:
                continue
            coder.encode(self._bit(x, y, p), 0 if raw else self._mag(x, y))
            self.mu[y + 1, x + 1] = 1

    def _clnpass(self, coder, p):
        def step(x, y):
            if self.sig[y + 1, x + 1] or self.pi[y + 1, x + 1]:
                return
            b = self._bit(x, y, p)
            coder.encode(b, self._zc(x, y))
            if b:
                self._significant(coder, x, y, False)

        full = self.h & ~3
        for k in range(0, full, 4):
            for x in range(self.w):
                run = all(not self.sig[y + 1, x + 1] and not self.pi[y + 1, x + 1]
                          and not sum(self._counts(x, y)) for y in range(k, k + 4))
                start = k
                if run:
                    bits = [self._bit(x, y, p) for y in range(k, k + 4)]
                    if not any(bits):
                        coder.encode(0, CTX_AGG)
                        continue
                    coder.encode(1, CTX_AGG)
                    r = bits.index(1)
                    coder.encode(r >> 1, CTX_UNI)
                    coder.encode(r & 1, CTX_UNI)
                    self._significant(coder, x, k + r, False)
                    start = k + r + 1
                for y in range(start, k + 4):
                    step(x, y)
        for x in range(self.w):
            for y in range(full, self.h):
                step(x, y)
        self.pi[...] = 0
        if self.style & 32:
            for b in (1, 0, 1, 0):
                coder.encode(b, CTX_UNI)

    def _code(self):
        ctx = Contexts()
        passes = []  # (passtype, bpno_plus_one)
        bpno = self.nbits
        passtype = 2
        while bpno >= 1:
            passes.append((passtype, bpno))
            passtype += 1
            if passtype == 3:
                passtype, bpno = 0, bpno - 1
        # segments as the decoder's init_seg splits the passes
        sizes = []
        left = len(passes)
        while left > 0:
            if self.style & 4:
                m = 1
            elif self.style & 1:
                m = 10 if not sizes else (2 if sizes[-1][1] in (1, 10) else 1)
            else:
                m = 109
            n = min(m, left)
            sizes.append((n, m))
            left -= n
        at = 0
        for n, _ in sizes:
            kind, b = passes[at]
            raw = (b <= self.numbps - 4) and kind < 2 and bool(self.style & 1)
            coder = RawEncoder() if raw else MQEncoder(ctx)
            for kind, b in passes[at:at + n]:
                p = b - 1
                if kind == 0:
                    self._sigpass(coder, p, raw)
                elif kind == 1:
                    self._refpass(coder, p, raw)
                else:
                    self._clnpass(coder, p)
                if self.style & 2 and not raw:
                    ctx.reset()
            self.segments.append((n, coder.flush()))
            at += n


# --- Tier-2 (Annex B): tag trees, packet headers, progression -----------------------


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc, self.n, self.room = 0, 0, 8

    def put(self, bit: int):
        self.acc = (self.acc << 1) | bit
        self.n += 1
        if self.n == self.room:
            self.out.append(self.acc)
            self.room = 7 if self.acc == 0xFF else 8
            self.acc, self.n = 0, 0

    def bits(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.put((value >> i) & 1)

    def flush(self) -> bytes:
        if self.n:
            self.out.append(self.acc << (self.room - self.n))
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class TagTree:
    def __init__(self, values: np.ndarray):
        h, w = values.shape
        self.levels = [values.astype(np.int64)]
        while h > 1 or w > 1:
            h, w = (h + 1) // 2, (w + 1) // 2
            prev = self.levels[-1]
            nxt = np.full((h, w), 1 << 30, np.int64)
            for y in range(prev.shape[0]):
                for x in range(prev.shape[1]):
                    nxt[y // 2, x // 2] = min(nxt[y // 2, x // 2], prev[y, x])
            self.levels.append(nxt)
        self.low = [np.zeros_like(a) for a in self.levels]
        self.known = [np.zeros(a.shape, bool) for a in self.levels]

    def encode(self, bw: BitWriter, y: int, x: int, threshold: int):
        path = []
        for lvl in range(len(self.levels)):
            path.append((lvl, y >> lvl, x >> lvl))
        low = 0
        for lvl, yy, xx in reversed(path):
            if low > self.low[lvl][yy, xx]:
                self.low[lvl][yy, xx] = low
            else:
                low = self.low[lvl][yy, xx]
            while low < threshold:
                if low >= self.levels[lvl][yy, xx]:
                    if not self.known[lvl][yy, xx]:
                        bw.put(1)
                        self.known[lvl][yy, xx] = True
                    break
                bw.put(0)
                low += 1
            self.low[lvl][yy, xx] = low


def ceildiv(a, b):
    return -(-a // b)


def fwd53_lines(x: np.ndarray, cas: int) -> np.ndarray:
    """The forward reversible 5/3 along axis 1 (the inverse of the
    decoder's), interleaved in, low-pass then high-pass out."""
    n = x.shape[1]
    x = x.astype(np.int64).copy()
    if n == 1:
        return x * 2 if cas else x
    idx = np.arange(n)
    left = np.abs(idx - 1)
    right = np.where(idx + 1 >= n, 2 * (n - 1) - (idx + 1), idx + 1)
    lo, hi = idx[cas::2], idx[1 - cas::2]
    x[:, hi] -= (x[:, left[hi]] + x[:, right[hi]]) >> 1
    x[:, lo] += (x[:, left[lo]] + x[:, right[lo]] + 2) >> 2
    return np.concatenate([x[:, lo], x[:, hi]], axis=1)


class TileComp:
    """One tile-component's resolutions, bands, precincts and code-blocks,
    laid out as jpeg2000_decode.cpp's build_tilecomp lays them."""

    def __init__(self, rect, levels, cblk, precincts, coef_fn):
        self.x0, self.y0, self.x1, self.y1 = rect
        self.nres = levels + 1
        self.res = []
        for r in range(self.nres):
            lev = levels - r
            rx0, ry0 = ceildiv(self.x0, 1 << lev), ceildiv(self.y0, 1 << lev)
            rx1, ry1 = ceildiv(self.x1, 1 << lev), ceildiv(self.y1, 1 << lev)
            pdx, pdy = precincts[r] if precincts else (15, 15)
            pw = (ceildiv(rx1, 1 << pdx) - (rx0 >> pdx)) if rx1 > rx0 else 0
            ph = (ceildiv(ry1, 1 << pdy) - (ry0 >> pdy)) if ry1 > ry0 else 0
            cbw = min(cblk[0], pdx if r == 0 else pdx - 1)
            cbh = min(cblk[1], pdy if r == 0 else pdy - 1)
            bands = []
            for b in ([0] if r == 0 else [1, 2, 3]):
                if r == 0:
                    bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                else:
                    nb = levels - r + 1
                    xob, yob = b & 1, b >> 1
                    bx0 = ceildiv(self.x0 - (xob << (nb - 1)), 1 << nb)
                    by0 = ceildiv(self.y0 - (yob << (nb - 1)), 1 << nb)
                    bx1 = ceildiv(self.x1 - (xob << (nb - 1)), 1 << nb)
                    by1 = ceildiv(self.y1 - (yob << (nb - 1)), 1 << nb)
                precs = []
                for pj in range(ph):
                    for pi in range(pw):
                        px0 = ((rx0 >> pdx) + pi) << pdx
                        py0 = ((ry0 >> pdy) + pj) << pdy
                        px1, py1 = px0 + (1 << pdx), py0 + (1 << pdy)
                        if r:
                            px0, py0, px1, py1 = px0 >> 1, py0 >> 1, px1 >> 1, py1 >> 1
                        qx0, qy0 = max(px0, bx0), max(py0, by0)
                        qx1, qy1 = min(px1, bx1), min(py1, by1)
                        blocks = []
                        if qx1 > qx0 and qy1 > qy0 and bx1 > bx0 and by1 > by0:
                            cx0, cy0 = qx0 >> cbw, qy0 >> cbh
                            cx1, cy1 = ceildiv(qx1, 1 << cbw), ceildiv(qy1, 1 << cbh)
                            for cy in range(cy0, cy1):
                                row = []
                                for cx in range(cx0, cx1):
                                    row.append((max(cx << cbw, qx0), max(cy << cbh, qy0),
                                                min((cx + 1) << cbw, qx1),
                                                min((cy + 1) << cbh, qy1)))
                                blocks.append(row)
                        precs.append(blocks)
                bands.append({"b": b, "rect": (bx0, by0, bx1, by1), "precs": precs})
            self.res.append({"rect": (rx0, ry0, rx1, ry1), "pdx": pdx, "pdy": pdy, "pw": pw,
                             "ph": ph, "bands": bands})
        self.coef = coef_fn(self)

    def band_view(self, r, band):
        """The band's coefficients in the decoder's layout (each band beside
        the lower resolution)."""
        bx0, by0, bx1, by1 = band["rect"]
        x = y = 0
        if band["b"] & 1:
            px0, _, px1, _ = self.res[r - 1]["rect"]
            x = px1 - px0
        if band["b"] & 2:
            _, py0, _, py1 = self.res[r - 1]["rect"]
            y = py1 - py0
        return self.coef[y:y + by1 - by0, x:x + bx1 - bx0]


def forward_dwt(samples: np.ndarray, tc: TileComp) -> np.ndarray:
    """The tile-component's samples (h, w) through the forward 5/3, each
    level columns then rows, into the decoder's layout."""
    a = samples.astype(np.int64).copy()
    for r in range(tc.nres - 1, 0, -1):
        x0, y0, x1, y1 = tc.res[r]["rect"]
        rw, rh = x1 - x0, y1 - y0
        if rw <= 0 or rh <= 0:
            continue
        a[:rh, :rw] = fwd53_lines(a[:rh, :rw].T, y0 % 2).T
        a[:rh, :rw] = fwd53_lines(a[:rh, :rw], x0 % 2)
    return a


def packet_order(tcs, comps, prog, layers, pocs, tile_rect):
    """The decoder's packet order (OpenJPEG's pi.c) for one tile: a list of
    (layer, resolution, component, precinct)."""
    tx0, ty0, tx1, ty1 = tile_rect
    nc = len(tcs)
    maxres = max(t.nres for t in tcs)
    entries = pocs or [(0, 0, layers, maxres, nc, prog)]
    done, out = set(), []

    def emit(lay, r, c, p):
        if c >= nc or r >= tcs[c].nres or lay >= layers:
            return
        res = tcs[c].res[r]
        if p >= res["pw"] * res["ph"] or (lay, r, c, p) in done:
            return
        done.add((lay, r, c, p))
        out.append((lay, r, c, p))

    def steps(cset, rset):
        dx = dy = None
        for c in cset:
            cdx, cdy = comps[c]["dx"], comps[c]["dy"]
            for r in range(tcs[c].nres):
                lev = tcs[c].nres - 1 - r
                res = tcs[c].res[r]
                v = cdx << (res["pdx"] + lev)
                dx = v if dx is None else min(dx, v)
                v = cdy << (res["pdy"] + lev)
                dy = v if dy is None else min(dy, v)
        return dx, dy

    def visit(c, r, x, y, l1):
        if r >= tcs[c].nres:
            return
        cdx, cdy = comps[c]["dx"], comps[c]["dy"]
        res = tcs[c].res[r]
        lev = tcs[c].nres - 1 - r
        trx0, try0 = ceildiv(tx0, cdx << lev), ceildiv(ty0, cdy << lev)
        trx1, try1 = ceildiv(tx1, cdx << lev), ceildiv(ty1, cdy << lev)
        rpx, rpy = res["pdx"] + lev, res["pdy"] + lev
        if not (y % (cdy << rpy) == 0 or (y == ty0 and (try0 << lev) % (1 << rpy))):
            return
        if not (x % (cdx << rpx) == 0 or (x == tx0 and (trx0 << lev) % (1 << rpx))):
            return
        if res["pw"] == 0 or res["ph"] == 0 or trx0 == trx1 or try0 == try1:
            return
        prci = (ceildiv(x, cdx << lev) >> res["pdx"]) - (trx0 >> res["pdx"])
        prcj = (ceildiv(y, cdy << lev) >> res["pdy"]) - (try0 >> res["pdy"])
        for lay in range(l1):
            emit(lay, r, c, prci + prcj * res["pw"])

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    for r0, c0, l1, r1, c1, pg in entries:
        r1, c1, l1 = min(r1, maxres), min(c1, nc), min(l1, layers)
        if pg == 0:
            for lay in range(l1):
                for r in range(r0, r1):
                    for c in range(c0, c1):
                        if r < tcs[c].nres:
                            for p in range(tcs[c].res[r]["pw"] * tcs[c].res[r]["ph"]):
                                emit(lay, r, c, p)
        elif pg == 1:
            for r in range(r0, r1):
                for lay in range(l1):
                    for c in range(c0, c1):
                        if r < tcs[c].nres:
                            for p in range(tcs[c].res[r]["pw"] * tcs[c].res[r]["ph"]):
                                emit(lay, r, c, p)
        elif pg == 2:
            dx, dy = steps(range(c0, c1), None)
            for r in range(r0, r1):
                for x, y in positions(dx, dy):
                    for c in range(c0, c1):
                        visit(c, r, x, y, l1)
        elif pg == 3:
            dx, dy = steps(range(c0, c1), None)
            for x, y in positions(dx, dy):
                for c in range(c0, c1):
                    for r in range(r0, r1):
                        visit(c, r, x, y, l1)
        else:
            for c in range(c0, c1):
                dx, dy = steps([c], None)
                for x, y in positions(dx, dy):
                    for r in range(r0, r1):
                        visit(c, r, x, y, l1)
    return out


def marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, len(body) + 2) + body


def encode(planes, prec, *, signed=None, sub=None, origin=(0, 0), tile=None, tile_origin=None,
           levels=3, cblk=(6, 6), style=0, precincts=None, prog=0, layers=1, mct=False,
           sop=False, eph=False, ppm=False, ppt=False, pocs=None, roi=None, tile_parts=1,
           coc=None, qcc_guard=None) -> bytes:
    """A reversible 5/3 J2K codestream of `planes` (one (h_c, w_c) integer
    array per component, already at the component's sampling) with
    precision `prec` per component. `sub` gives each component's (dx, dy),
    `origin` the image offset and `tile`/`tile_origin` the tiling on the
    reference grid; `style` the code-block style bits, `precincts` the
    (PPx, PPy) of each resolution, `prog` and `pocs` the progression and
    its changes ((RS, CS, LYE, RE, CE, P) each), `layers` the quality
    layers the passes are spread over, `roi` {component: shift} (the
    component's lowest resolution scaled up by the shift, the rest left as
    background), `tile_parts` how many tile-parts
    each tile's packets are split into, `coc` {component: (levels, cblk,
    style)} and `qcc_guard` {component: guard bits} (GUARD_BITS elsewhere)."""
    nc = len(planes)
    signed = signed or [False] * nc
    sub = sub or [(1, 1)] * nc
    roi = roi or {}
    coc = coc or {}
    qcc_guard = qcc_guard or {}
    ox, oy = origin
    h0, w0 = planes[0].shape
    x1, y1 = ox + w0 * sub[0][0], oy + h0 * sub[0][1]
    for p, (dx, dy) in zip(planes, sub):
        if p.shape != (ceildiv(y1, dy) - ceildiv(oy, dy), ceildiv(x1, dx) - ceildiv(ox, dx)):
            raise ValueError("a plane's shape does not follow from the image and its sampling")
    tw, th = tile or (x1, y1)
    tox, toy = tile_origin or (0, 0)
    comps = [{"dx": d[0], "dy": d[1]} for d in sub]
    samples = []
    for p, bits, sg in zip(planes, prec, signed):
        a = p.astype(np.int64)
        samples.append(a if sg else a - (1 << (bits - 1)))
    if mct:
        r, g, b = samples[:3]
        samples[:3] = [(r + 2 * g + b) >> 2, b - g, r - g]
    comp_levels = [coc.get(c, (levels, cblk, style))[0] for c in range(nc)]
    comp_cblk = [coc.get(c, (levels, cblk, style))[1] for c in range(nc)]
    comp_style = [coc.get(c, (levels, cblk, style))[2] for c in range(nc)]

    def mb(c, b):
        gain = (0, 1, 1, 2)[b]
        return prec[c] + gain + (1 if mct and c < 3 else 0) + qcc_guard.get(c, GUARD_BITS) - 1

    main = [b"\xff\x4f"]
    siz = struct.pack(">HIIIIIIIIH", 0, x1, y1, ox, oy, tw, th, tox, toy, nc)
    for bits, sg, (dx, dy) in zip(prec, signed, sub):
        siz += struct.pack(">BBB", (bits - 1) | (0x80 if sg else 0), dx, dy)
    main.append(marker(0xFF51, siz))
    scod = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)

    def spcod(lv, cb, st):
        body = struct.pack(">BBBBB", lv, cb[0] - 2, cb[1] - 2, st, 1)
        if precincts:
            body += bytes((px | (py << 4)) for px, py in precincts[:lv + 1])
        return body

    main.append(marker(0xFF52, struct.pack(">BBHB", scod, prog, layers, 1 if mct else 0)
                       + spcod(levels, cblk, style)))
    for c, (lv, cb, st) in sorted(coc.items()):
        main.append(marker(0xFF53, struct.pack(">BB", c, 1 if precincts else 0)
                           + spcod(lv, cb, st)))

    def sqcd(c, lv, g):
        body = bytes([g << 5])
        for r in range(lv + 1):
            for b in ([0] if r == 0 else [1, 2, 3]):
                body += bytes([(prec[c] + (0, 1, 1, 2)[b] + (1 if mct and c < 3 else 0)) << 3])
        return body

    main.append(marker(0xFF5C, sqcd(0, levels, GUARD_BITS)))
    for c, g in sorted(qcc_guard.items()):
        main.append(marker(0xFF5D, bytes([c]) + sqcd(c, comp_levels[c], g)))
    for c, s in sorted(roi.items()):
        main.append(marker(0xFF5E, struct.pack(">BBB", c, 0, s)))
    if pocs:
        main.append(marker(0xFF5F, b"".join(struct.pack(">BBHBBB", *p) for p in pocs)))
    ntx, nty = ceildiv(x1 - tox, tw), ceildiv(y1 - toy, th)
    tiles_out = []
    for q in range(nty):
        for p in range(ntx):
            tx0, ty0 = max(tox + p * tw, ox), max(toy + q * th, oy)
            tx1, ty1 = min(tox + (p + 1) * tw, x1), min(toy + (q + 1) * th, y1)
            tcs = []
            for c in range(nc):
                dx, dy = sub[c]
                rect = (ceildiv(tx0, dx), ceildiv(ty0, dy), ceildiv(tx1, dx), ceildiv(ty1, dy))
                cx0, cy0 = ceildiv(ox, dx), ceildiv(oy, dy)
                part = samples[c][rect[1] - cy0:rect[3] - cy0, rect[0] - cx0:rect[2] - cx0]
                pr = precincts[:comp_levels[c] + 1] if precincts else None
                tcs.append(TileComp(rect, comp_levels[c], comp_cblk[c], pr,
                                    lambda t, part=part: forward_dwt(part, t)))
            # Tier-1 per code-block, and each code-block's passes spread over the layers
            blocks = {}
            for c, tc in enumerate(tcs):
                s = roi.get(c, 0)
                for r, res in enumerate(tc.res):
                    for bi, band in enumerate(res["bands"]):
                        view = tc.band_view(r, band)
                        bx0, by0 = band["rect"][:2]
                        for pi, prec_blocks in enumerate(band["precs"]):
                            for row in prec_blocks:
                                for (cx0, cy0, cx1, cy1) in row:
                                    co = view[cy0 - by0:cy1 - by0, cx0 - bx0:cx1 - bx0]
                                    if r == 0:
                                        co = co * (1 << s)
                                    cbk = CodeBlock(co, band["b"], comp_style[c], s,
                                                    mb(c, band["b"]))
                                    passes = sum(n for n, _ in cbk.segments)
                                    per = [passes * (lay + 1) // layers for lay in range(layers)]
                                    blocks[(c, r, bi, cx0, cy0)] = (cbk, per)
            packets = []
            states = {}
            order = packet_order(tcs, comps, prog, layers, pocs, (tx0, ty0, tx1, ty1))
            for lay, r, c, pidx in order:
                res = tcs[c].res[r]
                bw = BitWriter()
                body = bytearray()
                included_any = any(
                    blocks[(c, r, bi, *blk[:2])][1][lay] > (
                        blocks[(c, r, bi, *blk[:2])][1][lay - 1] if lay else 0)
                    for bi, band in enumerate(res["bands"])
                    for row in band["precs"][pidx] for blk in row)
                bw.put(1 if included_any else 0)
                if included_any:
                    for bi, band in enumerate(res["bands"]):
                        rows = band["precs"][pidx]
                        if not rows:
                            continue
                        key = (c, r, bi, pidx)
                        if key not in states:
                            first = np.array([[next((ly for ly in range(layers)
                                                     if blocks[(c, r, bi, *blk[:2])][1][ly] > 0),
                                                    layers) for blk in row] for row in rows])
                            zero = np.array([[blocks[(c, r, bi, *blk[:2])][0].zero_planes
                                              for blk in row] for row in rows])
                            states[key] = {"incl": TagTree(first), "imsb": TagTree(zero),
                                           "lblock": {}, "done": {}}
                        stt = states[key]
                        for yy, row in enumerate(rows):
                            for xx, blk in enumerate(row):
                                cbk, per = blocks[(c, r, bi, *blk[:2])]
                                before = per[lay - 1] if lay else 0
                                new = per[lay] - before
                                bkey = (yy, xx)
                                if bkey not in stt["done"]:
                                    stt["incl"].encode(bw, yy, xx, lay + 1)
                                    if new == 0:
                                        continue
                                    stt["imsb"].encode(bw, yy, xx, cbk.zero_planes + 1)
                                    stt["done"][bkey] = 0
                                    stt["lblock"][bkey] = 3
                                else:
                                    bw.put(1 if new else 0)
                                    if new == 0:
                                        continue
                                # number of passes
                                if new == 1:
                                    bw.put(0)
                                elif new == 2:
                                    bw.bits(0b10, 2)
                                elif new <= 5:
                                    bw.bits(0b1100 | (new - 3), 4)
                                elif new <= 36:
                                    bw.bits(0b1111, 4)
                                    bw.bits(new - 6, 5)
                                else:
                                    bw.bits(0b111111111, 9)
                                    bw.bits(new - 37, 7)
                                # the segment pieces these passes touch, and their bytes
                                pieces, start, seg_start = [], before, 0
                                for n, data in cbk.segments:
                                    seg_end = seg_start + n
                                    lo, hi = max(start, seg_start), min(before + new, seg_end)
                                    if lo < hi:
                                        a = len(data) * (lo - seg_start) // n
                                        b = len(data) * (hi - seg_start) // n
                                        pieces.append((hi - lo, data[a:b]))
                                    seg_start = seg_end
                                lb = stt["lblock"][bkey]
                                need = max(max(len(d).bit_length() - (k.bit_length() - 1), 0)
                                           for k, d in pieces)
                                inc = max(0, need - lb)
                                bw.bits((1 << (inc + 1)) - 2, inc + 1)
                                lb += inc
                                stt["lblock"][bkey] = lb
                                for k, d in pieces:
                                    bw.bits(len(d), lb + k.bit_length() - 1)
                                    body += d
                header = bw.flush()
                if eph:
                    header += b"\xff\x92"
                packets.append((header, bytes(body)))
            # tile-parts
            idx = q * ntx + p
            chunks = np.array_split(np.arange(len(packets)), tile_parts)
            parts = []
            nsop = 0
            for tp, ch in enumerate(chunks):
                tile_hdr, hdrs, data = b"", b"", b""
                for i in ch:
                    header, body = packets[i]
                    pre = struct.pack(">HHH", 0xFF91, 4, nsop % 65536) if sop else b""
                    nsop += 1
                    if ppm or ppt:
                        hdrs += header
                        data += pre + body
                    else:
                        data += pre + header + body
                if ppt:
                    tile_hdr += marker(0xFF61, bytes([tp]) + hdrs)
                body = tile_hdr + b"\xff\x93" + data
                sot = struct.pack(">HHHIBB", 0xFF90, 10, idx, 12 + len(body), tp, len(chunks))
                parts.append((sot + body, hdrs))
            tiles_out.append(parts)
    # tile-parts interleaved: every tile's first part, then every second part, ...
    order = [parts[k] for k in range(tile_parts) for parts in tiles_out if k < len(parts)]
    if ppm:  # in OpenJPEG's decoding order: each tile once its last tile-part is read
        payload = b"".join(struct.pack(">I", len(h)) + h for parts in tiles_out for _, h in parts)
        main.append(marker(0xFF60, bytes([0]) + payload))
    return b"".join(main) + b"".join(p for p, _ in order) + b"\xff\xd9"


# --- the JP2 container ------------------------------------------------------------------


def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2(codestream: bytes, *, enumcs=None, pclr=None, cmap=None, cdef=None, res=False,
        brand=b"jp2 ", colr=None, ihdr_extra=b"") -> bytes:
    """A JP2 file around `codestream`: ihdr from its SIZ (with
    `ihdr_extra` bytes past its fields), an enumerated colr box (or the raw
    `colr` payload), and optional pclr ((entries, depths)), cmap, cdef and
    res."""
    x1, y1, x0, y0 = struct.unpack_from(">IIII", codestream, 8)
    nc = struct.unpack_from(">H", codestream, 40)[0]
    header = box(b"ihdr", struct.pack(">IIHBBBB", y1 - y0, x1 - x0, nc, codestream[42], 7, 0, 0)
                 + ihdr_extra)
    if colr is not None:
        header += box(b"colr", colr)
    elif enumcs is not None:
        header += box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    if pclr is not None:
        entries, depths = pclr
        body = struct.pack(">HB", len(entries), len(depths)) + bytes(d - 1 for d in depths)
        body += b"".join(bytes(e) for e in entries)
        header += box(b"pclr", body)
    if cmap is not None:
        header += box(b"cmap", b"".join(struct.pack(">HBB", *m) for m in cmap))
    if cdef is not None:
        header += box(b"cdef", struct.pack(">H", len(cdef)) +
                      b"".join(struct.pack(">HHH", *d) for d in cdef))
    if res:
        header += box(b"res ", box(b"resc", struct.pack(">HHHHBB", 3, 1, 3, 1, 3, 3)))
    return (box(b"jP  ", b"\r\n\x87\n") + box(b"ftyp", brand + b"\x00\x00\x00\x00" + brand)
            + box(b"jp2h", header) + box(b"jp2c", codestream))


# --- the files --------------------------------------------------------------------------


def pil_files():
    """{name: bytes} that PIL's writer makes, over its options."""
    rgb = photo((20, 24), 1)
    gray = photo((19, 23), 2, 1)[..., 0]
    out = {
        "pil_rgb_default.jp2": pil_j2k(rgb),
        "pil_rgb_irreversible.jp2": pil_j2k(rgb, irreversible=True),
        "pil_gray_irreversible.j2k": pil_j2k(gray, no_jp2=True, irreversible=True),
        "pil_rgb_mct.jp2": pil_j2k(rgb, mct=1),
        "pil_rgb_mct_irreversible.jp2": pil_j2k(rgb, mct=1, irreversible=True),
        "pil_rgba.jp2": pil_j2k(photo((17, 21), 3, 4), "RGBA"),
        "pil_la.jp2": pil_j2k(photo((13, 15), 4, 2), "LA"),
        "pil_gray_signed.jp2": pil_j2k(gray, signed=True),
        "pil_rgb_plt_comment.jp2": pil_j2k(rgb, plt=True, comment="fixture"),
        "pil_rgb_no_jp2.j2k": pil_j2k(rgb, no_jp2=True),
        "pil_1x1.jp2": pil_j2k(np.array([[[200, 7, 99]]], np.uint8)),
        "pil_1x1_gray.j2k": pil_j2k(np.array([[77]], np.uint8), no_jp2=True),
        "pil_1x5.jp2": pil_j2k(photo((1, 5), 5)),
        "pil_7x1_irreversible.jp2": pil_j2k(photo((7, 1), 6, 1)[..., 0], irreversible=True,
                                            num_resolutions=1),
        "pil_i16.jp2": pil_j2k((photo((14, 18), 7, 1)[..., 0].astype(np.uint16) * 257 + 3)),
        "pil_i16_irreversible.j2k": pil_j2k(photo((14, 18), 8, 1)[..., 0].astype(np.uint16) * 200,
                                            no_jp2=True, irreversible=True),
        "pil_cblk_16x4.jp2": pil_j2k(rgb, codeblock_size=(16, 4)),
        "pil_cblk_4x32_irreversible.jp2": pil_j2k(rgb, codeblock_size=(4, 32), irreversible=True),
        "pil_precincts_32.jp2": pil_j2k(photo((40, 36), 9), precinct_size=(32, 64),
                                        num_resolutions=3, irreversible=True,
                                        quality_layers=[30, 10]),
    }
    for n in (1, 2, 4, 7):
        img = photo((70, 66), 10 + n) if n == 7 else rgb
        out[f"pil_resolutions_{n}.jp2"] = pil_j2k(img if n < 7 else img[..., 0],
                                                  num_resolutions=n, irreversible=n % 2 == 1,
                                                  quality_layers=[40] if n == 7 else None)
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out[f"pil_{prog.lower()}.jp2"] = pil_j2k(photo((33, 29), 20), progression=prog,
                                                 quality_layers=[40, 10, 2],
                                                 precinct_size=(32, 32), num_resolutions=3)
    out["pil_layers_rates_irreversible.jp2"] = pil_j2k(rgb, quality_layers=[60, 20, 5],
                                                       irreversible=True)
    out["pil_layers_db.jp2"] = pil_j2k(rgb, quality_mode="dB", quality_layers=[25, 35, 45])
    out["pil_tiles_odd.jp2"] = pil_j2k(photo((23, 25), 21), tile_size=(11, 9))
    out["pil_tiles_offsets.jp2"] = pil_j2k(photo((21, 19), 22), tile_size=(13, 10),
                                           tile_offset=(3, 2), offset=(5, 7))
    out["pil_tiles_irreversible.j2k"] = pil_j2k(photo((26, 30), 23), tile_size=(17, 15),
                                                tile_offset=(1, 4), offset=(4, 6),
                                                irreversible=True, no_jp2=True,
                                                quality_layers=[20, 5])
    return out


def hand_files():
    """{name: bytes} written by `encode` and `jp2`: what PIL's writer cannot
    reach."""
    rgb = photo((18, 22), 30).astype(np.int64)
    planes = [rgb[..., c] for c in range(3)]
    gray = [photo((21, 19), 31, 1)[..., 0].astype(np.int64)]
    out = {}
    styles = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16, "segsym": 32,
              "bypass_termall": 5, "bypass_reset_vsc": 11, "all": 63}
    for name, st in styles.items():
        out[f"style_{name}.j2k"] = encode(planes, [8] * 3, style=st, levels=2, cblk=(4, 4),
                                          layers=2)
    out["sop_eph.j2k"] = encode(planes, [8] * 3, sop=True, eph=True, layers=3, levels=2)
    small = [p[:10, :13] for p in planes]
    out["ppm.j2k"] = encode(small, [8] * 3, ppm=True, layers=2, tile=(8, 6), tile_parts=2)
    out["ppt_sop.j2k"] = encode(small, [8] * 3, ppt=True, sop=True, eph=True, layers=2,
                                tile=(9, 7), tile_parts=2)
    out["poc.j2k"] = encode(planes, [8] * 3, layers=3, levels=3, precincts=[(2, 2), (2, 2),
                                                                            (3, 3), (3, 3)],
                            pocs=[(0, 0, 2, 2, 3, 1), (0, 0, 3, 4, 2, 4), (0, 0, 3, 4, 3, 0)])
    for prog in range(5):
        out[f"precincts_prog{prog}.j2k"] = encode(
            small, [8] * 3, prog=prog, layers=2, levels=2, precincts=[(1, 2), (2, 1), (2, 2)],
            origin=(3, 1), tile=(9, 7), tile_origin=(1, 0), cblk=(3, 2))
    out["tile_parts.j2k"] = encode(small, [8] * 3, tile=(7, 6), tile_parts=3, layers=2)
    out["coc_qcc.j2k"] = encode(planes, [8] * 3, coc={1: (1, (5, 3), 8), 2: (4, (2, 6), 33)},
                                qcc_guard={1: 1, 2: 3}, levels=2)
    out["roi_past_background.j2k"] = encode(gray, [8], roi={0: 12}, levels=2)
    out["roi_at_background.j2k"] = encode(gray, [8], roi={0: 8}, levels=2)
    out["roi_rgb_one_component.j2k"] = encode(planes, [8] * 3, roi={1: 12}, levels=1)
    out["mct_rct.j2k"] = encode(planes, [8] * 3, mct=True, levels=3)
    out["levels_0.j2k"] = encode(planes, [8] * 3, levels=0, origin=(1, 2))
    out["odd_origin.j2k"] = encode(gray, [8], levels=4, origin=(7, 5), tile=(10, 9),
                                   tile_origin=(5, 3))
    rng = np.random.default_rng(32)
    for bits in (1, 4, 12):
        out[f"gray_{bits}bit.j2k"] = encode([rng.integers(0, 1 << bits, (9, 11))], [bits],
                                            levels=2)
    out["rgb_12bit.j2k"] = encode([rng.integers(0, 4096, (8, 10)) for _ in range(3)], [12] * 3,
                                  levels=2)
    out["rgb_5bit_signed.j2k"] = encode([rng.integers(-16, 16, (8, 10)) for _ in range(3)],
                                        [5] * 3, signed=[True] * 3, levels=2)
    out["gray_12bit_signed.j2k"] = encode([rng.integers(-2048, 2048, (9, 7))], [12],
                                          signed=[True], levels=2)
    out["gray_16bit_signed.j2k"] = encode([rng.integers(-32768, 32768, (6, 5))], [16],
                                          signed=[True], levels=1)
    out["la_10bit.j2k"] = encode([rng.integers(0, 1024, (7, 9)) for _ in range(2)], [10, 10],
                                 levels=1)
    # JP2 boxes
    out["jp2_9bit_mode_l.jp2"] = jp2(encode([rng.integers(0, 512, (8, 8))], [9], levels=1),
                                     enumcs=17)
    out["jp2_srgb_cdef_res.jp2"] = jp2(encode(planes, [8] * 3, levels=2), enumcs=16,
                                       cdef=[(0, 0, 1), (1, 0, 2), (2, 0, 3)], res=True)
    out["jp2_sycc.jp2"] = jp2(encode(planes, [8] * 3, levels=2), enumcs=18)
    alpha = photo((18, 22), 33, 1)[..., 0].astype(np.int64)
    out["jp2_sycc_rgba.jp2"] = jp2(encode(planes + [alpha], [8] * 4, levels=1), enumcs=18)
    out["jp2_icc.jp2"] = jp2(encode(planes, [8] * 3, levels=1), colr=b"\x02\x00\x00" + bytes(32))
    out["jp2_unknown_enum_no_colr.jp2"] = jp2(encode(gray, [8], levels=1), enumcs=None)
    out["jp2_gray_brand_jpx.jp2"] = jp2(encode(gray, [8], levels=2), enumcs=17,
                                            brand=b"jpx ")
    out["jp2_cmyk.jp2"] = jp2(encode(planes + [planes[0] // 2], [8] * 4, levels=2), enumcs=12)
    idx = rng.integers(0, 6, (10, 12))
    entries = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (9, 9, 9), (255, 0, 0), (40, 50, 60)]
    out["jp2_pclr.jp2"] = jp2(encode([idx], [8], levels=1), enumcs=16,
                              pclr=(entries, (8, 8, 8)), cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])
    out["jp2_pclr_alpha.jp2"] = jp2(encode([idx, rng.integers(0, 256, (10, 12))], [8, 8],
                                           levels=1),
                                    enumcs=16, pclr=(entries, (8, 8, 8)),
                                    cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2), (1, 0, 0)])
    # sub-sampled components: 4:2:0 chroma, and a 4:2:2 gray + alpha
    y = photo((16, 20), 34, 1)[..., 0].astype(np.int64)
    cb = photo((8, 10), 35, 1)[..., 0].astype(np.int64)
    cr = photo((8, 10), 36, 1)[..., 0].astype(np.int64)
    out["sub_420.j2k"] = encode([y, cb, cr], [8] * 3, sub=[(1, 1), (2, 2), (2, 2)], levels=2)
    out["sub_420_sycc.jp2"] = jp2(encode([y, cb, cr], [8] * 3, sub=[(1, 1), (2, 2), (2, 2)],
                                         levels=2), enumcs=18)
    y2 = photo((15, 21), 37, 1)[..., 0].astype(np.int64)
    c2 = photo((15, 10), 38, 1)[..., 0].astype(np.int64)
    out["sub_odd_origin.j2k"] = encode([y2, c2, c2], [8] * 3, sub=[(1, 1), (2, 1), (2, 1)],
                                       origin=(1, 0), levels=2)
    return out


def refused_files(files):
    """{name: (bytes, words of the port's ValueError)}: files PIL refuses."""
    base = files["pil_rgb_default.jp2"]
    cs = files["style_bypass.j2k"]
    planes = [photo((6, 7), 40)[..., c].astype(np.int64) for c in range(3)]
    five = encode(planes + planes[:2], [8] * 5, levels=1)
    out = {
        "refused_truncated.jp2": (base[:len(base) // 2], "box"),
        "refused_no_jp2h.jp2": (base[:12] + box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
                                + box(b"jp2c", cs), "jp2h"),
        "refused_five_components.j2k": (five, "mode"),
        "refused_eycc.jp2": (jp2(encode(planes, [8] * 3, levels=1), enumcs=24), "PIL"),
        "refused_gray_srgb.jp2": (jp2(encode(planes[:1], [8], levels=1), enumcs=16), "PIL"),
        "refused_rgb_cmyk.jp2": (jp2(encode(planes, [8] * 3, levels=1), enumcs=12), "PIL"),
        "refused_no_cod.j2k": (cs[:cs.index(b"\xff\x52")]
                               + cs[cs.index(b"\xff\x5c"):], "COD"),
        "refused_bad_precinct.jp2": (pil_j2k(photo((40, 50), 20), progression="RPCL",
                                             precinct_size=(16, 16), quality_layers=[60]),
                                     "precinct"),
        "refused_ihdr_size.jp2": (jp2(encode(planes, [8] * 3, levels=1), enumcs=16,
                                      ihdr_extra=b"\x00"), "ihdr"),
        "refused_pclr_257_colours.jp2": (jp2(encode([np.zeros((4, 4), np.int64)], [8], levels=1),
                                             enumcs=16, pclr=([(i % 256, i // 256, 7)
                                                               for i in range(257)], (8, 8, 8)),
                                             cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)]), "256"),
    }
    return out


def tree_files(hw=TREE_HW):
    """{name: bytes}: the rgb images of chip_smoke.py's new-formats tree, RGB
    JP2 and J2K files (lossless, 9/7, tiled, and hand-written with code-block
    styles)."""
    a, b, c, d = (photo(hw, 50 + i, noise=2.0) for i in range(4))
    return {"tree_lossless.jpx": pil_j2k(a),
            "tree_irreversible.jpx": pil_j2k(b, irreversible=True, quality_layers=[30, 10]),
            "tree_tiles.jpx": pil_j2k(c, tile_size=(32, 24), progression="RPCL", no_jp2=True,
                                      irreversible=True, quality_layers=[20, 8]),
            "tree_styles.jpx": jp2(encode([d[..., k].astype(np.int64) for k in range(3)], [8] * 3,
                                          style=63, mct=True, levels=3, sop=True, eph=True),
                                   enumcs=16)}


def timing_files(hw=(480, 640)):
    """{name: bytes} of 640 x 480 photo-like JP2 files for decode times
    (tests/fixtures/images/time_decode.py): 5/3 lossless and 9/7 lossy RGB,
    PIL's defaults otherwise."""
    return {"jpeg2000_53_lossless_640.jp2": pil_j2k(photo(hw, 140)),
            "jpeg2000_97_lossy_640.jp2": pil_j2k(photo(hw, 141), irreversible=True,
                                                 quality_layers=[20])}


def port_raw(img) -> np.ndarray:
    """PIL's pixels in the port's raw form (image_io.Decoded.raw): "LA" and
    "PA" their first band, RGBA its RGB, CMYK its four bands."""
    raw = np.asarray(img)
    if img.mode in ("LA", "PA"):
        return np.ascontiguousarray(raw[..., 0])
    if raw.ndim == 3 and img.mode != "CMYK":
        return np.ascontiguousarray(raw[..., :3])
    return raw


def pil_digests(data: bytes) -> dict:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    rgb = np.asarray(img.convert("RGB"))
    raw = port_raw(img)
    return {"mode": img.mode, "shape": list(rgb.shape),
            "sha256": hashlib.sha256(rgb.tobytes()).hexdigest(),
            "raw_shape": list(raw.shape), "raw_dtype": str(raw.dtype),
            "raw_sha256": hashlib.sha256(raw.tobytes()).hexdigest()}


def check_lossless(files):
    """PIL must decode the lossless hand-written files to the very samples
    given to `encode`."""
    from PIL import Image

    rgb = photo((18, 22), 30)
    gray = photo((21, 19), 31, 1)[..., 0]
    for name in [n for n in files if n.startswith("precincts_prog")] + [
            "ppm.j2k", "ppt_sop.j2k", "tile_parts.j2k"]:
        if not np.array_equal(np.asarray(Image.open(io.BytesIO(files[name]))), rgb[:10, :13]):
            raise SystemExit(f"{name}: PIL does not decode the samples encoded")
    names = [n for n in files if n.startswith("style_")] + [
        "sop_eph.j2k", "poc.j2k", "coc_qcc.j2k",
        "mct_rct.j2k", "levels_0.j2k", "jp2_srgb_cdef_res.jp2"]
    for name in names + ["roi_past_background.j2k", "odd_origin.j2k"]:
        want = rgb if name in names else gray
        got = np.asarray(Image.open(io.BytesIO(files[name])))
        if not np.array_equal(got, want):
            raise SystemExit(f"{name}: PIL does not decode the samples encoded")


def main():
    from PIL import Image

    files = {**pil_files(), **hand_files(), **tree_files()}
    check_lossless(files)
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
        if name.endswith((".jp2", ".j2k", ".jpx")):
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
