"""Write the JPEG fixtures that tests/test_torch_jpeg.py and chip_smoke.py
hold the port's decoder against, and expected.json: each file's shape and
the SHA-256 of PIL's Image.open(f).convert("RGB") pixels (or, for a file
the decoder must refuse, the words its error names).

    python tests/fixtures/jpeg/make_fixtures.py

Needs PIL. The files PIL cannot write (4:4:0, 4:1:1 and 1x3 sampling,
YCCK, 16-bit quantisation tables, a sequential file of non-interleaved
scans, progressive files that leave coefficients unrefined, so that
libjpeg-turbo smooths their blocks, and arithmetic-coded files with the DAC
conditioning of our choosing) come from libjpeg_encode.c, compiled against
the system libjpeg where its header and library are installed; without
them those files are left out and the script says so. The lossless (SOF3)
files, which the system libjpeg 2.1 cannot write, come from `lossless_jpeg`
below (a predictor and Huffman encoder of ITU-T T.81 Annex H). The files
PIL refuses (hierarchical, 12-bit, SOF11, a DNL-given height) are a fixture
with its header patched, and carry the words the port's ValueError names;
the script checks that PIL refuses each. Every digest is PIL's (12.1, with
libjpeg-turbo 3.1). Re-running it rewrites every file; the pixels come
from fixed seeds, so the files change only with the encoders.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from multimae_tpu_torch.data.dataset_folder import _smooth_sample  # noqa: E402

# The photo-like 500 x 375 files (ImageNet's typical size) that chip_smoke.py
# copies into its JPEG tree.
PHOTOS = {
    "photo_420_q90.jpg": dict(quality=90, subsampling=2),
    "photo_444_q95.jpg": dict(quality=95, subsampling=0),
    "photo_progressive.jpg": dict(quality=90, subsampling=2, progressive=True),
    "photo_restart.jpg": dict(quality=85, subsampling=1, restart_marker_rows=2),
}

# Small files, one per case of the generated tests: (size hw, mode, PIL options).
SMALL = {
    "s444.jpg": ((31, 64), "RGB", dict(quality=90, subsampling=0)),
    "s422.jpg": ((31, 64), "RGB", dict(quality=90, subsampling=1)),
    "s420.jpg": ((31, 64), "RGB", dict(quality=90, subsampling=2)),
    "q50.jpg": ((17, 33), "RGB", dict(quality=50)),
    "q75.jpg": ((17, 33), "RGB", dict(quality=75)),
    "q95.jpg": ((17, 33), "RGB", dict(quality=95)),
    "q100.jpg": ((17, 33), "RGB", dict(quality=100)),
    "optimize.jpg": ((31, 64), "RGB", dict(quality=90, optimize=True)),
    "progressive.jpg": ((31, 64), "RGB", dict(quality=90, progressive=True)),
    "progressive_444.jpg": ((31, 64), "RGB", dict(quality=95, subsampling=0, progressive=True)),
    "restart_blocks.jpg": ((31, 64), "RGB", dict(quality=90, restart_marker_blocks=3)),
    "restart_rows.jpg": ((31, 64), "RGB", dict(quality=90, restart_marker_rows=1)),
    "size_1x1.jpg": ((1, 1), "RGB", dict(quality=90)),
    "size_2x3.jpg": ((2, 3), "RGB", dict(quality=90)),
    "size_7x9.jpg": ((7, 9), "RGB", dict(quality=90)),
    "size_257x193.jpg": ((257, 193), "RGB", dict(quality=90)),
    "rgb_adobe.jpg": ((17, 33), "RGB", dict(quality=90, keep_rgb=True)),
    "gray.jpg": ((17, 33), "L", dict(quality=90)),
    "gray_progressive.jpg": ((31, 64), "L", dict(quality=90, progressive=True)),
    "cmyk.jpg": ((17, 33), "CMYK", dict(quality=90)),
}

# Files from the system libjpeg: (size hw, input space, JPEG space, quality,
# sampling, scans, restart rows[, "L,U,K" for an arithmetic-coded file]);
# see libjpeg_encode.c.
LIBJPEG = {
    "s440.jpg": ((33, 47), "rgb", "ycc", 90, "1x2,1x1,1x1", "default", 0),
    "s411.jpg": ((33, 47), "rgb", "ycc", 90, "4x1,1x1,1x1", "default", 0),
    "s440_progressive.jpg": ((33, 47), "rgb", "ycc", 90, "1x2,1x1,1x1", "progressive", 0),
    "ycck.jpg": ((33, 47), "cmyk", "ycck", 90, "2x2,1x1,1x1,2x2", "default", 0),
    "sof1_16bit_tables.jpg": ((33, 47), "rgb", "ycc", 10, "2x2,1x1,1x1", "default", 1),
    "noninterleaved.jpg": ((33, 47), "rgb", "ycc", 90, "2x1,1x1,1x1", "noninterleaved", 0),
    "s1x3.jpg": ((41, 37), "rgb", "ycc", 90, "1x3,1x1,1x1", "default", 0),
    # Arithmetic coding (SOF9, SOF10), the DAC's defaults and others.
    "arith_420.jpg": ((33, 47), "rgb", "ycc", 90, "2x2,1x1,1x1", "default", 0, "0,1,5"),
    "arith_444_restart.jpg": ((33, 47), "rgb", "ycc", 95, "1x1,1x1,1x1", "default", 1, "0,1,5"),
    "arith_dac.jpg": ((33, 47), "rgb", "ycc", 75, "2x1,1x1,1x1", "default", 0, "2,5,12"),
    "arith_gray_dac.jpg": ((33, 47), "gray", "gray", 90, "1x1", "default", 2, "1,1,40"),
    "arith_progressive.jpg": ((33, 47), "rgb", "ycc", 90, "2x2,1x1,1x1", "progressive", 0,
                              "0,1,5"),
    "arith_progressive_dac.jpg": ((41, 37), "rgb", "ycc", 90, "1x2,1x1,1x1", "progressive", 2,
                                  "3,9,2"),
    # Progressive files that leave one of the first nine AC coefficients
    # unrefined: libjpeg-turbo smooths their blocks (dc_approx leaves only
    # the DC unrefined, which is not smoothed).
    "progressive_dc_only.jpg": ((33, 47), "rgb", "ycc", 90, "2x2,1x1,1x1", "dconly", 0),
    "smooth_ac_approx.jpg": ((33, 47), "rgb", "ycc", 90, "2x2,1x1,1x1", "ac_approx", 0),
    "smooth_ac_low.jpg": ((41, 37), "rgb", "ycc", 90, "1x3,1x1,1x1", "ac_low", 0),
    "smooth_dc_approx.jpg": ((33, 47), "rgb", "ycc", 90, "1x2,1x1,1x1", "dc_approx", 0),
    "smooth_gray_dc_only.jpg": ((17, 70), "gray", "gray", 75, "1x1", "dconly", 0),
    "smooth_arith.jpg": ((33, 47), "rgb", "ycc", 90, "2x1,1x1,1x1", "ac_approx", 0, "0,1,5"),
    "smooth_narrow.jpg": ((40, 12), "rgb", "ycc", 80, "1x1,1x1,1x1", "ac_low", 0),
    # chip_smoke.py phase 20's tree (every file at 48 x 64, the size of the
    # PNG, BMP and netpbm tree files of tests/fixtures/images) and its
    # 640 x 480 timings (tests/fixtures/images/time_decode.py too).
    "tree_arith.jpg": ((48, 64), "rgb", "ycc", 90, "2x2,1x1,1x1", "default", 0, "0,1,5"),
    "tree_arith_progressive.jpg": ((48, 64), "rgb", "ycc", 90, "2x2,1x1,1x1", "progressive", 0,
                                   "0,1,5"),
    "tree_smooth.jpg": ((48, 64), "rgb", "ycc", 90, "2x2,1x1,1x1", "ac_approx", 0),
    "big_arith_640.jpg": ((480, 640), "rgb", "ycc", 90, "2x2,1x1,1x1", "default", 0, "0,1,5"),
    "big_arith_progressive_640.jpg": ((480, 640), "rgb", "ycc", 90, "2x2,1x1,1x1",
                                      "progressive", 0, "0,1,5"),
    "big_smooth_640.jpg": ((480, 640), "rgb", "ycc", 90, "2x2,1x1,1x1", "ac_approx", 0),
}
# A smoothed file with one of the ten quantisers smoothing divides by set
# to zero in its DQT (coefficient 3,0: zigzag 9): libjpeg-turbo does not
# smooth it.
ZERO_QUANT = {"smooth_zero_quant.jpg": "smooth_ac_approx.jpg"}
# Lossless (SOF3) files from `lossless_jpeg`: (size hw, components,
# predictor, point transform, restart rows).
LOSSLESS = {**{f"lossless_gray_p{p}.jpg": ((17, 23), 1, p, 0, 0) for p in range(1, 8)},
            "lossless_rgb_p4_pt1.jpg": ((19, 21), 3, 4, 1, 0),
            "lossless_rgb_p6_restart.jpg": ((19, 21), 3, 6, 0, 3)}
# Files PIL refuses, as the port does with ValueError naming these words:
# (the fixture patched, its patch, the words).
REFUSED = {
    "refused_hierarchical.jpg": ("s420.jpg", "sof5", "hierarchical"),
    "refused_12bit.jpg": ("s420.jpg", "precision12", "12-bit precision"),
    "refused_sof11.jpg": ("lossless_gray_p1.jpg", "sof11", "SOF11"),
    "refused_dnl_height.jpg": ("s420.jpg", "dnl", "DNL"),
}


def photo(hw, seed, grain=0.0):
    """A photo-like scene (the port's _smooth_sample); `grain` adds that
    much Gaussian noise, so a 500 x 375 file at quality 90 holds about as
    many bits as a photograph of that size."""
    rng = np.random.default_rng(seed)
    rgb, _, _ = _smooth_sample(rng, hw[0], hw[1], 40)
    if grain:
        rgb = np.clip(rgb + rng.normal(0, grain, rgb.shape), 0, 255).astype(np.uint8)
    return rgb


def pixels(hw, mode, seed):
    """Photo-like for the wider files, noise for the smallest."""
    rgb = photo(hw, seed) if min(hw) >= 8 else \
        np.random.default_rng(seed).integers(0, 256, hw + (3,), dtype=np.uint8)
    if mode == "L":
        return rgb[..., 1]
    if mode == "CMYK":
        return np.concatenate([255 - rgb, rgb[..., :1] // 3], axis=-1)
    return rgb


def pil_jpeg(arr, mode, options):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **options)
    return buf.getvalue()


def libjpeg_encoder(tmp):
    src = os.path.join(HERE, "libjpeg_encode.c")
    exe = os.path.join(tmp, "libjpeg_encode")
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        return None, "no C compiler"
    proc = subprocess.run([cc, "-O2", src, "-o", exe, "-ljpeg"], capture_output=True, text=True)
    if proc.returncode != 0:
        return None, proc.stderr.strip().splitlines()[-1] if proc.stderr else "cc failed"
    return exe, None


def libjpeg_file(exe, tmp, case, seed):
    hw, in_space, jpeg_space, quality, sampling, scans, rows = case[:7]
    arith = ["1", case[7]] if len(case) > 7 else []
    arr = pixels(hw, {"rgb": "RGB", "cmyk": "CMYK", "gray": "L"}[in_space], seed)
    raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
    with open(raw, "wb") as f:
        f.write(np.ascontiguousarray(arr).tobytes())
    subprocess.run([exe, raw, str(hw[1]), str(hw[0]), in_space, jpeg_space, str(quality),
                    sampling, scans, str(rows), out] + arith, check=True, capture_output=True)
    with open(out, "rb") as f:
        return f.read()


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class _Bits:
    """Entropy-coded bits, FF stuffed with 00, the last byte padded with 1s."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


# The JPEG standard's DC luminance table (Annex K.3): counts of codes of
# lengths 1-16, then the categories 0-11.
_DC_COUNTS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_SYMBOLS = list(range(12))


def _huffman_codes(counts, symbols):
    codes, code, k = {}, 0, 0
    for length, count in enumerate(counts, 1):
        for _ in range(count):
            codes[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _predict(psv, ra, rb, rc):
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv]


def lossless_jpeg(arr, psv, pt=0, restart_rows=0):
    """A lossless (SOF3) JPEG of (H, W) or (H, W, C) uint8 samples, every
    component sampled 1x1 in one interleaved scan, predictor `psv`, point
    transform `pt`, a restart marker every `restart_rows` rows (T.81 H.1:
    a row after a restart predicts from the left, its first sample from
    2^(P - Pt - 1); every other row's first sample from above)."""
    arr = arr[..., None] if arr.ndim == 2 else arr
    h, w, nc = arr.shape
    x = arr.astype(np.int64) >> pt
    codes = _huffman_codes(_DC_COUNTS, _DC_SYMBOLS)
    bits = _Bits()
    out = bytearray(b"\xff\xd8")
    out += _segment(0xC3, struct.pack(">BHHB", 8, h, w, nc)
                    + b"".join(bytes([i + 1, 0x11, 0]) for i in range(nc)))
    out += _segment(0xC4, bytes([0x00]) + bytes(_DC_COUNTS) + bytes(_DC_SYMBOLS))
    if restart_rows:
        out += _segment(0xDD, struct.pack(">H", restart_rows * w))
    out += _segment(0xDA, bytes([nc]) + b"".join(bytes([i + 1, 0x00]) for i in range(nc))
                    + bytes([psv, 0, pt]))
    data = bytearray()
    for y in range(h):
        first = y == 0 or (restart_rows and y % restart_rows == 0)
        if restart_rows and y and y % restart_rows == 0:
            bits.flush()
            data += bits.out + bytes([0xFF, 0xD0 + (y // restart_rows - 1) % 8])
            bits = _Bits()
        for xx in range(w):
            for c in range(nc):
                if first:
                    pred = (1 << (8 - pt - 1)) if xx == 0 else x[y, xx - 1, c]
                elif xx == 0:
                    pred = x[y - 1, 0, c]
                else:
                    pred = _predict(psv, x[y, xx - 1, c], x[y - 1, xx, c], x[y - 1, xx - 1, c])
                diff = (int(x[y, xx, c]) - int(pred)) & 0xFFFF
                diff = diff - 65536 if diff >= 32768 else diff
                s = abs(diff).bit_length()
                bits.put(*codes[s])
                if s:
                    bits.put(diff if diff > 0 else diff + (1 << s) - 1, s)
    bits.flush()
    data += bits.out
    return bytes(out + data + b"\xff\xd9")


def patched(data, how):
    """A file's header patched into one PIL refuses."""
    data = bytearray(data)
    sof = next(i for i in range(len(data) - 1)
               if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC1, 0xC2, 0xC3))
    if how == "sof5":
        data[sof + 1] = 0xC5
    elif how == "sof11":
        data[sof + 1] = 0xCB
    elif how == "precision12":
        data[sof + 4] = 12
    elif how == "dnl":  # height 0 in the frame, a DNL segment after the scan
        height = data[sof + 5:sof + 7]
        data[sof + 5:sof + 7] = b"\x00\x00"
        eoi = len(data) - 2
        data[eoi:eoi] = _segment(0xDC, bytes(height))
    return bytes(data)


def zero_quant(data):
    """The first DQT's zigzag entry 9 (coefficient 3,0) set to 0."""
    data = bytearray(data)
    i = data.index(b"\xff\xdb")
    data[i + 5 + 9] = 0
    return bytes(data)


def main():
    files = {}
    for i, (name, options) in enumerate(PHOTOS.items()):
        files[name] = pil_jpeg(photo((375, 500), 100 + i, grain=6.0), "RGB", options)
    for i, (name, (hw, mode, options)) in enumerate(SMALL.items()):
        files[name] = pil_jpeg(pixels(hw, mode, i), mode, options)
    with tempfile.TemporaryDirectory() as tmp:
        exe, why = libjpeg_encoder(tmp)
        if exe is None:
            print(f"the system libjpeg is not usable ({why}): "
                  f"{', '.join(list(LIBJPEG) + list(ZERO_QUANT))} left out")
        else:
            for i, (name, case) in enumerate(LIBJPEG.items()):
                # the seeds of the files older versions of this script wrote
                seed = 300 if name == "progressive_dc_only.jpg" else 200 + i
                files[name] = libjpeg_file(exe, tmp, case, seed)
            for name, src in ZERO_QUANT.items():
                files[name] = zero_quant(files[src])
    for i, (name, (hw, nc, psv, pt, rows)) in enumerate(LOSSLESS.items()):
        arr = pixels(hw, "RGB" if nc == 3 else "L", 400 + i)
        files[name] = lossless_jpeg(arr, psv, pt, rows)
    refused = {}
    for name, (src, how, words) in REFUSED.items():
        files[name] = patched(files[src], how)
        refused[name] = words
        try:
            Image.open(io.BytesIO(files[name])).convert("RGB")
        except (OSError, SyntaxError, ValueError):
            continue
        raise SystemExit(f"{name}: PIL reads it, so the port must too")
    expected = {}
    for name in sorted(files):
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(files[name])
        if name in refused:
            expected[name] = {"error": refused[name]}
            continue
        rgb = np.asarray(Image.open(io.BytesIO(files[name])).convert("RGB"))
        expected[name] = {"shape": list(rgb.shape),
                          "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(len(v) for v in files.values())
    print(f"wrote {len(files)} files, {total} bytes, and expected.json")


if __name__ == "__main__":
    main()
