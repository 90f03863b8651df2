"""Write the JPEG fixtures that tests/test_torch_jpeg.py and chip_smoke.py
hold the port's decoder against, and expected.json: each file's shape and
the SHA-256 of PIL's Image.open(f).convert("RGB") pixels (or, for a file
the decoder must refuse, the words its error names).

    python tests/fixtures/jpeg/make_fixtures.py

Needs PIL. The files PIL cannot write (4:4:0 and 4:1:1 sampling, YCCK,
16-bit quantisation tables, a sequential file of non-interleaved scans, a
progressive file of DC scans only) come from libjpeg_encode.c, compiled
against the system libjpeg where its header and library are installed;
without them those files are left out and the script says so. Re-running
it rewrites every file; the pixels come from fixed seeds, so the files
change only with the encoders.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
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
# sampling, scans, restart rows); see libjpeg_encode.c.
LIBJPEG = {
    "s440.jpg": ((33, 47), "rgb", "ycc", 90, "1x2,1x1,1x1", "default", 0),
    "s411.jpg": ((33, 47), "rgb", "ycc", 90, "4x1,1x1,1x1", "default", 0),
    "s440_progressive.jpg": ((33, 47), "rgb", "ycc", 90, "1x2,1x1,1x1", "progressive", 0),
    "ycck.jpg": ((33, 47), "cmyk", "ycck", 90, "2x2,1x1,1x1,2x2", "default", 0),
    "sof1_16bit_tables.jpg": ((33, 47), "rgb", "ycc", 10, "2x2,1x1,1x1", "default", 1),
    "noninterleaved.jpg": ((33, 47), "rgb", "ycc", 90, "2x1,1x1,1x1", "noninterleaved", 0),
}
# Files the decoder must refuse, with the words its error names.
REFUSED = {
    "progressive_dc_only.jpg": (((33, 47), "rgb", "ycc", 90, "2x2,1x1,1x1", "dconly", 0),
                                "unrefined"),
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
    hw, in_space, jpeg_space, quality, sampling, scans, rows = case
    arr = pixels(hw, {"rgb": "RGB", "cmyk": "CMYK"}[in_space], seed)
    raw, out = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
    with open(raw, "wb") as f:
        f.write(np.ascontiguousarray(arr).tobytes())
    subprocess.run([exe, raw, str(hw[1]), str(hw[0]), in_space, jpeg_space, str(quality),
                    sampling, scans, str(rows), out], check=True, capture_output=True)
    with open(out, "rb") as f:
        return f.read()


def main():
    files = {}
    for i, (name, options) in enumerate(PHOTOS.items()):
        files[name] = pil_jpeg(photo((375, 500), 100 + i, grain=6.0), "RGB", options)
    for i, (name, (hw, mode, options)) in enumerate(SMALL.items()):
        files[name] = pil_jpeg(pixels(hw, mode, i), mode, options)
    refused = {}
    with tempfile.TemporaryDirectory() as tmp:
        exe, why = libjpeg_encoder(tmp)
        if exe is None:
            print(f"the system libjpeg is not usable ({why}): "
                  f"{', '.join(list(LIBJPEG) + list(REFUSED))} left out")
        else:
            for i, (name, case) in enumerate(LIBJPEG.items()):
                files[name] = libjpeg_file(exe, tmp, case, 200 + i)
            for i, (name, (case, words)) in enumerate(REFUSED.items()):
                files[name] = libjpeg_file(exe, tmp, case, 300 + i)
                refused[name] = words
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
