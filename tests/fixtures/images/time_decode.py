"""Time the port's readers of the new formats beside PIL's on 640 x 480
photo-like files, in one thread, where PIL is installed:

    python tests/fixtures/images/time_decode.py [--repeats 20]

The PNG, BMP and netpbm files come from make_fixtures.timing_files; the
arithmetic-coded and smoothed JPEG files are tests/fixtures/jpeg/big_*.jpg.
Prints ms per file (load_image from disk, convert_rgb, against PIL's
Image.open(path).convert("RGB"); the median of 5 windows of `repeats`
decodes) for each, and checks the two agree.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from make_fixtures import timing_files  # noqa: E402
from multimae_tpu_torch.data.image_io import load_image  # noqa: E402


def ms_per_call(fn, repeats):
    fn()
    windows = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        windows.append((time.perf_counter() - t0) / repeats * 1e3)
    return statistics.median(windows)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=20)
    args = parser.parse_args()
    jpeg = os.path.join(os.path.dirname(HERE), "jpeg")
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for name, data in timing_files().items():
            paths.append(os.path.join(tmp, name))
            with open(paths[-1], "wb") as f:
                f.write(data)
        paths += sorted(os.path.join(jpeg, n) for n in os.listdir(jpeg) if n.startswith("big_"))
        for path in paths:
            def pil():
                return np.asarray(Image.open(path).convert("RGB"))

            if not np.array_equal(load_image(path), pil()):
                raise SystemExit(f"{path}: the port's decode differs from PIL's")
            port_ms = ms_per_call(lambda: load_image(path), args.repeats)
            pil_ms = ms_per_call(pil, args.repeats)
            print(f"{os.path.basename(path)} ({os.path.getsize(path)} bytes): port "
                  f"{port_ms:.3f} ms, PIL {pil_ms:.3f} ms ({port_ms / pil_ms:.2f}x)", flush=True)


if __name__ == "__main__":
    main()
