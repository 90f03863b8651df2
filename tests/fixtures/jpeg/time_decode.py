"""Time the port's JPEG decoder beside PIL's (libjpeg-turbo, with its SIMD)
on the 500 x 375 photo fixtures, in one thread, where PIL is installed:

    python tests/fixtures/jpeg/time_decode.py [--repeats 200]

Prints ms per file for each decoder (the median of 5 windows of
`repeats` decodes), and checks the two agree.
"""

from __future__ import annotations

import argparse
import io
import os
import statistics
import sys
import time

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(HERE))))

from multimae_tpu_torch import native  # noqa: E402


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
    parser.add_argument("--repeats", type=int, default=200)
    args = parser.parse_args()
    for name in sorted(n for n in os.listdir(HERE) if n.startswith("photo_")):
        with open(os.path.join(HERE, name), "rb") as f:
            data = f.read()

        def pil():
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))

        if not np.array_equal(native.decode_jpeg(data), pil()):
            raise SystemExit(f"{name}: the port's decode differs from PIL's")
        port_ms = ms_per_call(lambda: native.decode_jpeg(data), args.repeats)
        pil_ms = ms_per_call(pil, args.repeats)
        print(f"{name} ({len(data)} bytes): port {port_ms:.3f} ms, PIL {pil_ms:.3f} ms "
              f"({port_ms / pil_ms:.2f}x)")


if __name__ == "__main__":
    main()
