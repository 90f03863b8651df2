"""Interleaved A/B of the native JPEG decoder (`mm_decode_jpeg`) across
source trees of the repository, in one process, where PIL is installed:

    ROUNDS=15 REPEATS=10 python3 tests/fixtures/jpeg/ab_decode.py NAME=TREE [NAME=TREE ...]

(for example parent=build/parent change=. after `git archive` of the
parent commit into build/parent). Each tree's native library is built by
a subprocess in that tree, then all are loaded here with ctypes. For each
of tests/fixtures/jpeg/big_*.jpg and photo_*.jpg, ROUNDS rounds each time
a window of REPEATS decodes (bytes in memory, one thread) of every tree
and of PIL, the order rotated from round to round.
Prints per file each variant's median ms, and for every tree against the
first its per-round ratio (median, quartiles) and how many rounds it won."""
import ctypes
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
from PIL import Image

JPEG = os.path.dirname(os.path.abspath(__file__))
FILES = sorted(n for n in os.listdir(JPEG) if n.startswith(("big_", "photo_")))
ROUNDS = int(os.environ.get("ROUNDS", "15"))
REPEATS = int(os.environ.get("REPEATS", "10"))


def build(tree):
    code = "from multimae_tpu_torch import native; print(native.lib()._name)"
    r = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True,
                       check=True)
    return r.stdout.strip().splitlines()[-1]


def decoder(path):
    fn = ctypes.CDLL(os.path.abspath(path)).mm_decode_jpeg
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
    h, w = ctypes.c_int(), ctypes.c_int()
    msg = ctypes.create_string_buffer(256)

    def decode(data):
        args = (ctypes.addressof(h), ctypes.addressof(w), msg, 256)
        assert fn(data, len(data), None, 0, *args) == -3
        out = np.empty((h.value, w.value, 3), np.uint8)
        assert fn(data, len(data), out.ctypes.data, out.nbytes, *args) == 0, msg.value
        return out
    return decode


def main():
    names, fns = [], []
    for arg in sys.argv[1:]:
        name, tree = arg.split("=", 1)
        names.append(name)
        fns.append(decoder(build(tree)))
    names.append("PIL")
    fns.append(lambda data: np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    for name in FILES:
        with open(os.path.join(JPEG, name), "rb") as f:
            data = f.read()
        ref = fns[-1](data)
        for fn in fns:
            assert np.array_equal(fn(data), ref), name
        ms = [[] for _ in fns]
        for r in range(ROUNDS):
            for k in range(len(fns)):
                i = (k + r) % len(fns)
                t0 = time.perf_counter()
                for _ in range(REPEATS):
                    fns[i](data)
                ms[i].append((time.perf_counter() - t0) / REPEATS * 1e3)
        row = {n: statistics.median(m) for n, m in zip(names, ms)}
        for n, m in zip(names[1:-1], ms[1:-1]):
            ratios = [b / a for a, b in zip(ms[0], m)]
            q = statistics.quantiles(ratios, n=4)
            row[f"{n}/{names[0]}"] = [statistics.median(ratios), q[0], q[2],
                                      sum(b < a for a, b in zip(ms[0], m)), ROUNDS]
        print(name, json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
