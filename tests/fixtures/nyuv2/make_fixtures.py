"""Write the NYUv2 fixture that tests/test_torch_prepare_nyuv2.py and
chip_smoke.py hold the port's HDF5 reader and prepare_nyuv2 against, and
expected.json:

  * nyu_depth_v2_labeled.mat in MATLAB v7.3's layout (HDF5 in the earliest
    format behind a 512-byte user block holding MATLAB's header text) at
    NYUv2's frame size: `images` uint8 (N, 3, 640, 480), `depths` float32
    (N, 640, 480) in metres with zero holes and `labels` uint16 (N, 640,
    480) over 0..894, each chunked (edge chunks included) with deflate;
    `accelData` float32 (N, 4) contiguous beside them; a `#refs#` group of
    uint16 strings and the object-reference datasets `names` and `scenes`
    that point into it; MATLAB_class attributes;
  * splits.mat (MATLAB v5): trainNdxs and testNdxs, 1-based, N_TRAIN and
    N_TEST frames (two each: the JAX tool cannot read a split of one frame,
    whose `squeeze()` leaves a 0-d array it then iterates);
  * classMapping40.mat (MATLAB v5): mapClass, 894 values in 1..40;
  * expected.json: each dataset's shape, dtype and the SHA-256 of h5py's
    array, and for the JAX tool's trees (tools/prepare_nyuv2.py with and
    without the class mapping, the default depth scale) the digest of
    every PNG as the port decodes it (prepare_nyuv2.png_digest).

    python tests/fixtures/nyuv2/make_fixtures.py

Needs h5py, scipy and PIL. The content is piecewise constant (tiles of one
colour, depth and label) so that the set stays small; it comes from fixed
seeds, so the files change only with the writers.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile

import h5py
import numpy as np
from scipy.io import savemat

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, REPO)

from multimae_tpu_torch.tools.prepare_nyuv2 import tree_digests  # noqa: E402

N_TRAIN, N_TEST = 2, 2
W, H = 640, 480  # HDF5 stores MATLAB's (H, W, ...) reversed: (N, ..., W, H)
TILE = 32
MAT = "nyu_depth_v2_labeled.mat"
DATASETS = ("images", "depths", "labels", "accelData")
MATLAB_HEADER = (b"MATLAB 7.3 MAT-file, Platform: GLNXA64, Created on: Tue Jun 19 "
                 b"10:54:42 2012 HDF5 schema 1.00 .").ljust(116, b" ")


def tiles(rng, n, values, shape=(W // TILE, H // TILE)):
    """(n, W, H) piecewise-constant frames: one value per TILE x TILE tile."""
    t = values(rng, (n,) + shape)
    return np.repeat(np.repeat(t, TILE, axis=1), TILE, axis=2)


def frames(n):
    rng = np.random.default_rng(2012)
    images = np.stack([tiles(rng, n, lambda r, s: r.integers(0, 256, s, dtype=np.uint8))
                       for _ in range(3)], axis=1)
    depths = tiles(rng, n, lambda r, s: r.uniform(0.5, 10.0, s).astype(np.float32))
    depths[tiles(rng, n, lambda r, s: r.random(s) < 0.15)] = 0.0  # holes
    labels = tiles(rng, n, lambda r, s: r.integers(0, 895, s, dtype=np.uint16))
    accel = rng.standard_normal((n, 4)).astype(np.float32)
    return images, depths, labels, accel


def write_mat(path, n):
    images, depths, labels, accel = frames(n)
    with h5py.File(path, "w", libver="earliest", userblock_size=512) as f:
        specs = {"images": (images, (1, 2, 200, H), "uint8"),
                 "depths": (depths, (3, W, H), "single"),
                 "labels": (labels, (1, 320, 300), "uint16")}
        for name, (arr, chunks, cls) in specs.items():
            ds = f.create_dataset(name, data=arr, chunks=chunks, compression="gzip",
                                  compression_opts=3)
            ds.attrs["MATLAB_class"] = np.bytes_(cls)
        f.create_dataset("accelData", data=accel).attrs["MATLAB_class"] = np.bytes_("single")
        refs = f.create_group("#refs#")
        words = {}
        for key, text in (("a", "wall"), ("b", "floor"), ("c", "bedroom_0001"),
                          ("d", "kitchen_0003"), ("e", "office_0012"), ("f", "study_0004")):
            words[key] = refs.create_dataset(key, data=np.frombuffer(
                text.encode("utf-16-le"), "<u2").reshape(-1, 1))
            words[key].attrs["MATLAB_class"] = np.bytes_("char")
        names = f.create_dataset("names", (1, 2), dtype=h5py.ref_dtype)
        names[0, 0], names[0, 1] = words["a"].ref, words["b"].ref
        scenes = f.create_dataset("scenes", (1, n), dtype=h5py.ref_dtype)
        for i, key in enumerate("cdef"[:n]):
            scenes[0, i] = words[key].ref
        for ds in (names, scenes):
            ds.attrs["MATLAB_class"] = np.bytes_("cell")
    with open(path, "r+b") as f:
        f.write(MATLAB_HEADER + b"\0" * 8 + b"\x00\x02IM")
    return {"images": images, "depths": depths, "labels": labels, "accelData": accel}


def write_support(out):
    order = np.random.default_rng(7).permutation(N_TRAIN + N_TEST) + 1
    savemat(os.path.join(out, "splits.mat"),
            {"trainNdxs": order[:N_TRAIN].astype(np.uint16).reshape(-1, 1),
             "testNdxs": order[N_TRAIN:].astype(np.uint16).reshape(-1, 1)})
    mapping = np.random.default_rng(40).integers(1, 41, (1, 894)).astype(np.float64)
    savemat(os.path.join(out, "classMapping40.mat"),
            {"mapClass": mapping,
             "className": np.array([[f"class{i}" for i in range(1, 41)]], dtype=object)})


def jax_tool_tree(out, mapped):
    """Digests of the tree the repository's tools/prepare_nyuv2.py writes."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, os.path.join(REPO, "tools", "prepare_nyuv2.py"),
               "--dataset_path", os.path.join(out, MAT),
               "--splits_path", os.path.join(out, "splits.mat"), "--save_path", tmp]
        if mapped:
            cmd += ["--class_mapping_path", os.path.join(out, "classMapping40.mat")]
        subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL)
        return tree_digests(tmp)


def main():
    arrays = write_mat(os.path.join(HERE, MAT), N_TRAIN + N_TEST)
    write_support(HERE)
    with h5py.File(os.path.join(HERE, MAT), "r") as f:
        datasets = {}
        for name in DATASETS:
            arr = np.asarray(f[name])
            assert np.array_equal(arr, arrays[name])
            datasets[name] = {"shape": list(arr.shape), "dtype": arr.dtype.str,
                              "sha256": hashlib.sha256(arr.tobytes()).hexdigest()}
    expected = {"datasets": datasets,
                "trees": {"class40": jax_tool_tree(HERE, True),
                          "raw": jax_tool_tree(HERE, False)},
                "splits": {"train": N_TRAIN, "test": N_TEST}}
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    sizes = {n: os.path.getsize(os.path.join(HERE, n)) for n in sorted(os.listdir(HERE))}
    print(json.dumps(sizes), sum(sizes.values()), "bytes")


if __name__ == "__main__":
    main()
