"""Convert the NYUv2 labeled release into the MultiMAE folder layout
(counterpart of the repository's tools/prepare_nyuv2.py; reference
tools/prepare_nyuv2.py), without h5py or PIL:

    python -m multimae_tpu_torch.tools.prepare_nyuv2 \\
        --dataset_path nyu_depth_v2_labeled.mat --splits_path splits.mat \\
        [--class_mapping_path classMapping40.mat] --save_path data/nyu \\
        [--depth_scale 1000]

writes <save_path>/{train,test}/{rgb,depth,semseg,mask_valid}/all/<idx:04d>.png,
the aligned trees the semseg, depth and pretraining CLIs read:

  * rgb: `images[i]` (3, W, H) transposed to (H, W, 3), 8-bit RGB;
  * depth: `depths[i]` in metres, np.clip(depth * depth_scale, 0, 65535)
    as uint16 (float32 arithmetic, as numpy promotes it), 16-bit gray;
  * semseg: `labels[i]` through the 894 -> 40 class map when one is given
    (0 stays void), as uint8, a palette PNG with the gray palette that
    Pillow's convert("P") from "L" gives;
  * mask_valid: (depth > 0) * 255, 8-bit gray.

The `.mat` release is MATLAB v7.3, an HDF5 file, read frame by frame with
the port's reader (utils/hdf5.py): one frame and its chunks in memory, where
the JAX tool loads the three datasets whole (about 4 GB). splits.mat and
classMapping40.mat are MATLAB v5 files, read with scipy.io.loadmat. The PNG
files come from data/image_io.py's writer; Pillow reads them as the same
modes, sizes, palettes and pixels as the JAX tool's.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from multimae_tpu_torch.data.image_io import read_png, write_png
from multimae_tpu_torch.utils.hdf5 import File

TASKS = ("rgb", "depth", "semseg", "mask_valid")
# Pillow's convert("P") of an "L" image keeps the pixels as indices into a
# gray ramp of 256 entries, and its PNG writer stores all 256.
GRAY_PALETTE = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)


def get_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser("Script to prepare NYUv2 dataset", add_help=True)
    parser.add_argument("--dataset_path", type=str, required=True,
                        help="Path to nyu_depth_v2_labeled.mat")
    parser.add_argument("--splits_path", type=str, required=True,
                        help="Path to splits.mat")
    parser.add_argument("--class_mapping_path", type=str, default=None,
                        help="Path to classMapping40.mat")
    parser.add_argument("--save_path", type=str, required=True)
    parser.add_argument("--depth_scale", type=float, default=1000.0,
                        help="Depth metres -> uint16 scale")
    return parser.parse_args(argv)


def read_label_map(path: Optional[str]) -> Optional[np.ndarray]:
    """The 894 -> 40 class map with 0 kept void, or None."""
    if path is None:
        return None
    from scipy.io import loadmat

    mapping = loadmat(path)["mapClass"][0]
    label_map = np.zeros(len(mapping) + 1, np.int32)
    label_map[1:] = mapping
    return label_map


def frame_arrays(image: np.ndarray, depth: np.ndarray, label: np.ndarray,
                 label_map: Optional[np.ndarray], depth_scale: float) -> Dict[str, np.ndarray]:
    """One frame as the JAX tool computes it (its :70-79): {task: pixels}."""
    rgb = image.transpose(2, 1, 0)          # (H, W, 3)
    depth_m = depth.transpose(1, 0)          # (H, W)
    label = label.transpose(1, 0)            # (H, W)
    if label_map is not None:
        label = label_map[label]
    depth_u16 = np.clip(depth_m * depth_scale, 0, 65535).astype(np.uint16)
    mask_valid = ((depth_m > 0) * 255).astype(np.uint8)
    return {"rgb": np.ascontiguousarray(rgb.astype(np.uint8)),
            "depth": np.ascontiguousarray(depth_u16),
            "semseg": np.ascontiguousarray(label.astype(np.uint8)),
            "mask_valid": np.ascontiguousarray(mask_valid)}


def write_frame(save_path: str, subset: str, index: int, arrays: Dict[str, np.ndarray]) -> None:
    name = f"{index:04d}.png"
    for task in TASKS:
        path = os.path.join(save_path, subset, task, "all", name)
        write_png(path, arrays[task], palette=GRAY_PALETTE if task == "semseg" else None)


def split_indices(splits: dict, key: str) -> np.ndarray:
    """0-based frame indices from splits.mat's 1-based column."""
    idx = np.asarray(splits[key]).squeeze() - 1
    if idx.dtype.kind == "f":
        if not np.array_equal(idx, np.floor(idx)):
            raise ValueError(f"{key}: indices that are not whole numbers")
        idx = idx.astype(np.int64)
    return np.atleast_1d(idx)


def prepare(dataset_path: str, splits_path: str, save_path: str,
            class_mapping_path: Optional[str] = None, depth_scale: float = 1000.0,
            verbose: bool = True) -> Dict[str, object]:
    """Write the tree; returns {"frames": {subset: count}, "seconds": s,
    "ms_per_frame": ms}."""
    from scipy.io import loadmat

    label_map = read_label_map(class_mapping_path)
    splits = loadmat(splits_path)
    subsets = (("train", split_indices(splits, "trainNdxs")),
               ("test", split_indices(splits, "testNdxs")))
    t0 = time.perf_counter()
    frames: Dict[str, int] = {}
    with File(dataset_path) as f:
        images, depths, labels = f["images"], f["depths"], f["labels"]
        for subset, indices in subsets:
            for task in TASKS:
                os.makedirs(os.path.join(save_path, subset, task, "all"), exist_ok=True)
            for i in indices:
                arrays = frame_arrays(images[i], depths[i], labels[i], label_map, depth_scale)
                write_frame(save_path, subset, int(i), arrays)
            frames[subset] = len(indices)
            if verbose:
                print(f"{subset}: wrote {len(indices)} examples")
    seconds = time.perf_counter() - t0
    total = sum(frames.values())
    return {"frames": frames, "seconds": seconds,
            "ms_per_frame": seconds * 1e3 / total if total else 0.0}


def png_digest(path: str) -> str:
    """SHA-256 of a PNG's decoded content as the port reads it: colour
    type, shape, dtype, palette and the pixels (little-endian)."""
    with open(path, "rb") as fh:
        img = read_png(fh.read())
    px = np.ascontiguousarray(img.pixels)
    h = hashlib.sha256(f"{img.color_type} {px.shape} {px.dtype.str[1:]}".encode())
    if img.palette is not None:
        h.update(np.ascontiguousarray(img.palette, np.uint8).tobytes())
    h.update(px.astype(px.dtype.newbyteorder("<"), copy=False).tobytes())
    return h.hexdigest()


def tree_digests(save_path: str) -> Dict[str, str]:
    """{path relative to save_path: png_digest} of every PNG of the tree."""
    out = {}
    for root, _, files in os.walk(save_path):
        for name in sorted(files):
            if name.endswith(".png"):
                path = os.path.join(root, name)
                out[os.path.relpath(path, save_path).replace(os.sep, "/")] = png_digest(path)
    return dict(sorted(out.items()))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    args = get_args(argv)
    return prepare(args.dataset_path, args.splits_path, args.save_path,
                   class_mapping_path=args.class_mapping_path, depth_scale=args.depth_scale)


if __name__ == "__main__":
    main()
