"""The Taskonomy dataset and its per-task transforms without PIL or cv2
(counterpart of multimae_tpu/data/taskonomy.py; reference
utils/taskonomy/).

* `task_parameters`: channels, clamps and file kinds per task (reference
  task_configs.py:5-99), the JAX package's table.
* `task_transform`: the shorter side resized to `image_size` (PIL's 8-bit
  BILINEAR for rgb, `native.pil_resize(..., "bilinear")`; PIL's NEAREST
  for every other task: `native.pil_nearest` for 8-bit images and
  `native.pil_nearest_i16` for 16-bit planes, which Pillow opens as
  "I;16" and resizes through another code path, with other pixel
  centres), then each task's normalisation: ImageNet for rgb, / 255
  for normal, curvature and reshading, / 65535 for the 16-bit tasks, the
  3x3 Gaussian blur (cv2.GaussianBlur at sigma 1, `native.gaussian_blur_3x3`)
  for edge_occlusion, the clamp and rescale of the tasks that have one,
  and the valid mask (its invalid region grown by a 4x4 max pool) from the
  depth_zbuffer PNG.
* `TaskonomyDataset`: a CSV split of (building, point, view) rows over
  root/<task>/<building>/point_<p>_view_<v>_domain_<task>.png, the PNGs
  read by the port's decoder (16-bit gray included, data/image_io.py).

The JAX loader opens its PNGs with PIL's LOAD_TRUNCATED_IMAGES; the port
raises ValueError naming a truncated file, and the loader's corrupt-file
retry draws another sample. `twin=True` reads and transforms with the
numpy twins of the native functions (tests and chip_smoke.py's A/B).
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from multimae_tpu_torch import native
from multimae_tpu_torch.data.image_io import load_image
from multimae_tpu_torch.data.pil_ops import resize_twin as pil_resize_twin
from multimae_tpu_torch.data.pretrain_transforms import _nearest_index
from multimae_tpu_torch.utils.data_constants import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD

task_parameters: Dict[str, Dict] = {
    "class_object": {"num_classes": 1000, "ext": "npy", "domain_id": "class_object"},
    "class_scene": {"num_classes": 365, "ext": "npy", "domain_id": "class_scene"},
    "depth_zbuffer": {
        "num_channels": 1, "mask_val": 1.0,
        "clamp_to": (0.0, 8000.0 / (2**16 - 1)),
        "ext": "png", "domain_id": "depth_zbuffer",
    },
    "depth_euclidean": {
        "num_channels": 1, "clamp_to": (0.0, 8000.0 / (2**16 - 1)),
        "ext": "png", "domain_id": "depth_euclidean",
    },
    "edge_texture": {
        "num_channels": 1, "clamp_to": (0.0, 0.25),
        "ext": "png", "domain_id": "edge_texture",
    },
    "edge_occlusion": {"num_channels": 1, "ext": "png", "domain_id": "edge_occlusion"},
    "keypoints3d": {"num_channels": 1, "ext": "png", "domain_id": "keypoints3d"},
    "keypoints2d": {"num_channels": 1, "ext": "png", "domain_id": "keypoints2d"},
    "principal_curvature": {
        "num_channels": 3, "mask_val": 0.0, "ext": "png",
        "domain_id": "principal_curvature",
    },
    "reshading": {"num_channels": 1, "ext": "png", "domain_id": "reshading"},
    "normal": {"num_channels": 3, "mask_val": 0.502, "ext": "png",
               "domain_id": "normal"},
    "mask_valid": {"num_channels": 1, "mask_val": 0.0, "ext": "png",
                   "domain_id": "depth_zbuffer"},
    "rgb": {"num_channels": 3, "ext": "png", "domain_id": "rgb"},
    "segment_semantic": {"num_channels": 18, "ext": "png",
                         "domain_id": "segmentsemantic"},
}


def make_valid_mask(mask01: np.ndarray, max_pool_size: int = 4) -> np.ndarray:
    """(H, W) bool, True where valid: the invalid region of a {0, 1} mask
    grown by a max pool of `max_pool_size` and a nearest upsample
    (reference transforms.py:43-62, JAX :65-83); rows and columns past the
    last whole pool stay invalid, as in the JAX function."""
    h, w = mask01.shape
    inv = 1.0 - mask01
    hp = (h // max_pool_size) * max_pool_size
    wp = (w // max_pool_size) * max_pool_size
    pooled = inv[:hp, :wp].reshape(
        hp // max_pool_size, max_pool_size, wp // max_pool_size, max_pool_size
    ).max(axis=(1, 3))
    up = np.repeat(np.repeat(pooled, max_pool_size, 0), max_pool_size, 1)
    out = np.zeros((h, w), np.float32)
    out[:hp, :wp] = up
    return out == 0


def _reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(idx)
    return np.where(idx < 0, -idx, np.where(idx >= n, 2 * n - 2 - idx, idx))


def _fma(a: np.ndarray, b: np.float32, c: np.ndarray) -> np.ndarray:
    """a * b + c rounded once to float32 (through float64, exact for the
    product)."""
    return (a.astype(np.float64) * np.float64(b) + c.astype(np.float64)).astype(np.float32)


def gaussian_blur_3x3_twin(img: np.ndarray) -> np.ndarray:
    """`native.gaussian_blur_3x3` in numpy: cv2.GaussianBlur(img, (3, 3),
    sigmaX=1.0) of an (H, W) float32 image, the fused multiply-adds and the
    odd-width row tail of OpenCV's separable filters (native/fastimage.cpp)."""
    k0, k1 = np.float32(0.45186275), np.float32(0.27406862)  # getGaussianKernel(3, 1)
    h, w = img.shape
    cols = np.arange(w)
    left, right = img[:, _reflect101(cols - 1, w)], img[:, _reflect101(cols + 1, w)]
    sides = left + right
    rows = _fma(img, k0, sides * k1)
    if w % 2:
        rows[:, -1] = _fma(sides[:, -1], k1, img[:, -1] * k0)
    ys = np.arange(h)
    up, down = rows[_reflect101(ys - 1, h)], rows[_reflect101(ys + 1, h)]
    return _fma(up + down, k1, rows * k0)


def _resize(img: np.ndarray, size_hw, bilinear: bool, twin: bool) -> np.ndarray:
    """PIL's resize of a decoded PNG: 8-bit BILINEAR, or NEAREST (any dtype)."""
    h, w = img.shape[:2]
    if (h, w) == tuple(size_hw):
        return img
    if bilinear:
        return (pil_resize_twin if twin else native.pil_resize)(img, size_hw, "bilinear")
    if img.dtype == np.uint16:
        if not twin:
            return native.pil_nearest_i16(img, size_hw)
        centres = [((np.arange(n) + 0.5) * (m / n)).astype(np.int64)
                   for m, n in zip((h, w), size_hw)]
        return img[centres[0]][:, centres[1]]
    if twin:
        return img[_nearest_index(h, size_hw[0])][:, _nearest_index(w, size_hw[1])]
    return native.pil_nearest(img, (0, 0, h, w), size_hw)


def task_transform(img: np.ndarray, task: str, image_size: Optional[int] = 256,
                   twin: bool = False) -> np.ndarray:
    """A decoded PNG (as `load_image(path, convert_rgb=False)` gives it) ->
    the task's (H, W, C) float32 array (JAX :86-133; reference
    transforms.py:66-133); segment_semantic stays int32, mask_valid bool."""
    params = task_parameters[task]
    if image_size is not None:
        h, w = img.shape[:2]
        scale = image_size / min(w, h)
        img = _resize(img, (round(h * scale), round(w * scale)), task == "rgb", twin)
    arr = img

    if task == "rgb":
        x = arr.astype(np.float32) / 255.0
        x = (x - np.asarray(IMAGENET_DEFAULT_MEAN, np.float32)) / np.asarray(
            IMAGENET_DEFAULT_STD, np.float32)
    elif task == "normal":
        x = arr.astype(np.float32) / 255.0
    elif task == "mask_valid":
        return make_valid_mask((arr > 0).astype(np.float32))[..., None]
    elif task in ("keypoints2d", "keypoints3d", "depth_euclidean",
                  "depth_zbuffer", "edge_texture"):
        x = arr.astype(np.float32) / (2**16 - 1.0)
        x = x[..., None] if x.ndim == 2 else x[..., :1]
    elif task == "edge_occlusion":
        x = arr.astype(np.float32) / (2**16 - 1.0)
        x = (gaussian_blur_3x3_twin if twin else native.gaussian_blur_3x3)(x)
        x = x[..., None]
    elif task in ("principal_curvature", "curvature"):
        x = arr.astype(np.float32) / 255.0
        x = x[..., :2]
    elif task == "reshading":
        x = arr.astype(np.float32) / 255.0
        x = x[..., :1] if x.ndim == 3 else x[..., None]
    elif task == "segment_semantic":
        return arr.astype(np.int32)
    else:
        x = arr.astype(np.float32)

    if "clamp_to" in params:
        lo, hi = params["clamp_to"]
        x = np.clip(x, lo, hi) / hi  # MAKE_RESCALE_0_MAX_0_POS1
    return x


def task_path(data_root: str, task: str, building: str, point: str, view: str) -> str:
    """root/<task>/<building>/point_<p>_view_<v>_domain_<task>.png; mask_valid
    reads root/mask_valid/<building>/..._domain_depth_zbuffer.png (JAX :176-181)."""
    task_id = "depth_zbuffer" if task == "mask_valid" else task
    return os.path.join(data_root, task, building,
                        f"point_{point}_view_{view}_domain_{task_id}.png")


class TaskonomyDataset:
    """The (building, point, view) rows of <splits_dir>/<variant>_<split>.csv
    (a header row first; splits_dir defaults to <root>/splits), the first
    `max_images` of them; `load_raw(i)` -> ({task: array}, 0) through
    `task_transform` (JAX :136-196)."""

    def __init__(self, data_root: str, tasks: Sequence[str], split: str = "train",
                 variant: str = "tiny", image_size: int = 256,
                 max_images: Optional[int] = None, splits_dir: Optional[str] = None,
                 twin: bool = False):
        self.data_root = data_root
        self.tasks = list(tasks)
        self.image_size = image_size
        self.twin = twin  # the numpy twins, for comparisons; no CLI
        splits_dir = splits_dir or os.path.join(data_root, "splits")
        path = os.path.join(splits_dir, f"{variant}_{split}.csv")
        with open(path) as f:
            reader = csv.reader(f)
            next(reader)
            self.image_ids: List[tuple] = [tuple(row) for row in reader]
        if isinstance(max_images, int):
            self.image_ids = self.image_ids[:max_images]
        print(f"Initialized TaskonomyDataset with {len(self.image_ids)} images "
              f"from variant {variant} in split {split}.")

    def __len__(self) -> int:
        return len(self.image_ids)

    def load_raw(self, index: int):
        building, point, view = self.image_ids[index]
        result = {}
        for task in self.tasks:
            img = load_image(task_path(self.data_root, task, building, point, view),
                             convert_rgb=False, twin=self.twin)
            result[task] = task_transform(img, task, self.image_size, self.twin)
        return result, 0

    def __getitem__(self, index: int):
        return self.load_raw(index)


def write_taskonomy_tree(root: str, tasks: Sequence[str], splits: Dict[str, int],
                         hw=(512, 512), seed: int = 0, variant: str = "tiny",
                         buildings: int = 2) -> str:
    """Write a Taskonomy-layout tree of photo-like PNGs drawn from `seed`
    for tests and chip runs: for each split (name -> rows) rows of
    (building, point, view) in <root>/splits/<variant>_<split>.csv, and per
    row and task root/<task>/<building>/point_<p>_view_<v>_domain_<task>.png:
    8-bit RGB for rgb, normal and principal_curvature, 8-bit gray for
    reshading, 16-bit gray for the depth, edge and keypoint tasks, and for
    mask_valid the depth_zbuffer map, whose zero patch is invalid. Returns
    the splits directory."""
    from multimae_tpu_torch.data.dataset_folder import _smooth_sample
    from multimae_tpu_torch.data.image_io import write_png

    rng = np.random.default_rng(seed)
    h, w = hw
    split_dir = os.path.join(root, "splits")
    os.makedirs(split_dir, exist_ok=True)
    n = 0
    for split, rows in splits.items():
        with open(os.path.join(split_dir, f"{variant}_{split}.csv"), "w") as f:
            f.write("building,point,view\n")
            for _ in range(rows):
                building, point, view = f"b{n % buildings}", str(n), str(n % 3)
                f.write(f"{building},{point},{view}\n")
                n += 1
                rgb, depth, _ = _smooth_sample(rng, h, w, 2)
                zbuffer = depth.copy()
                y, x = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
                zbuffer[y:y + h // 8, x:x + w // 8] = 0
                for task in tasks:
                    if task in ("rgb", "normal", "principal_curvature"):
                        px = rgb if task == "rgb" else np.roll(rgb, 1 + len(task), axis=2)
                    elif task == "reshading":
                        px = rgb[..., 1]
                    elif task in ("depth_zbuffer", "mask_valid"):
                        px = zbuffer
                    else:
                        px = depth
                    path = task_path(root, task, building, point, view)
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    write_png(path, np.ascontiguousarray(px), filters="adaptive")
    return split_dir
