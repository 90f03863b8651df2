"""Depth-regression fine-tune augmentations without cv2 (counterpart of
multimae_tpu/data/regression_transforms.py; reference
utils/dataset_regression.py:31-130).

`NYUTransform` (SmallestMaxSize, hflip, the optional BYOL colour jitter and
ToGray on rgb, RandomCrop or the eval CenterCrop, ImageNet normalisation)
and `DataAugmentationForRegression` (depth standardised with the NYU mean
and std, mask_valid = (PNG == 255), invalid depth set to `mask_value`)
follow the JAX package line for line, draws included, on the semseg
transforms' cv2 arithmetic (data/semseg_transforms.py): INTER_LINEAR for
rgb, INTER_NEAREST for depth and mask_valid, the colour jitter and
RGB2GRAY, in the native library, or with `twin=True` in the numpy twins.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np

from multimae_tpu_torch.data.semseg_transforms import NATIVE_OPS, TWIN_OPS, _color_jitter, _resize
from multimae_tpu_torch.utils.data_constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    NYU_MEAN,
    NYU_STD,
)

AUG_IS_MASK = {"rgb": False, "depth": True, "mask_valid": True}


class NYUTransform:
    """Reference nyu_transform (:31-64), JAX :30-79."""

    def __init__(self, train: bool, input_size: int = 256, color_aug: bool = False,
                 twin: bool = False):
        self.train = train
        self.input_size = input_size
        self.color_aug = color_aug
        self.ops = TWIN_OPS if twin else NATIVE_OPS  # the twins for comparisons; no CLI
        self.mean = np.asarray(IMAGENET_DEFAULT_MEAN, np.float32) * 255
        self.std = np.asarray(IMAGENET_DEFAULT_STD, np.float32) * 255

    def __call__(self, arrays: Dict[str, np.ndarray],
                 rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        rng = rng or random
        s = self.input_size
        out = dict(arrays)

        # SmallestMaxSize: the shorter side becomes s
        h, w = next(iter(out.values())).shape[:2]
        scale = s / min(h, w)
        size_wh = (round(w * scale), round(h * scale))
        out = {k: _resize(v, size_wh, AUG_IS_MASK.get(k, True), self.ops)
               for k, v in out.items()}

        if self.train:
            if rng.random() < 0.5:
                out = {k: np.ascontiguousarray(v[:, ::-1]) for k, v in out.items()}
            if self.color_aug and "rgb" in out:
                if rng.random() < 0.5:
                    out["rgb"] = _color_jitter(out["rgb"], rng, brightness=0.1255,
                                               contrast=0.4, saturation=0.5, hue=0.2,
                                               image_ops=self.ops)
                if rng.random() < 0.3:
                    gray = self.ops.rgb_to_gray(out["rgb"])
                    out["rgb"] = np.stack([gray] * 3, axis=-1)
            h, w = next(iter(out.values())).shape[:2]
            top = rng.randint(0, h - s) if h > s else 0
            left = rng.randint(0, w - s) if w > s else 0
        else:
            h, w = next(iter(out.values())).shape[:2]
            top, left = (h - s) // 2, (w - s) // 2
        out = {k: v[top:top + s, left:left + s] for k, v in out.items()}

        if "rgb" in out:
            rgb = out["rgb"].astype(np.float32)
            out["rgb"] = (rgb - self.mean) / self.std
        return out


class DataAugmentationForRegression:
    """Reference :97-130, JAX :82-107: the transform, then depth as
    (depth - NYU_MEAN) / NYU_STD (H, W, 1) with `mask_value` where
    mask_valid is not 255, mask_valid as (H, W, 1) bool, the rest float32."""

    def __init__(self, transform, mask_value: float = 0.0):
        self.transform = transform
        self.mask_value = mask_value

    def __call__(self, task_dict: Dict[str, object],
                 rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        arrays = {k: np.array(v) for k, v in task_dict.items()}
        arrays = self.transform(arrays, rng=rng)

        out = {}
        depth = arrays.pop("depth").astype(np.float32)
        depth = (depth - NYU_MEAN) / NYU_STD
        if "mask_valid" in arrays:
            mask_valid = arrays.pop("mask_valid") == 255
            depth[~mask_valid] = self.mask_value
            out["mask_valid"] = mask_valid[..., None]
        out["depth"] = depth[..., None]
        for task, v in arrays.items():
            out[task] = v.astype(np.float32)
        return out
