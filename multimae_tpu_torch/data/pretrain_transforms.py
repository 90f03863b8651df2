"""Pretraining augmentations (counterpart of
multimae_tpu/data/pretrain_transforms.py; reference utils/datasets.py:66-117).

ONE RandomResizedCrop (scale 0.2-1.0, ratio 3/4-4/3) and one horizontal
flip are drawn per example and applied to every modality, then:
  * rgb    -> float32 (H, W, 3), ImageNet-normalised;
  * depth  -> float32 (H, W, 1), uint16 / 2^16;
  * semseg -> int32 (H/4, W/4) class map.

The resampling is PIL's, in the port's native library (native/fastimage.cpp;
the port has no PIL):
  * rgb: the JAX package's native path (fastimage `crop_resize_normalize`):
    PIL's antialiased bicubic weights over the whole image, the window
    centred in the crop box, sums in floating point with no uint8 rounding
    between or after the passes, then the flip and the normalisation.
  * depth: PIL's "I;16" resize of the crop (Resample.c, 16-bit path):
    the same weights inside the crop, each pass summed in double and
    rounded half away from zero to 16 bits, PIL's clipping included.
  * semseg: PIL's NEAREST resize of a palette image (Geometry.c
    ImagingScaleAffine): source pixel = int of the pixel centre, the
    centres accumulated step by step as PIL does (torch's "nearest-exact"
    rule), to (s, s) and then to (s/4, s/4).
The functions named *_twin are the same arithmetic in numpy, bit-equal to
the native ones; tests and chip_smoke.py's A/B use them
(`DataAugmentationForMultiMAE(twin=True)`), no CLI does.
Outputs are NHWC numpy arrays.
"""

from __future__ import annotations

import math
import random
from typing import Dict, Optional, Tuple

import numpy as np

from multimae_tpu_torch import native
from multimae_tpu_torch.utils.data_constants import (
    IMAGE_TASKS,
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    IMAGENET_INCEPTION_MEAN,
    IMAGENET_INCEPTION_STD,
)


def random_resized_crop_params(
    height: int,
    width: int,
    scale: Tuple[float, float] = (0.2, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
    rng: Optional[random.Random] = None,
) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop.get_params algorithm (i, j, h, w)."""
    rng = rng or random
    area = height * width
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect_ratio = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect_ratio)))
        h = int(round(math.sqrt(target_area / aspect_ratio)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h)
            j = rng.randint(0, width - w)
            return i, j, h, w
    # Fallback: center crop at a clipped aspect ratio.
    in_ratio = float(width) / float(height)
    if in_ratio < min(ratio):
        w = width
        h = int(round(w / min(ratio)))
    elif in_ratio > max(ratio):
        h = height
        w = int(round(h * max(ratio)))
    else:
        w = width
        h = height
    i = (height - h) // 2
    j = (width - w) // 2
    return i, j, h, w


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter (a = -0.5)."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def resample_weights(in_size: int, in0: float, in1: float, out_size: int, *,
                     pil_scale: bool, bicubic: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's antialiased bicubic (or bilinear) weights (Resample.c
    precompute_coeffs) for the window [in0, in1) of an axis of `in_size`
    pixels resized to `out_size`: source indices and normalised float64
    weights, both (out_size, taps), padded with weight 0 on index 0. The
    filter's argument is (x - center + 0.5) * (1 / filterscale) with
    `pil_scale` (Resample.c), else (x - center + 0.5) / filterscale (the
    JAX package's fastimage.cpp)."""
    scale = (in1 - in0) / out_size
    filterscale = max(scale, 1.0)
    support = (2.0 if bicubic else 1.0) * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = in0 + (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.floor(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.floor(center + support + 0.5), in_size).astype(np.int64)
    x = xmin[:, None] + np.arange(taps)[None, :]
    inside = x < xmax[:, None]
    arg = ((x - center[:, None] + 0.5) * (1.0 / filterscale) if pil_scale
           else (x - center[:, None] + 0.5) / filterscale)
    w = np.where(inside, (_bicubic if bicubic else _bilinear)(arg), 0.0)
    total = np.zeros((out_size, 1))
    for t in range(taps):  # summed in PIL's order
        total = total + w[:, t:t + 1]
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    return np.where(inside, x, 0), w


def _resample_rows(src: np.ndarray, idx: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """sum over taps t of src[idx[:, t]] * w[:, t] along `axis`, tap by tap
    (PIL's order), in float64."""
    shape = [1] * src.ndim
    shape[axis] = -1
    acc = 0.0
    for t in range(idx.shape[1]):
        acc = acc + np.take(src, idx[:, t], axis=axis) * w[:, t].reshape(shape)
    return acc


def _round_u16(v: np.ndarray) -> np.ndarray:
    """PIL's 16-bit store: round half away from zero, then its byte clipping
    (negative -> 0; past 65535 the high byte clips to 255)."""
    r = np.where(v >= 0.0, np.floor(v + 0.5), np.ceil(v - 0.5)).astype(np.int64)
    lo = np.where(r < 0, 0, r % 256)
    hi = np.clip(r >> 8, 0, 255)
    return (hi * 256 + lo).astype(np.uint16)


def resize_u16_twin(img: np.ndarray, size: int) -> np.ndarray:
    """PIL's bicubic resize of an "I;16" image to (size, size)."""
    h, w = img.shape
    xi, xw = resample_weights(w, 0.0, w, size, pil_scale=True)
    yi, yw = resample_weights(h, 0.0, h, size, pil_scale=True)
    tmp = _round_u16(_resample_rows(img.astype(np.float64), xi, xw, axis=1))
    return _round_u16(_resample_rows(tmp.astype(np.float64), yi, yw, axis=0))


def crop_resize_normalize_twin(img: np.ndarray, crop: Tuple[int, int, int, int], size: int,
                               mean: np.ndarray, std: np.ndarray, hflip: bool,
                               bicubic: bool = True) -> np.ndarray:
    """(H, W, C) uint8 -> (size, size, C) float32: the JAX package's native
    crop + antialiased bicubic resize + flip + normalise (fastimage.cpp
    mm_crop_resize_normalize)."""
    i, j, h, w = crop
    sh, sw = img.shape[:2]
    xi, xw = resample_weights(sw, j, j + w, size, pil_scale=False, bicubic=bicubic)
    yi, yw = resample_weights(sh, i, i + h, size, pil_scale=False, bicubic=bicubic)
    lo, hi = int(yi[yw != 0].min(initial=sh)), int((yi + 1)[yw != 0].max(initial=0))
    rows = img[lo:hi].astype(np.float64)
    tmp = _resample_rows(rows, xi, xw, axis=1).astype(np.float32)
    out = _resample_rows(tmp.astype(np.float64), np.where(yw != 0, yi - lo, 0), yw, axis=0)
    out = out.astype(np.float32) / np.float32(255.0)
    if hflip:
        out = out[:, ::-1]
    return np.ascontiguousarray((out - mean) / std, np.float32)


def crop_resize_u8_twin(img: np.ndarray, crop: Tuple[int, int, int, int], size: int,
                        hflip: bool, bicubic: bool = True) -> np.ndarray:
    """fastimage.cpp mm_crop_resize_u8: the resample above with mean 0 and
    std 1/255, rounded half away from zero and clamped to [0, 255]."""
    c = img.shape[2]
    v = crop_resize_normalize_twin(img, crop, size, np.zeros(c, np.float32),
                                   np.full(c, 1.0 / 255.0, np.float32), hflip, bicubic)
    r = np.trunc(v)
    r = r + np.where(np.abs(v - r) >= 0.5, np.sign(v), 0)
    return np.clip(r, 0, 255).astype(np.uint8)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's NEAREST source index per output pixel (ImagingScaleAffine): the
    centre starts at scale / 2 and advances by scale, summed step by step."""
    step = in_size / out_size
    centers = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    return np.minimum(centers.astype(np.int64), in_size - 1)


def resize_nearest_twin(img: np.ndarray, size: int) -> np.ndarray:
    """PIL's NEAREST resize to (size, size)."""
    h, w = img.shape[:2]
    return img[_nearest_index(h, size)][:, _nearest_index(w, size)]


class DataAugmentationForMultiMAE:
    """Consistent crop/flip across modalities + per-task arrays."""

    def __init__(
        self,
        input_size: int = 224,
        hflip: float = 0.5,
        imagenet_default_mean_and_std: bool = True,
        twin: bool = False,
    ):
        self.input_size = input_size
        self.hflip = hflip
        self.twin = twin  # the numpy twins, for comparisons; no CLI sets it
        if imagenet_default_mean_and_std:
            self.rgb_mean = np.asarray(IMAGENET_DEFAULT_MEAN, np.float32)
            self.rgb_std = np.asarray(IMAGENET_DEFAULT_STD, np.float32)
        else:
            self.rgb_mean = np.asarray(IMAGENET_INCEPTION_MEAN, np.float32)
            self.rgb_std = np.asarray(IMAGENET_INCEPTION_STD, np.float32)

    def __call__(
        self, task_dict: Dict[str, np.ndarray], rng: Optional[random.Random] = None
    ) -> Dict[str, np.ndarray]:
        rng = rng or random
        flip = rng.random() < self.hflip
        ijhw = None
        s = self.input_size

        out = {}
        for task, img in task_dict.items():
            if task not in IMAGE_TASKS:
                out[task] = img
                continue
            if ijhw is None:
                ijhw = random_resized_crop_params(img.shape[0], img.shape[1], rng=rng)
            i, j, h, w = ijhw

            if task == "rgb":
                out[task] = (crop_resize_normalize_twin(img, ijhw, s, self.rgb_mean,
                                                        self.rgb_std, flip) if self.twin
                             else native.crop_resize_normalize(img, ijhw, (s, s), self.rgb_mean,
                                                               self.rgb_std, hflip=flip))
                continue
            if task == "depth":
                if img.dtype != np.uint16:
                    raise ValueError(f"depth maps must be 16-bit, not {img.dtype}")
                if self.twin:
                    arr = resize_u16_twin(img[i:i + h, j:j + w], s)
                    arr = arr[:, ::-1] if flip else arr
                else:
                    arr = native.crop_resize_u16(img, ijhw, (s, s), hflip=flip)
                out[task] = (arr.astype(np.float32) / (2**16))[..., None]  # (H, W, 1)
            elif self.twin:  # semseg, semseg_coco: palette indices
                arr = resize_nearest_twin(img[i:i + h, j:j + w], s)
                arr = arr[:, ::-1] if flip else arr
                out[task] = resize_nearest_twin(arr, s // 4).astype(np.int32)  # (H/4, W/4)
            else:
                arr = native.pil_nearest(img, ijhw, (s, s), hflip=flip)
                out[task] = native.pil_nearest(arr, (0, 0, s, s), (s // 4, s // 4)).astype(
                    np.int32)
        return out
