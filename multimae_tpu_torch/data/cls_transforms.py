"""ImageNet classification transforms on (H, W, 3) uint8 arrays
(counterpart of multimae_tpu/data/cls_transforms.py; reference
utils/transforms_factory.py:51-134 and utils/datasets.py:190-205).

  * `ClsTrainTransform`: RandomResizedCrop (scale 0.08-1, the JAX
    `random_resized_crop_params`), Pillow's 8-bit resize of the crop
    (bicubic, bilinear, lanczos or nearest; bilinear or bicubic at random
    with "random"), a horizontal flip, RandAugment, an AutoAugment policy
    or AugMix (or ColorJitter when --aa is off), the normalisation and
    RandomErasing;
  * `ClsEvalTransform`: the shorter side resized to int(input / crop_pct)
    (bicubic, bilinear, lanczos or nearest), then the centre crop and the
    normalisation.

Both return (H, W, 3) float32. Every draw comes from the random.Random
the caller passes (the loader gives each record its own): the JAX
transform's RandAugment and its "random" interpolation draw from the
process-global `random` instead. The draws are made in the JAX order
(crop, interpolation, flip, the augmentation, erasing), so a global
`random` seeded like the record's generator reproduces them. The Pillow
operations are data/pil_ops.py's: native, or the numpy twins with
`twin=True` (tests and chip_smoke.py's A/B; no CLI).
"""

from __future__ import annotations

import math
import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from multimae_tpu_torch.data import pil_ops
from multimae_tpu_torch.data.auto_augment import create_aa_transform
from multimae_tpu_torch.data.pil_ops import NATIVE_OPS, TWIN_OPS, PilOps
from multimae_tpu_torch.data.pretrain_transforms import random_resized_crop_params
from multimae_tpu_torch.utils.data_constants import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD


def _check_interpolation(name: str, allowed: Sequence[str]) -> str:
    """The JAX package's _PIL_INTERP names (:29-34), and "random" where
    the caller allows it; another name raises KeyError as there."""
    if name not in allowed:
        raise KeyError(f"interpolation {name!r}: one of {', '.join(allowed)}")
    return name


def _resample_of(name: str, rng: random.Random) -> str:
    """The resize filter; "random" draws bilinear or bicubic (JAX :37-40)."""
    if name == "random":
        return "bicubic" if rng.choice((False, True)) else "bilinear"
    return name


class RandomErasing:
    """timm's 'pixel' random erasing on a normalised HWC float array (JAX
    :43-81, reference utils/random_erasing.py)."""

    def __init__(self, probability: float = 0.25, min_area: float = 0.02,
                 max_area: float = 1 / 3, min_aspect: float = 0.3,
                 max_aspect: Optional[float] = None, mode: str = "pixel", count: int = 1):
        self.probability = probability
        self.min_area = min_area
        self.max_area = max_area
        max_aspect = max_aspect or 1 / min_aspect
        self.log_aspect = (math.log(min_aspect), math.log(max_aspect))
        self.mode = mode
        self.count = count

    def __call__(self, arr: np.ndarray, rng: random.Random) -> np.ndarray:
        if rng.random() > self.probability:
            return arr
        h, w, c = arr.shape
        area = h * w
        arr = arr.copy()
        for _ in range(self.count):
            for _ in range(10):
                target = area * rng.uniform(self.min_area, self.max_area) / self.count
                aspect = math.exp(rng.uniform(*self.log_aspect))
                eh = int(round(math.sqrt(target * aspect)))
                ew = int(round(math.sqrt(target / aspect)))
                if eh < h and ew < w:
                    top = rng.randint(0, h - eh)
                    left = rng.randint(0, w - ew)
                    if self.mode == "pixel":
                        arr[top:top + eh, left:left + ew] = np.random.default_rng(
                            rng.getrandbits(32)).standard_normal((eh, ew, c)).astype(arr.dtype)
                    elif self.mode == "const":
                        arr[top:top + eh, left:left + ew] = 0.0
                    break
        return arr


class ColorJitter:
    """Brightness, contrast and saturation through ImageEnhance, in an
    order drawn from `rng` (JAX :84-100)."""

    def __init__(self, amount: float = 0.4, ops: PilOps = NATIVE_OPS):
        self.amount = amount
        self.ops = ops

    def __call__(self, img: np.ndarray, rng: random.Random) -> np.ndarray:
        lo, hi = max(0.0, 1 - self.amount), 1 + self.amount
        fns = [pil_ops.brightness, pil_ops.contrast, pil_ops.color]
        rng.shuffle(fns)
        for fn in fns:
            img = fn(img, rng.uniform(lo, hi), self.ops)
        return img


def _normalize(img: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return (np.asarray(img, np.float32) / 255.0 - mean) / std


class ClsTrainTransform:
    def __init__(self, input_size: int = 224, hflip: float = 0.5,
                 color_jitter: Optional[float] = 0.4,
                 auto_augment: Optional[str] = "rand-m9-mstd0.5-inc1",
                 interpolation: str = "bicubic", re_prob: float = 0.25,
                 re_mode: str = "pixel", re_count: int = 1,
                 mean: Sequence[float] = IMAGENET_DEFAULT_MEAN,
                 std: Sequence[float] = IMAGENET_DEFAULT_STD,
                 scale: Tuple[float, float] = (0.08, 1.0),
                 ratio: Tuple[float, float] = (3 / 4, 4 / 3), twin: bool = False):
        self.input_size = input_size
        self.hflip = hflip
        self.interpolation = _check_interpolation(interpolation,
                                                  pil_ops.RESAMPLE + ("random",))
        self.scale = scale
        self.ratio = ratio
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.ops = TWIN_OPS if twin else NATIVE_OPS
        self.aa = self.cj = None
        if auto_augment:
            img_mean = tuple(min(255, round(255 * m)) for m in mean)
            self.aa = create_aa_transform(auto_augment, {"img_mean": img_mean}, twin=twin)
        elif color_jitter is not None and color_jitter > 0:
            self.cj = ColorJitter(color_jitter, self.ops)  # timm drops it under AA
        self.re = RandomErasing(re_prob, mode=re_mode, count=re_count) if re_prob > 0 else None

    def augment_u8(self, img: np.ndarray, rng: random.Random) -> np.ndarray:
        """Everything before the normalisation: (H, W, 3) uint8 ->
        (input, input, 3) uint8."""
        i, j, h, w = random_resized_crop_params(img.shape[0], img.shape[1], scale=self.scale,
                                                ratio=self.ratio, rng=rng)
        s = self.input_size
        out = self.ops.resize(img[i:i + h, j:j + w], (s, s),
                              _resample_of(self.interpolation, rng))
        if rng.random() < self.hflip:
            out = np.ascontiguousarray(out[:, ::-1])
        if self.aa is not None:
            out = self.aa(out, rng)
        elif self.cj is not None:
            out = self.cj(out, rng)
        return out

    def __call__(self, img: np.ndarray, rng: random.Random) -> np.ndarray:
        arr = _normalize(self.augment_u8(img, rng), self.mean, self.std)
        return self.re(arr, rng) if self.re is not None else arr


class ClsEvalTransform:
    def __init__(self, input_size: int = 224, crop_pct: Optional[float] = None,
                 interpolation: str = "bicubic",
                 mean: Sequence[float] = IMAGENET_DEFAULT_MEAN,
                 std: Sequence[float] = IMAGENET_DEFAULT_STD, twin: bool = False):
        if crop_pct is None:
            crop_pct = 224 / 256 if input_size < 384 else 1.0
        self.input_size = input_size
        self.resize_size = int(input_size / crop_pct)
        self.resample = _check_interpolation(interpolation, pil_ops.RESAMPLE)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.ops = TWIN_OPS if twin else NATIVE_OPS

    def crop_u8(self, img: np.ndarray) -> np.ndarray:
        """torchvision Resize(int) then CenterCrop, as uint8."""
        h, w = img.shape[:2]
        scale = self.resize_size / min(w, h)
        nw, nh = round(w * scale), round(h * scale)
        out = self.ops.resize(img, (nh, nw), self.resample)
        s = self.input_size
        left, top = (nw - s) // 2, (nh - s) // 2
        return out[top:top + s, left:left + s]

    def __call__(self, img: np.ndarray, rng: Optional[random.Random] = None) -> np.ndarray:
        return _normalize(self.crop_u8(img), self.mean, self.std)


class ImageRecord:
    """Adapts a classification transform to the loader's records: the
    (H, W, 3) array becomes {"image": transform(array, rng)}."""

    def __init__(self, transform):
        self.transform = transform

    def __call__(self, img: np.ndarray, rng: random.Random) -> Dict[str, np.ndarray]:
        return {"image": self.transform(img, rng)}
