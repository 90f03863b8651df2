"""RandAugment on (H, W, 3) uint8 arrays (counterpart of
multimae_tpu/data/auto_augment.py; reference utils/auto_augment.py, timm's).

timm's config grammar (`rand-m9-mstd0.5-inc1`: magnitude 9, gaussian
magnitude noise of std 0.5, the "increasing" level maps; `n` layers,
`mmax`), the 15 ops of RAND_TRANSFORMS and RAND_INCREASING_TRANSFORMS and
the level maps of the JAX module (:123-175). The geometric ops fill with
hparams["img_mean"] (the dataset mean, (124, 116, 104) for ImageNet's) and
pick bilinear or bicubic at random. The image ops are Pillow's, rebuilt in
data/pil_ops.py (native, or the numpy twins with `twin=True`).

Every draw (the ops chosen, each op's probability test, the gaussian
magnitude, the sign of a level, the resample) comes from the
random.Random the caller passes, the record's own: the JAX module draws
from the process-global `random`, so its batches depend on how records
fall on worker processes. The draws are made in the JAX module's order,
so a global `random` seeded like the record's generator reproduces them.

The AutoAugment policies (`original`, `v0`, ...) and AugMix (`augmix-*`)
are not ported: no recipe uses them; they raise naming ROADMAP.md queue 1
item 14.
"""

from __future__ import annotations

import random
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimae_tpu_torch.data import pil_ops
from multimae_tpu_torch.data.pil_ops import NATIVE_OPS, TWIN_OPS, PilOps

_LEVEL_DENOM = 10.0
_DEFAULT_FILL = (128, 128, 128)


def _negate(v: float, rng: random.Random) -> float:
    return -v if rng.random() > 0.5 else v


# --- ops: (img, level, fill, bicubic, image ops) -> img ------------------------------
# Module-level functions: RandAugment travels to the loader's spawned workers
# by pickle.


def _auto_contrast(img, *_):
    return pil_ops.autocontrast(img)


def _equalize(img, *_):
    return pil_ops.equalize(img)


def _invert(img, *_):
    return pil_ops.invert(img)


def _rotate(img, degrees, fill, bicubic, ops):
    return pil_ops.rotate(img, degrees, bicubic, fill, ops)


def _posterize(img, bits, *_):
    bits = int(bits)
    return img.copy() if bits >= 8 else pil_ops.posterize(img, max(bits, 1))


def _solarize(img, thresh, *_):
    return pil_ops.solarize(img, int(thresh))


def _solarize_add(img, add, *_):
    return pil_ops.solarize_add(img, int(add))


def _color(img, factor, fill, bicubic, ops):
    return pil_ops.color(img, factor, ops)


def _contrast(img, factor, fill, bicubic, ops):
    return pil_ops.contrast(img, factor, ops)


def _brightness(img, factor, fill, bicubic, ops):
    return pil_ops.brightness(img, factor, ops)


def _sharpness(img, factor, fill, bicubic, ops):
    return pil_ops.sharpness(img, factor, ops)


def _shear_x(img, factor, fill, bicubic, ops):
    return ops.affine(img, (1, factor, 0, 0, 1, 0), bicubic, fill)


def _shear_y(img, factor, fill, bicubic, ops):
    return ops.affine(img, (1, 0, 0, factor, 1, 0), bicubic, fill)


def _translate_x_rel(img, pct, fill, bicubic, ops):
    return ops.affine(img, (1, 0, pct * img.shape[1], 0, 1, 0), bicubic, fill)


def _translate_y_rel(img, pct, fill, bicubic, ops):
    return ops.affine(img, (1, 0, 0, 0, 1, pct * img.shape[0]), bicubic, fill)


_FNS = {
    "AutoContrast": _auto_contrast, "Equalize": _equalize, "Invert": _invert,
    "Rotate": _rotate, "Posterize": _posterize, "Solarize": _solarize,
    "SolarizeAdd": _solarize_add, "Color": _color, "Contrast": _contrast,
    "Brightness": _brightness, "Sharpness": _sharpness, "ShearX": _shear_x,
    "ShearY": _shear_y, "TranslateXRel": _translate_x_rel, "TranslateYRel": _translate_y_rel,
}


# --- level maps (JAX :123-141): (magnitude, rng) -> level -----------------------------


def _enhance_level(m, rng):
    return 1.8 * m / _LEVEL_DENOM + 0.1


def _enhance_increasing_level(m, rng):
    return 1.0 + _negate(0.9 * m / _LEVEL_DENOM, rng)


def _shear_level(m, rng):
    return _negate(0.3 * m / _LEVEL_DENOM, rng)


def _translate_rel_level(m, rng):
    return _negate(0.45 * m / _LEVEL_DENOM, rng)


def _rotate_level(m, rng):
    return _negate(30.0 * m / _LEVEL_DENOM, rng)


def _posterize_increasing_level(m, rng):
    return 4 - int(4.0 * m / _LEVEL_DENOM)


def _solarize_level(m, rng):
    return 256 - int(256 * m / _LEVEL_DENOM)


def _solarize_add_level(m, rng):
    return int(110 * m / _LEVEL_DENOM)


# name: (function, level map or None, geometric)
_OPS: Dict[str, Tuple[str, Optional[Callable], bool]] = {
    "AutoContrast": ("AutoContrast", None, False),
    "Equalize": ("Equalize", None, False),
    "Invert": ("Invert", None, False),
    "Rotate": ("Rotate", _rotate_level, True),
    "Posterize": ("Posterize", _posterize_increasing_level, False),
    "PosterizeIncreasing": ("Posterize", _posterize_increasing_level, False),
    "Solarize": ("Solarize", _solarize_level, False),
    "SolarizeIncreasing": ("Solarize", _solarize_level, False),
    "SolarizeAdd": ("SolarizeAdd", _solarize_add_level, False),
    "Color": ("Color", _enhance_level, False),
    "ColorIncreasing": ("Color", _enhance_increasing_level, False),
    "Contrast": ("Contrast", _enhance_level, False),
    "ContrastIncreasing": ("Contrast", _enhance_increasing_level, False),
    "Brightness": ("Brightness", _enhance_level, False),
    "BrightnessIncreasing": ("Brightness", _enhance_increasing_level, False),
    "Sharpness": ("Sharpness", _enhance_level, False),
    "SharpnessIncreasing": ("Sharpness", _enhance_increasing_level, False),
    "ShearX": ("ShearX", _shear_level, True),
    "ShearY": ("ShearY", _shear_level, True),
    "TranslateXRel": ("TranslateXRel", _translate_rel_level, True),
    "TranslateYRel": ("TranslateYRel", _translate_rel_level, True),
}

RAND_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
    "ShearY", "TranslateXRel", "TranslateYRel",
]

RAND_INCREASING_TRANSFORMS = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]


class AugmentOp:
    """One op with its probability and magnitude (JAX :184-217)."""

    def __init__(self, name: str, prob: float = 0.5, magnitude: float = 10,
                 magnitude_std: float = 0.0, magnitude_max: Optional[float] = None,
                 fill: Sequence[int] = _DEFAULT_FILL):
        fn, level_fn, geometric = _OPS[name]
        self.name = name
        self.fn = _FNS[fn]
        self.level_fn = level_fn
        self.geometric = geometric
        self.prob = prob
        self.magnitude = magnitude
        self.magnitude_std = magnitude_std
        self.magnitude_max = magnitude_max
        self.fill = tuple(int(v) for v in fill)

    def magnitude_level(self, rng: random.Random) -> Optional[float]:
        """Draw the magnitude and map it to the op's level (None: no level)."""
        m = self.magnitude
        if self.magnitude_std > 0:
            if self.magnitude_std == float("inf"):
                m = rng.uniform(0, m)
            else:
                m = rng.gauss(m, self.magnitude_std)
        upper = self.magnitude_max or _LEVEL_DENOM
        m = max(0.0, min(m, upper))
        return None if self.level_fn is None else self.level_fn(m, rng)

    def __call__(self, img: np.ndarray, rng: random.Random,
                 ops: PilOps = NATIVE_OPS) -> np.ndarray:
        if self.prob < 1.0 and rng.random() > self.prob:
            return img
        level = self.magnitude_level(rng)
        bicubic = bool(rng.choice((False, True))) if self.geometric else False
        return self.fn(img, level, self.fill, bicubic, ops)


class RandAugment:
    """`num_layers` ops drawn with replacement, each applied with its
    probability (JAX :220-227)."""

    def __init__(self, ops: Sequence[AugmentOp], num_layers: int = 2, twin: bool = False):
        self.ops = list(ops)
        self.num_layers = num_layers
        self.image_ops = TWIN_OPS if twin else NATIVE_OPS  # the twins for comparisons

    def __call__(self, img: np.ndarray, rng: random.Random) -> np.ndarray:
        for op in rng.choices(self.ops, k=self.num_layers):
            img = op(img, rng, self.image_ops)
        return img


def rand_augment_transform(config_str: str, hparams: Optional[Dict] = None,
                           twin: bool = False) -> RandAugment:
    """Parse 'rand-m9-mstd0.5-inc1'-style configs (timm grammar, JAX :419-446)."""
    hparams = dict(hparams or {})
    magnitude = _LEVEL_DENOM
    num_layers = 2
    increasing = False
    magnitude_std = 0.0
    magnitude_max = None
    config = config_str.split("-")
    if config[0] != "rand":
        raise ValueError(f"unsupported aa config {config_str}")
    for c in config[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            magnitude_std = float(val)
            if magnitude_std > 100:
                magnitude_std = float("inf")
        elif key == "mmax":
            magnitude_max = float(val)
        elif key == "inc":
            increasing = bool(int(val))
        elif key == "m":
            magnitude = float(val)
        elif key == "n":
            num_layers = int(val)
        elif key == "w":
            pass  # choice weights: no recipe sets them
        else:
            raise ValueError(f"Unknown RandAugment option {c}")
    names: List[str] = RAND_INCREASING_TRANSFORMS if increasing else RAND_TRANSFORMS
    fill = tuple(hparams.get("img_mean", _DEFAULT_FILL))
    ops = [AugmentOp(n, prob=0.5, magnitude=magnitude, magnitude_std=magnitude_std,
                     magnitude_max=magnitude_max, fill=fill) for n in names]
    return RandAugment(ops, num_layers=num_layers, twin=twin)


def create_aa_transform(config_str: str, hparams: Optional[Dict] = None,
                        twin: bool = False) -> RandAugment:
    """'rand-*' -> RandAugment. AugMix and the AutoAugment policies raise."""
    if config_str.startswith("rand"):
        return rand_augment_transform(config_str, hparams, twin)
    kind = "AugMix" if config_str.startswith("augmix") else "AutoAugment"
    raise NotImplementedError(f"--aa {config_str}: {kind} is not ported yet (ROADMAP.md queue "
                              "1 item 14); the recipes use rand-m9-mstd0.5-inc1")
