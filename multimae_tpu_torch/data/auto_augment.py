"""RandAugment, the AutoAugment policies and AugMix on (H, W, 3) uint8
arrays (counterpart of multimae_tpu/data/auto_augment.py; reference
utils/auto_augment.py, timm's).

timm's config grammar (`rand-m9-mstd0.5-inc1`: magnitude 9, gaussian
magnitude noise of std 0.5, the "increasing" level maps; `n` layers,
`mmax`), the 15 ops of RAND_TRANSFORMS and RAND_INCREASING_TRANSFORMS and
the level maps of the JAX module (:123-175). The geometric ops fill with
hparams["img_mean"] (the dataset mean, (124, 116, 104) for ImageNet's) and
pick bilinear or bicubic at random. The image ops are Pillow's, rebuilt in
data/pil_ops.py (native, or the numpy twins with `twin=True`).

Every draw (the ops chosen, each op's probability test, the gaussian or
uniform magnitude, the sign of a level, the resample, an AutoAugment
sub-policy, AugMix's chain depths) comes from the random.Random the caller
passes, the record's own: the JAX module draws from the process-global
`random` (and AugMix from the global `np.random`), so its batches depend on
how records fall on worker processes. The draws are made in the JAX
module's order, so a global `random` seeded like the record's generator
reproduces them. AugMix's Dirichlet and Beta draws come from a
np.random.RandomState seeded with the record generator's next 32 bits, the
first thing it draws (a global `np.random` seeded the same way reproduces
them).

Two JAX behaviours are kept (ROADMAP.md section 3): the AutoAugment
policies build their ops without `fill`, so their geometric ops fill with
_DEFAULT_FILL (128, 128, 128), not the dataset mean that hparams carries
(JAX :306-308, :26; its `aa.fill`, :328, is never read); `originalr` and
`v0r` are the tables of `original` and `v0` (:318-319).
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


# --- AutoAugment (JAX :230-330): one sub-policy of two (op, probability,
# magnitude) stages drawn per image. 'v0' is the TF EfficientNet policy,
# 'original' the paper's ImageNet policy.

_POLICY_V0 = [
    [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
    [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
    [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
    [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]

_POLICY_ORIGINAL = [
    [("PosterizeIncreasing", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("PosterizeIncreasing", 0.6, 7), ("PosterizeIncreasing", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("PosterizeIncreasing", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("PosterizeIncreasing", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]

_POLICIES = {"original": _POLICY_ORIGINAL, "originalr": _POLICY_ORIGINAL,
             "v0": _POLICY_V0, "v0r": _POLICY_V0}


class AutoAugment:
    """One sub-policy drawn per image, its ops applied in turn, each with
    its probability at its fixed magnitude (JAX :300-308). The ops are
    built as the JAX module builds them per call: magnitude_std 0 and the
    default fill."""

    def __init__(self, policy: Sequence[Sequence[Tuple[str, float, float]]],
                 twin: bool = False):
        self.policy = [[AugmentOp(name, prob=prob, magnitude=magnitude)
                        for name, prob, magnitude in sub] for sub in policy]
        self.image_ops = TWIN_OPS if twin else NATIVE_OPS

    def __call__(self, img: np.ndarray, rng: random.Random) -> np.ndarray:
        for op in rng.choice(self.policy):
            img = op(img, rng, self.image_ops)
        return img


def auto_augment_transform(config_str: str, hparams: Optional[Dict] = None,
                           twin: bool = False) -> AutoAugment:
    """'original[-mstd0.5]' / 'v0' / 'originalr' / 'v0r' (timm's grammar,
    JAX :311-330): the options after the name are parsed by nothing, and
    hparams (the fill) is not read, as in the JAX module."""
    policy_name = config_str.split("-")[0]
    if policy_name not in _POLICIES:
        raise ValueError(f"Unknown AutoAugment policy {policy_name}")
    return AutoAugment(_POLICIES[policy_name], twin=twin)


# --- AugMix (Hendrycks et al.; JAX :333-398) --------------------------------------------

AUGMIX_TRANSFORMS = [
    "AutoContrast", "ColorIncreasing", "ContrastIncreasing",
    "BrightnessIncreasing", "SharpnessIncreasing", "Equalize", "Rotate",
    "PosterizeIncreasing", "SolarizeIncreasing", "ShearX", "ShearY",
    "TranslateXRel", "TranslateYRel",
]


class AugMixAugment:
    """`width` chains of `depth` ops (1-3 drawn per chain where depth <= 0),
    Dirichlet-mixed, then Beta-blended with the original image, in float32
    as the JAX module computes it (:356-368): the mix accumulates
    w * chain, the blend is m * img + (1 - m) * mix, clipped to [0, 255]
    and truncated to uint8."""

    def __init__(self, ops: Sequence[AugmentOp], alpha: float = 1.0, width: int = 3,
                 depth: int = -1, twin: bool = False):
        self.ops = list(ops)
        self.alpha = alpha
        self.width = width
        self.depth = depth
        self.image_ops = TWIN_OPS if twin else NATIVE_OPS

    def __call__(self, img: np.ndarray, rng: random.Random) -> np.ndarray:
        draws = np.random.RandomState(rng.getrandbits(32))
        ws = draws.dirichlet([self.alpha] * self.width).astype(np.float32)
        m = float(draws.beta(self.alpha, self.alpha))
        mixed = np.zeros(img.shape, np.float32)
        for w in ws:
            depth = self.depth if self.depth > 0 else rng.randint(1, 3)
            img_aug = img
            for op in rng.choices(self.ops, k=depth):
                img_aug = op(img_aug, rng, self.image_ops)
            mixed += w * np.asarray(img_aug, np.float32)
        blended = m * np.asarray(img, np.float32) + (1.0 - m) * mixed
        return np.clip(blended, 0, 255).astype(np.uint8)


def augmix_transform(config_str: str, hparams: Optional[Dict] = None,
                     twin: bool = False) -> AugMixAugment:
    """Parse 'augmix-m3-w3[-d1][-a1][-mstd*]' configs (timm's grammar, JAX
    :371-398): magnitude 3, width 3, depth -1, alpha 1 and a uniform
    magnitude (mstd inf) unless given; the ops fill with hparams' img_mean."""
    hparams = dict(hparams or {})
    magnitude, width, depth, alpha, mstd = 3.0, 3, -1, 1.0, float("inf")
    for c in config_str.split("-")[1:]:
        cs = re.split(r"(\d.*)", c)
        if len(cs) < 2:
            continue
        key, val = cs[:2]
        if key == "mstd":
            mstd = float(val)
        elif key == "m":
            magnitude = float(val)
        elif key == "w":
            width = int(val)
        elif key == "d":
            depth = int(val)
        elif key == "a":
            alpha = float(val)
    fill = tuple(hparams.get("img_mean", _DEFAULT_FILL))
    ops = [AugmentOp(n, prob=1.0, magnitude=magnitude, magnitude_std=mstd, fill=fill)
           for n in AUGMIX_TRANSFORMS]
    return AugMixAugment(ops, alpha=alpha, width=width, depth=depth, twin=twin)


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
                        twin: bool = False):
    """'rand-*' -> RandAugment, 'augmix-*' -> AugMix, otherwise an
    AutoAugment policy (timm's create_transform grammar, JAX :401-409)."""
    if config_str.startswith("rand"):
        return rand_augment_transform(config_str, hparams, twin)
    if config_str.startswith("augmix"):
        return augmix_transform(config_str, hparams, twin)
    return auto_augment_transform(config_str, hparams, twin)
