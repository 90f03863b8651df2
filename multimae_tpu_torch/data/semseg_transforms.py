"""Semantic segmentation fine-tune augmentations without cv2 (counterpart
of multimae_tpu/data/semseg_transforms.py; reference
utils/datasets_semseg.py:33-172).

The JAX package builds these on cv2. Its arithmetic is rebuilt in the
port's native library (native/fastimage.cpp: `resize_linear`,
`resize_nearest`, `rgb_to_gray`, `rgb_to_hsv`, `hsv_to_rgb` here are its
functions) and, bit-equal to it, in numpy (the functions named *_twin),
so that the same `random.Random` gives the same arrays:

* `resize_linear` is cv2.resize with INTER_LINEAR. For uint8 it is
  OpenCV's fixed-point path: 11-bit coefficients rounded from float32
  source positions, a horizontal pass in integers, and the vectorised
  vertical pass that shifts each row sum right by 4, keeps the high 16
  bits of its product with the coefficient and rounds the sum of the two
  by 2 bits. Columns clamp their taps to the border, rows clamp only
  their indices. float32 images take the float path (coefficients from
  double positions), within about 2e-7 of cv2 relative to the largest
  value.
* `resize_nearest` is INTER_NEAREST: source index floor(dst * (1 /
  (dst_len / src_len))), clamped; any dtype.
* `rgb_to_gray`, `rgb_to_hsv` and `hsv_to_rgb` are COLOR_RGB2GRAY,
  COLOR_RGB2HSV and COLOR_HSV2RGB on uint8: gray in 15-bit fixed point;
  H in [0, 180) and S from OpenCV's 12-bit division tables; the inverse
  in float32 with fused multiply-adds in the two hue-dependent terms,
  truncated to uint8 where OpenCV's vector loop runs (whole groups of
  HSV2RGB_LANES pixels from the start of each row) and rounded in the
  rest of the row, its scalar tail.
Each was checked bit for bit against cv2 over every uint8 colour and
over resizes of random sizes, up and down. The twins serve tests and
chip_smoke.py's A/B (`SimpleTransform(twin=True)`); no CLI selects them.

`SimpleTransform` (hflip, LongestMaxSize, colour jitter on rgb, the
large-scale jitter RandomScale(0.1, 2.0), pad bottom and right with 128 /
254, random crop, ImageNet normalisation), `standardize_depth_map` and
`DataAugmentationForSemSeg` (labels with the void class and
reduce_zero_label, the pseudo_semseg 0.25x nearest downsample,
mask_valid) follow the JAX package line for line, draws included.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np

from multimae_tpu_torch import native
from multimae_tpu_torch.utils.data_constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    PAD_MASK_VALUE,
    SEG_IGNORE_INDEX,
)

AUG_TYPES = {
    "rgb": "image",
    "depth": "mask",
    "semseg": "mask",
    "pseudo_semseg": "mask",
    "mask_valid": "mask",
}

_COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _linear_taps(src_len: int, dst_len: int, clamp: bool, exact_float: bool):
    """(i0, i1, w0, w1) of OpenCV's linear resize along one axis: the two
    source indices and float32 weights of each output position. `clamp`
    (the columns) moves a tap that falls off either border onto the edge
    with weight 1; otherwise only the indices are clamped (the rows).
    `exact_float` computes the positions in double (the float32 path)."""
    pos = (np.arange(dst_len) + 0.5) * (1.0 / (dst_len / src_len)) - 0.5
    if exact_float:
        start = np.floor(pos)
        frac = (pos - start).astype(np.float32)
    else:
        pos = pos.astype(np.float32)
        start = np.floor(pos)
        frac = (pos - start).astype(np.float32)
    start = start.astype(np.int64)
    if clamp:
        low, high = start < 0, start >= src_len - 1
        frac[low | high] = 0.0
        start[low] = 0
        start[high] = src_len - 1
    i0 = np.clip(start, 0, src_len - 1)
    i1 = np.clip(start + 1, 0, src_len - 1)
    return i0, i1, np.float32(1.0) - frac, frac


def resize_linear_twin(arr: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(arr, size_wh, interpolation=INTER_LINEAR) for uint8 and
    float32 (H, W) or (H, W, C) arrays."""
    if arr.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_linear takes uint8 or float32, not {arr.dtype}")
    dw, dh = size_wh
    h, w = arr.shape[:2]
    src = arr if arr.ndim == 3 else arr[..., None]
    exact = arr.dtype == np.float32
    x0, x1, a0, a1 = _linear_taps(w, dw, clamp=True, exact_float=exact)
    y0, y1, b0, b1 = _linear_taps(h, dh, clamp=False, exact_float=exact)
    if exact:
        hor = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
        out = hor[y0] * b0[:, None, None] + hor[y1] * b1[:, None, None]
    else:
        one = np.float32(1 << _COEF_BITS)
        ia0, ia1 = np.rint(a0 * one).astype(np.int32), np.rint(a1 * one).astype(np.int32)
        ib0, ib1 = np.rint(b0 * one).astype(np.int32), np.rint(b1 * one).astype(np.int32)
        s = src.astype(np.int32)
        hor = s[:, x0] * ia0[None, :, None] + s[:, x1] * ia1[None, :, None]
        top, bottom = hor[y0] >> 4, hor[y1] >> 4
        out = (((top * ib0[:, None, None]) >> 16) + ((bottom * ib1[:, None, None]) >> 16)
               + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8)
    if arr.ndim == 2 or arr.shape[2] == 1:  # cv2 drops a single channel
        return out[..., 0]
    return out


def resize_nearest_twin(arr: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(arr, size_wh, interpolation=INTER_NEAREST), any dtype."""
    dw, dh = size_wh
    h, w = arr.shape[:2]
    xs = np.minimum(np.floor(np.arange(dw) * (1.0 / (dw / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (1.0 / (dh / h))).astype(np.int64), h - 1)
    out = arr[ys][:, xs]
    if out.ndim == 3 and out.shape[2] == 1:
        return out[..., 0]
    return out


def rgb_to_gray_twin(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, COLOR_RGB2GRAY) on uint8 (..., 3)."""
    x = rgb.astype(np.int32)
    y = x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + (1 << 14)
    return (y >> 15).astype(np.uint8)


_HSV_SHIFT = 12
with np.errstate(divide="ignore"):
    _DIV = np.arange(256, dtype=np.float64)
    _SDIV = np.where(_DIV > 0, np.rint((255 << _HSV_SHIFT) / _DIV), 0).astype(np.int32)
    _HDIV = np.where(_DIV > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * _DIV)), 0).astype(np.int32)
del _DIV


def rgb_to_hsv_twin(rgb: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(rgb, COLOR_RGB2HSV) on uint8 (..., 3): H in [0, 180)."""
    x = rgb.astype(np.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


# Pixels per step of OpenCV's vectorised HSV2RGB_b loop (AVX2 dispatch)
HSV2RGB_LANES = 32

# (b, g, r) picks from (v, p, q, t) per hue sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb_twin(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) on uint8 (H, W, 3) with H in [0, 180)."""
    f32, one = np.float32, np.float32(1.0)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.where(h >= 6, h - 6, h)
    sector = np.floor(h).astype(np.int64)
    h = (h - sector).astype(f32)
    # 1 - s*h and 1 - s*(1 - h) as fused multiply-adds: one rounding each
    q = (1.0 - s.astype(np.float64) * h).astype(f32)
    t = (1.0 - s.astype(np.float64) * (one - h)).astype(f32)
    tab = np.stack([v, v * (one - s), v * q, v * t], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr)
    rgb = bgr[..., ::-1] * f32(255.0)
    vector = hsv.shape[-2] // HSV2RGB_LANES * HSV2RGB_LANES
    rgb[..., :vector, :] = np.trunc(rgb[..., :vector, :])
    rgb[..., vector:, :] = np.rint(rgb[..., vector:, :])
    return np.clip(rgb, 0, 255).astype(np.uint8)


class ImageOps(NamedTuple):
    """The cv2 operations the transforms call."""
    resize_linear: Callable
    resize_nearest: Callable
    rgb_to_gray: Callable
    rgb_to_hsv: Callable
    hsv_to_rgb: Callable


NATIVE_OPS = ImageOps(native.resize_linear, native.resize_nearest, native.rgb_to_gray,
                      native.rgb_to_hsv, native.hsv_to_rgb)
TWIN_OPS = ImageOps(resize_linear_twin, resize_nearest_twin, rgb_to_gray_twin,
                    rgb_to_hsv_twin, hsv_to_rgb_twin)
resize_linear, resize_nearest = native.resize_linear, native.resize_nearest
rgb_to_gray, rgb_to_hsv, hsv_to_rgb = native.rgb_to_gray, native.rgb_to_hsv, native.hsv_to_rgb


def _resize(arr: np.ndarray, size_wh: Tuple[int, int], is_mask: bool,
            ops: ImageOps) -> np.ndarray:
    return ops.resize_nearest(arr, size_wh) if is_mask else ops.resize_linear(arr, size_wh)


def _color_jitter(img: np.ndarray, rng: random.Random,
                  brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1,
                  image_ops: ImageOps = NATIVE_OPS) -> np.ndarray:
    """torchvision-style jitter on a uint8 RGB array (random order). The
    ops are closures over one `f`, as in the JAX package: the brightness,
    contrast and saturation ops all blend with the last factor drawn
    (saturation's), which the port keeps so that the draws give the same
    arrays."""
    img = img.astype(np.float32)

    def blend(a, b, f):
        return np.clip(a * f + b * (1 - f), 0, 255)

    gray, to_hsv, to_rgb = image_ops.rgb_to_gray, image_ops.rgb_to_hsv, image_ops.hsv_to_rgb
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: blend(x, 0.0, f))
    if contrast > 0:
        f = rng.uniform(max(0, 1 - contrast), 1 + contrast)
        ops.append(lambda x: blend(x, gray(x.astype(np.uint8)).mean(), f))
    if saturation > 0:
        f = rng.uniform(max(0, 1 - saturation), 1 + saturation)
        ops.append(lambda x: blend(
            x, gray(x.astype(np.uint8))[..., None].astype(np.float32), f))
    if hue > 0:
        shift = rng.uniform(-hue, hue)

        def hue_op(x):
            hsv = to_hsv(x.astype(np.uint8)).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(shift * 180)) % 180
            return to_rgb(hsv.astype(np.uint8)).astype(np.float32)

        ops.append(hue_op)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img.astype(np.uint8)


class SimpleTransform:
    """Reference simple_transform (:33-81)."""

    def __init__(self, train: bool, input_size: int = 512,
                 pad_value: int = 128, pad_mask_value: int = PAD_MASK_VALUE,
                 color_jitter_p: float = 0.5, hflip_p: float = 0.5, twin: bool = False):
        self.train = train
        self.ops = TWIN_OPS if twin else NATIVE_OPS  # the twins for comparisons; no CLI
        self.input_size = input_size
        self.pad_value = pad_value
        self.pad_mask_value = pad_mask_value
        self.color_jitter_p = color_jitter_p
        self.hflip_p = hflip_p
        self.mean = np.asarray(IMAGENET_DEFAULT_MEAN, np.float32) * 255
        self.std = np.asarray(IMAGENET_DEFAULT_STD, np.float32) * 255

    def __call__(self, arrays: Dict[str, np.ndarray],
                 rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        rng = rng or random
        s = self.input_size
        out = dict(arrays)

        def is_mask(task):
            return AUG_TYPES.get(task, "image") == "mask"

        if self.train and rng.random() < self.hflip_p:
            out = {k: np.ascontiguousarray(v[:, ::-1]) for k, v in out.items()}

        # LongestMaxSize
        h, w = next(iter(out.values())).shape[:2]
        scale = s / max(h, w)
        if scale != 1.0:
            size_wh = (round(w * scale), round(h * scale))
            out = {k: _resize(v, size_wh, is_mask(k), self.ops) for k, v in out.items()}

        if self.train:
            if rng.random() < self.color_jitter_p and "rgb" in out:
                out["rgb"] = _color_jitter(out["rgb"], rng, image_ops=self.ops)
            # LSJ RandomScale(0.1, 2.0)
            factor = 1.0 + rng.uniform(0.1 - 1.0, 2.0 - 1.0)
            h, w = next(iter(out.values())).shape[:2]
            size_wh = (max(1, round(w * factor)), max(1, round(h * factor)))
            out = {k: _resize(v, size_wh, is_mask(k), self.ops) for k, v in out.items()}

        # PadIfNeeded (top-left anchored: pad bottom/right)
        h, w = next(iter(out.values())).shape[:2]
        pad_h, pad_w = max(0, s - h), max(0, s - w)
        if pad_h or pad_w:
            def pad(v, task):
                value = self.pad_mask_value if is_mask(task) else self.pad_value
                pads = ((0, pad_h), (0, pad_w)) + ((0, 0),) * (v.ndim - 2)
                return np.pad(v, pads, constant_values=value)
            out = {k: pad(v, k) for k, v in out.items()}

        if self.train:
            h, w = next(iter(out.values())).shape[:2]
            top = rng.randint(0, h - s) if h > s else 0
            left = rng.randint(0, w - s) if w > s else 0
            out = {k: v[top:top + s, left:left + s] for k, v in out.items()}

        if "rgb" in out:
            rgb = out["rgb"].astype(np.float32)
            out["rgb"] = (rgb - self.mean) / self.std
        return out


def standardize_depth_map(img: np.ndarray, trunc_value: float = 0.1) -> np.ndarray:
    """Reference :98-118: PAD values -> NaN, truncated standardisation."""
    img = img.astype(np.float32).copy()
    img[img == PAD_MASK_VALUE] = np.nan
    flat = np.sort(img.reshape(-1))
    flat = flat[~np.isnan(flat)]
    trunc = flat[int(trunc_value * len(flat)): int((1 - trunc_value) * len(flat))]
    mean = trunc.mean() if len(trunc) else 0.0
    var = trunc.var() if len(trunc) else 1.0
    img = np.nan_to_num(img, nan=mean)
    return (img - mean) / np.sqrt(var + 1e-6)


class DataAugmentationForSemSeg:
    """Reference :84-172: the geometric transform, then each task's array:
    depth standardised (zero outside mask_valid), rgb float32, semseg
    labels adapted, pseudo_semseg at a quarter of the size, mask_valid as
    a (H, W, 1) bool."""

    def __init__(self, transform: SimpleTransform, seg_num_classes: int,
                 seg_ignore_index: int = SEG_IGNORE_INDEX,
                 standardize_depth: bool = True,
                 seg_reduce_zero_label: bool = False,
                 seg_use_void_label: bool = False):
        self.transform = transform
        self.seg_num_classes = seg_num_classes
        self.seg_ignore_index = seg_ignore_index
        self.standardize_depth = standardize_depth
        self.seg_reduce_zero_label = seg_reduce_zero_label
        self.seg_use_void_label = seg_use_void_label

    def seg_adapt_labels(self, img: np.ndarray) -> np.ndarray:
        """Reference :120-136: padding becomes the void class (or the ignore
        index); reduce_zero_label makes 0 ignored and shifts the rest down."""
        img = img.astype(np.int64)
        if self.seg_use_void_label:
            pad_replace = (self.seg_num_classes + 1 if self.seg_reduce_zero_label
                           else self.seg_num_classes)
        else:
            pad_replace = self.seg_ignore_index
        img[img == PAD_MASK_VALUE] = pad_replace
        if self.seg_reduce_zero_label:
            img[img == 0] = self.seg_ignore_index
            img = img - 1
            img[img == self.seg_ignore_index - 1] = self.seg_ignore_index
        return img

    def __call__(self, task_dict: Dict[str, object],
                 rng: Optional[random.Random] = None) -> Dict[str, np.ndarray]:
        arrays = {k: np.array(v) for k, v in task_dict.items()}
        arrays = self.transform(arrays, rng=rng)

        out = {}
        for task, v in arrays.items():
            if task == "depth":
                img = v.astype(np.float32)
                if self.standardize_depth:
                    img = standardize_depth_map(img)
                if "mask_valid" in arrays:
                    mask_valid = np.squeeze(arrays["mask_valid"] == 255)
                    img[~mask_valid] = 0.0
                out[task] = img[..., None]  # (H, W, 1)
            elif task == "rgb":
                out[task] = v.astype(np.float32)
            elif task == "semseg":
                out[task] = self.seg_adapt_labels(v).astype(np.int32)
            elif task == "pseudo_semseg":
                h, w = v.shape[:2]
                out[task] = self.transform.ops.resize_nearest(v, (w // 4, h // 4)).astype(
                    np.int32)
            elif task == "mask_valid":
                out[task] = (v == 255)[..., None]
            else:
                out[task] = v
        return out
