"""PIL's 8-bit image operations on (H, W, 3) uint8 arrays, without PIL:
the numpy twins of native/pil_ops.cpp, bit-equal to Pillow's C code
(libImaging) and to the native functions.

  * `resize_twin`: `Image.resize` with BICUBIC (a = -0.5), BILINEAR or
    LANCZOS (support 3) (Resample.c, 8 bits per channel): the weights of
    each output pixel computed in double, normalised to fixed point with 22
    fraction bits; the horizontal pass first, stored as uint8, then the
    vertical pass; a pass whose axis keeps its size is skipped. NEAREST is
    Pillow's own path (Geometry.c ImagingScaleAffine): each output pixel
    copies the source pixel under its centre, the centres summed step by
    step.
  * `affine_twin`: `Image.transform(AFFINE)` with BILINEAR or BICUBIC and a
    fill colour (Geometry.c `ImagingGenericTransform`): the output pixel
    centre (x + 0.5, y + 0.5) mapped through the matrix in double; a source
    point outside [0, w) x [0, h) keeps the fill; bilinear truncates to
    uint8, bicubic (Geometry.c's a = -1 kernel) clamps and truncates.
    `rotate_matrix` is `Image.rotate`'s matrix; `rotate` also takes its
    copy and transpose fast paths.
  * ImageEnhance: `gray_twin` (`convert("L")`, (19595 R + 38470 G + 7471 B
    + 0x8000) >> 16), `smooth_twin` (`filter(ImageFilter.SMOOTH)`: 3 x 3
    weights 1,1,1 / 1,5,1 / 1,1,1 over 13 in float32, the border copied)
    and `blend_twin` (`Image.blend` in float32, truncated, clipped when the
    factor leaves [0, 1]); Color, Contrast, Brightness and Sharpness blend
    their degenerate image with the original.
  * ImageOps' look-up-table ops, numpy only (a histogram at most and one
    `np.take`): `autocontrast`, `equalize`, `invert`, `posterize`,
    `solarize` and `solarize_add`.

`NATIVE_OPS` and `TWIN_OPS` hold the four functions that have a native
form; the transforms take one of the two (`twin=True` for comparisons).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import numpy as np

from multimae_tpu_torch import native
from multimae_tpu_torch.data.pretrain_transforms import _nearest_index, resample_weights

PRECISION_BITS = 22


# --- Image.resize (Resample.c, 8 bits per channel) ---------------------------------


def _fixed_point(w: np.ndarray) -> np.ndarray:
    """normalize_coeffs_8bpc: each double weight to int with 22 fraction
    bits, rounded half away from zero."""
    return np.where(w < 0, np.trunc(-0.5 + w * (1 << PRECISION_BITS)),
                    np.trunc(0.5 + w * (1 << PRECISION_BITS))).astype(np.int64)


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _resample_pass(src: np.ndarray, out_size: int, axis: int, resample: str) -> np.ndarray:
    idx, w = resample_weights(src.shape[axis], 0.0, float(src.shape[axis]), out_size,
                              pil_scale=True, resample=resample)
    k = _fixed_point(w)
    shape = [1] * src.ndim
    shape[axis] = -1
    acc = np.full(1, 1 << (PRECISION_BITS - 1), np.int64)
    for t in range(idx.shape[1]):  # PIL's order; exact in int64 either way
        acc = acc + np.take(src, idx[:, t], axis=axis).astype(np.int64) * k[:, t].reshape(shape)
    return _clip8(acc)


RESAMPLE = ("nearest", "bilinear", "bicubic", "lanczos")


def check_resample(resample: str) -> str:
    if resample not in RESAMPLE:
        raise ValueError(f"resample {resample!r}: one of {', '.join(RESAMPLE)}")
    return resample


def resize_twin(img: np.ndarray, size_hw: Sequence[int], resample: str = "bicubic"
                ) -> np.ndarray:
    """`Image.fromarray(img).resize((w, h), resample)` for (H, W) or
    (H, W, C) uint8, `resample` one of RESAMPLE."""
    dh, dw = (int(v) for v in size_hw)
    out = np.ascontiguousarray(img, np.uint8)
    if check_resample(resample) == "nearest":
        return out[_nearest_index(out.shape[0], dh)][:, _nearest_index(out.shape[1], dw)]
    if dw != out.shape[1]:
        out = _resample_pass(out, dw, 1, resample)
    if dh != out.shape[0]:
        out = _resample_pass(out, dh, 0, resample)
    return out.copy() if out is img else out


# --- Image.transform(AFFINE) (Geometry.c) -----------------------------------------


def rotate_matrix(width: int, height: int, degrees: float) -> tuple:
    """`Image.rotate`'s inverse affine matrix about the centre (no expand)."""
    angle = -math.radians(degrees % 360.0)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    cx, cy = width / 2, height / 2
    m[2] = m[0] * -cx + m[1] * -cy + m[2] + cx
    m[5] = m[3] * -cx + m[4] * -cy + m[5] + cy
    return tuple(m)


def _cubic(v1, v2, v3, v4, d):
    """Geometry.c's BICUBIC macro (a = -1)."""
    p1 = v2
    p2 = -v1 + v3
    p3 = 2 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    return p1 + d * (p2 + d * (p3 + d * p4))


def affine_twin(img: np.ndarray, matrix: Sequence[float], bicubic: bool,
                fill: Sequence[int]) -> np.ndarray:
    """`Image.fromarray(img).transform(img.size, AFFINE, matrix, resample,
    fillcolor=fill)` for (H, W, C) uint8 with BILINEAR or BICUBIC."""
    h, w, c = img.shape
    a0, a1, a2, a3, a4, a5 = (float(v) for v in matrix)
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64) + 0.5,
                         np.arange(w, dtype=np.float64) + 0.5, indexing="ij")
    xin = a0 * xx + a1 * yy + a2
    yin = a3 * xx + a4 * yy + a5
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin = np.where(inside, xin, 0.5) - 0.5
    yin = np.where(inside, yin, 0.5) - 0.5
    x0 = np.floor(xin).astype(np.int64)
    y0 = np.floor(yin).astype(np.int64)
    dx = (xin - x0)[..., None]
    dy = (yin - y0)[..., None]
    src = img.astype(np.int64)

    def px(y, x):  # the row y (valid) at the clamped column x
        return src[y, np.clip(x, 0, w - 1)]

    if bicubic:
        x0, y0 = x0 - 1, y0 - 1
        rows = []
        for r in range(4):
            y = y0 + r
            v = _cubic(*(px(np.clip(y, 0, h - 1), x0 + t) for t in range(4)), dx)
            if r:  # rows past the edge repeat the previous one (Geometry.c)
                valid = ((y >= 0) & (y < h))[..., None]
                v = np.where(valid, v, rows[-1])
            rows.append(v)
        v = _cubic(*rows, dy)
        out = np.where(v <= 0.0, 0, np.where(v >= 255.0, 255, np.trunc(np.clip(v, 0, 255))))
    else:
        def lerp(a, b, d):
            return a + (b - a) * d

        v1 = lerp(px(np.clip(y0, 0, h - 1), x0), px(np.clip(y0, 0, h - 1), x0 + 1), dx)
        y1 = y0 + 1
        v2 = lerp(px(np.clip(y1, 0, h - 1), x0), px(np.clip(y1, 0, h - 1), x0 + 1), dx)
        v2 = np.where(((y1 >= 0) & (y1 < h))[..., None], v2, v1)
        out = np.trunc(lerp(v1, v2, dy))
    fill = np.asarray(fill, np.uint8).reshape(1, 1, c)
    return np.where(inside[..., None], out.astype(np.uint8), fill)


# --- ImageEnhance ----------------------------------------------------------------


def gray_twin(img: np.ndarray) -> np.ndarray:
    """`convert("L")` of RGB: (H, W, 3) -> (H, W) uint8."""
    v = img.astype(np.int64)
    return ((v[..., 0] * 19595 + v[..., 1] * 38470 + v[..., 2] * 7471 + 0x8000) >> 16
            ).astype(np.uint8)


def smooth_twin(img: np.ndarray) -> np.ndarray:
    """`filter(ImageFilter.SMOOTH)` of RGB (Filter.c ImagingFilter3x3)."""
    h, w = img.shape[:2]
    if h < 3 or w < 3:
        return img.copy()
    k = np.float32(1.0) / np.float32(13.0)
    k5 = np.float32(5.0) / np.float32(13.0)
    f = img.astype(np.float32)

    def row(r, centre):  # KERNEL1x3 over rows r of the interior columns
        return f[r, :-2] * k + f[r, 1:-1] * centre + f[r, 2:] * k

    ss = np.float32(0.5) + row(slice(2, None), k)
    ss = ss + row(slice(1, -1), k5)
    ss = ss + row(slice(0, -2), k)
    out = img.copy()
    out[1:-1, 1:-1] = np.where(ss <= 0, 0, np.where(ss >= 255, 255,
                                                    np.trunc(np.clip(ss, 0, 255))))
    return out


def blend_twin(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """`Image.blend(a, b, alpha)`: a + alpha (b - a) in float32, truncated
    to uint8, clipped to [0, 255] where alpha is outside [0, 1]."""
    alpha = np.float32(alpha)
    if alpha == 0:
        return a.copy()
    if alpha == 1:
        return b.copy()
    v = a.astype(np.float32) + alpha * (b.astype(np.int32) - a.astype(np.int32)).astype(
        np.float32)
    if 0 <= alpha <= 1:
        return np.trunc(v).astype(np.uint8)
    return np.where(v <= 0, 0, np.where(v >= 255, 255, np.trunc(np.clip(v, 0, 255)))).astype(
        np.uint8)


class PilOps(NamedTuple):
    """The operations with a native form."""
    resize: Callable
    affine: Callable
    gray: Callable
    smooth: Callable
    blend: Callable


NATIVE_OPS = PilOps(native.pil_resize, native.pil_affine, native.pil_gray, native.pil_smooth,
                    native.pil_blend)
TWIN_OPS = PilOps(resize_twin, affine_twin, gray_twin, smooth_twin, blend_twin)


def color(img: np.ndarray, factor: float, ops: PilOps = NATIVE_OPS) -> np.ndarray:
    """ImageEnhance.Color: blend with the L image."""
    gray = ops.gray(img)
    return ops.blend(np.repeat(gray[..., None], img.shape[2], axis=2), img, factor)


def contrast(img: np.ndarray, factor: float, ops: PilOps = NATIVE_OPS) -> np.ndarray:
    """ImageEnhance.Contrast: blend with the mean of the L image,
    int(mean + 0.5) (ImageStat over the histogram)."""
    gray = ops.gray(img)
    mean = int(float(gray.sum(dtype=np.int64)) / gray.size + 0.5)
    return ops.blend(np.full_like(img, mean), img, factor)


def brightness(img: np.ndarray, factor: float, ops: PilOps = NATIVE_OPS) -> np.ndarray:
    """ImageEnhance.Brightness: blend with black."""
    return ops.blend(np.zeros_like(img), img, factor)


def sharpness(img: np.ndarray, factor: float, ops: PilOps = NATIVE_OPS) -> np.ndarray:
    """ImageEnhance.Sharpness: blend with the SMOOTH-filtered image."""
    return ops.blend(ops.smooth(img), img, factor)


def rotate(img: np.ndarray, degrees: float, bicubic: bool, fill: Sequence[int],
           ops: PilOps = NATIVE_OPS) -> np.ndarray:
    """`Image.rotate(degrees, resample, fillcolor=fill)` about the centre."""
    angle = degrees % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    return ops.affine(img, rotate_matrix(w, h, degrees), bicubic, fill)


# --- ImageOps' look-up tables ----------------------------------------------------


def apply_lut(img: np.ndarray, lut: Sequence[int]) -> np.ndarray:
    """`Image.point` with one 256-entry table for every channel."""
    return np.take(np.asarray(lut, np.uint8), img)


def _histograms(img: np.ndarray) -> list:
    return [np.bincount(img[..., ch].ravel(), minlength=256) for ch in range(img.shape[2])]


def _per_channel(img: np.ndarray, luts: list) -> np.ndarray:
    return np.stack([apply_lut(img[..., ch], lut) for ch, lut in enumerate(luts)], axis=-1)


def autocontrast(img: np.ndarray) -> np.ndarray:
    """ImageOps.autocontrast(img): each channel stretched from its lowest
    to its highest value, int(ix * scale + offset)."""
    luts = []
    for h in _histograms(img):
        nz = np.flatnonzero(h)
        lo, hi = int(nz[0]), int(nz[-1])
        if hi <= lo:
            luts.append(list(range(256)))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append([min(max(int(ix * scale + offset), 0), 255) for ix in range(256)])
    return _per_channel(img, luts)


def equalize(img: np.ndarray) -> np.ndarray:
    """ImageOps.equalize(img): per channel, the integer histogram steps."""
    luts = []
    for h in _histograms(img):
        histo = [int(v) for v in h if v]
        step = (sum(histo) - histo[-1]) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(list(range(256)))
            continue
        lut, n = [], step // 2
        for i in range(256):
            lut.append(min(n // step, 255))
            n += int(h[i])
        luts.append(lut)
    return _per_channel(img, luts)


def invert(img: np.ndarray) -> np.ndarray:
    return apply_lut(img, list(range(255, -1, -1)))


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    mask = ~(2 ** (8 - bits) - 1)
    return apply_lut(img, [i & mask for i in range(256)])


def solarize(img: np.ndarray, threshold: int) -> np.ndarray:
    return apply_lut(img, [i if i < threshold else 255 - i for i in range(256)])


def solarize_add(img: np.ndarray, add: int, threshold: int = 128) -> np.ndarray:
    return apply_lut(img, [min(255, i + add) if i < threshold else i for i in range(256)])
