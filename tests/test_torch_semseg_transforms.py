"""The port's cv2-free semantic segmentation augmentations
(multimae_tpu_torch/data/semseg_transforms.py) against cv2 and against
the JAX package's transforms, which are built on cv2.

* resize_linear on uint8 is bit-equal to cv2.resize(INTER_LINEAR) over a
  scan of sizes: the 640x480 -> 512x384 LongestMaxSize, the large-scale
  jitter's factors from 0.1 to 2.0, odd and one-pixel sizes, up and down,
  one and three channels; on float32 within 1e-5 of the largest |value|
  (measured about 2e-7).
* resize_nearest is bit-equal to INTER_NEAREST on uint8, uint16 and
  int32 over the same scan.
* rgb_to_gray and rgb_to_hsv are bit-equal to cv2 on every uint8
  colour; hsv_to_rgb on every H < 180, S and V, and at row widths whose
  tails leave OpenCV's vector loop.
* The colour jitter and the whole DataAugmentationForSemSeg, train and
  eval, with the void label and reduce_zero_label, mask_valid and a
  pseudo_semseg map, are bit-equal to the JAX transform given the same
  random.Random: masks, depth and labels, and rgb (within the 1e-5 the
  float rgb is allowed, measured 0).
"""

import random

import cv2
import numpy as np
import pytest

from multimae_tpu.data import semseg_transforms as J
from multimae_tpu_torch.data import semseg_transforms as P


def scan():
    """(h, w, dh, dw) cases."""
    cases = [(480, 640, 384, 512), (384, 512, 768, 1024), (1, 7, 3, 2), (5, 1, 2, 9),
             (2, 2, 1, 1), (3, 3, 200, 7), (37, 53, 71, 29), (97, 131, 128, 173)]
    for f in (0.1, 0.137, 0.5, 0.999, 1.37, 1.999, 2.0):  # the LSJ range at 512x384
        cases.append((384, 512, max(1, round(384 * f)), max(1, round(512 * f))))
    rng = np.random.default_rng(0)
    cases += [tuple(int(v) for v in rng.integers(1, 300, 4)) for _ in range(9)]
    return cases


CASES = scan()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_resize_linear_uint8_is_cv2(case):
    h, w, dh, dw = case
    rng = np.random.default_rng(h * 1000 + w)
    for shape in ((h, w, 3), (h, w)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
        got = P.resize_linear(img, (dw, dh))
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", CASES[::3], ids=lambda c: "x".join(map(str, c)))
def test_resize_linear_float32_within_1e5(case):
    h, w, dh, dw = case
    img = (np.random.default_rng(w).random((h, w, 3)) * 255).astype(np.float32)
    ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR)
    got = P.resize_linear(img, (dw, dh))
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32])
def test_resize_nearest_is_cv2(dtype):
    rng = np.random.default_rng(1)
    for h, w, dh, dw in CASES:
        for shape in ((h, w), (h, w, 3)):
            img = rng.integers(0, 256 if dtype == np.uint8 else 65536, shape).astype(dtype)
            ref = cv2.resize(img, (dw, dh), interpolation=cv2.INTER_NEAREST)
            np.testing.assert_array_equal(P.resize_nearest(img, (dw, dh)), ref)


def every_colour():
    return np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                                indexing="ij"), -1).reshape(4096, 4096, 3).astype(np.uint8)


def test_rgb_to_gray_and_hsv_on_every_colour():
    rgb = every_colour()
    np.testing.assert_array_equal(P.rgb_to_gray(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
    np.testing.assert_array_equal(P.rgb_to_hsv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


def test_hsv_to_rgb_on_every_hsv():
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"),
                   -1).reshape(180 * 64, 1024, 3).astype(np.uint8)
    np.testing.assert_array_equal(P.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("width", [1, 17, 31, 32, 33, 85, 100, 129])
def test_hsv_to_rgb_row_tails(width):
    rng = np.random.default_rng(width)
    hsv = np.stack([rng.integers(0, 180, (64, width)), rng.integers(0, 256, (64, width)),
                    rng.integers(0, 256, (64, width))], -1).astype(np.uint8)
    np.testing.assert_array_equal(P.hsv_to_rgb(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("shape", [(96, 128, 3), (128, 85, 3)])
def test_color_jitter_matches_jax(shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    for seed in range(24):
        np.testing.assert_array_equal(P._color_jitter(img, random.Random(seed)),
                                      J._color_jitter(img, random.Random(seed)))


def sample(h, w, seed, pseudo=False):
    """A raw NYU-like sample: uint8 RGB, uint16 depth, labels 0-39 with a
    patch of 255, a 0/255 mask_valid (and a COCO pseudo_semseg map)."""
    rng = np.random.default_rng(seed)
    sem = rng.integers(0, 40, (h, w)).astype(np.uint8)
    sem[: h // 5, : w // 5] = 255
    out = {"rgb": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
           "depth": rng.integers(0, 65536, (h, w), dtype=np.uint16),
           "semseg": sem,
           "mask_valid": (rng.random((h, w)) < 0.9).astype(np.uint8) * 255}
    if pseudo:
        out["pseudo_semseg"] = rng.integers(0, 140, (h, w)).astype(np.uint8)
    return out


LABELS = {"plain": (False, False), "void": (True, False), "reduce_zero": (False, True),
          "void_reduce_zero": (True, True)}


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("labels", sorted(LABELS))
def test_augmentation_matches_jax(train, labels):
    void, reduce_zero = LABELS[labels]
    kw = dict(seg_num_classes=40, seg_use_void_label=void, seg_reduce_zero_label=reduce_zero)
    jt = J.DataAugmentationForSemSeg(J.SimpleTransform(train, 128), **kw)
    pt = P.DataAugmentationForSemSeg(P.SimpleTransform(train, 128), **kw)
    for i, hw in enumerate([(480, 640), (97, 131), (300, 200), (60, 80)] * 3):
        s = sample(*hw, seed=i, pseudo=i % 2 == 1)
        ref, got = jt(s, random.Random(i)), pt(s, random.Random(i))
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            if k == "rgb":
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_augmentation_without_depth_standardisation_matches_jax():
    kw = dict(seg_num_classes=40, standardize_depth=False)
    jt = J.DataAugmentationForSemSeg(J.SimpleTransform(True, 96), **kw)
    pt = P.DataAugmentationForSemSeg(P.SimpleTransform(True, 96), **kw)
    for i in range(4):
        s = sample(72, 90, seed=50 + i)
        ref, got = jt(s, random.Random(i)), pt(s, random.Random(i))
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
