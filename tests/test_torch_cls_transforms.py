"""The classification transforms without PIL, against PIL and the JAX
package.

Every Pillow operation the port rebuilds (data/pil_ops.py, native/pil_ops.cpp)
is bit-equal to Pillow on the same uint8 array, in its native form and
its numpy twin:

* `Image.resize` BICUBIC and BILINEAR, from crops smaller, larger and
  equal to the output in one axis (PIL then skips that axis's pass), and
  the eval transform's shorter-side resize with its centre crop; NEAREST
  and LANCZOS up and down at odd sizes;
* `Image.transform(AFFINE)` and `Image.rotate` with both resamples and the
  dataset-mean fill, shear and translate at RandAugment's levels;
* ImageEnhance Color, Contrast, Brightness and Sharpness, and the LUT ops
  of ImageOps;
* each of RandAugment's ops (plain and "increasing" level maps) at
  magnitudes 0, 5, 9 and 10 with both signs, level and image equal to the
  JAX op's.

The whole `ClsTrainTransform` equals the JAX one with the JAX global
`random` seeded as the port's record generator, bit-equal after the
normalisation (and so before it); `RandomErasing` equals the JAX one for
the same generator. The AutoAugment policies (original, originalr, v0,
v0r) and AugMix equal the JAX ones, native and twin, with the JAX global
`random` seeded as the record generator and, for AugMix, the global
`np.random` seeded with that generator's next 32 bits at the call (the
port seeds its numpy draws so); so do the train transform under them and
the train and eval transforms with nearest and lanczos. An unknown policy
raises ValueError as in the JAX module.
"""

import random
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageOps

from multimae_tpu.data import auto_augment as jaa
from multimae_tpu.data import cls_transforms as jtf
from multimae_tpu_torch import native
from multimae_tpu_torch.data import auto_augment as taa
from multimae_tpu_torch.data import cls_transforms as ttf
from multimae_tpu_torch.data import pil_ops
from multimae_tpu_torch.data.image_io import load_image

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jpeg" / "photo_420_q90.jpg"
FILL = (124, 116, 104)  # round(255 * IMAGENET_DEFAULT_MEAN)
OPS = {"native": pil_ops.NATIVE_OPS, "twin": pil_ops.TWIN_OPS}
RESAMPLE = {Image.NEAREST: "nearest", Image.BILINEAR: "bilinear", Image.BICUBIC: "bicubic",
            Image.LANCZOS: "lanczos"}


def noise(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def smooth(h, w, seed=0):
    """A gradient with grain: the values photographs have, not uniform noise."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 127 // max(h + w - 2, 1)], -1)
    grain = np.random.default_rng(seed).integers(-20, 21, (h, w, 3))
    return np.clip(base + grain, 0, 255).astype(np.uint8)


IMAGES = {"noise": noise(64, 80), "smooth": smooth(60, 50), "tiny": smooth(2, 5)}


@pytest.fixture(scope="module")
def photo():
    return load_image(str(FIXTURE))  # (375, 500, 3), the JPEG decode PIL gives


def pil(img):
    return Image.fromarray(img)


@pytest.mark.parametrize("impl", sorted(OPS))
@pytest.mark.parametrize("bicubic", [True, False])
def test_resize_matches_pil(impl, bicubic, photo):
    rs = Image.BICUBIC if bicubic else Image.BILINEAR
    crops = [photo[10:310, 40:264],    # width equal to 224: the vertical pass only
             photo[100:324, 7:307],    # height equal: the horizontal pass only
             photo[5:185, 20:170],     # smaller in both axes
             photo, photo[:224, :224]]  # larger; both equal (a copy)
    for crop in crops + [IMAGES["noise"], IMAGES["tiny"]]:
        ref = np.asarray(pil(crop).resize((224, 224), rs))
        np.testing.assert_array_equal(OPS[impl].resize(crop, (224, 224), RESAMPLE[rs]), ref)
    odd = IMAGES["smooth"]
    for size in [(37, 91), (13, 7), (60, 7), (1, 50)]:
        ref = np.asarray(pil(odd).resize(size[::-1], rs))
        np.testing.assert_array_equal(OPS[impl].resize(odd, size, RESAMPLE[rs]), ref)


@pytest.mark.parametrize("impl", sorted(OPS))
@pytest.mark.parametrize("rs", [Image.NEAREST, Image.LANCZOS], ids=["nearest", "lanczos"])
def test_nearest_and_lanczos_resize_match_pil(impl, rs, photo):
    """Up and down, odd sizes, one axis kept, from a photo, noise and a
    2 x 5 image."""
    for img in (photo[3:120, 5:187], IMAGES["noise"], IMAGES["smooth"], IMAGES["tiny"]):
        for size in [(224, 224), (37, 91), (13, 7), (img.shape[0], 33), (61, img.shape[1]),
                     (1, 50), (img.shape[0] * 3 + 1, img.shape[1] * 2 - 1)]:
            ref = np.asarray(pil(img).resize(size[::-1], rs))
            got = OPS[impl].resize(img, size, RESAMPLE[rs])
            np.testing.assert_array_equal(got, ref, err_msg=f"{img.shape} -> {size}")


@pytest.mark.parametrize("impl", sorted(OPS))
@pytest.mark.parametrize("crop_pct", [None, 0.95])
def test_eval_transform_matches_jax(impl, crop_pct, photo):
    for img in (photo, photo[:300, 50:250], IMAGES["noise"]):
        ref = jtf.ClsEvalTransform(input_size=64, crop_pct=crop_pct)(pil(img))
        got = ttf.ClsEvalTransform(input_size=64, crop_pct=crop_pct, twin=impl == "twin")(img)
        np.testing.assert_array_equal(got, ref)


def shear_translate(img, level):
    h, w = img.shape[:2]
    return [(1, level, 0, 0, 1, 0), (1, 0, 0, level, 1, 0),
            (1, 0, level * w, 0, 1, 0), (1, 0, 0, 0, 1, level * h)]


@pytest.mark.parametrize("impl", sorted(OPS))
@pytest.mark.parametrize("bicubic", [True, False])
def test_affine_and_rotate_match_pil(impl, bicubic):
    rs = Image.BICUBIC if bicubic else Image.BILINEAR
    for img in (IMAGES["noise"], IMAGES["smooth"]):
        h, w = img.shape[:2]
        for level in (0.0, 0.13, -0.3, 0.27, 0.45, -0.45):
            for m in shear_translate(img, level):
                ref = np.asarray(pil(img).transform((w, h), Image.AFFINE, m, resample=rs,
                                                    fillcolor=FILL))
                np.testing.assert_array_equal(OPS[impl].affine(img, m, bicubic, FILL), ref)
        for deg in (0, 3.7, -13.5, 27.0, 30, -30, 90, 180, 270):
            ref = np.asarray(pil(img).rotate(deg, resample=rs, fillcolor=FILL))
            got = pil_ops.rotate(img, deg, bicubic, FILL, OPS[impl])
            np.testing.assert_array_equal(got, ref)


ENHANCE = {"color": (ImageEnhance.Color, pil_ops.color),
           "contrast": (ImageEnhance.Contrast, pil_ops.contrast),
           "brightness": (ImageEnhance.Brightness, pil_ops.brightness),
           "sharpness": (ImageEnhance.Sharpness, pil_ops.sharpness)}


@pytest.mark.parametrize("impl", sorted(OPS))
@pytest.mark.parametrize("name", sorted(ENHANCE))
def test_enhance_matches_pil(impl, name):
    cls, fn = ENHANCE[name]
    for img in IMAGES.values():
        for factor in (0.0, 0.1, 0.37, 0.5, 1.0, 1.3, 1.9, 2.5):
            ref = np.asarray(cls(pil(img)).enhance(factor))
            np.testing.assert_array_equal(fn(img, factor, OPS[impl]), ref)


def test_gray_smooth_and_blend_parts_match_pil():
    img = IMAGES["noise"]
    from PIL import ImageFilter

    for impl in OPS.values():
        np.testing.assert_array_equal(impl.gray(img), np.asarray(pil(img).convert("L")))
        np.testing.assert_array_equal(impl.smooth(img),
                                      np.asarray(pil(img).filter(ImageFilter.SMOOTH)))
        other = noise(64, 80, seed=1)
        for alpha in (-0.5, 0.0, 0.3, 1.0, 1.7):
            np.testing.assert_array_equal(impl.blend(img, other, alpha),
                                          np.asarray(Image.blend(pil(img), pil(other), alpha)))


def test_lut_ops_match_pil():
    flat = np.zeros((8, 9, 3), np.uint8)
    flat[..., 1] = 77  # a constant channel
    few = np.random.default_rng(2).choice([3, 90, 91, 200], (20, 30, 3)).astype(np.uint8)
    for img in list(IMAGES.values()) + [flat, few]:
        p = pil(img)
        np.testing.assert_array_equal(pil_ops.autocontrast(img), np.asarray(ImageOps.autocontrast(p)))
        np.testing.assert_array_equal(pil_ops.equalize(img), np.asarray(ImageOps.equalize(p)))
        np.testing.assert_array_equal(pil_ops.invert(img), np.asarray(ImageOps.invert(p)))
        for bits in (1, 2, 4, 7, 8):
            np.testing.assert_array_equal(pil_ops.posterize(img, bits),
                                          np.asarray(ImageOps.posterize(p, bits)))
        for t in (0, 26, 128, 255, 256):
            np.testing.assert_array_equal(pil_ops.solarize(img, t),
                                          np.asarray(ImageOps.solarize(p, t)))
        for add in (0, 55, 110):
            np.testing.assert_array_equal(pil_ops.solarize_add(img, add),
                                          np.asarray(jaa.solarize_add(p, add)))


class _Fixed:
    """A generator stub whose random() returns `value`: 0.9 negates a level
    (_negate tests random() > 0.5), 0.1 keeps it."""

    def __init__(self, value):
        self.value = value

    def random(self):
        return self.value


@pytest.mark.parametrize("impl", sorted(OPS))
@pytest.mark.parametrize("name", sorted(taa._OPS))
def test_rand_augment_op_matches_jax(impl, name, monkeypatch):
    fn, level_fn, geometric = taa._OPS[name]
    jfn, jlevel_fn, jgeometric = jaa._OPS[name]
    assert geometric == jgeometric and (level_fn is None) == (jlevel_fn is None)
    img = smooth(48, 40, seed=3)
    for m in (0, 5, 9, 10):
        for draw in (0.9, 0.1):
            monkeypatch.setattr(jaa.random, "random", lambda: draw)
            level = None if level_fn is None else level_fn(float(m), _Fixed(draw))
            assert level == (None if jlevel_fn is None else jlevel_fn(float(m))), (m, draw)
            for bicubic in ((False, True) if geometric else (False,)):
                if geometric:
                    rs = Image.BICUBIC if bicubic else Image.BILINEAR
                    ref = jfn(pil(img), level, fill=FILL, resample=rs)
                else:
                    ref = jfn(pil(img), level)
                got = taa._FNS[fn](img, level, FILL, bicubic, OPS[impl])
                np.testing.assert_array_equal(got, np.asarray(ref), err_msg=f"{name} m{m}")


TRAIN_CASES = [(interp, aa, reprob)
               for interp in ("bicubic", "bilinear", "random")
               for aa in ("rand-m9-mstd0.5-inc1", "rand-m9-mstd0.5", "rand-n3-m10", None)
               for reprob in (0.0, 0.5)]


@pytest.mark.parametrize("interp,aa,reprob", TRAIN_CASES)
def test_train_transform_matches_jax(interp, aa, reprob):
    """The port draws everything from the record's generator; the JAX
    transform given the global `random` as its generator draws the same
    numbers in the same order."""
    img = smooth(96, 128, seed=4)
    jt = jtf.ClsTrainTransform(input_size=64, auto_augment=aa, interpolation=interp,
                               re_prob=reprob)
    for twin in (False, True):
        pt = ttf.ClsTrainTransform(input_size=64, auto_augment=aa, interpolation=interp,
                                   re_prob=reprob, twin=twin)
        for seed in range(6):
            random.seed(seed)
            ref = jt(pil(img), rng=random)
            got = pt(img, random.Random(seed))
            assert got.dtype == np.float32 and got.shape == (64, 64, 3)
            np.testing.assert_array_equal(got, ref, err_msg=f"seed {seed} twin {twin}")


def test_train_transform_on_a_photo_matches_jax(photo):
    """The recipe's transform at 224 px on a fixture photo."""
    jt = jtf.ClsTrainTransform(input_size=224, re_prob=0.25)
    pt = ttf.ClsTrainTransform(input_size=224, re_prob=0.25)
    for seed in range(4):
        random.seed(seed)
        ref = jt(pil(photo), rng=random)
        np.testing.assert_array_equal(pt(photo, random.Random(seed)), ref)


@pytest.mark.parametrize("mode,count", [("pixel", 1), ("pixel", 3), ("const", 1)])
def test_random_erasing_equals_jax(mode, count):
    arr = np.random.default_rng(0).standard_normal((40, 30, 3)).astype(np.float32)
    for seed in range(10):
        ref = jtf.RandomErasing(0.7, mode=mode, count=count)(arr, random.Random(seed))
        got = ttf.RandomErasing(0.7, mode=mode, count=count)(arr, random.Random(seed))
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("config", ["originalx", "v1-mstd0.5", "auto"])
def test_unported_policies_raise(config):
    """A policy neither package has raises ValueError naming it."""
    name = config.split("-")[0]
    for module in (taa, jaa):
        with pytest.raises(ValueError, match=f"Unknown AutoAugment policy {name}"):
            module.create_aa_transform(config)


class _SeededNumpy:
    """The JAX AugMix with the global np.random seeded from the global
    `random`'s next 32 bits, as the port seeds its numpy draws from the
    record generator's."""

    def __init__(self, aa):
        self.aa = aa

    def __call__(self, img):
        np.random.seed(random.getrandbits(32))
        return self.aa(img)


def jax_policy(config):
    aa = jaa.create_aa_transform(config, {"img_mean": FILL})
    return _SeededNumpy(aa) if config.startswith("augmix") else aa


POLICIES = ["original", "originalr", "v0", "v0r-mstd0.5", "augmix-m3-w3-mstd0.5",
            "augmix-m5-w4-d2", "augmix-m9-w2-d1-a0.5-mstd1"]


@pytest.mark.parametrize("impl", sorted(OPS))
@pytest.mark.parametrize("config", POLICIES)
def test_policies_match_jax(impl, config):
    img = smooth(40, 48, seed=6)
    jt = jax_policy(config)
    pt = taa.create_aa_transform(config, {"img_mean": FILL}, twin=impl == "twin")
    for seed in range(12):
        random.seed(seed)
        ref = np.asarray(jt(pil(img)))
        got = pt(img, random.Random(seed))
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, ref, err_msg=f"{config} seed {seed}")


POLICY_TRAIN_CASES = [("lanczos", "original"), ("nearest", "v0"), ("lanczos", "augmix-m3-w3-mstd0.5"),
                      ("nearest", "augmix-m5-w4-d2"), ("random", "v0r"), ("lanczos", None)]


@pytest.mark.parametrize("interp,aa", POLICY_TRAIN_CASES)
def test_train_transform_with_policies_and_filters_matches_jax(interp, aa):
    img = smooth(96, 128, seed=7)
    jt = jtf.ClsTrainTransform(input_size=64, auto_augment=aa, interpolation=interp,
                               re_prob=0.25)
    if aa and aa.startswith("augmix"):
        jt.aa = _SeededNumpy(jt.aa)
    for twin in (False, True):
        pt = ttf.ClsTrainTransform(input_size=64, auto_augment=aa, interpolation=interp,
                                   re_prob=0.25, twin=twin)
        for seed in range(4):
            random.seed(seed)
            ref = jt(pil(img), rng=random)
            np.testing.assert_array_equal(pt(img, random.Random(seed)), ref,
                                          err_msg=f"seed {seed} twin {twin}")


@pytest.mark.parametrize("impl", sorted(OPS))
@pytest.mark.parametrize("interp", ["nearest", "lanczos"])
def test_eval_transform_with_filters_matches_jax(impl, interp, photo):
    for img in (photo, photo[:300, 50:250], IMAGES["noise"]):
        ref = jtf.ClsEvalTransform(input_size=64, interpolation=interp)(pil(img))
        got = ttf.ClsEvalTransform(input_size=64, interpolation=interp, twin=impl == "twin")(img)
        np.testing.assert_array_equal(got, ref)


def test_native_ops_refuse_bad_arrays():
    with pytest.raises(ValueError, match="uint8"):
        native.pil_resize(np.zeros((4, 4, 3), np.float32), (2, 2))
    with pytest.raises(ValueError, match="shapes"):
        native.pil_blend(np.zeros((4, 4, 3), np.uint8), np.zeros((4, 5, 3), np.uint8), 0.5)


@pytest.mark.parametrize("twin", [False, True])
def test_transforms_pickle_for_the_loader_workers(twin):
    """The loader's workers are spawned: the transforms travel by pickle and
    give the same arrays on the other side."""
    import pickle

    from multimae_tpu_torch.data.cls_transforms import ImageRecord

    record = ImageRecord(ttf.ClsTrainTransform(input_size=64, re_prob=0.25, twin=twin))
    again = pickle.loads(pickle.dumps(record))
    img = smooth(96, 128, seed=5)
    np.testing.assert_array_equal(again(img, random.Random(3))["image"],
                                  record(img, random.Random(3))["image"])
