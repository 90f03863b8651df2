"""The port's inpainting demo (multimae_tpu_torch/cli/demo.py) against the
JAX package's demo.py.

* Reading the images: bit-equal to the JAX demo's PIL path (demo.py:61-76)
  for an RGB PNG and JPEG, a 16-bit ("I;16") and an 8-bit ("L") depth PNG,
  a palette ("P") and an 8-bit ("L") semseg PNG; an RGB semseg PNG raises.
  Pillow's 16-bit bicubic resize, as the native library and its numpy twin
  compute it, is bit-equal to Pillow's at sizes that shrink and that grow,
  0 and 65535 beside each other included (where Pillow clamps).
* The forward: the tiny pretraining model (dim 64, 2 blocks, decoders of
  256) at 64 px, loaded from a .pth that the JAX exporter
  (params_to_state_dict) wrote, with the masks --visible_rgb fixes: every
  pred within 5e-4 of the JAX model's apply on the JAX demo's inputs, the
  depth standardised as JAX method="sort"; the same PNG files as the JAX
  demo writes, the masks bit-equal to its PIL NEAREST resize.
* The same weights as a JAX `.msgpack` ({"params": {"model", "balancer"},
  "step", "epoch"}, written by flax): the preds equal the .pth run's bit
  for bit, so within 5e-4 of the JAX model's.
* A random-masking run keeps --num_encoded_tokens visible; a checkpoint
  that is neither a .pth nor a .msgpack (an orbax directory) raises
  ValueError with the JAX demo's reason (it open()s the file).
"""

import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from multimae_tpu.cli.factory import build_pretrain_model as jax_build_pretrain_model
from multimae_tpu.ops.masking import make_mask as jax_make_mask
from multimae_tpu.train.pretrain_step import standardize_depth as jax_standardize_depth
from multimae_tpu.utils.torch_compat import params_to_state_dict, state_dict_to_params
from multimae_tpu_torch import native
from multimae_tpu_torch.cli import demo
from multimae_tpu_torch.cli.factory import build_pretrain_model
from multimae_tpu_torch.data.image_io import load_image
from multimae_tpu_torch.data.pretrain_transforms import resize_u16_twin
from multimae_tpu_torch.train.pretrain_step import standardize_depth

MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
STD = np.asarray((0.229, 0.224, 0.225), np.float32)
S = 64
PROJ_SHAPES = {"rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)}
VISIBLE = "0,0 1,0 3,2 2,3"


# The JAX demo's reads (demo.py:61-76), line for line.
def pil_rgb(path, s):
    rgb = Image.open(path).convert("RGB").resize((s, s), Image.BICUBIC)
    rgb = np.asarray(rgb, np.float32) / 255.0
    return (rgb - MEAN) / STD


def pil_depth(path, s):
    return np.asarray(Image.open(path).resize((s, s)), np.float32)


def pil_semseg(path, s):
    semseg = Image.open(path).convert("P").resize((s // 4, s // 4), Image.NEAREST)
    return np.asarray(semseg, np.int32)


def smooth(rng, h, w, lo, hi):
    """A photo-like field with sharp edges, in [lo, hi]."""
    y, x = np.mgrid[0:h, 0:w]
    f = np.sin(x / 7.0 + rng.uniform(0, 6)) * np.cos(y / 5.0) + 0.3 * rng.standard_normal((h, w))
    f = (f - f.min()) / (f.max() - f.min())
    return lo + f * (hi - lo)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    root = tmp_path_factory.mktemp("demo_images")
    rng = np.random.default_rng(0)
    h, w = 75, 90
    rgb = np.stack([smooth(rng, h, w, 0, 255) for _ in range(3)], -1).astype(np.uint8)
    depth16 = smooth(rng, h, w, 0, 65535).astype(np.uint16)
    depth16[10:14] = 0
    depth16[14:18] = 65535  # overshoot next to 0: Pillow clamps
    depth8 = smooth(rng, h, w, 0, 255).astype(np.uint8)
    classes = (smooth(rng, h, w, 0, 39.99)).astype(np.uint8)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8).reshape(-1).tolist()
    paths = {"rgb_png": root / "rgb.png", "rgb_jpg": root / "rgb.jpg",
             "depth16": root / "depth16.png", "depth8": root / "depth8.png",
             "semseg_p": root / "semseg_p.png", "semseg_l": root / "semseg_l.png",
             "semseg_rgb": root / "semseg_rgb.png"}
    Image.fromarray(rgb, "RGB").save(paths["rgb_png"])
    Image.fromarray(rgb, "RGB").save(paths["rgb_jpg"], quality=90)
    Image.fromarray(depth16).save(paths["depth16"])
    Image.fromarray(depth8, "L").save(paths["depth8"])
    p = Image.fromarray(classes, "P")
    p.putpalette(palette)
    p.save(paths["semseg_p"])
    Image.fromarray(classes, "L").save(paths["semseg_l"])
    Image.fromarray(np.repeat(classes[..., None], 3, -1), "RGB").save(paths["semseg_rgb"])
    assert Image.open(paths["depth16"]).mode == "I;16"
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("kind", ["rgb_png", "rgb_jpg"])
@pytest.mark.parametrize("s", [64, 224])
def test_rgb_read_is_bit_equal_to_the_jax_demo(images, kind, s):
    np.testing.assert_array_equal(demo.read_rgb(images[kind], s), pil_rgb(images[kind], s))


@pytest.mark.parametrize("kind", ["depth16", "depth8"])
@pytest.mark.parametrize("s", [64, 224])
def test_depth_read_is_bit_equal_to_the_jax_demo(images, kind, s):
    np.testing.assert_array_equal(demo.read_depth(images[kind], s), pil_depth(images[kind], s))


@pytest.mark.parametrize("kind", ["semseg_p", "semseg_l"])
@pytest.mark.parametrize("s", [64, 224])
def test_semseg_read_is_bit_equal_to_the_jax_demo(images, kind, s):
    np.testing.assert_array_equal(demo.read_semseg(images[kind], s),
                                  pil_semseg(images[kind], s))


def test_semseg_of_another_mode_raises(images):
    with pytest.raises(ValueError, match="'RGB'"):
        demo.read_semseg(images["semseg_rgb"], S)
    with pytest.raises(ValueError, match="'RGB'"):
        demo.read_depth(images["rgb_png"], S)


@pytest.mark.parametrize("size", [(32, 32), (48, 40), (160, 200)])
def test_16_bit_bicubic_is_bit_equal_to_pillow(images, size):
    """Shrinking and growing, native and twin (the twin takes squares)."""
    img = Image.open(images["depth16"])
    arr = load_image(images["depth16"], convert_rgb=False)
    ref = np.asarray(img.resize(size[::-1]))
    np.testing.assert_array_equal(native.crop_resize_u16(arr, (0, 0) + arr.shape, size), ref)
    if size[0] == size[1]:
        np.testing.assert_array_equal(resize_u16_twin(arr, size[0]), ref)


def test_depth_standardisation_is_jax_sort(images):
    """The port keeps the reference's sort; the JAX demo's default bisect
    differs where integer depths tie at the 10% / 90% cuts."""
    d = demo.read_depth(images["depth16"], S)[None, ..., None]
    port = standardize_depth(torch.from_numpy(d)).numpy()
    jsort = np.asarray(jax_standardize_depth(jnp.asarray(d), method="sort"))
    np.testing.assert_allclose(port, jsort, rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def jax_run(images, tmp_path_factory):
    """The tiny pretraining model's JAX params written to a .pth, and the
    JAX demo's preds with the --visible_rgb masks."""
    domains = ["rgb", "depth", "semseg"]
    model = jax_build_pretrain_model(model_name="pretrain_multimae_tiny", in_domains=domains,
                                     out_domains=domains, extra_norm_pix_loss=False,
                                     input_size=S)
    inputs = {"rgb": jnp.asarray(pil_rgb(images["rgb_png"], S)[None]),
              "depth": jax_standardize_depth(
                  jnp.asarray(pil_depth(images["depth16"], S)[None, ..., None]), method="sort"),
              "semseg": jnp.asarray(pil_semseg(images["semseg_p"], S)[None])}
    # The port's initial weights, imported by the JAX package into a template
    # eval_shape traces (a jitted init would compile for seconds).
    abstract = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)}, inputs,
        num_encoded_tokens=8)["params"])
    port = build_pretrain_model(model_name="pretrain_multimae_tiny", in_domains=domains,
                                out_domains=domains, extra_norm_pix_loss=False, input_size=S,
                                seed=7, device="cpu")
    params, _ = state_dict_to_params(
        {k: v.numpy() for k, v in port.state_dict().items()},
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), abstract), strict=True,
        verbose=False)
    params = jax.tree.map(np.array, params)
    sd = params_to_state_dict(params, proj_shapes=PROJ_SHAPES)
    pth = str(tmp_path_factory.mktemp("demo_ckpt") / "tiny.pth")
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
               pth)
    with open(pth[:-len(".pth")] + ".msgpack", "wb") as f:
        f.write(flax.serialization.msgpack_serialize({
            "params": {"model": params, "balancer": {"log_vars": np.zeros(3, np.float32)}},
            "step": 7, "epoch": 0}))
    n = S // 16
    coords = [tuple(map(int, c.split(","))) for c in VISIBLE.split()]
    masks = jax_make_mask(n, n, {d: (coords if d == "rgb" else []) for d in domains})
    visible = int(sum((np.asarray(m) == 0).sum() for m in masks.values()))
    preds, out_masks = jax.jit(lambda p, x: model.apply(
        {"params": p}, x, mask_inputs=True, task_masks=masks, num_encoded_tokens=visible,
        rngs={"masking": jax.random.PRNGKey(0)}))(params, inputs)
    return pth, {t: np.asarray(p) for t, p in preds.items()}, {
        t: np.asarray(m) for t, m in out_masks.items()}


def demo_argv(images, pth, out, *extra):
    return ["--checkpoint", pth, "--rgb", images["rgb_png"], "--depth", images["depth16"],
            "--semseg", images["semseg_p"], "--input_size", str(S), "--device", "cpu",
            "--out_dir", str(out), *extra]


@pytest.fixture
def tiny(monkeypatch):
    """The demo builds the tiny pretraining model (its own is MultiMAE-B, as
    the JAX demo's)."""
    build = demo.build_pretrain_model
    monkeypatch.setattr(demo, "build_pretrain_model", lambda **kw: build(
        model_name="pretrain_multimae_tiny", **kw))


def test_demo_preds_match_the_jax_model(images, jax_run, tiny, tmp_path):
    pth, jpreds, jmasks = jax_run
    out = demo.main(demo_argv(images, pth, tmp_path, "--visible_rgb", VISIBLE))
    assert set(out["preds"]) == set(jpreds) == {"rgb", "depth", "semseg"}
    for task, pred in out["preds"].items():
        np.testing.assert_allclose(pred.numpy(), jpreds[task], rtol=0, atol=5e-4, err_msg=task)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(f"{k}_{t}.png" for k in ("pred", "mask") for t in jpreds)
    for task, m in jmasks.items():
        n = int(np.sqrt(m[0].size))
        ref = Image.fromarray((m[0].reshape(n, n) * 255).astype(np.uint8), "L").resize(
            (S, S), Image.NEAREST)
        np.testing.assert_array_equal(
            load_image(str(tmp_path / f"mask_{task}.png"), convert_rgb=False), np.asarray(ref))
    shapes = {"rgb": (S, S, 3), "depth": (S, S), "semseg": (S // 4, S // 4)}
    for task, shape in shapes.items():
        img = load_image(str(tmp_path / f"pred_{task}.png"), convert_rgb=False)
        assert img.shape == shape and img.dtype == np.uint8


def test_random_masking_keeps_the_encoded_tokens(images, jax_run, tiny, tmp_path):
    out = demo.main(demo_argv(images, jax_run[0], tmp_path, "--num_encoded_tokens", "20",
                              "--seed", "3"))
    assert sum(int((m == 0).sum()) for m in out["masks"].values()) == 20
    assert all(torch.isfinite(p).all() for p in out["preds"].values())


def test_msgpack_checkpoint_gives_the_pth_preds(images, jax_run, tiny, tmp_path):
    pth, jpreds, _ = jax_run
    ref = demo.main(demo_argv(images, pth, tmp_path / "pth", "--visible_rgb", VISIBLE))
    out = demo.main(demo_argv(images, pth[:-len(".pth")] + ".msgpack", tmp_path / "msgpack",
                              "--visible_rgb", VISIBLE))
    for task, pred in out["preds"].items():
        assert torch.equal(pred, ref["preds"][task]), task
        np.testing.assert_allclose(pred.numpy(), jpreds[task], rtol=0, atol=5e-4, err_msg=task)


def test_non_pth_checkpoint_raises_naming_the_exporter(images, tiny, tmp_path):
    with pytest.raises(ValueError, match=r"open\(\) as one flax msgpack file"):
        demo.main(demo_argv(images, str(tmp_path / "checkpoint-0.orbax"), tmp_path))


def test_demo_defaults_to_the_card(monkeypatch, images, tmp_path):
    assert demo.get_args(["--checkpoint", "x.pth", "--rgb", "x.png"]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = demo_argv(images, "x.pth", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        demo.main(argv[:argv.index("--device")] + argv[argv.index("--device") + 2:])
