"""The port's masked-reconstruction forward against the JAX package.

The tiny MultiMAE (dim 64, 2 blocks, 4 heads; 64 px input, so 16 tokens
per modality) is built and initialised by multimae_tpu, exported to a
state_dict, loaded strictly into multimae_tpu_torch, and both run the
same numpy batch with the same fixed masks (24 of 48 tokens visible).
The JAX decoders run the fused_decoder Pallas kernel in interpret mode;
the port's run its plain twin (CPU tensors).

Tolerances: fp32 preds within 5e-4 absolute, losses within 1e-4
relative. The remaining differences are the GELU (JAX's bf16 paths and
the Pallas kernel use the tanh-basis polynomial, within 3e-6 of erf),
LayerNorm variance (fast E[x^2]-E[x]^2 in the kernel, two-pass here) and
summation order. In bf16 (fp32 semseg decoder) the same differences
flip bf16 roundings, which then propagate: preds within 2e-2 relative
RMS, losses within 2e-3 relative.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.cli import factory as jfactory
from multimae_tpu.models.criterion import (
    MaskedCrossEntropyLoss as JCE,
    MaskedL1Loss as JL1,
    MaskedMSELoss as JMSE,
)
from multimae_tpu.ops import fused_decoder_pallas as fdp
from multimae_tpu_torch.cli import factory as tfactory
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJ_SHAPES = {"rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)}
TINY = dict(model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
            decoder_num_heads=4, decoder_depth=2)
K = 24
B = 2


def fixed_masks(batch, tasks=("rgb", "depth", "semseg"), seed=3):
    """K of the 16 * len(tasks) tokens visible per sample."""
    rng = np.random.default_rng(seed)
    masks = np.ones((batch, 16 * len(tasks)), np.int32)
    for i in range(batch):
        masks[i, rng.permutation(masks.shape[1])[:K]] = 0
    return {t: masks[:, 16 * j:16 * (j + 1)] for j, t in enumerate(tasks)}


@pytest.fixture(scope="module")
def params():
    """The tiny model's fp32 parameters (the same tree for every dtype)."""
    jmodel = jfactory.build_pretrain_model(**TINY)
    jbatch = jfactory.make_synthetic_batch(B, input_size=64, seed=1)
    return jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        jbatch, num_encoded_tokens=K)["params"])()


def run_both(params, jdtype, tdtype, fp32_adapters=(),
             in_domains=("rgb", "depth", "semseg")):
    jmodel = jfactory.build_pretrain_model(dtype=jdtype, in_domains=in_domains,
                                           fp32_output_adapters=fp32_adapters,
                                           **TINY)
    jbatch = jfactory.make_synthetic_batch(B, input_size=64, in_domains=in_domains,
                                           seed=1)
    masks = fixed_masks(B, in_domains)
    fdp.set_force_mode("interpret")
    try:
        jpreds, _ = jax.jit(lambda p, x, m: jmodel.apply(
            {"params": p}, x, task_masks=m, num_encoded_tokens=K))(
                params, jbatch, {t: jnp.asarray(m) for t, m in masks.items()})
    finally:
        fdp.set_force_mode(None)

    tmodel = tfactory.build_pretrain_model(dtype=tdtype, in_domains=in_domains,
                                           fp32_output_adapters=fp32_adapters,
                                           **TINY, device="cpu")
    sd = jax_params_to_state_dict(jax.tree.map(np.array, params), PROJ_SHAPES)
    tmodel.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                           strict=True)
    tmodel.eval()
    tbatch = tfactory.make_synthetic_batch(B, input_size=64, in_domains=in_domains,
                                           seed=1, device="cpu")
    with torch.inference_mode():
        tpreds, tmasks = tmodel(tbatch, num_encoded_tokens=K,
                                task_masks={t: torch.from_numpy(m)
                                            for t, m in masks.items()})
    for t, m in masks.items():
        np.testing.assert_array_equal(tmasks[t].numpy(), m)
    return jbatch, masks, jpreds, tbatch, tpreds


def losses_both(jbatch, masks, jpreds, tbatch, tpreds):
    jl = {"rgb": JMSE(16, 1), "depth": JL1(16, 1), "semseg": JCE(16, 4),
          "norm_rgb": JMSE(16, 1, norm_pix=True)}
    tl = tfactory.build_pretrain_losses(("rgb", "depth", "semseg"))
    out = {}
    for t in jpreds:
        src = "rgb" if t == "norm_rgb" else t
        a = float(jl[t](jpreds[t].astype(jnp.float32), jbatch[src],
                        mask=jnp.asarray(masks[src])))
        b = float(tl[t](tpreds[t].float(), tbatch[src],
                        mask=torch.from_numpy(masks[src])))
        out[t] = (a, b)
    return out


@pytest.fixture(scope="module")
def fp32_run(params):
    return run_both(params, jnp.float32, torch.float32)


@pytest.mark.parametrize("task", ["rgb", "depth", "semseg", "norm_rgb"])
def test_fp32_preds_match_jax(fp32_run, task):
    _, _, jpreds, _, tpreds = fp32_run
    j = np.asarray(jpreds[task])
    t = tpreds[task].numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=0, atol=5e-4)


def test_fp32_losses_match_jax(fp32_run):
    for task, (a, b) in losses_both(*fp32_run).items():
        assert abs(a - b) <= 1e-4 * abs(a), (task, a, b)


def test_output_task_without_input_matches_jax():
    """semseg predicted from rgb + depth only: its decoder's queries are
    mask tokens plus its embeddings (no task slice to gather from)."""
    in_domains = ("rgb", "depth")
    jmodel = jfactory.build_pretrain_model(in_domains=in_domains, **TINY)
    jbatch = jfactory.make_synthetic_batch(B, input_size=64, in_domains=in_domains)
    params = jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(2), "masking": jax.random.PRNGKey(3)},
        jbatch, num_encoded_tokens=K)["params"])()
    _, _, jpreds, _, tpreds = run_both(params, jnp.float32, torch.float32,
                                       in_domains=in_domains)
    assert set(tpreds) == {"rgb", "depth", "semseg", "norm_rgb"}
    for task in jpreds:
        np.testing.assert_allclose(tpreds[task].numpy(), np.asarray(jpreds[task]),
                                   rtol=0, atol=5e-4, err_msg=task)


def test_bf16_with_fp32_semseg_matches_jax(params):
    run = run_both(params, jnp.bfloat16, torch.bfloat16, fp32_adapters=("semseg",))
    _, _, jpreds, _, tpreds = run
    assert tpreds["semseg"].dtype == torch.float32
    assert tpreds["rgb"].dtype == torch.bfloat16
    for task in jpreds:
        j = np.asarray(jpreds[task], np.float32)
        t = tpreds[task].float().numpy()
        rel = np.sqrt(np.mean((t - j) ** 2) / np.mean(j ** 2))
        assert rel <= 2e-2, (task, rel)
    for task, (a, b) in losses_both(*run).items():
        assert abs(a - b) <= 2e-3 * abs(a), (task, a, b)


@pytest.mark.slow
def test_full_width_vit_b_matches_jax():
    """MultiMAE ViT-B at 224 px (3 x 196 tokens, 98 visible, four decoders
    of dim 256, depth 2), B=1, fp32: preds within 5e-4, losses within 1e-4."""
    base = dict(model_name="pretrain_multimae_base")
    jmodel = jfactory.build_pretrain_model(**base)
    jbatch = jfactory.make_synthetic_batch(1, seed=5)
    rng = np.random.default_rng(6)
    flat = np.ones((1, 588), np.int32)
    flat[0, rng.permutation(588)[:98]] = 0
    masks = {t: flat[:, 196 * j:196 * (j + 1)] for j, t in
             enumerate(("rgb", "depth", "semseg"))}
    params = jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        jbatch, num_encoded_tokens=98)["params"])()
    fdp.set_force_mode("interpret")
    try:
        jpreds, _ = jax.jit(lambda p, x, m: jmodel.apply(
            {"params": p}, x, task_masks=m, num_encoded_tokens=98))(
                params, jbatch, {t: jnp.asarray(m) for t, m in masks.items()})
    finally:
        fdp.set_force_mode(None)
    tmodel = tfactory.build_pretrain_model(**base, device="cpu")
    sd = jax_params_to_state_dict(jax.tree.map(np.array, params), PROJ_SHAPES)
    tmodel.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    tbatch = tfactory.make_synthetic_batch(1, seed=5, device="cpu")
    with torch.inference_mode():
        tpreds, _ = tmodel.eval()(tbatch, num_encoded_tokens=98,
                                  task_masks={t: torch.from_numpy(m) for t, m in masks.items()})
    for task in jpreds:
        np.testing.assert_allclose(tpreds[task].numpy(), np.asarray(jpreds[task]),
                                   rtol=0, atol=5e-4, err_msg=task)
    for task, (a, b) in losses_both(jbatch, masks, jpreds, tbatch, tpreds).items():
        assert abs(a - b) <= 1e-4 * abs(a), (task, a, b)


def test_port_forward_imports_no_jax():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import torch\n"
        "from multimae_tpu_torch.cli.factory import build_pretrain_model, make_synthetic_batch\n"
        "m = build_pretrain_model(model_name='pretrain_multimae_tiny', input_size=64,\n"
        "                         decoder_dim=64, decoder_num_heads=4, device='cpu').eval()\n"
        "g = torch.Generator().manual_seed(0)\n"
        "with torch.inference_mode():\n"
        "    preds, masks = m(make_synthetic_batch(2, input_size=64, device='cpu'),\n"
        "                     num_encoded_tokens=24, generator=g)\n"
        "assert preds['rgb'].shape == (2, 64, 64, 3)\n"
        "import importlib, pkgutil, multimae_tpu_torch\n"
        "for mod in pkgutil.walk_packages(multimae_tpu_torch.__path__, 'multimae_tpu_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "new = {n.split('.')[0] for n in set(sys.modules) - before}\n"
        "bad = new & {'jax', 'jaxlib', 'flax', 'multimae_tpu'}\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_return_patches_are_the_pixel_preds_patchified():
    """decoder_return_patches=True gives each decoder's (B, N, C*p*p) token
    patches, the NHWC preds cut back into patches (criterion.patchify_cpp)."""
    from multimae_tpu_torch.models.criterion import patchify_cpp

    masks = {t: torch.from_numpy(m) for t, m in fixed_masks(B).items()}
    batch = tfactory.make_synthetic_batch(B, input_size=64, seed=1, device="cpu")
    preds = {}
    for patches in (False, True):
        model = tfactory.build_pretrain_model(seed=2, decoder_return_patches=patches,
                                              **TINY, device="cpu").eval()
        with torch.inference_mode():
            preds[patches], _ = model(batch, num_encoded_tokens=K, task_masks=masks)
    for task, img in preds[False].items():
        p = 4 if task == "semseg" else 16
        assert preds[True][task].shape == (B, 16, img.shape[-1] * p * p)
        torch.testing.assert_close(preds[True][task], patchify_cpp(img, p), rtol=0, atol=0)
