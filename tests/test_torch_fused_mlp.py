"""The K3b plain twins against the JAX fused_ln_mlp_res kernel, the K3a
plain twins against the JAX fused_mlp kernel (at the end of the file), and
the ConvNeXt block and head against the JAX modules.

The same numpy inputs go through JAX `fused_ln_mlp_res` (forward and its
custom VJP), run in Pallas interpret mode on the CPU
(`set_force_mode("interpret")`, as tests/test_fused_mlp.py runs it), and
through the port's twins `fused_ln_mlp_res_ref` and
`fused_ln_mlp_res_bwd_ref` (through the port's autograd Function), at
3,000 rows: the JAX kernel pads them to two 2048-row tiles, so its dW
accumulation across tiles is covered. fp32, within 1e-4 of each tensor's
largest |value|. The known gaps: the JAX kernel's GELU is a tanh-basis fit
of erf (within 3e-6) and its LayerNorm the fast variance E[x^2] - E[x]^2;
the port's are exact erf and two-pass.

ConvNeXtBlock and ConvNeXtAdapter (fp32, tiny) take the JAX modules'
parameters through the port's converter and match their outputs within
5e-4 of the largest |value|: the depthwise conv and the 1x1 conv, the
LayerNorm, the sub-pixel reshape and the bilinear resize.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.models.conv_utils import ConvNeXtBlock as JBlock
from multimae_tpu.models.output_adapters import ConvNeXtAdapter as JAdapter
from multimae_tpu.ops import fused_mlp_pallas as fmp
from multimae_tpu_torch.models.conv_utils import ConvNeXtBlock
from multimae_tpu_torch.models.output_adapters import ConvNeXtAdapter
from multimae_tpu_torch.ops import fused_mlp
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict

M, K, H = 3000, 128, 512


def weights(seed=0):
    """fp32 numpy weights in the torch layout: (ln_g, ln_b, w1 (H, K), b1,
    w2 (K, H), b2)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale, offset=0.0):
        return (rng.standard_normal(shape) * scale + offset).astype(np.float32)

    return (r(K, scale=0.1, offset=1.0), r(K, scale=0.1), r(H, K, scale=K ** -0.5),
            r(H, scale=0.02), r(K, H, scale=H ** -0.5), r(K, scale=0.02))


def jax_weights(w):
    g, b, w1, b1, w2, b2 = (jnp.asarray(a) for a in w)
    return g, b, w1.T, b1, w2.T, b2


def assert_close(out, ref, tol, what):
    out = out.detach().numpy() if torch.is_tensor(out) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=0, atol=tol * np.abs(ref).max(), err_msg=what)


@pytest.fixture(scope="module")
def jax_run():
    rng = np.random.default_rng(1)
    x, res, dy = (rng.standard_normal((M, K)).astype(np.float32) for _ in range(3))
    w = weights()
    jw = jax_weights(w)
    fmp.set_force_mode("interpret")
    try:
        out, vjp = jax.vjp(lambda *a: fmp.fused_ln_mlp_res(*a), jnp.asarray(x),
                           jnp.asarray(res), *jw)
        grads = vjp(jnp.asarray(dy))
    finally:
        fmp.set_force_mode(None)
    return (x, res, dy, w), np.asarray(out), [np.asarray(a) for a in grads]


def test_forward_twin_matches_jax_kernel(jax_run):
    (x, res, _, w), jout, _ = jax_run
    out = fused_mlp.fused_ln_mlp_res_ref(torch.from_numpy(x), torch.from_numpy(res),
                                         fused_mlp.MlpWeights(*map(torch.from_numpy, w)))
    assert_close(out, jout, 1e-4, "y")


# JAX grads are (dx, dres, dg, db, dw1 (K, H), db1, dw2 (H, K), db2).
GRADS = ["dx", "dres", "ln_g", "ln_b", "w1", "b1", "w2", "b2"]


@pytest.mark.parametrize("i", range(len(GRADS)), ids=GRADS)
def test_backward_twin_matches_jax_vjp(jax_run, i):
    (x, res, dy, w), _, jgrads = jax_run
    tx, tres = (torch.from_numpy(a).requires_grad_() for a in (x, res))
    tw = fused_mlp.MlpWeights(*(torch.from_numpy(a).requires_grad_() for a in w))
    fused_mlp.fused_ln_mlp_res(tx, tres, tw).backward(torch.from_numpy(dy))
    got = [tx.grad, tres.grad] + [t.grad for t in tw]
    ref = jgrads[i].T if GRADS[i] in ("w1", "w2") else jgrads[i]
    assert got[i].dtype == torch.float32
    assert_close(got[i], ref, 1e-4, GRADS[i])


def test_backward_twin_matches_autograd():
    """The written-out backward twin against autograd through the forward
    twin (fp32): the same gradients by two routes."""
    rng = np.random.default_rng(2)
    x, res, dy = (torch.from_numpy(rng.standard_normal((300, K)).astype(np.float32))
                  for _ in range(3))
    w = fused_mlp.MlpWeights(*(torch.from_numpy(a).requires_grad_() for a in weights(3)))
    x.requires_grad_()
    fused_mlp.fused_ln_mlp_res_ref(x, res, w).backward(dy)
    dx, dw = fused_mlp.fused_ln_mlp_res_bwd_ref(x.detach(), dy, w)
    for name, a, t in zip(["x"] + list(fused_mlp.MlpWeights._fields), [dx, *dw], [x, *w]):
        torch.testing.assert_close(a, t.grad, rtol=0, atol=2e-5 * float(t.grad.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("m,k,h,dtype,ok", [
    (65536, 384, 1536, torch.bfloat16, True), (16384, 384, 1536, torch.bfloat16, True),
    (16383, 384, 1536, torch.bfloat16, True), (4096, 384, 1536, torch.bfloat16, True),
    (4095, 384, 1536, torch.bfloat16, False), (65536, 384, 1536, torch.float32, False),
    (65536, 100, 400, torch.bfloat16, False)])
def test_supported_is_the_jax_predicate(m, k, h, dtype, ok):
    """The JAX predicate's dtype and widths; its row floor of 16384 (a TPU
    number) is the H100's MIN_ROWS = 4096 here, so the two agree outside
    rows 4096-16383."""
    assert fused_mlp.supported(m, k, h, dtype) == ok
    if k % 128 == 0 and h % 128 == 0 and not fused_mlp.MIN_ROWS <= m < fused_mlp.JAX_MIN_ROWS:
        assert fmp.supported(m, k, h, jnp.bfloat16 if dtype == torch.bfloat16
                             else jnp.float32) == ok


def load_jax(module, params):
    sd = jax_params_to_state_dict(jax.tree.map(np.asarray, params))
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return module


def test_convnext_block_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 12, 10, 32)).astype(np.float32)
    jblk = JBlock(dim=32)
    params = jblk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    ref = jblk.apply({"params": params}, jnp.asarray(x))
    blk = load_jax(ConvNeXtBlock(32), params)
    assert_close(blk(torch.from_numpy(x)), ref, 5e-4, "ConvNeXtBlock")


def test_convnext_adapter_matches_jax():
    """Tiny head: 64 px, 16 tokens of width 48, embed 256 = 16 sub-pixels
    of 16 channels, 2 blocks, 5 classes; rgb tokens first, then depth's,
    then the global token."""
    tokens = np.random.default_rng(5).standard_normal((2, 33, 48)).astype(np.float32)
    info = {"tasks": {"rgb": {"start_idx": 0, "end_idx": 16, "num_tokens": 16},
                      "depth": {"start_idx": 16, "end_idx": 32, "num_tokens": 16}},
            "image_size": (64, 64), "num_global_tokens": 1}
    kw = dict(num_classes=5, embed_dim=256, preds_per_patch=16, depth=2, patch_size=16)
    jad = JAdapter(**kw, main_tasks=("rgb",))
    params = jad.init(jax.random.PRNGKey(1), jnp.asarray(tokens), info)["params"]
    ref = jad.apply({"params": params}, jnp.asarray(tokens), info)
    ad = load_jax(ConvNeXtAdapter(**kw, dim_tokens_enc=48), params)
    out = ad(torch.from_numpy(tokens), info)
    assert tuple(out.shape) == (2, 64, 64, 5)
    assert_close(out, ref, 5e-4, "ConvNeXtAdapter")


# ---------------------------------------------------------------- K3a --
#
# The K3a twins `fused_mlp_ref` / `fused_mlp_bwd_ref` (through the port's
# autograd Function) against JAX `fused_mlp` and its custom VJP, run in
# Pallas interpret mode with a 128-row tile as tests/test_fused_mlp.py runs
# it, at 256 rows (two whole tiles) and 300 (a padded remainder). The JAX
# kernel takes w1 (K, H) and w2 (H, K); the port's torch layout is their
# transpose. fp32: within 1e-5 (forward) and 1e-4 (gradients) of each
# tensor's largest |value| (the JAX GELU is the tanh-basis fit of erf,
# within 3e-6). bf16: relative RMS 1e-2, the twins' TWIN tolerance.

MLP_K, MLP_H = 128, 256
MLP_GRADS = ["dx", "w1", "b1", "w2", "b2"]


def mlp_weights_np(seed=6):
    """fp32 numpy weights in the torch layout: (w1 (H, K), b1, w2 (K, H), b2)."""
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal(s) * 0.3).astype(np.float32)
                 for s in ((MLP_H, MLP_K), (MLP_H,), (MLP_K, MLP_H), (MLP_K,)))


@pytest.fixture(scope="module", params=[(256, "float32"), (300, "float32"),
                                        (256, "bfloat16"), (300, "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def mlp_run(request):
    m, dtype = request.param
    rng = np.random.default_rng(m)
    x, dy = (rng.standard_normal((m, MLP_K)).astype(np.float32) for _ in range(2))
    w = mlp_weights_np()
    jdt = jnp.dtype(dtype)
    jx, jdy = (jnp.asarray(a).astype(jdt) for a in (x, dy))
    w1, b1, w2, b2 = (jnp.asarray(a) for a in w)
    old_tile = fmp._ROW_TILE
    fmp.set_force_mode("interpret")
    fmp._ROW_TILE = 128
    try:
        out, vjp = jax.vjp(fmp.fused_mlp, jx, w1.T, b1, w2.T, b2)
        grads = vjp(jdy)
    finally:
        fmp.set_force_mode(None)
        fmp._ROW_TILE = old_tile
    jgrads = [np.asarray(g.astype(jnp.float32)) for g in grads]
    jgrads[1], jgrads[3] = jgrads[1].T, jgrads[3].T  # to the torch layout
    tdt = getattr(torch, dtype)
    return (dtype, torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt), w,
            np.asarray(out.astype(jnp.float32)), jgrads)


def assert_mlp_close(out, ref, dtype, tol_fp32, what):
    out = out.detach().float().numpy()
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol_fp32 * np.abs(ref).max(),
                                   err_msg=what)
    else:
        rel = float(np.sqrt(((out - ref) ** 2).mean() / (ref ** 2).mean()))
        assert rel <= 1e-2, (what, rel)


def test_fused_mlp_twin_matches_jax_kernel(mlp_run):
    dtype, x, _, w, jout, _ = mlp_run
    out = fused_mlp.fused_mlp_ref(x, fused_mlp.MlpCoreWeights(*map(torch.from_numpy, w)))
    assert out.dtype == x.dtype
    assert_mlp_close(out, jout, dtype, 1e-5, "y")


@pytest.mark.parametrize("i", range(len(MLP_GRADS)), ids=MLP_GRADS)
def test_fused_mlp_backward_matches_jax_vjp(mlp_run, i):
    dtype, x, dy, w, _, jgrads = mlp_run
    tx = x.clone().requires_grad_()
    tw = fused_mlp.MlpCoreWeights(*(torch.from_numpy(a).requires_grad_() for a in w))
    fused_mlp.fused_mlp(tx, tw).backward(dy)
    got = [tx.grad] + [t.grad for t in tw]
    assert got[i].dtype == (x.dtype if i == 0 else torch.float32)
    assert_mlp_close(got[i], jgrads[i], dtype, 1e-4, MLP_GRADS[i])


def test_fused_mlp_backward_twin_matches_autograd():
    """The written-out K3a backward twin against autograd through the
    forward twin (fp32): the same gradients by two routes."""
    rng = np.random.default_rng(7)
    x, dy = (torch.from_numpy(rng.standard_normal((300, MLP_K)).astype(np.float32))
             for _ in range(2))
    w = fused_mlp.MlpCoreWeights(*(torch.from_numpy(a).requires_grad_()
                                   for a in mlp_weights_np(8)))
    x.requires_grad_()
    fused_mlp.fused_mlp_ref(x, w).backward(dy)
    dx, dw = fused_mlp.fused_mlp_bwd_ref(x.detach(), dy, w)
    for name, a, t in zip(["x"] + list(fused_mlp.MlpCoreWeights._fields), [dx, *dw], [x, *w]):
        torch.testing.assert_close(a, t.grad, rtol=0, atol=2e-5 * float(t.grad.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("m,k,h,dtype", [
    (16384, 384, 1536, torch.bfloat16), (16383, 384, 1536, torch.bfloat16),
    (65536, 128, 512, torch.bfloat16), (65536, 384, 1536, torch.float32),
    (65536, 192, 768, torch.bfloat16), (65536, 384, 1000, torch.bfloat16),
    (262144, 4096, 4096, torch.bfloat16)])
def test_fused_mlp_supported_is_the_jax_predicate(m, k, h, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    assert fused_mlp.fused_mlp_supported(m, k, h, dtype) == fmp.supported(m, k, h, jdt)


def test_fused_mlp_cpu_path_takes_the_twins_without_a_launch():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((40, MLP_K)).astype(np.float32)).requires_grad_()
    w = fused_mlp.MlpCoreWeights(*(torch.from_numpy(a).requires_grad_()
                                   for a in mlp_weights_np()))
    before = (fused_mlp.LAUNCHES_MLP, fused_mlp.LAUNCHES_MLP_BWD,
              fused_mlp.LAUNCHES, fused_mlp.LAUNCHES_BWD)
    out = fused_mlp.fused_mlp(x, w)
    out.backward(torch.ones_like(out))
    assert (fused_mlp.LAUNCHES_MLP, fused_mlp.LAUNCHES_MLP_BWD,
            fused_mlp.LAUNCHES, fused_mlp.LAUNCHES_BWD) == before
    torch.testing.assert_close(out, fused_mlp.fused_mlp_ref(x, w), rtol=0, atol=0)
    assert all(t.grad is not None for t in (x, *w))
