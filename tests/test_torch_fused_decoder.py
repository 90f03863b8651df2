"""fused_decoder_core (K1), forward and backward: the port's plain twins
against the JAX Pallas kernels (interpret mode), the SpatialOutputAdapter's
module path against its core path, and the CPU path's gradients. The CUDA
kernels themselves are held against the twins in test_torch_kernels.py.

Forward tolerances as in test_torch_fused_block.py: fp32 within 5e-4
absolute, bf16 within 2e-2 relative RMS against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.ops import fused_decoder_pallas as fdp
from multimae_tpu_torch.ops import fused_decoder

B, NQ, NC, D, HEADS, DEPTH = 2, 16, 9, 64, 4, 2
# (B, Nq, Nc, D, heads): the module's shape, and ragged ones at head width
# 32 whose edges the CUDA tiles mask (16-row tiles, 64-key chunks).
SHAPES = [(B, NQ, NC, D, HEADS), (2, 20, 13, 64, 2), (3, 17, 5, 64, 2)]
_KERNELS = {"wq", "wkv", "wxp", "w1", "w2", "wqkv", "wp", "wf1", "wf2"}


def jax_weights(seed=0, d=D, depth=DEPTH):
    """DecoderCoreWeights in the JAX kernel layout, numpy fp32."""
    rng = np.random.default_rng(seed)
    hidden = 4 * d

    def rnd(*shape, scale=0.2, offset=0.0):
        return (rng.standard_normal(shape) * scale + offset).astype(np.float32)

    return fdp.DecoderCoreWeights(
        qn_g=rnd(1, d, offset=1.0), qn_b=rnd(1, d), cn_g=rnd(1, d, offset=1.0),
        cn_b=rnd(1, d), on_g=rnd(1, d, offset=1.0), on_b=rnd(1, d),
        wq=rnd(d, d), bq=rnd(1, d), wkv=rnd(d, 2 * d), bkv=rnd(1, 2 * d),
        wxp=rnd(d, d), bxp=rnd(1, d), w1=rnd(d, hidden, scale=0.1),
        b1=rnd(1, hidden), w2=rnd(hidden, d, scale=0.05), b2=rnd(1, d),
        n1_g=rnd(depth, 1, d, offset=1.0), n1_b=rnd(depth, 1, d),
        wqkv=rnd(depth, d, 3 * d), bqkv=rnd(depth, 1, 3 * d),
        wp=rnd(depth, d, d), bp=rnd(depth, 1, d),
        n2_g=rnd(depth, 1, d, offset=1.0), n2_b=rnd(depth, 1, d),
        wf1=rnd(depth, d, hidden, scale=0.1), bf1=rnd(depth, 1, hidden),
        wf2=rnd(depth, hidden, d, scale=0.05), bf2=rnd(depth, 1, d))


def to_torch(w, depth=DEPTH, device="cpu"):
    """JAX layout -> the port's DecoderCoreWeights (torch layout)."""
    out = []
    for name, a in zip(w._fields, w):
        a = np.asarray(a)
        stacked = name in fdp.DecoderCoreWeights._fields[16:]
        if name in _KERNELS:
            a = np.swapaxes(a, -1, -2)
        else:
            a = a.reshape(depth, -1) if stacked else a.reshape(-1)
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return fused_decoder.DecoderCoreWeights(*out)


def inputs(seed=1, b=B, nq=NQ, nc=NC, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, nq, d)).astype(np.float32),
            rng.standard_normal((b, nc, d)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_twin_matches_jax_kernel(jdtype, tdtype, shape):
    b, nq, nc, d, heads = shape
    w = jax_weights(d=d)
    q, c = inputs(b=b, nq=nq, nc=nc, d=d)
    fdp.set_force_mode("interpret")
    try:
        ref = np.asarray(fdp.fused_decoder_core(jnp.asarray(q), jnp.asarray(c), w,
                                                heads, DEPTH, jdtype), np.float32)
    finally:
        fdp.set_force_mode(None)
    out = fused_decoder.decoder_core_ref(
        torch.from_numpy(q).to(tdtype), torch.from_numpy(c).to(tdtype),
        to_torch(w), heads, DEPTH).float().numpy()
    if tdtype == torch.float32:
        np.testing.assert_allclose(out, ref, rtol=0, atol=5e-4)
    else:
        rel = np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref ** 2))
        assert rel <= 2e-2, rel


def adapter():
    from multimae_tpu_torch.models.output_adapters import SpatialOutputAdapter

    m = SpatialOutputAdapter(num_channels=3, stride_level=1, patch_size_full=16,
                             dim_tokens_enc=D, dim_tokens=D, depth=DEPTH,
                             image_size=64, num_heads=HEADS,
                             context_tasks=("rgb",), task="rgb")
    m.load_state_dict(_adapter_state(m), strict=True)
    return m.eval()


def _adapter_state(m):
    """Random values for every parameter of the adapter."""
    g = torch.Generator().manual_seed(0)
    sd = {}
    for k, v in m.state_dict().items():
        r = torch.randn(v.shape, generator=g) * 0.1
        is_ln_scale = k.endswith(".weight") and "norm" in k.split(".")[-2]
        sd[k] = r + 1.0 if is_ln_scale else r
    return sd


def test_adapter_module_path_matches_core_path():
    m = adapter()
    q, c = (torch.from_numpy(a) for a in inputs())
    with torch.no_grad():
        core = fused_decoder.fused_decoder_core(q, c, m.core_weights(), HEADS, DEPTH)
        modules = m.decode_modules(q, c)
    torch.testing.assert_close(modules, core, rtol=0, atol=1e-5)


def test_cpu_twin_is_differentiable_without_a_launch():
    w = to_torch(jax_weights())
    q, c = (torch.from_numpy(a).requires_grad_() for a in inputs())
    before = fused_decoder.LAUNCHES
    fused_decoder.fused_decoder_core(q, c, w, HEADS, DEPTH).square().sum().backward()
    assert fused_decoder.LAUNCHES == before
    assert torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0
    assert torch.isfinite(c.grad).all() and c.grad.abs().sum() > 0


# ------------------------------------------------------------- backward --
# decoder_core_bwd_ref (the plain twin the CUDA backward kernel is held
# against) against the JAX backward kernel run in interpret mode, and, in
# fp32, against torch.autograd of the plain forward. Tolerances: fp32
# within 5e-4 absolute, scaled by max(1, max|JAX|) for the weight
# gradients (sums over B*Nq rows); bf16 within 2e-2 relative RMS; the
# twin against autograd within 1e-5 relative RMS (summation order only).

_FIELDS = fdp.DecoderCoreWeights._fields


def jax_vjp(jdtype, seed_g=4, shape=SHAPES[0]):
    import jax

    b, nq, nc, d, heads = shape
    w = jax_weights(d=d)
    q, c = inputs(b=b, nq=nq, nc=nc, d=d)
    g = np.random.default_rng(seed_g).standard_normal((b, nq, d)).astype(np.float32)
    qj, cj, gj = (jnp.asarray(a, jdtype) for a in (q, c, g))
    fdp.set_force_mode("interpret")
    try:
        _, vjp = jax.vjp(lambda a, bb, ww: fdp.fused_decoder_core(a, bb, ww, heads, DEPTH,
                                                                  jdtype), qj, cj, w)
        dq, dc, dw = vjp(gj)
    finally:
        fdp.set_force_mode(None)
    return w, q, c, g, (dq, dc, dw)


def rel_rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_backward_twin_matches_jax_kernel(jdtype, tdtype, shape):
    heads = shape[4]
    w, q, c, g, (jdq, jdc, jdw) = jax_vjp(jdtype, shape=shape)
    tq, tc, tg = (torch.from_numpy(a).to(tdtype) for a in (q, c, g))
    dq, dc, dw = fused_decoder.decoder_core_bwd_ref(tq, tc, to_torch(w), tg, heads, DEPTH)
    assert dq.dtype == tdtype and dc.dtype == tdtype
    ref_dw = to_torch(fdp.DecoderCoreWeights(*[np.array(t, np.float32) for t in jdw]))
    pairs = [("dq", dq, np.asarray(jdq, np.float32)), ("dc", dc, np.asarray(jdc, np.float32))]
    pairs += [(f"d{n}", a, r.numpy()) for n, a, r in zip(_FIELDS, dw, ref_dw)]
    for name, out, ref in pairs:
        out = out.float().numpy()
        assert out.shape == ref.shape, name
        if tdtype == torch.float32:
            atol = 5e-4 * max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(out, ref, rtol=0, atol=atol, err_msg=name)
        else:
            assert rel_rms(out, ref) <= 2e-2, (name, rel_rms(out, ref))


def test_backward_twin_matches_autograd():
    w = to_torch(jax_weights())
    q, c = (torch.from_numpy(a) for a in inputs())
    g = torch.from_numpy(np.random.default_rng(4).standard_normal((B, NQ, D))
                         .astype(np.float32))
    dq, dc, dw = fused_decoder.decoder_core_bwd_ref(q, c, w, g, HEADS, DEPTH)
    qa, ca = q.clone().requires_grad_(), c.clone().requires_grad_()
    wa = fused_decoder.DecoderCoreWeights(*[t.clone().requires_grad_() for t in w])
    fused_decoder.decoder_core_ref(qa, ca, wa, HEADS, DEPTH).backward(g)
    for name, out, ref in [("dq", dq, qa.grad), ("dc", dc, ca.grad)] + [
            (f"d{n}", a, r.grad) for n, a, r in zip(_FIELDS, dw, wa)]:
        assert rel_rms(out.double().numpy(), ref.double().numpy()) <= 1e-5, name


def test_cpu_backward_runs_the_twin_without_a_launch():
    w = fused_decoder.DecoderCoreWeights(*[t.requires_grad_() for t in to_torch(jax_weights())])
    q, c = (torch.from_numpy(a).requires_grad_() for a in inputs())
    g = torch.ones((B, NQ, D))
    before = fused_decoder.LAUNCHES_BWD
    fused_decoder.fused_decoder_core(q, c, w, HEADS, DEPTH).backward(g)
    assert fused_decoder.LAUNCHES_BWD == before
    dq, dc, dw = fused_decoder.decoder_core_bwd_ref(q.detach(), c.detach(), w, g, HEADS, DEPTH)
    assert torch.equal(q.grad, dq) and torch.equal(c.grad, dc)
    assert all(torch.equal(t.grad, r) for t, r in zip(w, dw))
