"""fused_decoder_core forward (K1): the port's plain twin against the JAX
Pallas kernel (interpret mode), the SpatialOutputAdapter's module path
against its core path, and the CPU path's gradients. The CUDA kernel
itself is held against the twin in test_torch_kernels.py.

Tolerances as in test_torch_fused_block.py: fp32 within 5e-4 absolute,
bf16 within 2e-2 relative RMS against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.ops import fused_decoder_pallas as fdp
from multimae_tpu_torch.ops import fused_decoder

B, NQ, NC, D, HEADS, DEPTH = 2, 16, 9, 64, 4, 2
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


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_twin_matches_jax_kernel(jdtype, tdtype):
    w = jax_weights()
    q, c = inputs()
    fdp.set_force_mode("interpret")
    try:
        ref = np.asarray(fdp.fused_decoder_core(jnp.asarray(q), jnp.asarray(c), w,
                                                HEADS, DEPTH, jdtype), np.float32)
    finally:
        fdp.set_force_mode(None)
    out = fused_decoder.decoder_core_ref(
        torch.from_numpy(q).to(tdtype), torch.from_numpy(c).to(tdtype),
        to_torch(w), HEADS, DEPTH).float().numpy()
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
