"""fused_block_infer (K4): the port's plain twin against the JAX Pallas
kernel (interpret mode), and the Block module path against the twin.
The CUDA kernel itself is held against the twin in test_torch_kernels.py.

Twin vs JAX: fp32 within 5e-4 absolute (GELU erf vs the kernel's
tanh-basis polynomial, <= 3e-6; two-pass vs fast-variance LayerNorm;
summation order); bf16 within 2e-2 relative RMS (the same differences
flip bf16 roundings).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.ops import fused_block_pallas as fbp
from multimae_tpu_torch.ops import fused_block

B, N, D, HEADS, HIDDEN = 2, 13, 128, 4, 512


def jax_weights(seed=0, d=D, hidden=HIDDEN):
    """Block weights in the JAX kernel layout (in, out), numpy fp32."""
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=0.2, offset=0.0):
        return (rng.standard_normal(shape) * scale + offset).astype(np.float32)

    return fbp.BlockWeights(
        n1_g=rnd(1, d, offset=1.0), n1_b=rnd(1, d),
        wqkv=rnd(d, 3 * d), bqkv=rnd(1, 3 * d), wp=rnd(d, d), bp=rnd(1, d),
        n2_g=rnd(1, d, offset=1.0), n2_b=rnd(1, d),
        w1=rnd(d, hidden, scale=0.1), b1=rnd(1, hidden),
        w2=rnd(hidden, d, scale=0.05), b2=rnd(1, d))


def to_torch(w, device="cpu"):
    """JAX layout -> the port's BlockWeights (torch (out, in) layout)."""
    def conv(name, a):
        a = np.asarray(a)
        a = a.T if name in ("wqkv", "wp", "w1", "w2") else a.reshape(-1)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return fused_block.BlockWeights(*[conv(n, a) for n, a in zip(w._fields, w)])


def inputs(seed=1, b=B, n=N, d=D):
    return np.random.default_rng(seed).standard_normal((b, n, d)).astype(np.float32)


@pytest.mark.parametrize("jdtype,tdtype", [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)])
def test_twin_matches_jax_kernel(jdtype, tdtype):
    w = jax_weights()
    x = inputs()
    fbp.set_force_mode("interpret")
    try:
        ref = np.asarray(fbp.fused_block_infer(jnp.asarray(x), w, HEADS, jdtype),
                         np.float32)
    finally:
        fbp.set_force_mode(None)
    out = fused_block.block_infer_ref(torch.from_numpy(x).to(tdtype), to_torch(w),
                                      HEADS).float().numpy()
    if tdtype == torch.float32:
        np.testing.assert_allclose(out, ref, rtol=0, atol=5e-4)
    else:
        rel = np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref ** 2))
        assert rel <= 2e-2, rel


def test_module_path_matches_twin():
    """models.vit.Block on the CPU (module path) equals the twin."""
    from multimae_tpu_torch.models.vit import Block

    blk = Block(D, HEADS, mlp_ratio=HIDDEN / D, dtype=torch.float32)
    w = to_torch(jax_weights())
    with torch.no_grad():
        for p, t in zip(blk.block_weights(), w):
            p.copy_(t)
    x = torch.from_numpy(inputs())
    with torch.no_grad():
        torch.testing.assert_close(blk(x), fused_block.block_infer_ref(x, w, HEADS),
                                   rtol=0, atol=1e-6)
