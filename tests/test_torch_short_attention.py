"""The K2 plain twins against the JAX short-attention kernel, and the
attention dispatch.

The same numpy inputs go through JAX `short_attention` (forward with its
lse, and its custom VJP), run in Pallas interpret mode on the CPU as
tests/test_short_attention.py runs it, and through the port's twins
`short_attention_ref` and `short_attention_bwd_ref` (through the port's
autograd Function). Both of the JAX kernel's layouts are covered: the
heads-batched grid at (2, 40, 2, 32), and the per-head grid at (1, 2049,
2, 32), where `_heads_batched` is false.

Tolerances, against each tensor's largest |value|: fp32 1e-5 (forward)
and 1e-4 (gradients): both sides compute the same fp32 products in
another summation order. bf16: relative RMS 1e-2, the twins' TWIN
tolerance: both round probabilities and dS to bf16, and a sum landing
next to a rounding boundary flips one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.ops import short_attention_pallas as sap
from multimae_tpu.ops.attention import einsum_attention_bnhd as jeinsum
from multimae_tpu_torch.ops import attention, short_attention

SHAPES = {"heads_batched": (2, 40, 2, 32), "per_head": (1, 2049, 2, 32)}


def inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def to_jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def to_torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


def assert_close(out, ref, dtype, tol_fp32, what):
    out = np.asarray(out.float() if torch.is_tensor(out) else out.astype(jnp.float32))
    ref = np.asarray(ref.astype(jnp.float32))
    assert out.shape == ref.shape, (what, out.shape, ref.shape)
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol_fp32 * np.abs(ref).max(),
                                   err_msg=what)
    else:
        assert rel_rms(out, ref) <= 1e-2, (what, rel_rms(out, ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", sorted(SHAPES))
def test_twins_match_jax_kernel(layout, dtype):
    shape = SHAPES[layout]
    b, n, h, dh = shape
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    assert sap._heads_batched(n, n, h, dh, jdt.itemsize) == (layout == "heads_batched")
    scale = dh ** -0.5
    q, k, v, g = inputs(shape)
    jq, jk, jv, jg = (to_jax(a, jdt) for a in (q, k, v, g))
    jo, jlse = sap._fwd(jq, jk, jv, scale, with_lse=True)
    _, vjp = jax.vjp(lambda a, b_, c: sap.short_attention(a, b_, c, scale), jq, jk, jv)
    jgrads = vjp(jg)

    tq, tk, tv = (to_torch(a, tdt).requires_grad_() for a in (q, k, v))
    o, lse = short_attention.short_attention_ref(tq, tk, tv, scale)
    assert_close(o.detach(), jo, dtype, 1e-5, "o")
    assert_close(lse.detach(), jlse, "float32", 1e-5, "lse")
    out = short_attention.short_attention(tq, tk, tv, scale)
    torch.testing.assert_close(out, o, rtol=0, atol=0)
    out.backward(to_torch(g, tdt))
    for name, t, jt in zip(("dq", "dk", "dv"), (tq, tk, tv), jgrads):
        assert t.grad.dtype == tdt
        assert_close(t.grad, jt, dtype, 1e-4, name)


def test_twin_backward_matches_autograd_fp32():
    """The written-out backward twin against autograd through the forward
    twin: the same gradient by two routes."""
    q, k, v, g = inputs((2, 37, 3, 64), seed=4)
    scale = 64 ** -0.5
    tq, tk, tv = (torch.from_numpy(a).double().float().requires_grad_() for a in (q, k, v))
    o, lse = short_attention.short_attention_ref(tq, tk, tv, scale)
    o.backward(torch.from_numpy(g))
    delta = short_attention.attention_delta(o.detach(), torch.from_numpy(g))
    twin = short_attention.short_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                                   torch.from_numpy(g), lse.detach(), delta,
                                                   scale)
    for a, t in zip(twin, (tq, tk, tv)):
        torch.testing.assert_close(a, t.grad, rtol=0, atol=1e-5 * float(t.grad.abs().max()))


@pytest.mark.parametrize("nk", [99, 600])
def test_einsum_path_matches_jax(nk):
    q = inputs((2, 50, 4, 32), seed=1)[0]
    k, v = inputs((2, nk, 4, 32), seed=2)[:2]
    out = attention.einsum_attention_bnhd(*(torch.from_numpy(a) for a in (q, k, v)), 32 ** -0.5)
    ref = jeinsum(*(jnp.asarray(a) for a in (q, k, v)), 32 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nk", [511, 512, 2049])
def test_dispatch_takes_the_einsum_path_off_the_card(dtype, nk):
    """The K2 gate is the JAX one on the card (bf16, kv >= 512,
    supported); on the CPU every shape takes the einsum path and no
    kernel is launched."""
    q = torch.from_numpy(inputs((1, 64, 2, 32), seed=3)[0]).to(dtype)
    k, v = (torch.from_numpy(a).to(dtype) for a in inputs((1, nk, 2, 32), seed=5)[:2])
    assert attention.SHORT_KERNEL_MIN_KV == 512
    assert short_attention.supported(q, k)
    assert not attention.use_short_kernel(q, k)
    before = (short_attention.LAUNCHES, short_attention.LAUNCHES_BWD)
    out = attention.fused_attention_bnhd(q, k, v, 32 ** -0.5)
    assert (short_attention.LAUNCHES, short_attention.LAUNCHES_BWD) == before
    torch.testing.assert_close(out, attention.einsum_attention_bnhd(q, k, v, 32 ** -0.5),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,ok", [((2, 600, 2, 64), True), ((2, 600, 2, 48), False),
                                      ((2, 600, 2, 256), False), ((2, 600, 12, 128), True)])
def test_supported_head_widths(shape, ok):
    q = torch.empty(shape)
    assert short_attention.supported(q, q) == ok
