"""Plain PyTorch building blocks shared by the modules (models/vit.py)
and by the kernels' plain twins (ops/fused_block.py, ops/fused_decoder.py).

Dtype policy, mirroring flax's `dtype=` / `param_dtype=` placement in
the JAX package: parameters stay fp32 and are cast to the compute dtype
at use; LayerNorm statistics, attention logits and the softmax are fp32
whatever the compute dtype. `dense` rounds the matmul to the compute
dtype before it adds the bias in that dtype, as flax's Dense and the
Pallas kernels' `_dense` do (fused_decoder_pallas.py:297-301).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LAYERNORM_EPS = 1e-6

# The launch grids' limits of the CUDA kernels (csrc/): a GEMM puts one
# block per 128 rows on its grid's y axis (csrc/decoder_tc.cuh launch_tc,
# launch_gemm), an attention kernel its heads on y and its samples on z;
# each axis holds at most 65535 blocks. The kernels' offsets into their
# tensors are size_t, so no element count caps a shape.
GRID_LIMIT = 65535
MAX_GEMM_ROWS = GRID_LIMIT * 128


def check_grid(what: str, rows: int = 0, batch: int = 1, heads: int = 1) -> None:
    """Raise ValueError where a launch would leave its grid: `rows` rows
    through a GEMM, `batch` samples of `heads` heads on an attention grid.
    The gates call it for a shape they otherwise take, so such a shape
    fails with the reason instead of leaving the kernel for the module
    path."""
    if rows > MAX_GEMM_ROWS:
        raise ValueError(f"{what}: {rows} rows exceed the {MAX_GEMM_ROWS} a GEMM's grid "
                         f"holds ({GRID_LIMIT} blocks of 128 rows)")
    if batch > GRID_LIMIT or heads > GRID_LIMIT:
        raise ValueError(f"{what}: {batch} samples of {heads} heads exceed the attention "
                         f"grid's {GRID_LIMIT} blocks on an axis")


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """fp32 statistics (two-pass), eps 1e-6, output in `dtype`."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(),
                        LAYERNORM_EPS).to(dtype)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """x @ weight.T on the torch (out, in) layout, in `dtype`."""
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    return y if bias is None else y + bias.to(dtype)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    """Exact-erf GELU (or, with `approximate`, the tanh form that the JAX
    package's --approx_gelu selects) evaluated in fp32, rounded to x's
    dtype."""
    return F.gelu(x.float(), approximate="tanh" if approximate else "none").to(x.dtype)


def gelu_grad(x: torch.Tensor) -> torch.Tensor:
    """Derivative of the exact-erf GELU in fp32: Phi(x) + x * phi(x)."""
    xf = x.float()
    return (0.5 * (1.0 + torch.erf(xf * 0.7071067811865476))
            + xf * torch.exp(-0.5 * xf * xf) * 0.3989422804014327)


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).float()


def dense_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """Backward of `dense` as the Pallas kernels write it (JAX
    fused_decoder_pallas._dense_bwd :304, on the torch (out, in) layout):
    dx = g . w in the compute dtype, dw = g^T . x and db = colsum(g) in fp32."""
    gf = _rows(g)
    return torch.matmul(g, w), gf.t() @ _rows(x), gf.sum(0)


def layer_norm_bwd(dy: torch.Tensor, x: torch.Tensor, gamma: torch.Tensor):
    """(dx fp32, dgamma, dbeta) of `layer_norm` at input x (JAX
    fused_decoder_pallas._ln_bwd :285, with the two-pass statistics)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    inv = torch.rsqrt(((xf - mu) ** 2).mean(-1, keepdim=True) + LAYERNORM_EPS)
    xhat = (xf - mu) * inv
    dyf = dy.float()
    dxhat = dyf * gamma.float()
    dx = inv * (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    return dx, (_rows(dyf) * _rows(xhat)).sum(0), _rows(dyf).sum(0)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, H*dh) -> (B, H, N, dh)."""
    b, n, c = t.shape
    return t.reshape(b, n, heads, c // heads).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, H, N, dh) -> (B, N, H*dh)."""
    b, h, n, dh = t.shape
    return t.transpose(1, 2).reshape(b, n, h * dh)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    """Softmax attention on (B, H, N, dh) in the compute dtype of q:
    fp32 logits and softmax, probabilities rounded to the compute dtype
    before P @ V, fp32 accumulation (reference multimae_utils.py:170-182)."""
    dtype = q.dtype
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(dtype).float(), v.float()).to(dtype)


# A kernel against its plain twin on the card, as (relative RMS error,
# max abs error / max |twin|). Both round at the same places and differ
# in summation order only; in fp32 that leaves ~1e-6 relative noise. In
# bf16 an fp32 sum that lands next to a rounding boundary flips one bf16
# ulp (2^-8 relative), and the flip propagates through later steps.
TWIN_TOLERANCE = {torch.bfloat16: (1e-2, 5e-2), torch.float32: (1e-5, 1e-4)}


def twin_error(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, relative RMS error) of `out` against `ref`."""
    o, r = out.double(), ref.double()
    err = (o - r).abs()
    rel = float(torch.sqrt(((o - r) ** 2).mean() / (r ** 2).mean().clamp_min(1e-30)))
    return float(err.max()), rel


# The backward kernel's gradients against its twin's, by the compute dtype
# (the weight gradients are fp32 in both dtypes). In fp32 as above. In
# bf16 the backward rounds at about twice as many places in a row as the
# forward (the recomputed forward, then every dX GEMM, residual gradient
# and dS on the way back), so a flipped rounding has a chain twice as long
# to spread along: measured up to 7.4e-3 relative RMS at (32, 196, 99,
# 256), against 2.9e-3 for the forward; hence twice the forward's limit.
GRAD_TOLERANCE = {torch.bfloat16: (2e-2, 5e-2), torch.float32: (1e-5, 1e-4)}


def assert_matches_twin(out: torch.Tensor, ref: torch.Tensor, what: str,
                        grad_of: Optional[torch.dtype] = None) -> tuple[float, float]:
    """Raise unless `out` agrees with its twin within TWIN_TOLERANCE, or,
    for a gradient computed in the compute dtype `grad_of`, within
    GRAD_TOLERANCE[grad_of]; returns (max abs error, relative RMS error)."""
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{what}: {tuple(out.shape)} {out.dtype} vs "
                             f"{tuple(ref.shape)} {ref.dtype}")
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{what}: non-finite output")
    max_abs, rel = twin_error(out, ref)
    tol_rel, tol_abs = (TWIN_TOLERANCE[ref.dtype] if grad_of is None
                        else GRAD_TOLERANCE[grad_of])
    scale = float(ref.double().abs().max())
    if rel > tol_rel or max_abs > tol_abs * max(scale, 1.0):
        raise AssertionError(f"{what}: max abs {max_abs:.3e} (limit "
                             f"{tol_abs * max(scale, 1.0):.3e}), rel RMS {rel:.3e} "
                             f"(limit {tol_rel:.1e})")
    return max_abs, rel
