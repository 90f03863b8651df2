"""Fused SpatialOutputAdapter decoder body, forward (kernel K1 fwd).

Counterpart of multimae_tpu/ops/fused_decoder_pallas.py
`fused_decoder_core` (forward: `_fwd_kernel`, math `_core_fwd`):

    queries, context --> query_norm / context_norm -> cross-attention
        (no residual on its output) -> x + MLP(out_norm(x))
        -> depth x (x + self-attn(LN(x)); x + MLP(LN(x))) --> tokens

On a CUDA tensor the wrapper launches the kernel chain of
csrc/fused_decoder_fwd.cu (bf16 or fp32; fp32 GEMMs are true fp32 FMA,
not TF32); on a CPU tensor it runs the plain twin `decoder_core_ref`,
which autograd differentiates. On the card the op is a
torch.autograd.Function whose backward raises until the backward kernel
is ported with the training step. Numerics as in ops/fused_block.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multimae_tpu_torch.ops import _build
from multimae_tpu_torch.ops.functional import (
    attention,
    dense,
    gelu,
    layer_norm,
    merge_heads,
    split_heads,
)
from multimae_tpu_torch.ops.fused_block import BlockWeights, block_infer_ref, check_kernel_shapes

LAUNCHES = 0  # kernel launches made by fused_decoder_core

_FORCE_MODE = None  # None | "plain" (tests and the kernel-vs-twin check)


def set_force_mode(mode):
    global _FORCE_MODE
    assert mode in (None, "plain")
    _FORCE_MODE = mode


class DecoderCoreWeights(NamedTuple):
    """fp32 parameters in the torch layout; the per-block tensors are
    stacked on a leading `depth` axis (the JAX package's field order)."""

    qn_g: torch.Tensor   # query_norm (D,)
    qn_b: torch.Tensor
    cn_g: torch.Tensor   # context_norm
    cn_b: torch.Tensor
    on_g: torch.Tensor   # out_norm
    on_b: torch.Tensor
    wq: torch.Tensor     # cross-attention q (D, D)
    bq: torch.Tensor
    wkv: torch.Tensor    # cross-attention kv (2D, D)
    bkv: torch.Tensor
    wxp: torch.Tensor    # cross-attention proj (D, D)
    bxp: torch.Tensor
    w1: torch.Tensor     # mlp fc1 (H, D)
    b1: torch.Tensor
    w2: torch.Tensor     # mlp fc2 (D, H)
    b2: torch.Tensor
    n1_g: torch.Tensor   # (depth, D)
    n1_b: torch.Tensor
    wqkv: torch.Tensor   # (depth, 3D, D)
    bqkv: torch.Tensor
    wp: torch.Tensor     # (depth, D, D)
    bp: torch.Tensor
    n2_g: torch.Tensor
    n2_b: torch.Tensor
    wf1: torch.Tensor    # (depth, H, D)
    bf1: torch.Tensor
    wf2: torch.Tensor    # (depth, D, H)
    bf2: torch.Tensor


_LN_IDX = frozenset(
    i for i, f in enumerate(DecoderCoreWeights._fields)
    if f[0] in ("q", "c", "o", "n") and f[-2:] in ("_g", "_b")
)


def _cast(w: DecoderCoreWeights, dtype) -> DecoderCoreWeights:
    """LayerNorm parameters stay fp32; everything else to `dtype`."""
    return DecoderCoreWeights(*[
        t.float().contiguous() if i in _LN_IDX else t.to(dtype).contiguous()
        for i, t in enumerate(w)
    ])


def _block(w: DecoderCoreWeights, i: int) -> BlockWeights:
    return BlockWeights(w.n1_g[i], w.n1_b[i], w.wqkv[i], w.bqkv[i], w.wp[i],
                        w.bp[i], w.n2_g[i], w.n2_b[i], w.wf1[i], w.bf1[i],
                        w.wf2[i], w.bf2[i])


def decoder_core_ref(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
                     heads: int, depth: int) -> torch.Tensor:
    """Plain twin: queries (B, Nq, D), context (B, Nc, D), both in the
    compute dtype -> (B, Nq, D)."""
    dtype = q.dtype
    d = q.shape[-1]
    qn = layer_norm(q, w.qn_g, w.qn_b, dtype)
    cn = layer_norm(c, w.cn_g, w.cn_b, dtype)
    k, v = dense(cn, w.wkv, w.bkv, dtype).split(d, dim=-1)
    a = attention(split_heads(dense(qn, w.wq, w.bq, dtype), heads),
                  split_heads(k, heads), split_heads(v, heads),
                  (d // heads) ** -0.5)
    x = dense(merge_heads(a), w.wxp, w.bxp, dtype)
    h = gelu(dense(layer_norm(x, w.on_g, w.on_b, dtype), w.w1, w.b1, dtype))
    x = x + dense(h, w.w2, w.b2, dtype)
    for i in range(depth):
        x = block_infer_ref(x, _block(w, i), heads)
    return x


_ENTRY = {torch.bfloat16: "mm_fused_decoder_fwd_bf16",
          torch.float32: "mm_fused_decoder_fwd_f32"}


def _launch(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
            heads: int, depth: int) -> torch.Tensor:
    global LAUNCHES
    if q.device.type != "cuda" or c.device != q.device:
        raise ValueError(f"fused_decoder_core: no kernel for {q.device}/{c.device}")
    if q.dtype not in _ENTRY or c.dtype != q.dtype:
        raise ValueError(f"fused_decoder_core: kernel takes bfloat16 or float32, "
                         f"not {q.dtype}/{c.dtype}")
    if q.dim() != 3 or c.dim() != 3 or not (q.is_contiguous() and c.is_contiguous()):
        raise ValueError("fused_decoder_core: q and c must be contiguous (B, N, D)")
    b, nq, d = q.shape
    nc = c.shape[1]
    if c.shape[0] != b or c.shape[2] != d:
        raise ValueError(f"fused_decoder_core: context {tuple(c.shape)} does not "
                         f"match queries {tuple(q.shape)}")
    hidden = w.w1.shape[0]
    check_kernel_shapes(d, heads, hidden, max(nq, nc))
    wc = _cast(w, q.dtype)
    expect = {"wq": (d, d), "wkv": (2 * d, d), "wxp": (d, d), "w1": (hidden, d),
              "w2": (d, hidden), "wqkv": (depth, 3 * d, d), "wp": (depth, d, d),
              "wf1": (depth, hidden, d), "wf2": (depth, d, hidden),
              "n1_g": (depth, d), "bqkv": (depth, 3 * d), "bf1": (depth, hidden)}
    for name, t in zip(DecoderCoreWeights._fields, wc):
        if name in expect and tuple(t.shape) != expect[name]:
            raise ValueError(f"fused_decoder_core: weight {name} is "
                             f"{tuple(t.shape)}, expected {expect[name]}")
        if t.device != q.device:
            raise ValueError(f"fused_decoder_core: weight {name} on {t.device}")
    mq, mc = b * nq, b * nc

    def scratch(rows, cols):
        return torch.empty((rows, cols), device=q.device, dtype=q.dtype)

    out = torch.empty_like(q)
    bufs = [scratch(mq, d), scratch(mc, d), scratch(mq, d), scratch(mc, 2 * d),
            scratch(mq, d), scratch(mq, 3 * d), scratch(mq, hidden)]
    lib = _build.load()
    rc = getattr(lib, _ENTRY[q.dtype])(
        q.data_ptr(), c.data_ptr(), out.data_ptr(), _build.pointer_array(wc),
        *[t.data_ptr() for t in bufs],
        b, nq, nc, d, heads, hidden, depth,
        torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES += 1
    _build.check(lib, rc, "fused_decoder_core")
    return out


class _FusedDecoderCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, c, heads, depth, *weights):
        return _launch(q, c, DecoderCoreWeights(*weights), heads, depth)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "fused_decoder_core has no backward kernel on CUDA yet (the "
            "recompute backward of fused_decoder_pallas._bwd_kernel)")


def fused_decoder_core(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
                       heads: int, depth: int) -> torch.Tensor:
    """queries (B, Nq, D), context (B, Nc, D) in the compute dtype ->
    (B, Nq, D). CPU tensors take the plain twin; CUDA tensors launch the
    kernel or raise."""
    if _FORCE_MODE == "plain" or q.device.type == "cpu":
        return decoder_core_ref(q, c, w, heads, depth)
    return _FusedDecoderCore.apply(q, c, heads, depth, *w)
