"""Fused SpatialOutputAdapter decoder body (kernel K1, forward and backward).

Counterpart of multimae_tpu/ops/fused_decoder_pallas.py
`fused_decoder_core` (forward: `_fwd_kernel`, math `_core_fwd`;
backward: `_fused_bwd` -> `_bwd_kernel`, math `_core_bwd`):

    queries, context --> query_norm / context_norm -> cross-attention
        (no residual on its output) -> x + MLP(out_norm(x))
        -> depth x (x + self-attn(LN(x)); x + MLP(LN(x))) --> tokens

The op is a torch.autograd.Function, as the JAX op is a custom_vjp. On a
CUDA tensor its forward launches the kernel chain of
csrc/fused_decoder_fwd.cu and its backward the recompute backward of
csrc/fused_decoder_bwd.cu (bf16 or fp32; fp32 GEMMs are true fp32 FMA,
not TF32); on a CPU tensor the same Function runs the plain twins
`decoder_core_ref` and `decoder_core_bwd_ref`, as the JAX op runs
`_core_fwd`/`_core_bwd` in its "ref" mode. The backward returns dq and dc
in the compute dtype and fp32 gradients for the 28 weight tensors.
Numerics as in ops/fused_block.py. `supported` is the gate the
SpatialOutputAdapter consults before it calls this op; the shapes it
refuses take the adapter's module path.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from multimae_tpu_torch.ops import _build
from multimae_tpu_torch.ops.functional import (
    LAYERNORM_EPS,
    attention,
    dense,
    dense_bwd,
    fp32,
    gelu,
    gelu_grad,
    layer_norm,
    layer_norm_bwd,
    merge_heads,
    split_heads,
)
from multimae_tpu_torch.ops.fused_block import (
    SMEM_LIMIT,
    BlockWeights,
    check_kernel_shapes,
    shape_problem,
)

LAUNCHES = 0      # forward kernel launches made by fused_decoder_core
LAUNCHES_BWD = 0  # backward kernel launches made by its gradient

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


def _core_fwd(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
              heads: int, depth: int, save=None) -> torch.Tensor:
    """The decoder body; with a dict `save`, records the activations the
    backward reads (JAX `_core_fwd(save=...)`, fused_decoder_pallas.py:519)."""
    dtype = q.dtype
    d = q.shape[-1]
    scale = (d // heads) ** -0.5

    def rec(**kw):
        if save is not None:
            save.update(kw)

    qn = layer_norm(q, w.qn_g, w.qn_b, dtype)
    cn = layer_norm(c, w.cn_g, w.cn_b, dtype)
    k, v = dense(cn, w.wkv, w.bkv, dtype).split(d, dim=-1)
    xq, xk, xv = (split_heads(t, heads) for t in (dense(qn, w.wq, w.bq, dtype), k, v))
    a = merge_heads(attention(xq, xk, xv, scale))
    x = dense(a, w.wxp, w.bxp, dtype)
    on = layer_norm(x, w.on_g, w.on_b, dtype)
    h_pre = dense(on, w.w1, w.b1, dtype)
    h = gelu(h_pre)
    rec(qn=qn, cn=cn, xq=xq, xk=xk, xv=xv, xa=a, x_attn=x, on=on, xh_pre=h_pre, xh=h)
    x = x + dense(h, w.w2, w.b2, dtype)
    for i in range(depth):
        bw = _block(w, i)
        n1 = layer_norm(x, bw.n1_g, bw.n1_b, dtype)
        sq, sk, sv = (split_heads(t, heads)
                      for t in dense(n1, bw.wqkv, bw.bqkv, dtype).split(d, dim=-1))
        a = merge_heads(attention(sq, sk, sv, scale))
        mid = x + dense(a, bw.wp, bw.bp, dtype)
        n2 = layer_norm(mid, bw.n2_g, bw.n2_b, dtype)
        h_pre = dense(n2, bw.w1, bw.b1, dtype)
        h = gelu(h_pre)
        rec(**{f"b{i}_in": x, f"b{i}_n1": n1, f"b{i}_q": sq, f"b{i}_k": sk,
               f"b{i}_v": sv, f"b{i}_a": a, f"b{i}_mid": mid, f"b{i}_n2": n2,
               f"b{i}_h_pre": h_pre, f"b{i}_h": h})
        x = mid + dense(h, bw.w2, bw.b2, dtype)
    return x


def decoder_core_ref(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
                     heads: int, depth: int) -> torch.Tensor:
    """Plain twin: queries (B, Nq, D), context (B, Nc, D), both in the
    compute dtype -> (B, Nq, D)."""
    return _core_fwd(q, c, w, heads, depth)


# ------------------------------------------------------ the plain backward --
# Written out as the JAX recompute-VJP (`_core_bwd`) is, so that it rounds
# where the kernel rounds: dense dx to the dtype, dW and db in fp32, the
# LayerNorm backward in fp32, the residual g = T(g + dx) after the fp32 sum,
# attention dS = T(P * (dP - rowsum(dP * P)) * scale). In fp32, dP is taken
# from V less its mean over the keys, as the kernel takes it.


def _attend_bwd(q, k, v, do, scale):
    """(dq, dk, dv) of ops/functional.attention on (B, H, N, dh), with the
    fp32 probabilities recomputed (JAX `_attend_bwd_2d` :477). In fp32 the
    keys' mean is taken out of V before dP = dO . V^T: that moves each
    query row's dP by a constant, which dS does not see, and where the
    context tokens share most of their value it keeps dP - rowsum(dP * P)
    from cancelling to a tenth of fp32's precision (the semseg decoder's
    dq, 1.1e-5 from float64 at the pretraining step's inputs)."""
    dtype = q.dtype
    qf, kf, vf, dof = fp32(q), fp32(k), fp32(v), fp32(do)
    p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale, dim=-1)
    dv = torch.matmul(fp32(p.to(dtype)).transpose(-1, -2), dof).to(dtype)
    if dtype == torch.float32:
        vf = vf - vf.mean(dim=-2, keepdim=True)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = fp32((p * (dp - (dp * p).sum(-1, keepdim=True)) * scale).to(dtype))
    return (torch.matmul(ds, kf).to(dtype),
            torch.matmul(ds.transpose(-1, -2), qf).to(dtype), dv)


def _residual(g, dx):
    return (fp32(g) + dx).to(g.dtype)


def decoder_core_bwd_ref(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
                         g: torch.Tensor, heads: int, depth: int):
    """Plain twin of the backward: the gradient g (B, Nq, D) of the output
    -> (dq, dc) in the compute dtype and fp32 dW (DecoderCoreWeights)."""
    dtype = q.dtype
    d = q.shape[-1]
    scale = (d // heads) ** -0.5
    wc = _cast(w, dtype)
    s = {}
    _core_fwd(q, c, wc, heads, depth, save=s)
    g = g.to(dtype)
    dw = {}
    blk = {f: [None] * depth for f in DecoderCoreWeights._fields[16:]}
    for i in reversed(range(depth)):
        bw = _block(wc, i)
        dh, blk["wf2"][i], blk["bf2"][i] = dense_bwd(s[f"b{i}_h"], bw.w2, g)
        dh_pre = (fp32(dh) * gelu_grad(s[f"b{i}_h_pre"])).to(dtype)
        dn2, blk["wf1"][i], blk["bf1"][i] = dense_bwd(s[f"b{i}_n2"], bw.w1, dh_pre)
        dx, blk["n2_g"][i], blk["n2_b"][i] = layer_norm_bwd(dn2, s[f"b{i}_mid"], bw.n2_g)
        g = _residual(g, dx)
        da, blk["wp"][i], blk["bp"][i] = dense_bwd(s[f"b{i}_a"], bw.wp, g)
        dqkv = torch.cat([merge_heads(t) for t in _attend_bwd(
            s[f"b{i}_q"], s[f"b{i}_k"], s[f"b{i}_v"], split_heads(da, heads), scale)],
            dim=-1)
        dn1, blk["wqkv"][i], blk["bqkv"][i] = dense_bwd(s[f"b{i}_n1"], bw.wqkv, dqkv)
        dx, blk["n1_g"][i], blk["n1_b"][i] = layer_norm_bwd(dn1, s[f"b{i}_in"], bw.n1_g)
        g = _residual(g, dx)
    dw.update({f: torch.stack(v) for f, v in blk.items()})

    dh, dw["w2"], dw["b2"] = dense_bwd(s["xh"], wc.w2, g)
    dh_pre = (fp32(dh) * gelu_grad(s["xh_pre"])).to(dtype)
    don, dw["w1"], dw["b1"] = dense_bwd(s["on"], wc.w1, dh_pre)
    dx, dw["on_g"], dw["on_b"] = layer_norm_bwd(don, s["x_attn"], wc.on_g)
    g = _residual(g, dx)
    da, dw["wxp"], dw["bxp"] = dense_bwd(s["xa"], wc.wxp, g)
    dxq, dxk, dxv = _attend_bwd(s["xq"], s["xk"], s["xv"], split_heads(da, heads), scale)
    dxq = merge_heads(dxq)
    dkv = torch.cat([merge_heads(dxk), merge_heads(dxv)], dim=-1)
    dqn, dw["wq"], dw["bq"] = dense_bwd(s["qn"], wc.wq, dxq)
    dcn, dw["wkv"], dw["bkv"] = dense_bwd(s["cn"], wc.wkv, dkv)
    dq, dw["qn_g"], dw["qn_b"] = layer_norm_bwd(dqn, q, wc.qn_g)
    dc, dw["cn_g"], dw["cn_b"] = layer_norm_bwd(dcn, c, wc.cn_g)
    return dq.to(dtype), dc.to(dtype), DecoderCoreWeights(**dw)


def decoder_core_f64(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights, g: torch.Tensor,
                     heads: int, depth: int) -> list:
    """The decoder body in float64 through torch's autograd, rounded to no
    compute dtype: [output, dq, dc, *dW in DecoderCoreWeights order] for
    the output's gradient g. The exact reference an fp32 kernel and its
    twin are both held to where the two part."""
    d = q.shape[-1]
    scale = (d // heads) ** -0.5
    leaves = [t.detach().double().requires_grad_() for t in (q, c, *w)]
    q64, c64, *ws = leaves
    p = DecoderCoreWeights(*ws)

    def ln(x, gamma, beta):
        return F.layer_norm(x, (d,), gamma, beta, LAYERNORM_EPS)

    def lin(x, weight, bias):
        return x @ weight.t() + bias

    def attend(xq, xk, xv):
        def heads_of(t):
            return t.reshape(t.shape[0], t.shape[1], heads, -1).transpose(1, 2)
        a = torch.softmax(heads_of(xq) @ heads_of(xk).transpose(-1, -2) * scale, -1)
        return (a @ heads_of(xv)).transpose(1, 2).reshape(xq.shape)

    def mlp(x, gamma, beta, w1, b1, w2, b2):
        return lin(F.gelu(lin(ln(x, gamma, beta), w1, b1)), w2, b2)

    k, v = lin(ln(c64, p.cn_g, p.cn_b), p.wkv, p.bkv).split(d, -1)
    x = lin(attend(lin(ln(q64, p.qn_g, p.qn_b), p.wq, p.bq), k, v), p.wxp, p.bxp)
    x = x + mlp(x, p.on_g, p.on_b, p.w1, p.b1, p.w2, p.b2)
    for i in range(depth):
        qkv = lin(ln(x, p.n1_g[i], p.n1_b[i]), p.wqkv[i], p.bqkv[i]).split(d, -1)
        x = x + lin(attend(*qkv), p.wp[i], p.bp[i])
        x = x + mlp(x, p.n2_g[i], p.n2_b[i], p.wf1[i], p.bf1[i], p.wf2[i], p.bf2[i])
    return [x.detach()] + list(torch.autograd.grad(x, leaves, g.double()))

# ---------------------------------------------------------------- kernels --


def bwd_attention_smem(nk: int, dh: int, dtype) -> int:
    """The shared-memory figure the backward's gate holds against
    SMEM_LIMIT: a copy of `attention_bwd_smem_bytes` in
    csrc/fused_decoder_bwd.cu, which `mm_fused_decoder_bwd_workspace`
    returns (fp32 dK and dV accumulators, a 32-row tile's P and dS and its
    Q and dO rows, then K and V rows padded to dh + 2 in the compute dtype)."""
    size = 4 if dtype == torch.float32 else 2
    return 4 * (2 * nk * dh + 2 * 32 * nk + 2 * 32 * dh) + 2 * nk * (dh + 2) * size


def supported(nq: int, nc: int, dim: int, heads: int, depth: int, dtype,
              hidden: int) -> bool:
    """Whether both K1 kernels take the decoder body: bf16 or fp32, depth of
    at least 1, the chains' widths (fused_block.shape_problem: in fp32 the
    forward's K/V rows within shared memory), head width 32 or 64, and the
    backward's shared memory within SMEM_LIMIT. The counterpart of the JAX
    `fused_decoder_pallas.supported`, which the JAX adapter consults on
    every backend (multimae_tpu/models/output_adapters.py:295-303); every
    shape it refuses takes the adapter's module path."""
    if dtype not in (torch.bfloat16, torch.float32) or depth < 1 or heads <= 0:
        return False
    nk = max(nq, nc)
    if shape_problem(dim, heads, hidden, nk, dtype) is not None:
        return False
    dh = dim // heads
    return dh in (32, 64) and bwd_attention_smem(nk, dh, dtype) <= SMEM_LIMIT


_ENTRY = {torch.bfloat16: "mm_fused_decoder_fwd_bf16",
          torch.float32: "mm_fused_decoder_fwd_f32"}
_ENTRY_BWD = {torch.bfloat16: "mm_fused_decoder_bwd_bf16",
              torch.float32: "mm_fused_decoder_bwd_f32"}


def _check(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
           heads: int, depth: int) -> DecoderCoreWeights:
    """Raise for inputs the kernels do not take; returns the weights cast
    to the compute dtype (LayerNorm parameters fp32)."""
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
    check_kernel_shapes(d, heads, hidden, max(nq, nc), q.dtype)
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
    return wc


def _launch(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
            heads: int, depth: int) -> torch.Tensor:
    global LAUNCHES
    wc = _check(q, c, w, heads, depth)
    b, nq, d = q.shape
    nc = c.shape[1]
    hidden = w.w1.shape[0]
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


def _launch_bwd(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
                g: torch.Tensor, heads: int, depth: int):
    global LAUNCHES_BWD
    wc = _check(q, c, w, heads, depth)
    if g.shape != q.shape or g.dtype != q.dtype or not g.is_contiguous():
        raise ValueError(f"fused_decoder_core backward: gradient {tuple(g.shape)} "
                         f"{g.dtype} does not match queries {tuple(q.shape)} {q.dtype}")
    b, nq, d = q.shape
    nc = c.shape[1]
    dh = d // heads
    if depth < 1 or dh not in (32, 64):
        raise ValueError(f"fused_decoder_core backward: no kernel for depth {depth}, "
                         f"head width {dh}")
    hidden = w.w1.shape[0]
    lib = _build.load()
    t_elems, f_elems, smem = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    lib.mm_fused_decoder_bwd_workspace(b, nq, nc, d, heads, hidden, depth,
                                       int(q.dtype == torch.float32), ctypes.byref(t_elems),
                                       ctypes.byref(f_elems), ctypes.byref(smem))
    if smem.value > SMEM_LIMIT:
        raise ValueError(f"fused_decoder_core backward: {max(nq, nc)} keys of width "
                         f"{dh} exceed shared memory")
    ws = torch.empty(t_elems.value, device=q.device, dtype=q.dtype)
    fws = torch.empty(f_elems.value, device=q.device, dtype=torch.float32)
    dq, dc = torch.empty_like(q), torch.empty_like(c)
    dw = [torch.empty(t.shape, device=q.device, dtype=torch.float32) for t in wc]
    rc = getattr(lib, _ENTRY_BWD[q.dtype])(
        q.data_ptr(), c.data_ptr(), g.data_ptr(), dq.data_ptr(), dc.data_ptr(),
        _build.pointer_array(wc), _build.pointer_array(dw), ws.data_ptr(),
        fws.data_ptr(), b, nq, nc, d, heads, hidden, depth,
        torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES_BWD += 1
    _build.check(lib, rc, "fused_decoder_core backward")
    return dq, dc, DecoderCoreWeights(*dw)


def _plain(q: torch.Tensor) -> bool:
    return _FORCE_MODE == "plain" or q.device.type == "cpu"


def fused_decoder_core_bwd(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
                           g: torch.Tensor, heads: int, depth: int):
    """The backward of fused_decoder_core: (dq, dc) in the compute dtype
    and fp32 dW. CPU tensors take the plain twin; CUDA tensors launch the
    kernel or raise."""
    if _plain(q):
        return decoder_core_bwd_ref(q, c, w, g, heads, depth)
    return _launch_bwd(q, c, w, g, heads, depth)


class _FusedDecoderCore(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, c, heads, depth, *weights):
        ctx.heads, ctx.depth = heads, depth
        ctx.save_for_backward(q, c, *weights)
        w = DecoderCoreWeights(*weights)
        if _plain(q):
            return decoder_core_ref(q, c, w, heads, depth)
        return _launch(q, c, w, heads, depth)

    @staticmethod
    def backward(ctx, grad):
        q, c, *weights = ctx.saved_tensors
        w = DecoderCoreWeights(*weights)
        dq, dc, dw = fused_decoder_core_bwd(q, c, w, grad.to(q.dtype).contiguous(),
                                            ctx.heads, ctx.depth)
        return (dq, dc, None, None, *dw)


def fused_decoder_core(q: torch.Tensor, c: torch.Tensor, w: DecoderCoreWeights,
                       heads: int, depth: int) -> torch.Tensor:
    """queries (B, Nq, D), context (B, Nc, D) in the compute dtype ->
    (B, Nq, D). CPU tensors take the plain twins, forward and backward;
    CUDA tensors launch the kernels or raise."""
    return _FusedDecoderCore.apply(q, c, heads, depth, *w)
