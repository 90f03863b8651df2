"""Short-sequence softmax attention in the (B, N, H, dh) layout (kernel K2,
forward and backward).

Counterpart of multimae_tpu/ops/short_attention_pallas.py
`short_attention` (forward `_fwd`, backward `_short_attention_bwd` ->
`_bwd`): o = softmax(q . k^T * scale) . v per (sample, head), with the fp32
row logsumexp saved for a backward that recomputes the probabilities with
one exp, p = exp(s * scale - lse), and takes delta = rowsum(do * o): the
plain twin from `attention_delta` (as the JAX package computes it in XLA
outside the kernel), the CUDA backward in its own first launch.

The op is a torch.autograd.Function, as the JAX op is a custom_vjp. On a
CUDA tensor its forward launches csrc/short_attention_fwd.cu and its
backward csrc/short_attention_bwd.cu (bf16 only: the JAX gate sends other
dtypes to the einsum path); on a CPU tensor the same Function runs the
plain twins `short_attention_ref` and `short_attention_bwd_ref`.

q, k and v are read where they lie: any (B, N, H, dh) view with unit
strides over (H, dh), such as the slices of a fused qkv projection
reshaped to (B, N, 3, H, dh), goes to the kernel without a copy.

Numerics of the kernels and their twins, as the Pallas kernels': fp32
logits and softmax, probabilities rounded to the compute dtype before
P . V, fp32 accumulation; in the backward dv = T(p)^T . do,
ds = T(p * (dp - delta) * scale), dq = ds . k and dk = ds^T . q, each
product summed in fp32 and rounded to the compute dtype.
"""

from __future__ import annotations

import ctypes

import torch

from multimae_tpu_torch.ops import _build
from multimae_tpu_torch.ops.functional import check_grid

LAUNCHES = 0      # forward kernel launches made by short_attention
LAUNCHES_BWD = 0  # backward kernel launches made by its gradient

_FORCE_MODE = None  # None | "plain" (tests and the kernel-vs-twin check)

HEAD_WIDTHS = (32, 64, 128)


def set_force_mode(mode):
    global _FORCE_MODE
    assert mode in (None, "plain")
    _FORCE_MODE = mode


def supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Shapes the kernels take: (B, N, H, dh) with a head width of 32, 64
    or 128, and q and k of one batch, head count and width. Any length:
    the kernels stream 64-row tiles, so no (Nq, Nk) row has to fit on
    chip, unlike the TPU kernel's VMEM bound (:363-382). A shape it takes
    whose B or H would leave the grids raises ValueError with the reason
    (functional.check_grid)."""
    if not (q.dim() == 4 and k.dim() == 4 and q.shape[0] == k.shape[0]
            and q.shape[2:] == k.shape[2:] and q.shape[3] in HEAD_WIDTHS):
        return False
    check_grid("short_attention", batch=q.shape[0], heads=q.shape[2])
    return True


# ------------------------------------------------------------- the twins --


def _bhnd(t: torch.Tensor) -> torch.Tensor:
    return t.float().permute(0, 2, 1, 3)


def short_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float):
    """Plain twin of the forward: q (B, Nq, H, dh), k and v (B, Nk, H, dh)
    in the compute dtype -> (o (B, Nq, H, dh) in that dtype, lse
    (B, H, Nq, 1) fp32), as `_fwd(..., with_lse=True)`."""
    s = torch.matmul(_bhnd(q), _bhnd(k).transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    p = e / den
    o = torch.matmul(p.to(q.dtype).float(), _bhnd(v))
    return o.permute(0, 2, 1, 3).to(q.dtype), m + torch.log(den)


def attention_delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in fp32, (B, N, H, dh) -> (B, H, N, 1): the
    sum over keys of p * dp, taken over dh instead (JAX :352-355)."""
    return (g.float() * o.float()).sum(-1).permute(0, 2, 1).unsqueeze(-1)


def short_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                            scale: float):
    """Plain twin of the backward (`_bwd_kernel_ph` math): the gradient do
    (B, Nq, H, dh), lse and delta (B, H, Nq, 1) fp32 -> (dq, dk, dv) in the
    compute dtype, in the (B, N, H, dh) layout."""
    dtype = q.dtype
    qf, kf, vf, dof = _bhnd(q), _bhnd(k), _bhnd(v), _bhnd(do)
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale - lse.float())
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta.float()) * scale).to(dtype).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    return tuple(t.permute(0, 2, 1, 3).to(dtype) for t in (dq, dk, dv))


# --------------------------------------------------------------- kernels --


def _row_stride(t: torch.Tensor, name: str) -> int:
    """The row stride of a (B, N, H, dh) view the kernels read in place:
    unit stride over (H, dh), rows evenly spaced, 16-byte aligned."""
    b, n, h, dh = t.shape
    row = t.stride(1)
    if (t.stride(3) != 1 or t.stride(2) != dh or row < h * dh or row % 8
            or (b > 1 and t.stride(0) != n * row) or t.data_ptr() % 16):
        raise ValueError(f"short_attention: {name} {tuple(t.shape)} with strides "
                         f"{t.stride()} is not a (B, N, H, dh) view the kernel reads")
    return row


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[int, int, int]:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"short_attention: no kernel for {name} on {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"short_attention: kernel takes bfloat16, not {t.dtype}")
    if not supported(q, k) or v.shape != k.shape:
        raise ValueError(f"short_attention: no kernel for q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    return _row_stride(q, "q"), _row_stride(k, "k"), _row_stride(v, "v")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    global LAUNCHES
    ldq, ldk, ldv = _check(q, k, v)
    b, nq, h, dh = q.shape
    o = torch.empty((b, nq, h, dh), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, nq, 1), device=q.device, dtype=torch.float32)
    lib = _build.load()
    rc = lib.mm_short_attention_fwd_bf16(
        q.data_ptr(), ldq, k.data_ptr(), ldk, v.data_ptr(), ldv, o.data_ptr(),
        lse.data_ptr(), b, nq, k.shape[1], h, dh,
        torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES += 1
    _build.check(lib, rc, "short_attention")
    return o, lse


def _launch_bwd(q, k, v, o, do, lse):
    global LAUNCHES_BWD
    ldq, ldk, ldv = _check(q, k, v)
    b, nq, h, dh = q.shape
    for name, t in (("o", o), ("do", do)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"short_attention backward: {name} must be a contiguous "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    if lse.shape != (b, h, nq, 1) or lse.dtype != torch.float32:
        raise ValueError(f"short_attention backward: lse must be fp32 {(b, h, nq, 1)}")
    lse = lse.contiguous()
    dq = torch.empty_like(do)
    dk = torch.empty(k.shape, device=k.device, dtype=k.dtype)
    dv = torch.empty(v.shape, device=v.device, dtype=v.dtype)
    lib = _build.load()
    elems = ctypes.c_longlong()
    lib.mm_short_attention_bwd_workspace(b, nq, h, ctypes.byref(elems))
    ws = torch.empty(elems.value, device=q.device, dtype=torch.float32)
    rc = lib.mm_short_attention_bwd_bf16(
        q.data_ptr(), ldq, k.data_ptr(), ldk, v.data_ptr(), ldv, o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), ws.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, nq, k.shape[1], h, dh,
        torch.cuda.current_stream(q.device).cuda_stream)
    LAUNCHES_BWD += 1
    _build.check(lib, rc, "short_attention backward")
    return dq, dk, dv


def _plain(q: torch.Tensor) -> bool:
    return _FORCE_MODE == "plain" or q.device.type == "cpu"


def short_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """(o, lse) of the forward. CPU tensors take the plain twin; CUDA
    tensors launch the kernel or raise. The kernel computes with
    scale = dh ** -0.5, the only scale the model uses."""
    if _plain(q):
        return short_attention_ref(q, k, v, scale)
    if scale != q.shape[-1] ** -0.5:
        raise ValueError(f"short_attention: the kernel's scale is dh ** -0.5, not {scale}")
    return _launch(q, k, v)


def short_attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) from the forward's o and lse and the gradient do."""
    if _plain(q):
        return short_attention_bwd_ref(q, k, v, do, lse, attention_delta(o, do), scale)
    if scale != q.shape[-1] ** -0.5:
        raise ValueError(f"short_attention: the kernel's scale is dh ** -0.5, not {scale}")
    return _launch_bwd(q, k, v, o.contiguous(), do.contiguous(), lse)


class _ShortAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = short_attention_fwd(q, k, v, scale)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, grad):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = short_attention_bwd(q, k, v, o, lse, grad.to(q.dtype), ctx.scale)
        return dq, dk, dv, None


def short_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q (B, Nq, H, dh), k and v (B, Nk, H, dh) in the compute dtype ->
    (B, Nq, H, dh). CPU tensors take the plain twins, forward and backward;
    CUDA tensors launch the kernels or raise."""
    return _ShortAttention.apply(q, k, v, scale)
