"""2D interpolation on NHWC tensors (counterpart of multimae_tpu/ops/resize.py).

The JAX package re-implements torch's `F.interpolate` numerics as
separable matmuls; here `F.interpolate` itself is the reference, so the
port only converts the layout around it. The bilinear resize's gradient
is its exact adjoint as two matmuls (`_Bilinear`): torch's CUDA backward
adds each output's share into its source pixels with atomics, in an order
that changes from run to run, and a training run resumed from a save must
retrace the one it continues bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimae_tpu_torch.ops.functional import fp32


def _bilinear_matrix(n_in: int, n_out: int, align_corners: bool,
                     like: torch.Tensor) -> torch.Tensor:
    """(n_out, n_in): the weight of each source line in each output line of
    torch's bilinear interpolation along one axis (the source index
    `area_pixel_compute_source_index` gives, its floor and the next line,
    clamped at the edge)."""
    dst = torch.arange(n_out, dtype=torch.float64)
    if align_corners:
        src = dst * ((n_in - 1) / (n_out - 1)) if n_out > 1 else torch.zeros_like(dst)
    else:
        src = ((dst + 0.5) * (n_in / n_out) - 0.5).clamp(min=0.0)
    lo = src.floor().long().clamp(max=n_in - 1)
    hi = (lo + 1).clamp(max=n_in - 1)
    frac = src - lo
    w = torch.zeros(n_out, n_in, dtype=torch.float64)
    rows = torch.arange(n_out)
    w.index_put_((rows, lo), 1.0 - frac, accumulate=True)
    w.index_put_((rows, hi), frac, accumulate=True)
    return w.to(like.device, like.dtype)


class _Bilinear(torch.autograd.Function):
    """F.interpolate(mode="bilinear") of an NCHW tensor; the gradient is
    Wh^T @ g @ Ww, its adjoint in two matmuls, which add in a fixed order."""

    @staticmethod
    def forward(ctx, x, size, align_corners):
        ctx.in_hw, ctx.align_corners = tuple(x.shape[2:]), align_corners
        return F.interpolate(x, size=size, mode="bilinear", align_corners=align_corners)

    @staticmethod
    def backward(ctx, g):
        (h, w), (ho, wo) = ctx.in_hw, g.shape[2:]
        wh = _bilinear_matrix(h, ho, ctx.align_corners, g)
        ww = _bilinear_matrix(w, wo, ctx.align_corners, g)
        return torch.matmul(wh.t(), torch.matmul(g, ww)), None, None


def interpolate_2d(
    x: torch.Tensor,
    size: tuple[int, int],
    mode: str = "bilinear",
    align_corners: bool = False,
) -> torch.Tensor:
    """Resize the two spatial dims of an NHWC tensor (B, H, W, C).

    Returns `x` itself when the size already matches (every pos-emb
    resize at the training resolution)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    dtype = x.dtype
    x = fp32(x.permute(0, 3, 1, 2))
    if mode == "bilinear":
        y = _Bilinear.apply(x, tuple(size), align_corners)
    else:
        y = F.interpolate(x, size=size, mode=mode, align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(dtype)
