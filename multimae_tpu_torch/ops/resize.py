"""2D interpolation on NHWC tensors (counterpart of multimae_tpu/ops/resize.py).

The JAX package re-implements torch's `F.interpolate` numerics as
separable matmuls; here `F.interpolate` itself is the reference, so the
port only converts the layout around it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    y = F.interpolate(
        x.permute(0, 3, 1, 2).float(), size=size, mode=mode,
        align_corners=align_corners,
    )
    return y.permute(0, 2, 3, 1).to(dtype)
