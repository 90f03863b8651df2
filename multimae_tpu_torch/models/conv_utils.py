"""NHWC conv blocks for dense-prediction heads (counterpart of
multimae_tpu/models/conv_utils.py; reference multimae/output_adapter_utils.py).

Only the ConvNeXt block is here; ResidualConvUnit and FeatureFusionBlock
come with the DPT head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimae_tpu_torch.models.vit import Dense, LayerNorm, trunc_normal_
from multimae_tpu_torch.ops import fused_mlp
from multimae_tpu_torch.ops.functional import gelu


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
                padding: int = 0, groups: int = 1) -> torch.Tensor:
    """A Conv2d on an NHWC tensor in `dtype`, NHWC out; the bias is added
    after the product is rounded, as the JAX package's flax Conv does. The
    NCHW view of x is channels-last in memory, so is the output, and the
    NHWC result is contiguous without a copy."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype),
                 padding=padding, groups=groups)
    y = y + conv.bias.to(dtype)[:, None, None]
    return y.permute(0, 2, 3, 1).contiguous()


def make_conv(in_ch: int, out_ch: int, kernel: int, groups: int = 1) -> nn.Conv2d:
    """An nn.Conv2d whose parameters are created empty (no global-RNG init);
    the owner fills them from its generator."""
    conv = nn.Conv2d(in_ch, out_ch, kernel, groups=groups, device="meta")
    conv.weight = nn.Parameter(torch.empty(conv.weight.shape))
    conv.bias = nn.Parameter(torch.empty(out_ch))
    return conv


@torch.no_grad()
def lecun_normal_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """flax's default Conv init: truncated normal with variance 1/fan_in;
    zero bias."""
    fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
    trunc_normal_(conv.weight, generator, std=fan_in ** -0.5 / 0.87962566103423978)
    conv.bias.zero_()


class ConvNeXtBlock(nn.Module):
    """7x7 depthwise conv + LN + pointwise MLP, residual (reference
    output_adapter_utils.py:19-57; JAX models/conv_utils.py:26-106), NHWC.

    With no layer scale, the LN -> fc1 -> GELU -> fc2 + residual tail runs
    as the K3b kernel on bf16 CUDA tensors of at least fused_mlp.MIN_ROWS
    rows (the JAX gate, :51-62); otherwise through the modules."""

    def __init__(self, dim: int, layer_scale_init_value: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.dwconv = make_conv(dim, dim, 7, groups=dim)
        self.norm = LayerNorm(dim, dtype)
        self.pwconv1 = Dense(dim, 4 * dim, dtype=dtype, init_std=0.02)
        self.pwconv2 = Dense(4 * dim, dim, dtype=dtype, init_std=0.02)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init_value))
                      if layer_scale_init_value > 0 else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.dwconv, generator)

    def mlp_weights(self) -> fused_mlp.MlpWeights:
        return fused_mlp.MlpWeights(self.norm.weight, self.norm.bias,
                                    self.pwconv1.weight, self.pwconv1.bias,
                                    self.pwconv2.weight, self.pwconv2.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = conv2d_nhwc(x, self.dwconv, self.dtype, padding=3, groups=self.dim)
        rows = x.numel() // self.dim
        if (self.gamma is None and x.is_cuda
                and fused_mlp.supported(rows, self.dim, 4 * self.dim, self.dtype)):
            y = fused_mlp.fused_ln_mlp_res(x.reshape(rows, self.dim),
                                           residual.reshape(rows, self.dim),
                                           self.mlp_weights())
            return y.reshape(x.shape)
        x = self.pwconv2(gelu(self.pwconv1(self.norm(x))))
        if self.gamma is not None:
            x = self.gamma.to(self.dtype) * x
        return residual + x
