"""NHWC conv blocks for dense-prediction heads (counterpart of
multimae_tpu/models/conv_utils.py; reference multimae/output_adapter_utils.py):
the ConvNeXt block, and the DPT head's ResidualConvUnit and
FeatureFusionBlock with their optional BatchNorm.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.nn.functional import all_reduce as differentiable_all_reduce

from multimae_tpu_torch.models.vit import Dense, LayerNorm, trunc_normal_
from multimae_tpu_torch.ops import fused_mlp
from multimae_tpu_torch.ops.functional import gelu
from multimae_tpu_torch.ops.resize import interpolate_2d
from multimae_tpu_torch.parallel.dist import world_size


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
                padding: int = 0, groups: int = 1, stride: int = 1) -> torch.Tensor:
    """A Conv2d on an NHWC tensor in `dtype`, NHWC out; the bias (where the
    conv has one) is added after the product is rounded, as the JAX
    package's flax Conv does. The NCHW view of x is channels-last in
    memory, so is the output, and the NHWC result is contiguous without a
    copy."""
    y = F.conv2d(x.permute(0, 3, 1, 2).to(dtype), conv.weight.to(dtype),
                 padding=padding, groups=groups, stride=stride)
    if conv.bias is not None:
        y = y + conv.bias.to(dtype)[:, None, None]
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose2d_nhwc(x: torch.Tensor, deconv: nn.ConvTranspose2d,
                          dtype: torch.dtype) -> torch.Tensor:
    """A ConvTranspose2d whose stride is its kernel (each input pixel
    becomes a kernel-sized tile) on an NHWC tensor in `dtype`, the bias
    added after the product is rounded: flax's ConvTranspose with
    transpose_kernel=True and SAME padding at these sizes."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2).to(dtype), deconv.weight.to(dtype),
                           stride=deconv.stride)
    y = y + deconv.bias.to(dtype)[:, None, None]
    return y.permute(0, 2, 3, 1).contiguous()


def make_conv(in_ch: int, out_ch: int, kernel: int, groups: int = 1, bias: bool = True,
              stride: int = 1) -> nn.Conv2d:
    """An nn.Conv2d whose parameters are created empty (no global-RNG init);
    the owner fills them from its generator."""
    conv = nn.Conv2d(in_ch, out_ch, kernel, groups=groups, bias=bias, stride=stride,
                     device="meta")
    conv.weight = nn.Parameter(torch.empty(conv.weight.shape))
    conv.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
    return conv


def make_deconv(channels: int, kernel: int) -> nn.ConvTranspose2d:
    """An nn.ConvTranspose2d of stride `kernel`, parameters created empty."""
    deconv = nn.ConvTranspose2d(channels, channels, kernel, stride=kernel, device="meta")
    deconv.weight = nn.Parameter(torch.empty(deconv.weight.shape))
    deconv.bias = nn.Parameter(torch.empty(channels))
    return deconv


@torch.no_grad()
def lecun_normal_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """flax's default Conv init: truncated normal with variance 1/fan_in;
    zero bias."""
    fan_in = conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3]
    trunc_normal_(conv.weight, generator, std=fan_in ** -0.5 / 0.87962566103423978)
    if conv.bias is not None:
        conv.bias.zero_()


class ConvNeXtBlock(nn.Module):
    """7x7 depthwise conv + LN + pointwise MLP, residual (reference
    output_adapter_utils.py:19-57; JAX models/conv_utils.py:26-106), NHWC.

    With no layer scale, the LN -> fc1 -> GELU -> fc2 + residual tail runs
    as the K3b kernel on bf16 CUDA tensors of at least fused_mlp.MIN_ROWS
    rows (the JAX gate, :51-62); otherwise through the modules, whose GELU
    is the tanh form with `approx_gelu` (K3b keeps erf, as the JAX kernel
    keeps its own)."""

    def __init__(self, dim: int, layer_scale_init_value: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.dtype = dtype
        self.approx_gelu = False
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
        x = self.pwconv2(gelu(self.pwconv1(self.norm(x)), self.approx_gelu))
        if self.gamma is not None:
            x = self.gamma.to(self.dtype) * x
        return residual + x


class BatchNorm(nn.BatchNorm2d):
    """flax's nn.BatchNorm over an NHWC tensor, under nn.BatchNorm2d's
    parameter and buffer names (the reference's keys): in training the
    batch's fp32 mean and its variance as E[x^2] - E[x]^2 clamped at 0
    (flax's use_fast_variance), over the global batch under several
    processes, with the running statistics moved by 0.01 towards them
    (flax's momentum 0.99, torch's 0.01) and the biased variance kept, as
    flax keeps it; in eval the running statistics. (x - mean) * (weight /
    sqrt(var + 1e-5)) + bias in fp32, rounded to `dtype`."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-5, momentum=0.01)
        self.dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        super().reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            moments = torch.stack([xf.mean(dim=(0, 1, 2)), xf.square().mean(dim=(0, 1, 2))])
            world = world_size()
            if world > 1:
                moments = differentiable_all_reduce(moments) / world
            mean, var = moments[0], torch.clamp(moments[1] - moments[0].square(), min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(1 - self.momentum).add_(mean.detach() * self.momentum)
                self.running_var.mul_(1 - self.momentum).add_(var.detach() * self.momentum)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(self.dtype)


class ResidualConvUnit(nn.Module):
    """ReLU, 3x3 conv (and BatchNorm), ReLU, 3x3 conv (and BatchNorm), plus
    the input (reference :60-123, JAX :109-147); the convs have no bias
    where BatchNorm follows them."""

    def __init__(self, features: int, use_bn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = make_conv(features, features, 3, bias=not use_bn)
        self.conv2 = make_conv(features, features, 3, bias=not use_bn)
        self.bn1 = BatchNorm(features, dtype) if use_bn else None
        self.bn2 = BatchNorm(features, dtype) if use_bn else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.conv1, generator)
        lecun_normal_(self.conv2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv2d_nhwc(F.relu(x), self.conv1, self.dtype, padding=1)
        if self.bn1 is not None:
            out = self.bn1(out)
        out = conv2d_nhwc(F.relu(out), self.conv2, self.dtype, padding=1)
        if self.bn2 is not None:
            out = self.bn2(out)
        return out + x


class FeatureFusionBlock(nn.Module):
    """RefineNet fusion (reference :184-247, JAX :150-197): the residual
    branch refined by resConfUnit1 and added, resConfUnit2, a 2x bilinear
    upsample with align_corners=True, a 1x1 conv. The top block
    (refinenet4) takes no residual and has no resConfUnit1
    (`with_residual=False`): the JAX module declares one in `setup`, but
    flax creates a submodule's parameters at its first call, so the JAX
    parameter tree has none, and the reference's, never called, is one of
    the keys a `.pth` start ignores (utils/torch_compat.py)."""

    def __init__(self, features: int, use_bn: bool = False,
                 dtype: torch.dtype = torch.float32, with_residual: bool = True):
        super().__init__()
        self.dtype = dtype
        self.resConfUnit1 = ResidualConvUnit(features, use_bn, dtype) if with_residual else None
        self.resConfUnit2 = ResidualConvUnit(features, use_bn, dtype)
        self.out_conv = make_conv(features, features, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.out_conv, generator)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = x
        if res is not None:
            if self.resConfUnit1 is None:
                raise ValueError("this fusion block takes no residual")
            out = out + self.resConfUnit1(res)
        out = self.resConfUnit2(out)
        h, w = out.shape[1], out.shape[2]
        out = interpolate_2d(out, (2 * h, 2 * w), mode="bilinear", align_corners=True)
        return conv2d_nhwc(out, self.out_conv, self.dtype)
