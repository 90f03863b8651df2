"""ViT primitives: LayerNorm, Dense, Mlp, Attention, CrossAttention, Block
(counterpart of multimae_tpu/models/vit.py; reference
multimae/multimae_utils.py:138-232).

Parameters are fp32 and named as in the reference torch model, so a
state_dict exported from the JAX package loads with strict=True. Each
module casts its weights to its compute dtype at use (ops/functional.py).
Parameters are created empty; `init_weights(generator)` on the model
fills them from an explicit `torch.Generator`.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from multimae_tpu_torch.ops import fused_block
from multimae_tpu_torch.ops.functional import (
    attention,
    dense,
    gelu,
    layer_norm,
    merge_heads,
    split_heads,
)


# ------------------------------------------------------------ initialisers --
# Draws are made on the CPU from the caller's generator and copied into
# the parameter, so one seed gives the same weights on every device.


@torch.no_grad()
def uniform_(t: torch.Tensor, a: float, generator: torch.Generator) -> None:
    t.copy_((torch.rand(t.shape, generator=generator) * 2.0 - 1.0) * a)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, generator: torch.Generator,
                    num_fused: int = 1) -> None:
    """Xavier-uniform over the torch (out, in, *kernel) layout. For fused
    projections (qkv: num_fused=3, kv: 2) the fan-out is one part's, as
    the reference's special case (multimae/multimae.py:101-110)."""
    receptive = int(math.prod(t.shape[2:]))
    fan_in = t.shape[1] * receptive
    fan_out = t.shape[0] // num_fused * receptive
    uniform_(t, math.sqrt(6.0 / float(fan_in + fan_out)), generator)


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, generator: torch.Generator,
                  std: float = 0.02) -> None:
    """Normal(0, std) truncated to [-2 std, 2 std] by redrawing."""
    x = torch.randn(t.shape, generator=generator)
    bad = x.abs() > 2.0
    while bool(bad.any()):
        x = torch.where(bad, torch.randn(t.shape, generator=generator), x)
        bad = x.abs() > 2.0
    t.copy_(x * std)


# ---------------------------------------------------------------- modules --


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics regardless of compute dtype."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.dtype)


class Dense(nn.Module):
    """Linear layer in the compute dtype; weight (out, in) as nn.Linear."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, num_fused: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.dtype = dtype
        self.num_fused = num_fused

    def reset_parameters(self, generator: torch.Generator) -> None:
        xavier_uniform_(self.weight, generator, self.num_fused)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.dtype)


class Mlp(nn.Module):
    """fc1 -> exact-erf GELU -> fc2."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class Attention(nn.Module):
    """Self-attention with a fused qkv projection; scale head_dim**-0.5."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype, num_fused=3)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        q, k, v = self.qkv(x).split(c, dim=-1)
        h = self.num_heads
        out = attention(split_heads(q, h), split_heads(k, h), split_heads(v, h),
                        (c // h) ** -0.5)
        return self.proj(merge_heads(out))


class CrossAttention(nn.Module):
    """Queries from x, fused kv projection from the context."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q = Dense(dim, dim, bias=qkv_bias, dtype=dtype)
        self.kv = Dense(dim, 2 * dim, bias=qkv_bias, dtype=dtype, num_fused=2)
        self.proj = Dense(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        h = self.num_heads
        k, v = self.kv(context).split(c, dim=-1)
        out = attention(split_heads(self.q(x), h), split_heads(k, h),
                        split_heads(v, h), (c // h) ** -0.5)
        return self.proj(merge_heads(out))


class Block(nn.Module):
    """Pre-LN ViT block (reference multimae_utils.py:217-232).

    Inference on the card (eval, no grad, bf16, qkv bias, CUDA tensor)
    runs the whole block as the fused_block_infer kernel, the gate of
    the JAX package's models/vit.py:311-336."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.qkv_bias = qkv_bias
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)

    def block_weights(self) -> fused_block.BlockWeights:
        a, m = self.attn, self.mlp
        return fused_block.BlockWeights(
            self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
            a.proj.weight, a.proj.bias, self.norm2.weight, self.norm2.bias,
            m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (
            not self.training
            and not torch.is_grad_enabled()
            and self.dtype == torch.bfloat16
            and self.qkv_bias
            and x.is_cuda
        ):
            return fused_block.fused_block_infer(
                x.to(self.dtype), self.block_weights(), self.num_heads)
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))
