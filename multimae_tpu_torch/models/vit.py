"""ViT primitives: LayerNorm, Dense, Mlp, Attention, CrossAttention, Block,
drop_path, dropout (counterpart of multimae_tpu/models/vit.py; reference
multimae/multimae_utils.py:105-232).

Parameters are fp32 and named as in the reference torch model, so a
state_dict exported from the JAX package loads with strict=True. Each
module casts its weights to its compute dtype at use (ops/functional.py).
Parameters are created empty; `init_weights(generator)` on the model
fills them from an explicit `torch.Generator`. Attention runs in the
JAX layout (B, N, H, dh) through ops/attention.py, which sends long bf16
sequences on the card to the K2 kernel. Dropout (`drop`, after the MLP and
the projections) and attention dropout (`attn_drop`, on the softmax
probabilities, which then takes the dense path) act in training only and
draw from the caller's generator (JAX models/vit.py:126-237).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from multimae_tpu_torch.ops import fused_block
from multimae_tpu_torch.ops.attention import fused_attention_bnhd
from multimae_tpu_torch.ops.functional import dense, gelu, layer_norm
from multimae_tpu_torch.parallel import tp


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


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Per-sample stochastic depth (reference multimae_utils.py:105-120, JAX
    models/vit.py:92-104): each sample's branch is kept with probability
    1 - rate, as floor(keep + U[0, 1)), and scaled by 1 / keep. U is drawn
    from `generator` (on x's device), one fp32 number per sample."""
    if rate == 0.0 or not training:
        return x
    if generator is None:
        raise ValueError("drop_path in training needs a torch.Generator")
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    u = torch.rand(shape, generator=generator, device=x.device, dtype=torch.float32)
    return (x / keep * torch.floor(keep + u).to(x.dtype)).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Element-wise dropout as flax's nn.Dropout: an element is kept where
    U[0, 1) < 1 - rate and scaled by 1 / (1 - rate), else zeroed; U is
    drawn from `generator` (on x's device), fp32."""
    if rate == 0.0 or not training:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=x.device, dtype=torch.float32)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def attention_dropped(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                      rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dense attention with dropout on the probabilities, (B, N, H, dh) in
    and out (JAX `_attention_core_dropped`): fp32 logits and softmax, the
    dropped probabilities rounded to q's dtype before P @ V, fp32 sums."""
    dtype = q.dtype
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = dropout(torch.softmax(s, dim=-1), rate, True, generator)
    return torch.einsum("bhnm,bmhd->bnhd", p.to(dtype).float(), v.float()).to(dtype)


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
                 dtype: torch.dtype = torch.float32, num_fused: int = 1,
                 init_std: Optional[float] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.dtype = dtype
        self.num_fused = num_fused
        self.init_std = init_std

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Xavier-uniform, or trunc-normal(init_std) where that is given."""
        if self.init_std is None:
            xavier_uniform_(self.weight, generator, self.num_fused)
        else:
            trunc_normal_(self.weight, generator, self.init_std)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.dtype)


class Mlp(nn.Module):
    """fc1 -> exact-erf GELU (tanh with `approx_gelu`, which
    `set_approx_gelu` sets) -> fc2 -> dropout at `drop` in training.

    Under tensor parallelism (parallel/tp.py sets `tp_group`) fc1 holds this
    rank's rows (column-parallel) and fc2 its columns (row-parallel): the
    input passes `copy_to_tp`, fc2's partial sums `reduce_from_tp`, and
    fc2's bias is added once after the sum."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32,
                 drop: float = 0.0):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype)
        self.fc2 = Dense(hidden, dim, dtype=dtype)
        self.drop = drop
        self.tp_group = None
        self.approx_gelu = False

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.tp_group is None:
            return dropout(self.fc2(gelu(self.fc1(x), self.approx_gelu)), self.drop,
                           self.training, generator)
        h = gelu(self.fc1(tp.copy_to_tp(x, self.tp_group)), self.approx_gelu)
        return dropout(tp.row_parallel(h, self.fc2, self.tp_group), self.drop,
                       self.training, generator)


def set_approx_gelu(model: nn.Module, enabled: bool) -> nn.Module:
    """Give every module-path GELU of `model` (its Mlps and ConvNeXt
    blocks) the tanh form, or the exact erf (JAX models/vit.py:74-89, a
    process-global there, a setting of this model's modules here). The
    kernels K1, K3b and K4 keep erf, as the JAX package's Pallas kernels
    keep their own GELU."""
    for m in model.modules():
        if hasattr(m, "approx_gelu"):
            m.approx_gelu = bool(enabled)
    return model


class Attention(nn.Module):
    """Self-attention with a fused qkv projection; scale head_dim**-0.5. In
    training, `attn_drop` > 0 takes the dense path with dropout on the
    probabilities, and `proj_drop` drops the projection's output.

    Under tensor parallelism (parallel/tp.py sets `tp_group` and
    `num_heads` to this rank's head count) qkv holds the q, k and v rows of
    this rank's heads and proj the matching columns: the input passes
    `copy_to_tp`, attention runs on the local heads (K2 where its gate
    admits them), and proj's partial sums `reduce_from_tp`. `head_dim`
    stays dim / the model's head count."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.float32, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype, num_fused=3)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.tp_group = None

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, _ = x.shape
        h, dh = self.num_heads, self.head_dim
        scale = dh ** -0.5
        if self.tp_group is not None:
            x = tp.copy_to_tp(x, self.tp_group)
        q, k, v = self.qkv(x).reshape(b, n, 3, h, dh).unbind(2)
        if self.attn_drop > 0.0 and self.training:
            out = attention_dropped(q, k, v, scale, self.attn_drop, generator)
        else:
            out = fused_attention_bnhd(q, k, v, scale)
        out = out.reshape(b, n, h * dh)
        y = self.proj(out) if self.tp_group is None else tp.row_parallel(
            out, self.proj, self.tp_group)
        return dropout(y, self.proj_drop, self.training, generator)


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
        b, n, c = x.shape
        h = self.num_heads
        scale = (c // h) ** -0.5
        q = self.q(x).reshape(b, n, h, c // h)
        k, v = self.kv(context).reshape(b, context.shape[1], 2, h, c // h).unbind(2)
        return self.proj(fused_attention_bnhd(q, k, v, scale).reshape(b, n, c))


class Block(nn.Module):
    """Pre-LN ViT block (reference multimae_utils.py:217-232).

    Inference on the card (eval, no grad, bf16, qkv bias, CUDA tensor,
    a shape fused_block.supported admits, no tensor parallelism) runs the
    whole block as the fused_block_infer kernel, the gate of the JAX
    package's models/vit.py:311-336 (whose `constraint_model_size() == 1`
    is the last condition: the kernel spans both of Megatron's sums);
    other shapes (the tiny models' head width of 16) take the module path.
    In training each residual
    branch goes through drop_path at `drop_path_rate`, drawing from the
    `generator` the caller hands to forward: the attention branch first,
    then the MLP's; dropout at `drop` and `attn_drop` draws from it too,
    each branch's before its drop_path."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, dtype: torch.dtype = torch.float32,
                 drop_path_rate: float = 0.0, drop: float = 0.0, attn_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.drop_path_rate = drop_path_rate
        self.qkv_bias = qkv_bias
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, dtype, attn_drop, drop)
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype, drop)

    def block_weights(self) -> fused_block.BlockWeights:
        a, m = self.attn, self.mlp
        return fused_block.BlockWeights(
            self.norm1.weight, self.norm1.bias, a.qkv.weight, a.qkv.bias,
            a.proj.weight, a.proj.bias, self.norm2.weight, self.norm2.bias,
            m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
        )

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if (
            not self.training
            and not torch.is_grad_enabled()
            and self.dtype == torch.bfloat16
            and self.qkv_bias
            and x.is_cuda
            and self.attn.tp_group is None
            and fused_block.supported(x.shape[1], x.shape[-1], self.num_heads,
                                      self.mlp.fc1.weight.shape[0], self.dtype, x.shape[0])
        ):
            return fused_block.fused_block_infer(
                x.to(self.dtype), self.block_weights(), self.num_heads)
        rate, train = self.drop_path_rate, self.training
        x = x + drop_path(self.attn(self.norm1(x), generator), rate, train, generator)
        return x + drop_path(self.mlp(self.norm2(x), generator), rate, train, generator)
