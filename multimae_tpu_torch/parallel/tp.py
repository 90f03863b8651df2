"""Megatron tensor parallelism over the mesh's "model" group (counterpart
of multimae_tpu/parallel/tp.py).

The JAX package shards weights with GSPMD and pins activations with
`constrain_tp`; XLA then inserts Megatron's two psums per block. Here the
same split is written out per rank, on plain tensors and
torch.autograd.Functions over the "model" process group:

  * `shard_model` replaces each encoder block's weights by this rank's
    piece (`split_kind`, the scope and split of `_tp_leaf_spec` :55-84,
    TP_SCOPE_RE the encoder blocks): mlp.fc1 column-parallel (weight
    rows and bias), mlp.fc2 and attn.proj row-parallel (weight columns;
    their biases stay whole and are added once after the sum), and
    attn.qkv by head: the q, k and v rows of this rank's H/k heads. The
    JAX package keeps qkv replicated only because its packed (3, H, dh)
    output has no contiguous GSPMD split (tp.py:16-19); the function is
    the same and the compute 1/k.
  * In each block, `copy_to_tp` (f: identity forward, all_reduce
    backward) sits before qkv and fc1, and `reduce_from_tp` (g: all_reduce
    forward, identity backward) after proj and fc2: two all_reduces per
    block forward, two backward. Attention runs on the local heads, with
    K2 where its gate admits the shape; the fused ViT-block kernel K4 is
    never taken (models/vit.py, the JAX gate's model size of 1).

Not DTensor: K2 is an opaque autograd.Function on plain (B, N, H, dh)
tensors, the head-indexed qkv split is not a contiguous Shard, and the
one collective needed, all_reduce, exists on every backend used here
(NCCL; gloo on CPU and on CUDA tensors). The sums run in fp32.

Everything outside the blocks (adapters, decoders, heads, losses) stays
replicated over "model": each rank computes its gradients, equal on every
rank of the group but for a kernel's rounding in another process, and
`sync_replicated_gradients` averages them over the group so the
replicated state stays identical; the data-parallel mean then runs over
the data group only.
The gradient norm counts each split tensor once (train/pretrain_step.py),
and a checkpoint holds the gathered canonical tensors (`full_tensor`,
train/train_state.py), so a save under TP loads under any layout.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

TP_SCOPE_RE = re.compile(r"^encoder\.\d+\.")

# How each Megatron tensor of a block splits: "qkv" cuts dim 0 head by head
# within each of q, k and v; "rows" cuts dim 0 and "cols" dim 1 into k
# contiguous pieces.
_RULES = {
    "attn.qkv.weight": "qkv", "attn.qkv.bias": "qkv",
    "attn.proj.weight": "cols",
    "mlp.fc1.weight": "rows", "mlp.fc1.bias": "rows",
    "mlp.fc2.weight": "cols",
}


def local_piece(kind: str, full: torch.Tensor, rank: int, k: int) -> torch.Tensor:
    """Rank `rank`'s piece of a canonical tensor under `kind`."""
    if kind == "qkv":
        parts = full.reshape(3, k, full.shape[0] // (3 * k), *full.shape[1:])
        return parts[:, rank].reshape(-1, *full.shape[1:]).contiguous()
    dim = 0 if kind == "rows" else 1
    return full.chunk(k, dim=dim)[rank].contiguous()


def join_pieces(kind: str, pieces) -> torch.Tensor:
    """The canonical tensor from every rank's piece, in rank order."""
    if kind == "qkv":
        rest = pieces[0].shape[1:]
        return torch.stack([p.reshape(3, -1, *rest) for p in pieces], dim=1).reshape(-1, *rest)
    return torch.cat(pieces, dim=0 if kind == "rows" else 1)


def full_shape(kind: str, shape, k: int) -> Tuple[int, ...]:
    shape = list(shape)
    shape[1 if kind == "cols" else 0] *= k
    return tuple(shape)


class _CopyToTP(torch.autograd.Function):
    """f: identity forward, the gradient summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_fp32(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """g: the partial sums summed over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_reduce_fp32(t: torch.Tensor, group) -> torch.Tensor:
    out = t.float().contiguous()
    if out.data_ptr() == t.data_ptr():
        out = out.clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def row_parallel(x: torch.Tensor, layer, group) -> torch.Tensor:
    """A row-parallel Dense: this rank's columns of the weight on its piece
    of the input, the partial sums summed over the group, then the whole
    bias once."""
    y = reduce_from_tp(torch.matmul(x.to(layer.dtype), layer.weight.to(layer.dtype).t()), group)
    return y if layer.bias is None else y + layer.bias.to(layer.dtype)


def model_tp(model: nn.Module) -> Optional[Tuple[object, int, int]]:
    """(group, rank, size) of a model that `shard_model` split, else None."""
    return getattr(model, "tp", None)


def shard_model(model: nn.Module, group, rank: int, size: int) -> nn.Module:
    """Replace every encoder block's Megatron tensors by rank `rank`'s piece
    of `size` and point the blocks at `group`; in place, before the
    optimizer is built. Raises ValueError where a block's head count or MLP
    width does not divide `size`: a block split in part would compute
    another function."""
    if size == 1:
        return model
    heads = model.encoder[0].attn.num_heads
    for i, blk in enumerate(model.encoder):
        hidden = blk.mlp.fc1.weight.shape[0]
        if blk.attn.num_heads != heads or blk.attn.num_heads % size or hidden % size:
            raise ValueError(
                f"tensor parallelism over {size} ranks needs every encoder block's heads "
                f"and MLP width divisible by it; block {i} has {blk.attn.num_heads} heads, "
                f"width {hidden}")
        for suffix, kind in _RULES.items():
            mod_name, leaf = suffix.rsplit(".", 1)
            mod = blk.get_submodule(mod_name)
            full = getattr(mod, leaf)
            if full is None:
                continue
            setattr(mod, leaf, nn.Parameter(local_piece(kind, full.detach(), rank, size),
                                            requires_grad=full.requires_grad))
        blk.attn.num_heads = heads // size
        blk.attn.tp_group = blk.mlp.tp_group = group
    model.tp = (group, rank, size)
    return model


def sync_replicated_gradients(model: nn.Module, named_params) -> None:
    """Average over the group the gradients of the parameters every rank
    holds whole: the ranks compute them each on its own, equal but for
    what a kernel may round differently in another process (a convolution
    algorithm picked per process), and the mean keeps the replicated state
    identical on every rank. `named_params` are (name, parameter) pairs of
    the model (and the balancer's, which no rank splits)."""
    tp = model_tp(model)
    if tp is None:
        return
    from multimae_tpu_torch.parallel.dist import all_reduce_flat
    from multimae_tpu_torch.parallel.fsdp import is_sharded

    grads = [p.grad.to_local() if is_sharded(p.grad) else p.grad
             for n, p in named_params if p.grad is not None and split_kind(model, n) is None]
    all_reduce_flat(grads, tp[0], divide=tp[2])


def split_kind(model: nn.Module, name: str) -> Optional[str]:
    """How parameter `name` of a model that `shard_model` split is split
    ("qkv", "rows" or "cols"), or None (replicated, or no split model)."""
    if model_tp(model) is None or not TP_SCOPE_RE.match(name):
        return None
    return _RULES.get(name.split(".", 2)[2])


def full_tensor(model: nn.Module, name: str, t: torch.Tensor) -> torch.Tensor:
    """The canonical tensor of this rank's piece `t` of parameter `name`
    (every rank of the group calls it, in one order), or `t` where it is
    not split; on `t`'s device, gathered on the host under gloo and on the
    card under NCCL."""
    kind = split_kind(model, name)
    if kind is None:
        return t
    group, _, size = model_tp(model)
    where = t.device
    t = t.to("cpu" if dist.get_backend(group) == "gloo" else "cuda").contiguous()
    pieces = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(pieces, t, group=group)
    return join_pieces(kind, pieces).to(where)


def local_tensor(model: nn.Module, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's piece of the canonical tensor `full` of `name`."""
    kind = split_kind(model, name)
    if kind is None:
        return full
    _, rank, size = model_tp(model)
    return local_piece(kind, full, rank, size)


def canonical_shape(model: nn.Module, name: str, shape) -> Tuple[int, ...]:
    kind = split_kind(model, name)
    return tuple(shape) if kind is None else full_shape(kind, shape, model_tp(model)[2])
