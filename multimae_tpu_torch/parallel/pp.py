"""GPipe pipeline parallelism over the mesh's "stage" group (counterpart of
multimae_tpu/parallel/pp.py).

The encoder's L blocks are cut into S contiguous stages of L/S blocks,
stage s on the rank of stage index s; the rank's local batch is cut into
M microbatches, and the JAX schedule (:110-235) runs over M + S - 1
ticks: at tick t stage s works on microbatch t - s, when there is one.
Stage 0 feeds from the tokens; every other stage receives its input from
the stage before, and every stage but the last sends its output on. The
last stage's outputs, joined, go to every stage rank (:220-224), so the
decoders and losses run replicated over "stage" as in plain data
parallelism.

The backward runs the same ticks in reverse, by an explicit schedule: the
join's backward takes each microbatch's backward in turn, M-1 down to 0,
on every stage rank, one `torch.autograd.backward` through that
microbatch's blocks each. The gradient of its output is the last stage's
slice of the join's gradient, or received from the stage after; the
gradient of its input goes to the stage before, or on stage 0 into the
tokens' gradient. Each stage's receive then meets the send of the stage
after it in one order, whatever order autograd would pick for ready
nodes.

Under FSDP (parallel/fsdp.py) a stage's blocks stay gathered from their
first microbatch's forward to their last microbatch's backward, which
alone reduce-scatters the gradients summed over the microbatches; the
blocks of other stages never run on this rank and stay sharded, as
`jit_pp(fsdp=True)` gathers each stage's slice only.

Storage keeps the canonical per-block layout (:25-31): every stage rank
holds every block, and after the backward the gradients of the blocks and
of everything before them (the adapters, the global tokens), which only
the stage that ran them has, are summed over the stage group
(`reduce_stage_gradients`), so the state updates identically on every
stage rank and checkpoints are the same as under any other layout.

Gloo sends only CPU tensors: on a gloo group a hop copies a CUDA tensor
through the host. That is the backend's property, not a fallback: the
blocks still run on the card. NCCL sends from the card; the join's
broadcast and the gradient sums run on CUDA tensors under either.

The checks are the JAX package's, with its messages: the depth divides
S, the global batch divides data x M, drop, attn_drop and drop_path are
zero in training, the blocks are homogeneous, and M >= 1 (default 2 S,
set by the CLI). PP excludes --model_parallel and --dcn_data_parallel
(the CLI).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from multimae_tpu_torch.parallel import mesh as mesh_lib


class Pipeline:
    """The stage group of one rank and the microbatch count."""

    def __init__(self, mesh, n_micro: int):
        if int(n_micro) < 1:
            raise ValueError(
                f"pipeline microbatch count must be >= 1, got {n_micro} "
                "(--pipeline_microbatches)")
        self.group = mesh.get_group(mesh_lib.STAGE_AXIS)
        self.ranks = mesh_lib.axis_ranks(mesh, mesh_lib.STAGE_AXIS)
        self.stage = mesh_lib.axis_rank(mesh, mesh_lib.STAGE_AXIS)
        self.n_stage = len(self.ranks)
        self.n_data = mesh.batch.size
        self.n_micro = int(n_micro)

    def _via_host(self, t: torch.Tensor) -> bool:
        return t.is_cuda and dist.get_backend(self.group) == "gloo"

    def send(self, t: torch.Tensor, stage: int) -> None:
        t = t.detach().contiguous()
        dist.send(t.cpu() if self._via_host(t) else t, dst=self.ranks[stage], group=self.group)

    def recv(self, like: torch.Tensor, stage: int) -> torch.Tensor:
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if self._via_host(like) else like.device)
        dist.recv(buf, src=self.ranks[stage], group=self.group)
        return buf.to(like.device)


def attach(model: nn.Module, mesh, n_micro: int) -> nn.Module:
    """Make `model.run_encoder` run its blocks as this pipeline (training
    and eval, not all-layers mode)."""
    model.pipeline = Pipeline(mesh, n_micro)
    return model


_CFG_FIELDS = ("num_heads", "mlp_ratio", "qkv_bias", "drop", "attn_drop", "dtype")


def _block_cfg(b) -> dict:
    return {"num_heads": b.num_heads, "mlp_ratio": b.mlp.fc1.weight.shape[0],
            "qkv_bias": b.qkv_bias, "drop": b.mlp.drop, "attn_drop": b.attn.attn_drop,
            "dtype": b.dtype}


def check(blocks, batch: int, pipe: Pipeline, train: bool) -> None:
    """The JAX package's checks (pp.py:116-157), with its messages."""
    depth = len(blocks)
    if depth % pipe.n_stage:
        raise ValueError(
            f"encoder depth {depth} not divisible by {pipe.n_stage} pipeline stages")
    if batch % pipe.n_micro:
        raise ValueError(
            f"global batch {batch * pipe.n_data} not divisible by data axis {pipe.n_data} x "
            f"{pipe.n_micro} microbatches")
    if train and any(b.mlp.drop or b.attn.attn_drop or b.drop_path_rate for b in blocks):
        raise ValueError(
            "pipeline parallelism requires drop/attn_drop/drop_path == 0 "
            "during training (got a nonzero rate)")
    first = _block_cfg(blocks[0])
    for i, b in enumerate(blocks[1:], start=1):
        cfg = _block_cfg(b)
        for f in _CFG_FIELDS:
            if cfg[f] != first[f]:
                raise ValueError(
                    f"pipeline parallelism requires homogeneous encoder "
                    f"blocks; block {i}.{f}={cfg[f]!r} != block 0.{f}={first[f]!r}")


def _accumulate(blocks, last: bool) -> None:
    """FSDP: gather the gradients of the microbatches on the blocks of this
    stage and reduce-scatter them (and free the gathered parameters) only
    after the `last` microbatch's backward."""
    from torch.distributed.fsdp import FSDPModule

    for blk in blocks:
        if isinstance(blk, FSDPModule):
            blk.set_requires_gradient_sync(last, recurse=False)
            blk.set_reshard_after_backward(last, recurse=False)


class _Schedule(torch.autograd.Function):
    """Forward: the last stage's outputs, joined along the batch, on every
    stage rank (a broadcast). Backward: the microbatches' backward in the
    order M-1, ..., 0 (see the module docstring); the tokens get their
    gradient on stage 0. `ins` and `outs` are each microbatch's input leaf
    and output on this stage, with their own graphs."""

    @staticmethod
    def forward(ctx, tokens, pipe, blocks, ins, outs):
        ctx.pipe, ctx.blocks, ctx.ins, ctx.outs = pipe, blocks, ins, outs
        last = pipe.stage == pipe.n_stage - 1
        full = torch.cat([y.detach() for y in outs]) if last else torch.empty_like(tokens)
        dist.broadcast(full, src=pipe.ranks[-1], group=pipe.group)
        return full

    @staticmethod
    def backward(ctx, g):
        pipe, ins, outs = ctx.pipe, ctx.ins, ctx.outs
        first, last = pipe.stage == 0, pipe.stage == pipe.n_stage - 1
        slices = g.split([y.shape[0] for y in outs]) if last else None
        token_grads = [None] * len(outs)
        for m in reversed(range(len(outs))):
            gy = slices[m] if last else pipe.recv(outs[m], pipe.stage + 1)
            _accumulate(ctx.blocks, last=m == 0)
            torch.autograd.backward(outs[m], gy)
            if first:
                token_grads[m] = ins[m].grad
            else:
                pipe.send(ins[m].grad, pipe.stage - 1)
        ctx.ins = ctx.outs = None
        return (torch.cat(token_grads) if first else None), None, None, None, None


def pipelined_encoder(blocks, tokens: torch.Tensor, pipe: Pipeline,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The blocks over the GPipe schedule; the last block's tokens on every
    stage rank."""
    train = blocks[0].training
    check(blocks, tokens.shape[0], pipe, train)
    per = len(blocks) // pipe.n_stage
    mine = blocks[pipe.stage * per:(pipe.stage + 1) * per]
    micro = tokens.detach().chunk(pipe.n_micro)
    first, last = pipe.stage == 0, pipe.stage == pipe.n_stage - 1
    grad = torch.is_grad_enabled()
    ins: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    for t in range(pipe.n_micro + pipe.n_stage - 1):
        m = t - pipe.stage
        if not 0 <= m < pipe.n_micro:
            continue  # a bubble: this stage has no microbatch at this tick
        x = micro[m] if first else pipe.recv(micro[m], pipe.stage - 1)
        x = x.detach().requires_grad_(grad)
        y = x
        for blk in mine:
            y = blk(y, generator)
        if not last:
            pipe.send(y, pipe.stage + 1)
        ins.append(x)
        outs.append(y)
    return _Schedule.apply(tokens, pipe, mine, ins, outs)


def reduce_stage_gradients(model: nn.Module, params) -> None:
    """Sum over the stage group the gradients that only the stage that ran
    them has: every model parameter outside the output adapters (a
    parameter another stage holds gets zeros here first). The output
    adapters' are equal on every stage rank already. `params` are the
    model's (name, parameter) pairs."""
    pipe = getattr(model, "pipeline", None)
    if pipe is None:
        return
    from multimae_tpu_torch.parallel.dist import all_reduce_flat
    from multimae_tpu_torch.parallel.fsdp import is_sharded

    grads = []
    for name, p in params:
        if name.startswith("output_adapters.") or not p.requires_grad:
            continue
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad.to_local() if is_sharded(p.grad) else p.grad)
    all_reduce_flat(grads, pipe.group)
