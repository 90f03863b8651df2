"""FSDP (ZeRO-3) over the mesh's "data" axis (counterpart of
multimae_tpu/parallel/fsdp.py).

FSDP2 (`torch.distributed.fsdp.fully_shard`) holds every parameter, and
so every AdamW moment, 1/n per rank, sharded on dim 0: one unit per
encoder block and per decoder, then the root for the rest (adapters,
global tokens). A unit's parameters are gathered for its forward and its
backward, and their gradients reduce-scattered after. On a hybrid mesh
FSDP takes the 2-D ("dcn", "data") sub-mesh: replicated over dcn, sharded
over data (HSDP), so the parameter gathers stay inside one host, as
fsdp.py:14-17 keeps them on ICI.

The reduce-scatter averages over the ranks of the batch: it takes the
place of the data-parallel gradient mean of train/pretrain_step.py for
the parameters it manages. Each rank's gradient is already the data size
times its share of the global loss (the loss parts are all-reduced with a
differentiable sum), so the average is the global batch's gradient.
The gradient norm that drives clip and skip sums the shards
(train/pretrain_step.py); a checkpoint holds the full tensors
(train/train_state.py).

Under tensor parallelism the units hold the TP-local blocks, sharded over
the data sub-mesh of the (data, model) mesh (the JAX package's
`_add_fsdp_axis`). Under pipeline parallelism the units are the same, and
a stage's blocks stay gathered across its microbatches
(`reshard_after_forward=False`; parallel/pp.py reduce-scatters them after
the last microbatch's backward): a rank gathers only its own stage's
blocks, the slice `jit_pp(fsdp=True)` gathers in front of its shard_map.
The JAX package's per-leaf choice of the largest divisible axis and its
`min_size` are GSPMD layout choices with no counterpart.
"""

from __future__ import annotations

from torch import nn

from multimae_tpu_torch.parallel.mesh import fsdp_mesh


def apply_fsdp(model: nn.Module, mesh) -> nn.Module:
    """Shard `model` in place with FSDP2 over `mesh`'s batch axes: a unit
    per encoder block and per output adapter, then the root. Call after
    parallel/tp.shard_model and parallel/pp.attach, and before the
    optimizer is built."""
    from torch.distributed.fsdp import fully_shard

    sub = fsdp_mesh(mesh)
    piped = getattr(model, "pipeline", None) is not None
    for blk in model.encoder:
        fully_shard(blk, mesh=sub, reshard_after_forward=not piped)
    for adapter in (model.output_adapters or {}).values():
        fully_shard(adapter, mesh=sub)
    fully_shard(model, mesh=sub)
    return model


def is_sharded(t) -> bool:
    """True for an FSDP2 (DTensor) parameter, gradient or moment."""
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def shard_count(t) -> int:
    """Over how many ranks a DTensor's elements are split."""
    from torch.distributed.tensor import Shard

    n = 1
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            n *= t.device_mesh.size(i)
    return n
