"""Device meshes over torch.distributed (counterpart of
multimae_tpu/parallel/mesh.py :40-135 and parallel/pp.py :67-80).

A mesh arranges the processes of the world, one device each, on named
axes:

  * "dcn"   - the leading axis of a hybrid mesh: plain data parallelism
              across hosts. Only the gradient reduction crosses it.
  * "data"  - batch sharding; FSDP shards parameters over this axis only
              (parallel/fsdp.py), so their gathers stay inside one host.
  * "model" - tensor parallelism (parallel/tp.py), innermost, so one
              Megatron group is adjacent ranks on one host.
  * "stage" - pipeline parallelism (parallel/pp.py), innermost.

The meshes are torch `DeviceMesh`es with those axis names. Each also
carries its batch layout (`batch_layout`, a parallel/dist.BatchLayout):
the group over ("dcn", "data"), the mesh's own group of that axis or the
two flattened, whose ranks hold different samples. `layout_model` gives
it to the model, whose steps' batch-wide sums follow it; the CLIs take
the loader's shards, the synthetic batch and the masks' seeds from it, so
the ranks of one model or stage group see the same samples and masks.

The JAX package places its parallelism with GSPMD: sharding annotations
on a jitted step. Its in-model layout hints (`use_constraint_mesh`,
`constrain_batch_sharded`, `constrain_tp`'s constraint, `data_shard_map`,
`bnhd_shard_map`) only keep GSPMD from replicating opaque kernels; here
every rank runs its kernels on its own samples and heads by construction,
and they have no counterpart. Nor has its sequence-parallel note
(:232-247), a dead end of GSPMD that was never shipped.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from multimae_tpu_torch.parallel import dist as dist_lib

DCN_AXIS = "dcn"
DATA_AXIS = "data"
MODEL_AXIS = "model"
STAGE_AXIS = "stage"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type(device) -> str:
    return torch.device(device).type


def _build(ranks: torch.Tensor, names: Sequence[str], device) -> DeviceMesh:
    mesh = DeviceMesh(_device_type(device), ranks, mesh_dim_names=tuple(names))
    batch = tuple(n for n in names if n in (DCN_AXIS, DATA_AXIS))
    sub = mesh[batch]._flatten() if len(batch) > 1 else mesh[batch[0]]
    rank = 0
    for axis in batch:  # the coordinate over the batch axes, dcn major
        rank = rank * axis_size(mesh, axis) + axis_rank(mesh, axis)
    mesh.batch = dist_lib.BatchLayout(sub.get_group(), rank, sub.size())
    return mesh


def create_mesh(data: Optional[int] = None, model: int = 1, device="cuda") -> DeviceMesh:
    """("data", "model") mesh over the world, "model" innermost."""
    n = _world()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return _build(torch.arange(n).reshape(data, model), (DATA_AXIS, MODEL_AXIS), device)


def host_key(env=os.environ, rank: Optional[int] = None) -> int:
    """This process's host, the analogue of the JAX package's slice_index /
    process_index (:84-99): torchrun's GROUP_RANK, else the rank over
    LOCAL_WORLD_SIZE, else 0 (one host visible)."""
    if "GROUP_RANK" in env:
        return int(env["GROUP_RANK"])
    if "LOCAL_WORLD_SIZE" in env:
        rank = int(env.get("RANK", 0)) if rank is None else rank
        return rank // int(env["LOCAL_WORLD_SIZE"])
    return 0


def order_by_host(keys: Sequence[int], dcn: Optional[int]) -> Tuple[List[int], int]:
    """(ranks grouped host by host, the dcn count) from every rank's host
    key, with the JAX package's checks: a discovered count must equal an
    explicit `dcn`, and the hosts must hold equal numbers of ranks. With one
    host visible the ranks stay in order and are cut into `dcn` contiguous
    groups by the caller."""
    groups: Dict[int, List[int]] = {}
    for r, k in enumerate(keys):
        groups.setdefault(k, []).append(r)
    ordered = [groups[k] for k in sorted(groups)]
    if dcn is None:
        dcn = len(ordered)
    if len(ordered) > 1:
        if len(ordered) != dcn:
            raise ValueError(
                f"--dcn_data_parallel {dcn} != {len(ordered)} discovered "
                f"slices/processes; the slice topology wins — pass the real "
                f"count (or omit it)")
        sizes = {len(g) for g in ordered}
        if len(sizes) != 1:
            raise ValueError(f"unequal slice sizes {sizes}")
        return [r for g in ordered for r in g], dcn
    return list(range(len(keys))), dcn


def create_hybrid_mesh(dcn: Optional[int] = None, data: Optional[int] = None,
                       model: int = 1, device="cuda", env=os.environ) -> DeviceMesh:
    """("dcn", "data", "model") mesh: the ranks grouped host by host
    (`host_key`, gathered from every rank) so that "data" and "model" stay
    inside one host and only "dcn" crosses hosts."""
    n = _world()
    keys = [host_key(env)] * n
    if dist.is_initialized() and n > 1:
        gathered: List[Optional[int]] = [None] * n
        dist.all_gather_object(gathered, host_key(env))
        keys = [int(k) for k in gathered]
    ranks, dcn = order_by_host(keys, dcn)
    if n % dcn:
        raise ValueError(f"{n} devices not divisible into {dcn} slices")
    if data is None:
        data = n // dcn // model
    if dcn * data * model != n:
        raise ValueError(f"mesh {dcn}x{data}x{model} != {n} devices")
    return _build(torch.tensor(ranks).reshape(dcn, data, model),
                  (DCN_AXIS, DATA_AXIS, MODEL_AXIS), device)


def create_pp_mesh(stage: int, data: Optional[int] = None, device="cuda") -> DeviceMesh:
    """("data", "stage") mesh, "stage" innermost (JAX pp.py:67-80)."""
    n = _world()
    if data is None:
        data = n // stage
    if data * stage != n:
        raise ValueError(f"mesh {data}x{stage} != {n} devices")
    return _build(torch.arange(n).reshape(data, stage), (DATA_AXIS, STAGE_AXIS), device)


def batch_axes(mesh: Optional[DeviceMesh]):
    """The axes a batch dim shards over: ("dcn", "data") on hybrid meshes,
    ("data",) otherwise."""
    if mesh is not None and DCN_AXIS in mesh.mesh_dim_names:
        return (DCN_AXIS, DATA_AXIS)
    return (DATA_AXIS,)


def axis_size(mesh: Optional[DeviceMesh], axis: str) -> int:
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh: Optional[DeviceMesh], axis: str) -> int:
    """This rank's coordinate on `axis`. On "data", "model" and "stage" it
    is also its rank in the axis group: the meshes list each host's ranks in
    ascending order, so those groups ascend along their axis (only "dcn"
    may run across hosts in another order)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def axis_ranks(mesh: DeviceMesh, axis: str) -> List[int]:
    """The global ranks of this rank's group on `axis`, in group order."""
    return dist.get_process_group_ranks(mesh.get_group(axis))


def batch_layout(mesh: Optional[DeviceMesh]) -> dist_lib.BatchLayout:
    """The mesh's batch layout; the world's for None (plain data
    parallelism)."""
    return dist_lib.world_layout() if mesh is None else mesh.batch


def fsdp_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The sub-mesh FSDP shards over: ("dcn", "data") on a hybrid mesh
    (replicated over dcn, sharded over data: HSDP), else ("data",)."""
    return mesh[batch_axes(mesh)]


def mesh_for_flags(*, fsdp: bool = False, model_parallel: int = 1,
                   pipeline_parallel: int = 1, dcn_data_parallel: int = 0,
                   device="cuda") -> Optional[DeviceMesh]:
    """The mesh the CLIs' flags ask for (JAX run_pretraining_multimae.py
    :382-420), or None for plain data parallelism. A single process without
    a group joins a group of one first."""
    if not (fsdp or model_parallel > 1 or pipeline_parallel > 1 or dcn_data_parallel):
        return None
    if not dist.is_initialized():
        dist_lib.init_single_process_group(device)
    if pipeline_parallel > 1:
        return create_pp_mesh(stage=pipeline_parallel, device=device)
    if dcn_data_parallel:
        return create_hybrid_mesh(dcn=None if dcn_data_parallel < 0 else dcn_data_parallel,
                                  model=model_parallel, device=device)
    return create_mesh(model=model_parallel, device=device)


def layout_model(model, mesh: Optional[DeviceMesh], *, fsdp: bool = False,
                 n_micro: int = 0):
    """Lay `model` out on `mesh`, in place, before its optimizer is built:
    the mesh's batch layout, which its steps' sums follow, tensor
    parallelism over "model" (parallel/tp.py), the pipeline over "stage"
    with `n_micro` microbatches (parallel/pp.py), then FSDP over the batch
    axes (parallel/fsdp.py). Returns the model; a None mesh leaves it as it
    is (its steps sum over the world)."""
    if mesh is None:
        return model
    model.batch_layout = mesh.batch
    from multimae_tpu_torch.parallel import fsdp as fsdp_lib, pp, tp

    k = axis_size(mesh, MODEL_AXIS)
    if k > 1:
        tp.shard_model(model, mesh.get_group(MODEL_AXIS), axis_rank(mesh, MODEL_AXIS), k)
    if n_micro:
        pp.attach(model, mesh, n_micro)
    if fsdp:
        fsdp_lib.apply_fsdp(model, mesh)
    return model
