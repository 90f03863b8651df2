"""Process groups for data parallelism (counterpart of the process half of
multimae_tpu/parallel/mesh.py :322-392; reference utils/dist.py:62-93).

`initialize_distributed` recognises the launchers the reference does and
turns each into one `torch.distributed.init_process_group` call:
  * env:// (torchrun and the like): RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT;
  * the reference's --dist_on_itp: OpenMPI's OMPI_COMM_WORLD_RANK,
    OMPI_COMM_WORLD_SIZE and OMPI_COMM_WORLD_LOCAL_RANK with MASTER_ADDR
    and MASTER_PORT;
  * SLURM: SLURM_PROCID, SLURM_NTASKS and SLURM_LOCALID, with MASTER_ADDR
    and MASTER_PORT (SLURM names no rendezvous address of its own).
Anything else, or a world of one process, is a single process: no group.
The backend is NCCL for the card and gloo for the CPU; on the card each
process takes the card of its local rank.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def _launcher(env) -> Optional[Tuple[str, int, int, int]]:
    """(launcher, rank, world size, local rank), or None outside a launcher."""
    if "RANK" in env and "WORLD_SIZE" in env:
        rank = int(env["RANK"])
        return "env", rank, int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", rank))
    if "OMPI_COMM_WORLD_RANK" in env:
        rank = int(env["OMPI_COMM_WORLD_RANK"])
        return ("openmpi", rank, int(env["OMPI_COMM_WORLD_SIZE"]),
                int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", rank)))
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        rank = int(env["SLURM_PROCID"])
        return "slurm", rank, int(env["SLURM_NTASKS"]), int(env.get("SLURM_LOCALID", rank))
    return None


def initialize_distributed(device: str = "cuda") -> bool:
    """Join the process group the launcher describes; True if one was
    joined (or already exists), False for a single process. On the card
    it also selects the card of this process's local rank."""
    if dist.is_available() and dist.is_initialized():
        return True
    found = _launcher(os.environ)
    if found is None or found[2] <= 1:
        return False
    kind, rank, world, local_rank = found
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"{kind} launch of {world} processes needs {var}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(local_rank)
    addr = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    print(f"| distributed init ({kind}, rank {rank} of {world}): {addr}", flush=True)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=addr,
                            world_size=world, rank=rank)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main_process() -> bool:
    """rank-0 gating (reference utils/dist.py:46-59)."""
    return process_index() == 0


def local_batch_slice(global_batch: int) -> slice:
    """This process's slice of a global batch."""
    per_rank = global_batch // world_size()
    start = process_index() * per_rank
    return slice(start, start + per_rank)


def sum_across_processes(t: torch.Tensor) -> torch.Tensor:
    """The element-wise sum of `t` over every process (`t` itself for one
    process): one all_reduce, on the card under NCCL, on the CPU under
    gloo. The counterpart of the JAX package's sum_across_processes
    (multimae_tpu/utils/metrics.py:90)."""
    if world_size() == 1:
        return t
    on_card = dist.get_backend() == "nccl"
    out = t.to("cuda" if on_card else "cpu").clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out.to(t.device)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()
