"""The MultiMAE pretraining step (counterpart of
multimae_tpu/train/pretrain_step.py; reference
run_pretraining_multimae.py:458-578): truncated depth standardisation,
masking (fixed `task_masks` or drawn from a torch.Generator), the masked
forward, fp32 per-task losses with the norm_rgb target, loss balancing,
backward, global-norm clip and skip, and the AdamW update.

The step updates the TrainState in place. Deciding the skip reads the
gradient norm on the host, one synchronisation per step.

Under torch.distributed each rank steps on its slice of the global batch
and the step computes the JAX step's result, the loss of the global batch:
  1. each task loss gives its numerator and denominator (criterion.py
     `parts`: a masked loss averages over the samples whose mask is not
     empty, and that count differs between ranks);
  2. one differentiable all_reduce sums them, so every rank holds the
     global per-task losses, and the balancer (whose log-variance terms
     must count once) weights those;
  3. the backward of that all_reduce sums each rank's upstream gradient,
     so a rank's parameter gradients are world_size times its share, and
     one all_reduce per dtype over the flattened gradients, divided by
     world_size, gives the global batch's gradients on every rank;
  4. the grad norm, the clip and the skip follow, the same on every rank.

Under a mesh (parallel/mesh.py) the sums and the mean run over the data
group, the ranks that hold different samples, and not the world:
  * pipeline parallelism first sums over the stage group the gradients
    that only the stage that ran them has (parallel/pp.py);
  * tensor parallelism averages over the model group the gradients of
    what every rank holds whole (parallel/tp.py);
  * FSDP's reduce-scatter has already averaged the gradients it manages
    over the data group (parallel/fsdp.py); the mean covers the rest;
  * the grad norm counts every element once (`parallel_global_norm`):
    FSDP's shards and tensor parallelism's pieces are summed over their
    ranks, the frozen pos-embs' gradients included, as the JAX step's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.nn.functional import all_reduce as differentiable_all_reduce

from multimae_tpu_torch.models.criterion import ratio
from multimae_tpu_torch.parallel import tp
from multimae_tpu_torch.parallel.dist import all_reduce_flat, batch_layout
from multimae_tpu_torch.parallel.fsdp import is_sharded, shard_count
from multimae_tpu_torch.parallel.pp import reduce_stage_gradients

from multimae_tpu_torch.train.train_state import TrainState


def standardize_depth(depth: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Truncated per-sample standardisation of NHWC depth: drop the bottom
    and top 10% of values, standardise by the middle 80%'s mean and
    unbiased variance (reference run_pretraining_multimae.py:488-492; the
    JAX package's method='sort')."""
    b = depth.shape[0]
    flat = depth.reshape(b, -1).float()
    n = flat.shape[1]
    trunc = torch.sort(flat, dim=1).values[:, int(0.1 * n):int(0.9 * n)]
    mean = trunc.mean(dim=1).reshape(b, 1, 1, 1)
    var = trunc.var(dim=1, unbiased=True).reshape(b, 1, 1, 1)
    return ((depth - mean) / torch.sqrt(var + eps)).to(depth.dtype)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(torch.sum(t.float() ** 2) for t in tensors))


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's elements of a gradient (an FSDP DTensor's local shard)."""
    return t.to_local() if is_sharded(t) else t


def parallel_global_norm(model, named_grads) -> torch.Tensor:
    """The global norm of (name, gradient) pairs whose tensors may be FSDP
    shards or tensor-parallel pieces: each rank's sum of squares, weighted
    by 1 / the number of ranks that hold the same elements, summed over
    the world in fp64. Without either it is `global_norm` of the local
    gradients, which are then whole and equal on every rank."""
    named_grads = list(named_grads)
    if not any(is_sharded(g) or tp.split_kind(model, n) for n, g in named_grads):
        return global_norm([g for _, g in named_grads])
    world = dist.get_world_size()
    tp_size = tp.model_tp(model)[2] if tp.model_tp(model) else 1
    total = torch.zeros((), dtype=torch.float64, device=local(named_grads[0][1]).device)
    for n, g in named_grads:
        holders = world // (shard_count(g) if is_sharded(g) else 1)
        holders //= tp_size if tp.split_kind(model, n) else 1
        total += torch.sum(local(g).float() ** 2).double() / holders
    dist.all_reduce(total)
    return torch.sqrt(total).float()


def make_pretrain_train_step(
    model,
    balancer,
    tasks_loss_fn: Dict[str, Callable],
    *,
    num_encoded_tokens: int = 98,
    in_domains: Sequence[str] = ("rgb", "depth", "semseg"),
    alphas=1.0,
    sample_tasks_uniformly: bool = False,
    standardize_depth_flag: bool = True,
    extra_norm_pix_loss: bool = True,
    loss_on_unmasked: bool = False,
    clip_grad: Optional[float] = None,
    skip_grad: Optional[float] = None,
):
    """Build train_step(state, batch, *, generator=None, task_masks=None)
    -> metrics. The flags are the JAX step's (its :92-104): the inputs are
    the batch's `in_domains`; masks follow the Dirichlet(alphas) task
    proportions (or `sample_tasks_uniformly`); depth is standardised where
    `standardize_depth_flag`; with `extra_norm_pix_loss` the norm_rgb
    target is the RGB image under RGB's mask; `loss_on_unmasked` takes
    every loss over all tokens. `task_masks` ({task: (B, N_task) 0/1})
    fixes the masks; otherwise they are drawn from `generator`, which lies
    on the batch's device. Each loss object in `tasks_loss_fn` has `parts`
    (models/criterion.py)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
                   generator: Optional[torch.Generator] = None,
                   task_masks: Optional[Dict[str, torch.Tensor]] = None):
        for p in state.parameters():
            p.grad = None
        model.train()

        tasks = dict(batch)
        if standardize_depth_flag and "depth" in tasks:
            tasks["depth"] = standardize_depth(tasks["depth"])
        inputs = {t: v for t, v in tasks.items() if t in in_domains}
        preds, masks = model(inputs, num_encoded_tokens=num_encoded_tokens, alphas=alphas,
                             sample_tasks_uniformly=sample_tasks_uniformly,
                             task_masks=task_masks, generator=generator)
        masks = dict(masks)
        if extra_norm_pix_loss:
            tasks["norm_rgb"], masks["norm_rgb"] = tasks["rgb"], masks.get("rgb")
        parts = {t: tasks_loss_fn[t].parts(
                     pred.float(), tasks[t], mask=None if loss_on_unmasked else masks.get(t))
                 for t, pred in preds.items()}
        group, _, world = batch_layout(model)
        if world > 1:
            summed = differentiable_all_reduce(
                torch.stack([x for p in parts.values() for x in p]),
                group=dist.group.WORLD if group is None else group)
            parts = {t: (summed[2 * i], summed[2 * i + 1]) for i, t in enumerate(parts)}
        task_losses = {t: ratio(*p) for t, p in parts.items()}
        weighted = balancer(task_losses)
        sum(weighted.values()).backward()

        named = state.named_parameters()
        reduce_stage_gradients(model, model.named_parameters())
        tp.sync_replicated_gradients(model, named)
        named_grads = [(n, p.grad) for n, p in named if p.grad is not None]
        grads = [local(g) for _, g in named_grads]
        if world > 1:
            all_reduce_flat([g for _, g in named_grads if not is_sharded(g)], group, divide=world)
        grad_norm = parallel_global_norm(model, named_grads)
        if clip_grad is not None:
            scale = torch.clamp(clip_grad / (grad_norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(scale)
        norm = float(grad_norm)
        skip = not math.isfinite(norm) or (skip_grad is not None and norm >= skip_grad)
        state.apply_gradients(skip)

        metrics = {"loss": sum(task_losses.values()).detach(),
                   "grad_norm": grad_norm.detach(), "skipped": float(skip)}
        for t, v in task_losses.items():
            metrics[f"{t}_loss"] = v.detach()
        for t, v in weighted.items():
            metrics[f"{t}_loss_weighted"] = v.detach()
        return metrics

    return train_step
