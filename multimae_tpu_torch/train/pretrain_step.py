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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.nn.functional import all_reduce as differentiable_all_reduce

from multimae_tpu_torch.models.criterion import ratio
from multimae_tpu_torch.parallel.dist import world_size

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


def average_gradients(grads: Sequence[torch.Tensor], world: int) -> None:
    """Replace each gradient by its mean over the ranks: one all_reduce per
    dtype over the gradients flattened into one buffer."""
    by_dtype: Dict[torch.dtype, list] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for group in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in group])
        dist.all_reduce(flat)
        flat /= world
        offset = 0
        for g in group:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


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
        params = state.parameters()
        for p in params:
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
        world = world_size()
        if world > 1:
            summed = differentiable_all_reduce(torch.stack([x for p in parts.values() for x in p]))
            parts = {t: (summed[2 * i], summed[2 * i + 1]) for i, t in enumerate(parts)}
        task_losses = {t: ratio(*p) for t, p in parts.items()}
        weighted = balancer(task_losses)
        sum(weighted.values()).backward()

        grads = [p.grad for p in params if p.grad is not None]
        if world > 1:
            average_gradients(grads, world)
        grad_norm = global_norm(grads)
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
