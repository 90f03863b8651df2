"""The MultiMAE pretraining step (counterpart of
multimae_tpu/train/pretrain_step.py; reference
run_pretraining_multimae.py:458-578): truncated depth standardisation,
masking (fixed `task_masks` or drawn from a torch.Generator), the masked
forward, fp32 per-task losses with the norm_rgb target, loss balancing,
backward, global-norm clip and skip, and the AdamW update.

The step updates the TrainState in place. Deciding the skip reads the
gradient norm on the host, one synchronisation per step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch

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


def make_pretrain_train_step(
    model,
    balancer,
    tasks_loss_fn: Dict[str, Callable],
    *,
    num_encoded_tokens: int = 98,
    clip_grad: Optional[float] = None,
    skip_grad: Optional[float] = None,
):
    """Build train_step(state, batch, *, generator=None, task_masks=None)
    -> metrics, with the pretraining recipe's fixed settings: depth
    standardised, alphas 1, losses on the masked tokens, and the norm_rgb
    target (the RGB image, RGB's mask) wherever the model predicts it.
    `task_masks` ({task: (B, N_task) 0/1}) fixes the masks; otherwise they
    are drawn from `generator`, which lies on the batch's device."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
                   generator: Optional[torch.Generator] = None,
                   task_masks: Optional[Dict[str, torch.Tensor]] = None):
        params = state.parameters()
        for p in params:
            p.grad = None
        model.train()

        tasks = dict(batch)
        if "depth" in tasks:
            tasks["depth"] = standardize_depth(tasks["depth"])
        preds, masks = model(tasks, num_encoded_tokens=num_encoded_tokens,
                             task_masks=task_masks, generator=generator)
        masks = dict(masks)
        if "norm_rgb" in preds:
            tasks["norm_rgb"], masks["norm_rgb"] = tasks["rgb"], masks.get("rgb")
        task_losses = {t: tasks_loss_fn[t](pred.float(), tasks[t], mask=masks.get(t))
                       for t, pred in preds.items()}
        weighted = balancer(task_losses)
        sum(weighted.values()).backward()

        grads = [p.grad for p in params if p.grad is not None]
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
