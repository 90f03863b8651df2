"""Fine-tuning steps (counterpart of multimae_tpu/train/finetune_step.py):
classification (:20-67; reference run_finetuning_cls.py:474-577) and
dense prediction (:70-137; reference run_finetuning_semseg.py:593-682).
Each runs the forward in training mode (drop_path and dropout drawing
from an explicit torch.Generator), the fp32 loss, backward, the global
gradient norm, optional clip, the skip on a non-finite norm, and the
update through TrainState (the optimizer with the schedules, and for the
classification step the EMA and the --update_freq accumulation).

The step updates the TrainState in place. Deciding the skip reads the
gradient norm on the host, one synchronisation per step. A parameter the
loss does not reach (the encoder blocks past a DPT head's last hook) gets
a zero gradient, as jax.grad gives it, so that the optimizer still
decays it and counts its step as the JAX optimizer does; torch's would
skip a parameter whose .grad is None.

Under torch.distributed each rank steps on its slice of the global batch
and the loss is the global batch's, as the JAX step's over a sharded
batch: one differentiable all_reduce sums each rank's loss (the cls
step's mean, over the world size) or its (numerator, denominator) (the
dense step's), and the gradients are then averaged over the ranks (the
mechanism of train/pretrain_step.py).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import torch

from torch.distributed.nn.functional import all_reduce as differentiable_all_reduce

from multimae_tpu_torch.parallel.dist import world_size
from multimae_tpu_torch.train.pretrain_step import average_gradients, global_norm
from multimae_tpu_torch.train.train_state import TrainState


def _finish_step(state: TrainState, loss: torch.Tensor, params, world: int,
                 clip_grad: Optional[float]) -> Dict[str, torch.Tensor]:
    """Backward from the global loss, the gradient mean over the ranks, the
    norm, the clip, the skip and the update; the step's metrics."""
    loss.backward()
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    if world > 1:
        average_gradients(grads, world)
    grad_norm = global_norm(grads)
    if clip_grad is not None:
        scale = torch.clamp(clip_grad / (grad_norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale)
    skip = not math.isfinite(float(grad_norm))
    state.apply_gradients(skip)
    return {"loss": loss.detach(), "grad_norm": grad_norm.detach(), "skipped": float(skip)}


def make_cls_train_step(model, loss_fn: Callable, *, clip_grad: Optional[float] = None):
    """Build train_step(state, batch, *, generator=None) -> metrics
    {"loss", "grad_norm", "skipped"}. The batch holds "rgb" (B, H, W, 3)
    and "target": class ids, or (B, classes) soft targets after mixup;
    loss_fn(logits, target) is the mean loss over the batch
    (train/cross_entropy.py). `generator` (on the batch's device) feeds
    drop_path and dropout."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
                   generator: Optional[torch.Generator] = None):
        params = state.parameters()
        for p in params:
            p.grad = None
        model.train()
        logits = model({"rgb": batch["rgb"]}, generator=generator)["cls"]
        loss = loss_fn(logits, batch["target"])
        world = world_size()
        if world > 1:
            loss = differentiable_all_reduce(loss) / world
        return _finish_step(state, loss, params, world, clip_grad)

    return train_step


def make_cls_eval_step(model):
    """Build eval_step(batch) -> (B, classes) logits, from the model in eval
    mode under inference_mode (the encoder blocks then take the K4 gate)."""

    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model({"rgb": batch["rgb"]})["cls"]

    return eval_step


def make_dense_train_step(model, task: str, loss_parts_fn: Callable,
                          in_domains: Sequence[str] = ("rgb",), *,
                          clip_grad: Optional[float] = None):
    """Build train_step(state, batch, *, generator=None) -> metrics
    {"loss", "grad_norm", "skipped"}. The batch holds the input
    modalities and "target" (and "mask_valid"); `generator` (on the
    batch's device) feeds drop_path and dropout. loss_parts_fn(pred,
    target) gives the loss as (sum, count), loss_parts_fn(pred, target,
    mask_valid=...) where the batch has a mask_valid (JAX :100-103): the
    loss is sum / max(count, 1) over the global batch."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], *,
                   generator: Optional[torch.Generator] = None):
        params = state.parameters()
        for p in params:
            p.grad = None
        model.train()
        inputs = {d: batch[d] for d in in_domains if d in batch}
        pred = model(inputs, generator=generator)[task]
        kwargs = {"mask_valid": batch["mask_valid"]} if "mask_valid" in batch else {}
        parts = torch.stack(loss_parts_fn(pred.float(), batch["target"], **kwargs))
        world = world_size()
        if world > 1:
            parts = differentiable_all_reduce(parts)
        return _finish_step(state, parts[0] / parts[1].clamp_min(1), params, world,
                            clip_grad)

    return train_step


def make_dense_eval_step(model, task: str, in_domains: Sequence[str] = ("rgb",)):
    """Build eval_step(batch) -> the task's pred, from the model in eval
    mode under inference_mode (the encoder blocks then take the K4 gate)."""

    def eval_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        model.eval()
        with torch.inference_mode():
            return model({d: batch[d] for d in in_domains if d in batch})[task]

    return eval_step
