"""Dense regression losses and the NYUv2 depth metrics (counterpart of
multimae_tpu/train/regression_losses.py; reference
run_finetuning_depth.py:49-117).

NHWC tensors; a (B, H, W, 1) `mask_valid` broadcasts over the channels.
Each loss comes in two forms: `masked_*_loss_parts` gives the (sum,
count) the dense step reduces over the global batch
(train/finetune_step.py; the loss is sum / max(count, 1)), and
`masked_*_loss` that quotient for one process's batch. berhu's threshold
c = max(0.2 * max|diff|, 1e-5) is taken over the whole global batch, as
the JAX step takes it over its sharded batch: under several processes the
max is all-reduced first. It carries no gradient (JAX's stop_gradient).
Zeroing an invalid pixel's diff leaves berhu's L2 branch at c / 2 there,
so the invalid pixels are masked out a second time, as in the JAX
function.

`masked_nyu_metrics` keeps two JAX-package quirks for parity: its `log10`
is the RMS of a natural-log difference, and the CLI averages it (like
every metric) over batches weighted by their size, not by their valid
pixels.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from multimae_tpu_torch.parallel.dist import world_size
from multimae_tpu_torch.utils.data_constants import NYU_MEAN, NYU_STD

Parts = Tuple[torch.Tensor, torch.Tensor]


def _prep_mask(preds: torch.Tensor, mask_valid: Optional[torch.Tensor]) -> torch.Tensor:
    """`mask_valid` as a bool mask of preds' shape (JAX :17-23)."""
    if mask_valid is None:
        return torch.ones_like(preds, dtype=torch.bool)
    mask = mask_valid
    if mask.shape[-1] != preds.shape[-1]:
        mask = mask.repeat_interleave(preds.shape[-1] // mask.shape[-1], dim=-1)
    return mask.bool()


def _parts(loss: torch.Tensor, mask: torch.Tensor) -> Parts:
    return torch.where(mask, loss, 0.0).sum(), mask.sum().to(loss.dtype)


def masked_mse_loss_parts(preds, target, mask_valid=None) -> Parts:
    mask = _prep_mask(preds, mask_valid)
    return _parts((preds - target) ** 2, mask)


def masked_l1_loss_parts(preds, target, mask_valid=None) -> Parts:
    mask = _prep_mask(preds, mask_valid)
    return _parts((preds - target).abs(), mask)


def masked_berhu_loss_parts(preds, target, mask_valid=None) -> Parts:
    mask = _prep_mask(preds, mask_valid)
    diff = torch.where(mask, preds - target, 0.0)
    abs_diff = diff.abs()
    peak = abs_diff.detach().max()
    if world_size() > 1:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    c = torch.clamp(peak * 0.2, min=1e-5)
    berhu = torch.where(abs_diff < c, abs_diff, (diff.square() + c ** 2) / 2.0 / c)
    return _parts(berhu, mask)


def _quotient(parts: Parts) -> torch.Tensor:
    return parts[0] / parts[1].clamp_min(1)


def masked_mse_loss(preds, target, mask_valid=None) -> torch.Tensor:
    return _quotient(masked_mse_loss_parts(preds, target, mask_valid))


def masked_l1_loss(preds, target, mask_valid=None) -> torch.Tensor:
    return _quotient(masked_l1_loss_parts(preds, target, mask_valid))


def masked_berhu_loss(preds, target, mask_valid=None) -> torch.Tensor:
    return _quotient(masked_berhu_loss_parts(preds, target, mask_valid))


def masked_nyu_metrics(preds: torch.Tensor, target: torch.Tensor,
                       mask_valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """rmse, rel, srel, log10, delta_1-3 over the valid pixels of one batch,
    after undoing the NYU standardisation (JAX :54-81; reference :86-117)."""
    preds = preds * NYU_STD + NYU_MEAN
    target = target * NYU_STD + NYU_MEAN
    mask = _prep_mask(preds, mask_valid)
    n = mask.sum().clamp_min(1).to(preds.dtype)

    def mean(v):
        return torch.where(mask, v, 0.0).sum() / n

    diff = torch.where(mask, (preds - target).abs(), 0.0)
    tgt_c, prd_c = target.clamp_min(1e-6), preds.clamp_min(1e-6)
    max_rel = torch.maximum(preds / tgt_c, target / prd_c)
    log_diff = torch.where(mask, prd_c.log() - tgt_c.log(), 0.0)
    return {"rmse": (diff.square().sum() / n).sqrt(),
            "rel": mean(diff / tgt_c),
            "srel": mean(diff ** 2 / tgt_c),
            "log10": (log_diff.square().sum() / n).sqrt(),
            "delta_1": mean((max_rel < 1.25).to(preds.dtype)),
            "delta_2": mean((max_rel < 1.25 ** 2).to(preds.dtype)),
            "delta_3": mean((max_rel < 1.25 ** 3).to(preds.dtype))}


LOSS_PARTS = {
    "mse": masked_mse_loss_parts,
    "l1": masked_l1_loss_parts,
    "berhu": masked_berhu_loss_parts,
}
