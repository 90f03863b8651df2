"""Evaluation metrics (counterpart of multimae_tpu/utils/metrics.py:19-90):
top-k accuracy (reference utils/metrics.py:31-38); for segmentation
(reference utils/semseg_metrics.py) a confusion matrix counted on the
device, summed over processes by parallel/dist.sum_across_processes, with
mIoU, pixel accuracy and mean class accuracy from it; and the depth
metrics on metric depths (reference run_finetuning_depth.py:86-117)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def accuracy(logits: torch.Tensor, targets: torch.Tensor,
             topk: Sequence[int] = (1,)) -> List[torch.Tensor]:
    """Top-k accuracy in percent, one fp32 scalar per k. The classes are
    ranked as the JAX function ranks them, by a stable ascending argsort
    reversed: of equal logits the higher class index comes first."""
    maxk = max(topk)
    order = torch.argsort(logits, dim=-1, stable=True).flip(-1)[:, :maxk]
    correct = order == targets.reshape(-1, 1)
    return [correct[:, :k].any(dim=1).float().mean() * 100.0 for k in topk]


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
                     ignore_index: int = 255) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts, rows = label, columns =
    pred, over the pixels whose label is not `ignore_index`. As in the JAX
    function, the flat index label * num_classes + pred is counted, and
    one at or past num_classes**2 (a void-class pred in the last row) is
    dropped."""
    n = num_classes * num_classes
    valid = label != ignore_index
    idx = (label[valid].long() * num_classes + pred[valid].long()).clamp_max(n)
    return torch.bincount(idx, minlength=n + 1)[:n].reshape(num_classes, num_classes)


def miou_from_confusion(cm) -> Dict[str, object]:
    """aAcc, mIoU, mAcc and the per-class IoU and Acc (mean_iou semantics
    of utils/semseg_metrics.py:107-141): classes absent from both label
    and pred are NaN and left out of the means."""
    cm = np.asarray(torch.as_tensor(cm).cpu(), np.float64)
    inter = np.diag(cm)
    union = cm.sum(axis=0) + cm.sum(axis=1) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = inter / union
        acc = inter / cm.sum(axis=1)
    return {"aAcc": float(inter.sum() / max(cm.sum(), 1)),
            "mIoU": float(np.nanmean(iou)), "mAcc": float(np.nanmean(acc)),
            "IoU": iou, "Acc": acc}


def depth_metrics(pred: torch.Tensor, target: torch.Tensor,
                  mask_valid: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """rmse, rel, srel, log10 (the mean |log10 difference|), delta_1-3 over
    the valid pixels of depths in metres (JAX :65-86); invalid pixels are
    set to 1 before the divisions and logs, so they stay finite."""
    if mask_valid is None:
        mask_valid = torch.ones_like(pred, dtype=torch.bool)
    mask_valid = mask_valid.bool()
    n = mask_valid.sum().clamp_min(1).to(pred.dtype)
    pred = torch.where(mask_valid, pred, 1.0)
    target = torch.where(mask_valid, target, 1.0)

    def mean(v):
        return torch.where(mask_valid, v, 0.0).sum() / n

    diff = pred - target
    ratio = torch.maximum(pred / target, target / pred)
    return {"rmse": mean(diff ** 2).sqrt(), "rel": mean(diff.abs() / target),
            "srel": mean(diff ** 2 / target),
            "log10": mean((pred.log10() - target.log10()).abs()),
            "delta_1": mean((ratio < 1.25).to(pred.dtype)),
            "delta_2": mean((ratio < 1.25 ** 2).to(pred.dtype)),
            "delta_3": mean((ratio < 1.25 ** 3).to(pred.dtype))}
