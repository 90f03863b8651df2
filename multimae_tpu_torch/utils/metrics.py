"""Evaluation metrics (counterpart of multimae_tpu/utils/metrics.py:19-60,
:90): top-k accuracy (reference utils/metrics.py:31-38), and for
segmentation (reference utils/semseg_metrics.py) a confusion matrix
counted on the device, summed over processes by
parallel/dist.sum_across_processes, with mIoU, pixel accuracy and mean
class accuracy from it."""

from __future__ import annotations

from typing import Dict, List, Sequence

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
