"""Weights & Biases image panels (counterpart of
multimae_tpu/utils/log_images.py; reference utils/log_images.py:31-138).

`wandb` is imported at the call, and the panels are skipped where it is
not installed. Arrays are NHWC (numpy, or torch tensors on any device).
The CLIs accept --log_images_wandb and, as the JAX CLIs, do not call
these functions.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from multimae_tpu_torch.utils.data_constants import (
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    SEG_IGNORE_INDEX,
)


def _wandb():
    try:
        import wandb

        return wandb
    except ImportError:
        return None


def _np(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def inv_norm(rgb) -> np.ndarray:
    """Undo the ImageNet normalisation: (H, W, 3) float -> uint8."""
    mean = np.asarray(IMAGENET_DEFAULT_MEAN, np.float32)
    std = np.asarray(IMAGENET_DEFAULT_STD, np.float32)
    x = np.clip(_np(rgb) * std + mean, 0, 1)
    return (x * 255).astype(np.uint8)


def log_semseg_wandb(rgb, seg_pred, seg_gt, class_names: Optional[Sequence[str]] = None,
                     prefix: str = "", step: Optional[int] = None):
    """Mask-overlay panels of up to 8 samples (reference log_images.py:31-82)."""
    wandb = _wandb()
    if wandb is None:
        return
    rgb, seg_pred, seg_gt = _np(rgb), _np(seg_pred), _np(seg_gt)
    valid = seg_gt != SEG_IGNORE_INDEX
    n_classes = (int(max(seg_pred.max(), seg_gt[valid].max()) + 1) if valid.any()
                 else int(seg_pred.max()) + 1)
    class_labels = {i: (class_names[i] if class_names and i < len(class_names) else str(i))
                    for i in range(n_classes)}
    class_labels[SEG_IGNORE_INDEX] = "ignore"
    images = []
    for i in range(min(len(rgb), 8)):
        images.append(wandb.Image(inv_norm(rgb[i]), masks={
            "predictions": {"mask_data": np.asarray(seg_pred[i], np.int32),
                            "class_labels": class_labels},
            "ground_truth": {"mask_data": np.asarray(seg_gt[i], np.int32),
                             "class_labels": class_labels}}))
    wandb.log({f"{prefix}semseg": images}, step=step)


def log_taskonomy_wandb(inputs: Dict, preds: Dict, gts: Dict, prefix: str = "",
                        step: Optional[int] = None):
    """Input, prediction and ground-truth panels of up to 4 samples per task
    (reference log_images.py:85-138): rgb un-normalised, other tasks
    stretched between their 2nd and 98th percentiles."""
    wandb = _wandb()
    if wandb is None:
        return

    def to_img(task, arr):
        arr = np.asarray(arr, np.float32)
        if task == "rgb":
            return inv_norm(arr)
        arr = arr[..., 0] if arr.ndim == 3 else arr
        lo, hi = np.percentile(arr, [2, 98])
        arr = np.clip((arr - lo) / max(hi - lo, 1e-6), 0, 1)
        return (arr * 255).astype(np.uint8)

    def panel(task, arr):
        arr = _np(arr)
        return [wandb.Image(to_img(task, arr[i])) for i in range(min(len(arr), 4))]

    panels = {}
    for task, arr in inputs.items():
        panels[f"{prefix}input_{task}"] = panel(task, arr)
    for task in preds:
        panels[f"{prefix}pred_{task}"] = panel(task, preds[task])
        if task in gts:
            panels[f"{prefix}gt_{task}"] = panel(task, gts[task])
    wandb.log(panels, step=step)
