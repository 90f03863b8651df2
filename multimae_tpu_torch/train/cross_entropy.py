"""Classification losses (counterpart of multimae_tpu/train/cross_entropy.py;
reference utils/cross_entropy.py:17-43), on fp32 log-probabilities."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def label_smoothing_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    """Integer targets with label smoothing: (1 - s) NLL + s mean(-log p)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.long().unsqueeze(-1)).squeeze(-1)
    smooth = -logp.mean(dim=-1)
    return ((1.0 - smoothing) * nll + smoothing * smooth).mean()


def soft_target_cross_entropy(logits: torch.Tensor, soft_targets: torch.Tensor) -> torch.Tensor:
    """Soft (mixup) targets."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return torch.sum(-soft_targets.float() * logp, dim=-1).mean()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return label_smoothing_cross_entropy(logits, targets, smoothing=0.0)
