"""Multi-task loss balancing (counterpart of
multimae_tpu/train/task_balancing.py; reference utils/task_balancing.py).

* NoWeightingStrategy: identity (the caller sums the losses).
* UncertaintyWeightingStrategy: learnable per-task log-variances s_i,
  weighted_i = exp(-s_i) * L_i + s_i, and 0 where L_i == 0 (a task
  dropped this step; reference :33-39). Its `log_vars` sit in their own
  module so the optimizer can give them their own LR scale.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn


class NoWeightingStrategy(nn.Module):
    def __init__(self, tasks: Sequence[str] = ()):
        super().__init__()
        self.tasks = tuple(tasks)

    def forward(self, task_losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return dict(task_losses)


class UncertaintyWeightingStrategy(nn.Module):
    def __init__(self, tasks: Sequence[str]):
        super().__init__()
        self.tasks = tuple(tasks)
        self.log_vars = nn.Parameter(torch.zeros(len(self.tasks)))

    def forward(self, task_losses: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for i, task in enumerate(self.tasks):
            loss = task_losses[task]
            weighted = torch.exp(-self.log_vars[i]) * loss + self.log_vars[i]
            out[task] = torch.where(loss != 0.0, weighted, torch.zeros_like(weighted))
        return out


def build_balancer(strategy: str, tasks: Sequence[str]) -> nn.Module:
    """`strategy` is "none" (the JAX pretrain CLI's default) or
    "uncertainty" (the flagship recipe)."""
    if strategy == "none":
        return NoWeightingStrategy(tasks)
    if strategy == "uncertainty":
        return UncertaintyWeightingStrategy(tasks)
    raise ValueError(f"Unknown loss balancing strategy: {strategy}")
