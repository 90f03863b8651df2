"""Train state (counterpart of multimae_tpu/train/train_state.py :14-64):
the model, the loss balancer (None for fine-tuning), the optimizer and
the LR/WD schedule arrays, updated in place.

A skipped update leaves the parameters and the whole optimizer state
unchanged, the optimizer's own step counts included, while `step` still
advances, as the JAX state does. The schedules are therefore indexed by
`updates`, the count of applied updates (JAX indexes them by the optax
counts, which a skip does not advance), clamped at their last entry.
`state_dict` / `load_state_dict` carry all of it for a checkpoint
(train/checkpoint.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn


class TrainState:
    def __init__(self, model: nn.Module, balancer: Optional[nn.Module],
                 optimizer: torch.optim.Optimizer, lr_values: np.ndarray,
                 wd_values: Optional[np.ndarray] = None):
        self.model = model
        self.balancer = balancer
        self.optimizer = optimizer
        self.lr_values = np.asarray(lr_values, np.float32)
        self.wd_values = None if wd_values is None else np.asarray(wd_values, np.float32)
        self.step = 0      # steps taken, skipped ones included
        self.updates = 0   # updates applied

    def parameters(self) -> List[torch.Tensor]:
        """Every model and balancer parameter, in a fixed order."""
        extra = [] if self.balancer is None else list(self.balancer.parameters())
        return list(self.model.parameters()) + extra

    def apply_gradients(self, skip: bool) -> None:
        """One optimizer update from the parameters' .grad, unless `skip`."""
        if not skip:
            i = min(self.updates, len(self.lr_values) - 1)
            for group in self.optimizer.param_groups:
                group["lr"] = float(self.lr_values[i]) * group["lr_scale"]
                if self.wd_values is not None:
                    group["weight_decay"] = float(self.wd_values[i]) * group["wd_flag"]
            self.optimizer.step()
            self.updates += 1
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        """The model's, the balancer's and the optimizer's state_dicts and the
        step counters, in the reference checkpoint's key names."""
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "loss_balancer": None if self.balancer is None else self.balancer.state_dict(),
                "step": self.step, "updates": self.updates}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore what state_dict() saved (strict: every key and shape)."""
        self.model.load_state_dict(state["model"], strict=True)
        if self.balancer is not None:
            self.balancer.load_state_dict(state["loss_balancer"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.updates = int(state["updates"])
