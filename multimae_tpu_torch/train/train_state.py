"""Train state (counterpart of multimae_tpu/train/train_state.py): the
model, the loss balancer (None for fine-tuning), the optimizer, the LR/WD
schedule arrays, and for the classification fine-tune the parameter EMA
and gradient accumulation; updated in place.

A skipped update leaves the parameters and the whole optimizer state
unchanged, the optimizer's own step counts included, while `step` still
advances, as the JAX state does. The schedules are therefore indexed by
`updates`, the count of applied updates (JAX indexes them by the optax
counts, which a skip does not advance), clamped at their last entry.

* `update_freq` > 1 accumulates as optax.MultiSteps does (the JAX cls
  CLI's --update_freq): each step that is not skipped folds its gradients
  into their running mean, acc + (g - acc) / (n + 1), and every
  `update_freq`-th such step applies the mean and starts again from zero.
* `ema_decay` keeps an fp32 EMA of every model parameter on the model's
  device (the JAX TrainState's `ema_params`): after each step that is not
  skipped, ema = ema * decay + p * (1 - decay). The JAX state blends
  after skipped steps too (towards the unchanged parameters); here a
  skipped step leaves the EMA as it was.
* `HostEMA` is the same EMA in host memory (--model_ema_force_cpu, JAX
  :67-97), for a caller to update after each step.

`state_dict` / `load_state_dict` carry all of it for a checkpoint
(train/checkpoint.py); the EMA as `ema_params`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn


def _ema_blend(ema: List[torch.Tensor], params: List[torch.Tensor], decay: float) -> None:
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)


def _load_ema(ema: Dict[str, torch.Tensor], saved: Dict[str, Any]) -> None:
    if set(saved) != set(ema):
        raise ValueError(f"ema_params: keys differ from the model's "
                         f"({sorted(set(ema) ^ set(saved))[:5]})")
    for k, v in ema.items():
        v.copy_(torch.as_tensor(saved[k]).reshape(v.shape))


class HostEMA:
    """The parameter EMA in host memory: fp32 CPU copies of every model
    parameter, blended from the model's parameters by `update` (a copy to
    the host per call)."""

    def __init__(self, model: nn.Module, decay: float):
        self.decay = float(decay)
        self.params = {n: p.detach().to("cpu", torch.float32, copy=True)
                       for n, p in model.named_parameters()}
        self._names = list(self.params)
        self._model = model

    @torch.no_grad()
    def update(self) -> None:
        live = dict(self._model.named_parameters())
        host = [live[n].detach().to("cpu", torch.float32) for n in self._names]
        _ema_blend([self.params[n] for n in self._names], host, self.decay)

    def load(self, saved: Dict[str, Any]) -> None:
        _load_ema(self.params, saved)


class TrainState:
    def __init__(self, model: nn.Module, balancer: Optional[nn.Module],
                 optimizer: torch.optim.Optimizer, lr_values: np.ndarray,
                 wd_values: Optional[np.ndarray] = None, *, update_freq: int = 1,
                 ema_decay: Optional[float] = None):
        if update_freq < 1:
            raise ValueError(f"update_freq {update_freq} < 1")
        self.model = model
        self.balancer = balancer
        self.optimizer = optimizer
        self.lr_values = np.asarray(lr_values, np.float32)
        self.wd_values = None if wd_values is None else np.asarray(wd_values, np.float32)
        self.step = 0      # steps taken, skipped ones included
        self.updates = 0   # updates applied
        self.update_freq = update_freq
        self.mini_step = 0  # steps folded into grad_accum since the last update
        self.grad_accum: Optional[List[torch.Tensor]] = None
        self.ema_decay = ema_decay
        self.ema: Optional[Dict[str, torch.Tensor]] = None
        if ema_decay is not None:
            self.ema = {n: p.detach().to(torch.float32, copy=True)
                        for n, p in model.named_parameters()}

    def parameters(self) -> List[torch.Tensor]:
        """Every model and balancer parameter, in a fixed order."""
        extra = [] if self.balancer is None else list(self.balancer.parameters())
        return list(self.model.parameters()) + extra

    def _optimized(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def _accumulate(self) -> bool:
        """Fold the .grad of the optimized parameters into their running
        mean; True when this step completes `update_freq` of them, with the
        mean put in .grad for the update."""
        params = self._optimized()
        if self.grad_accum is None:
            self.grad_accum = [torch.zeros_like(p) for p in params]
        n = self.mini_step
        with torch.no_grad():
            for acc, p in zip(self.grad_accum, params):
                if p.grad is not None:
                    acc.add_((p.grad - acc) / (n + 1))
        self.mini_step += 1
        if self.mini_step < self.update_freq:
            return False
        for acc, p in zip(self.grad_accum, params):
            p.grad = acc.clone()
            acc.zero_()
        self.mini_step = 0
        return True

    def apply_gradients(self, skip: bool) -> None:
        """One optimizer update from the parameters' .grad (or one
        accumulation step), then the EMA blend, unless `skip`."""
        if not skip:
            if self.update_freq == 1 or self._accumulate():
                i = min(self.updates, len(self.lr_values) - 1)
                for group in self.optimizer.param_groups:
                    group["lr"] = float(self.lr_values[i]) * group["lr_scale"]
                    if self.wd_values is not None:
                        group["weight_decay"] = float(self.wd_values[i]) * group["wd_flag"]
                self.optimizer.step()
                self.updates += 1
            if self.ema is not None:
                named = dict(self.model.named_parameters())
                with torch.no_grad():
                    _ema_blend(list(self.ema.values()),
                               [named[n].detach().float() for n in self.ema], self.ema_decay)
        self.step += 1

    def state_dict(self) -> Dict[str, Any]:
        """The model's, the balancer's and the optimizer's state_dicts and the
        step counters, in the reference checkpoint's key names; the EMA
        (`ema_params`) and the accumulation where they are kept."""
        out = {"model": self.model.state_dict(),
               "optimizer": self.optimizer.state_dict(),
               "loss_balancer": None if self.balancer is None else self.balancer.state_dict(),
               "step": self.step, "updates": self.updates}
        if self.ema is not None:
            out["ema_params"] = self.ema
        if self.update_freq > 1:
            out["mini_step"] = self.mini_step
            out["grad_accum"] = self.grad_accum
        return out

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore what state_dict() saved (strict: every key and shape). A
        save without an EMA starts the EMA from the restored parameters."""
        self.model.load_state_dict(state["model"], strict=True)
        if self.balancer is not None:
            self.balancer.load_state_dict(state["loss_balancer"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self.updates = int(state["updates"])
        if self.ema is not None:
            if state.get("ema_params") is not None:
                _load_ema(self.ema, state["ema_params"])
            else:
                for n, p in self.model.named_parameters():
                    self.ema[n].copy_(p.detach())
        if self.update_freq > 1:
            self.mini_step = int(state.get("mini_step", 0))
            saved = state.get("grad_accum")
            self.grad_accum = None if saved is None else [
                torch.as_tensor(a).to(p.device) for a, p in zip(saved, self._optimized())]
