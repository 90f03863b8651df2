"""The optimizers with the reference's parameter groups (counterpart of
multimae_tpu/train/optim_factory.py :34-82, :127-239; reference
utils/optim_factory.py): AdamW, Adam, and SGD with momentum.

* Frozen parameters (the fixed sin-cos `pos_emb`s) get no update and no
  decay: they are left out of the optimizer (:53-57), unless
  learnable_pos_emb is set (the fine-tune CLIs' flag), which trains them
  without decay.
* With filter_bias_and_bn=False, the pretraining setting, every other
  model parameter is in one flat group with LR scale 1 and decay on,
  biases, LayerNorms, `mask_token` and `global_tokens` included: the
  reference's dict-model quirk (:163-166).
* With filter_bias_and_bn=True, 1-D parameters, biases and the model's
  no_weight_decay() set (`default_no_decay`, :34-50) are not decayed.
* With a LayerDecayValueAssigner (fine-tuning), each of those groups is
  split by layer, `layer_{id}_{decay|no_decay}`, with LR scale
  values[id]: input adapters and global tokens are layer 0, encoder
  block i is layer i + 1, everything else (the heads) the last (:60-82,
  :170-178).
* The balancer's parameters form their own group with
  `balancer_lr_scale`; they are decayed exactly when
  filter_bias_and_bn is False (:160-162).

Each param group carries `lr_scale` and `wd_flag`; TrainState sets the
group's `lr` and `weight_decay` from the schedules before each update.
torch's AdamW applies the decoupled decay p * (1 - lr * wd) before the
Adam step, the same update as the JAX package's optax chain
(scale_by_adam, + wd * p, * -lr; :89-124). The others follow the JAX
chains (:222-239), not torch's own optimizers:
* `adam`: scale_by_adam and the LR only. The JAX package leaves the
  weight decay out (torch's Adam would add an L2 term to the gradient,
  and no recipe sets adam with decay), so every group's wd_flag is 0.
* `sgd` and `nesterov` (Nesterov momentum, as timm's `sgd`) and
  `momentum` (heavy ball): `TraceSGD`, optax.trace, then the decoupled
  decay added to the update, then the LR; torch's SGD adds the decay to
  the gradient before the momentum instead.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


def default_no_decay(name: str, param: torch.Tensor) -> bool:
    """1-D parameters, biases, and the reference's no_weight_decay() set."""
    parts = name.split(".")
    if param.dim() <= 1 or parts[-1] == "bias":
        return True
    if parts[-1] in ("pos_emb", "mask_token", "global_tokens"):
        return True
    if parts[0] == "input_adapters" and "class_emb" in parts:
        return True
    return "task_embeddings" in parts


def frozen(name: str) -> bool:
    """Fixed sin-cos pos-embs (requires_grad=False in the reference)."""
    return name.split(".")[-1] == "pos_emb"


def get_num_layer_for_vit(name: str, num_values: int) -> int:
    """The layer of a parameter for layer-wise LR decay (reference
    utils/optim_factory.py:22-35, JAX :60-69, on torch parameter names)."""
    parts = name.split(".")
    if parts[0] in ("cls_token", "mask_token", "pos_embed", "global_tokens"):
        return 0
    if parts[0].startswith("patch_embed") or parts[0] == "input_adapters":
        return 0
    if parts[0] in ("encoder", "blocks"):
        return int(parts[1]) + 1
    return num_values - 1


class LayerDecayValueAssigner:
    """Reference utils/optim_factory.py:38-46: LR scale values[layer]."""

    def __init__(self, values: Sequence[float]):
        self.values = list(values)

    def get_scale(self, layer_id: int) -> float:
        return self.values[layer_id]

    def get_layer_id(self, name: str) -> int:
        return get_num_layer_for_vit(name, len(self.values))


def build_param_groups(
    model: nn.Module,
    balancer: Optional[nn.Module] = None,
    *,
    filter_bias_and_bn: bool = True,
    balancer_lr_scale: float = 1.0,
    layer_decay_assigner: Optional[LayerDecayValueAssigner] = None,
    learnable_pos_emb: bool = False,
) -> Tuple[List[Dict], List[str]]:
    """(param groups, names of the frozen parameters). Each group is a dict
    with `params`, `names`, `group`, `lr_scale` and `wd_flag`."""
    groups: Dict[str, Dict] = {}
    frozen_names: List[str] = []

    def add(group: str, name: str, p: torch.Tensor, lr_scale: float, wd_flag: float):
        g = groups.setdefault(group, {"group": group, "params": [], "names": [],
                                      "lr_scale": lr_scale, "wd_flag": wd_flag})
        g["params"].append(p)
        g["names"].append(name)

    for name, p in model.named_parameters():
        if frozen(name) and not learnable_pos_emb:
            frozen_names.append(name)
        elif not filter_bias_and_bn:
            add("flat_decay", name, p, 1.0, 1.0)
        else:
            kind = "no_decay" if default_no_decay(name, p) else "decay"
            wd_flag = 0.0 if kind == "no_decay" else 1.0
            if layer_decay_assigner is None:
                add(kind, name, p, 1.0, wd_flag)
            else:
                layer = layer_decay_assigner.get_layer_id(name)
                add(f"layer_{layer}_{kind}", name, p,
                    layer_decay_assigner.get_scale(layer), wd_flag)
    if balancer is not None:
        for name, p in balancer.named_parameters():
            add("balancer", "balancer." + name, p, balancer_lr_scale,
                0.0 if filter_bias_and_bn else 1.0)
    return list(groups.values()), frozen_names


class TraceSGD(torch.optim.Optimizer):
    """optax.trace(decay=momentum, nesterov) + decoupled weight decay + the
    LR (JAX :232-235): t = g + momentum * t; u = g + momentum * t with
    Nesterov, else t; p -= lr * (u + weight_decay * p). The trace starts at
    zero and is kept per parameter as `momentum_buffer`."""

    def __init__(self, params, momentum: float = 0.9, nesterov: bool = True):
        super().__init__(params, dict(lr=0.0, weight_decay=0.0, momentum=momentum,
                                      nesterov=nesterov))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("TraceSGD takes no closure")
        for group in self.param_groups:
            m, wd = group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                trace = state["momentum_buffer"]
                trace.mul_(m).add_(p.grad)
                u = p.grad + m * trace if group["nesterov"] else trace.clone()
                if wd:
                    u.add_(p, alpha=wd)
                p.add_(u, alpha=-group["lr"])


def create_optimizer(
    model: nn.Module,
    balancer: Optional[nn.Module] = None,
    *,
    opt: str = "adamw",
    weight_decay: float = 0.05,
    opt_betas: Tuple[float, float] = (0.9, 0.999),
    opt_eps: float = 1e-8,
    momentum: float = 0.9,
    filter_bias_and_bn: bool = True,
    balancer_lr_scale: float = 1.0,
    layer_decay_assigner: Optional[LayerDecayValueAssigner] = None,
    learnable_pos_emb: bool = False,
) -> torch.optim.Optimizer:
    """`opt` (the JAX signature's, :191-239: adamw, adam, sgd, nesterov or
    momentum, after an optional `<prefix>_`) over the groups of
    build_param_groups; each group's weight decay starts at weight_decay *
    wd_flag and its LR at 0 until TrainState sets them from the schedules."""
    kind = opt.lower().split("_")[-1]
    if kind not in ("adamw", "adam", "sgd", "nesterov", "momentum"):
        raise ValueError(f"Invalid optimizer {opt}")
    groups, _ = build_param_groups(model, balancer, filter_bias_and_bn=filter_bias_and_bn,
                                   balancer_lr_scale=balancer_lr_scale,
                                   layer_decay_assigner=layer_decay_assigner,
                                   learnable_pos_emb=learnable_pos_emb)
    for g in groups:
        if kind == "adam":
            g["wd_flag"] = 0.0
        g["lr"] = 0.0
        g["weight_decay"] = weight_decay * g["wd_flag"]
    if kind == "adamw":
        return torch.optim.AdamW(groups, lr=0.0, betas=tuple(opt_betas), eps=opt_eps)
    if kind == "adam":
        return torch.optim.Adam(groups, lr=0.0, betas=tuple(opt_betas), eps=opt_eps)
    return TraceSGD(groups, momentum=momentum, nesterov=kind != "momentum")
