"""AdamW with the reference's parameter groups (counterpart of
multimae_tpu/train/optim_factory.py :34-82, :127-239; reference
utils/optim_factory.py).

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
(scale_by_adam, + wd * p, * -lr; :89-124).
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


def create_optimizer(
    model: nn.Module,
    balancer: Optional[nn.Module] = None,
    *,
    opt: str = "adamw",
    weight_decay: float = 0.05,
    opt_betas: Tuple[float, float] = (0.9, 0.999),
    opt_eps: float = 1e-8,
    filter_bias_and_bn: bool = True,
    balancer_lr_scale: float = 1.0,
    layer_decay_assigner: Optional[LayerDecayValueAssigner] = None,
    learnable_pos_emb: bool = False,
) -> torch.optim.AdamW:
    """`opt` (the JAX signature's, :191-239) over the groups of
    build_param_groups; each group's weight decay starts at weight_decay *
    wd_flag and its LR at 0 until TrainState sets them from the schedules.
    AdamW, the recipes' optimizer, is the one ported."""
    if opt.lower() != "adamw":
        raise NotImplementedError(f"optimizer {opt!r} is not ported yet (ROADMAP.md "
                                  "queue 1 item 14 brings SGD and Adam); use adamw")
    groups, _ = build_param_groups(model, balancer, filter_bias_and_bn=filter_bias_and_bn,
                                   balancer_lr_scale=balancer_lr_scale,
                                   layer_decay_assigner=layer_decay_assigner,
                                   learnable_pos_emb=learnable_pos_emb)
    for g in groups:
        g["lr"] = 0.0
        g["weight_decay"] = weight_decay * g["wd_flag"]
    return torch.optim.AdamW(groups, lr=0.0, betas=tuple(opt_betas), eps=opt_eps)
