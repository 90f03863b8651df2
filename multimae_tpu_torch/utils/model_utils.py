"""Parameter freezing, counting and Signal Propagation Plot statistics
(counterpart of multimae_tpu/utils/model_utils.py; reference
utils/model.py:28-279).

Names are the dotted ones of `named_parameters` ("encoder.0.attn.qkv.weight",
"input_adapters.rgb.proj.weight"); a prefix matches a name's first
component or the start of the name, as the JAX helpers match flax paths.
"""

from __future__ import annotations

import fnmatch
from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from multimae_tpu_torch.train.optim_factory import frozen as default_frozen


def _matches(name: str, prefixes: Sequence[str]) -> bool:
    first = name.split(".")[0]
    return any(first.startswith(p) or name.startswith(p) for p in prefixes)


def match_submodules(model: nn.Module, submodule_prefixes: Sequence[str]) -> set:
    """Names of every parameter under the given prefixes (e.g. ["encoder",
    "input_adapters.rgb"])."""
    return {name for name, _ in model.named_parameters() if _matches(name, submodule_prefixes)}


def freeze_predicate(submodule_prefixes: Sequence[str]) -> Callable:
    """predicate(name, param, learnable_pos_emb=False) -> whether the
    parameter is frozen: the optimizer factory's rule (the fixed sin-cos
    pos-embs, unless learnable_pos_emb) or a name under the prefixes."""

    def is_frozen(name: str, param=None, learnable_pos_emb: bool = False) -> bool:
        if not learnable_pos_emb and default_frozen(name):
            return True
        return _matches(name, submodule_prefixes)

    return is_frozen


def count_parameters(model: nn.Module, trainable_only_frozen: Sequence[str] = ()) -> dict:
    """{"total", "frozen", "trainable"} element counts; `frozen` counts the
    parameters under the given prefixes."""
    frozen_set = match_submodules(model, trainable_only_frozen)
    params = list(model.named_parameters())
    total = sum(p.numel() for _, p in params)
    frozen = sum(p.numel() for n, p in params if n in frozen_set)
    return {"total": total, "frozen": frozen, "trainable": total - frozen}


# --- Signal Propagation Plot statistics (reference utils/model.py:28-106) ---
#
# Forward hooks on the modules whose dotted names match the unix-style
# patterns record each output, as the reference does; the activations are
# channels-last, as the JAX helpers take them (the port's tokens are
# (B, N, D)).


def avg_sq_ch_mean(activation: torch.Tensor) -> float:
    """Average squared channel mean (channels-last activations)."""
    a = activation.float()
    return float(a.mean(dim=tuple(range(a.dim() - 1))).pow(2).mean())


def avg_ch_var(activation: torch.Tensor) -> float:
    """Average channel variance (channels-last activations; ddof=1, as
    torch's .var())."""
    a = activation.float()
    axes = tuple(range(a.dim() - 1))
    n = 1
    for ax in axes:
        n *= a.shape[ax]
    var = (a - a.mean(dim=axes)).pow(2).sum(dim=axes) / max(n - 1, 1)
    return float(var.mean())


def extract_spp_stats(model: nn.Module, inputs, hook_fn_locs: Sequence[str],
                      hook_fns: Sequence[Callable], **forward_kwargs
                      ) -> Dict[str, List[Tuple[str, float]]]:
    """Per-module activation statistics for Signal Propagation Plots
    (reference utils/model.py:86-106; https://arxiv.org/abs/2101.08692):
    one forward of `model(inputs, **forward_kwargs)` with a hook on every
    module whose name fnmatch-es `hook_fn_locs[i]`, evaluating
    `hook_fns[i]` on its tensor output. Returns {hook_fn.__name__:
    [(module name, value), ...]} ordered by module name; a module whose
    output is not a tensor is skipped."""
    if len(hook_fn_locs) != len(hook_fns):
        raise ValueError("Please provide `hook_fns` for each `hook_fn_locs`, "
                         "their lengths are different.")
    outputs, handles = {}, []

    def record(name):
        def hook(module, args, out):
            if torch.is_tensor(out):
                outputs[name] = out.detach()
        return hook

    for name, module in model.named_modules():
        if name and any(fnmatch.fnmatch(name, loc) for loc in hook_fn_locs):
            handles.append(module.register_forward_hook(record(name)))
    try:
        with torch.no_grad():
            model(inputs, **forward_kwargs)
    finally:
        for h in handles:
            h.remove()
    stats = {fn.__name__: [] for fn in hook_fns}
    for name in sorted(outputs):
        for loc, fn in zip(hook_fn_locs, hook_fns):
            if fnmatch.fnmatch(name, loc):
                stats[fn.__name__].append((name, fn(outputs[name])))
    return stats
