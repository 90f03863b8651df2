"""Fine-tune starts from reference-layout `.pth` files (counterpart of
multimae_tpu/utils/torch_compat.py:109-267 and `load_pretrained_torch`,
multimae_tpu/train/checkpoint.py:552-570; reference utils/checkpoint.py:
26-72 and run_finetuning_semseg.py:410-425).

The port's modules carry the reference's torch keys, so loading is
`load_state_dict(strict=False)` after two surgeries on the source
tensors:
  * a `pos_emb` (1, D, h, w) on another grid than the model's is resized
    bicubically with align_corners=False (reference utils/pos_embed.py:
    44-58): a 224-px pretraining start of a 512-px fine-tune goes 14x14
    -> 32x32;
  * a `class_emb.weight` with one row fewer than the model's gets a zero
    row appended, the void class of the fine-tune CLI's pseudo_semseg
    input.
The report lists what the JAX function lists: `missing` (model keys with
no source), `unexpected` (source keys not loaded) and `ignored` (the
reference DPT head's aliased and unused keys, left out of `unexpected`).

A JAX `.msgpack` (flax's format, read by utils/flax_msgpack.py without
flax) starts a model by the JAX CLIs' own rules (`load_flax_start`): the
source params (under `params/model`, or `params`) are matched to the
model's flax tree on flax paths and shapes, so that the counts printed
are JAX's, and only then converted to the port's keys.

Files load under torch's weights-only unpickler. A reference training
checkpoint stores its `args` as an argparse.Namespace, which that
unpickler rejects; such a file is read again with Namespace, and only
Namespace, allow-listed.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Any, Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_IGNORED = (".scratch.layer_rn.", ".refinenet4.resConfUnit1.", ".act_postprocess.")


def torch_load_checkpoint(path: str) -> Any:
    """torch.load(weights_only=True) onto the CPU, retrying a rejected file
    with argparse.Namespace allow-listed; a damaged file raises its own
    error on the first pass."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        with torch.serialization.safe_globals([argparse.Namespace]):
            return torch.load(path, map_location="cpu", weights_only=True)


def payload_state_dict(payload: Any) -> Dict[str, torch.Tensor]:
    """The state_dict inside a payload: under `model`, `module` or
    `state_dict` (reference utils/checkpoint.py:118-127), or the payload
    itself."""
    for key in ("model", "module", "state_dict"):
        if isinstance(payload, dict) and isinstance(payload.get(key), dict):
            return payload[key]
    return payload


def adapt_tensor(key: str, src: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """`src` reshaped by the two surgeries to `target`'s shape where they
    apply; raises ValueError where the shapes still differ."""
    leaf = key.split(".")[-1]
    if (leaf == "pos_emb" and src.dim() == 4 and src.shape != target.shape
            and src.shape[:2] == target.shape[:2]):
        src = F.interpolate(src.float(), size=tuple(target.shape[2:]), mode="bicubic",
                            align_corners=False)
    if (key.endswith("class_emb.weight") and src.dim() == 2
            and src.shape[0] + 1 == target.shape[0] and src.shape[1] == target.shape[1]):
        src = torch.cat([src, src.new_zeros(1, src.shape[1])])
    if src.shape != target.shape:
        raise ValueError(f"{key}: source {tuple(src.shape)}, model {tuple(target.shape)}")
    return src


def load_pretrained(model: nn.Module, source: Any) -> Dict[str, List[str]]:
    """Load a `.pth` path or an already-read payload into `model`; returns
    {"missing", "unexpected", "ignored"} key lists."""
    payload = torch_load_checkpoint(source) if isinstance(source, str) else source
    state = payload_state_dict(payload)
    live = model.state_dict()
    loaded = {k: adapt_tensor(k, v, live[k]) for k, v in state.items() if k in live}
    model.load_state_dict(loaded, strict=False)
    missing = [k for k in live if k not in state]
    rest = [k for k in state if k not in live]
    ignored = [k for k in rest if any(m in k for m in _IGNORED)]
    report = {"missing": missing, "unexpected": [k for k in rest if k not in ignored],
              "ignored": ignored}
    print(f"[torch_compat] loaded {len(loaded)} tensors; missing ({len(missing)}): "
          f"{missing[:10]}; unexpected ({len(report['unexpected'])}): "
          f"{report['unexpected'][:10]}", flush=True)
    return report


def proj_shapes_of(model: nn.Module) -> Dict[str, Tuple[int, int, int]]:
    """{task: (C, ph, pw)} of the model's patch embeddings, which the
    flax Dense kernel (ph*pw*C, D) needs to become a Conv2d weight."""
    out = {}
    for key, value in model.state_dict().items():
        parts = key.split(".")
        if (len(parts) == 4 and parts[0] == "input_adapters" and parts[2:] == ["proj", "weight"]
                and value.dim() == 4):
            out[parts[1]] = tuple(value.shape[1:])
    return out


def _unflat(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _numpy(x) -> Any:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return x


FLAX_RULES = ("merge", "trunk", "strict")


def load_flax_start(model: nn.Module, source: Any, rule: str,
                    head_type: str = "regression") -> Dict[str, Any]:
    """Start `model` from a JAX `.msgpack` (a path, or the tree
    `flax_msgpack.msgpack_restore` read) by one of the JAX package's rules:
      * "merge", the cls CLI's (multimae_tpu/cli/run_finetuning_cls.py
        :339-361): each leaf of the model's flax tree whose path and shape
        the source has is copied, the head's too; the rest keep their
        initial values (no pos-emb resize, no class-embedding row);
      * "trunk", the semseg CLI's `_load_flax_trunk` (run_finetuning_semseg.py
        :535-555): the same with every `output_adapters*` path skipped;
      * "strict", the demo's `flax.serialization.from_state_dict`
        (demo.py:91-99): every leaf of the model must be in the source
        (KeyError otherwise), at the model's shape (ValueError); source
        leaves the model lacks are ignored, as flax ignores them.
    The counts are JAX's: N of the M leaves of the model's flax params
    (printed as `[finetune] loaded N/M tensors` for "merge" and "trunk").
    Returns {"loaded": N, "total": M, "paths": loaded flax paths}."""
    from multimae_tpu_torch.utils.convert import (_flatten, jax_params_to_state_dict,
                                                  state_dict_to_jax_params)
    from multimae_tpu_torch.utils.flax_msgpack import read_msgpack

    if rule not in FLAX_RULES:
        raise ValueError(f"rule {rule!r}: one of {FLAX_RULES}")
    payload = read_msgpack(source) if isinstance(source, str) else source
    params = payload["params"]
    src = dict(_flatten(params.get("model", params)))
    proj_shapes = proj_shapes_of(model)
    template = dict(_flatten(state_dict_to_jax_params(model.state_dict(), proj_shapes,
                                                      head_type)[0]))
    chosen = {}
    for path, leaf in template.items():
        if rule == "trunk" and path[0].startswith("output_adapters"):
            continue
        theirs = src.get(path)
        if theirs is None:
            if rule == "strict":
                raise KeyError(f"the checkpoint has no {'/'.join(path)}, which the model holds")
            continue
        if tuple(theirs.shape) != tuple(leaf.shape):
            if rule == "strict":
                raise ValueError(f"{'/'.join(path)}: checkpoint {tuple(theirs.shape)}, "
                                 f"model {tuple(leaf.shape)}")
            continue
        chosen[path] = _numpy(theirs)
    state = jax_params_to_state_dict(_unflat(chosen), proj_shapes, head_type)
    live = model.state_dict()
    model.load_state_dict({k: torch.from_numpy(v).to(live[k].dtype) for k, v in state.items()},
                          strict=False)
    if rule != "strict":
        print(f"[finetune] loaded {len(chosen)}/{len(template)} tensors", flush=True)
    return {"loaded": len(chosen), "total": len(template), "paths": sorted(chosen)}
