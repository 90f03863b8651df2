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

Files load under torch's weights-only unpickler. A reference training
checkpoint stores its `args` as an argparse.Namespace, which that
unpickler rejects; such a file is read again with Namespace, and only
Namespace, allow-listed.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Any, Dict, List

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
