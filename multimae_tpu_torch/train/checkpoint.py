"""Checkpoint save and auto-resume in the reference's `.pth` format
(counterpart of multimae_tpu/train/checkpoint.py; reference
utils/checkpoint.py:75-152).

`checkpoint-{epoch}.pth` is a torch.save of a dict with the reference's
keys, `model` (the state_dict, keyed like the reference's torch model),
`optimizer`, `epoch`, `loss_balancer` and `args` (plain values), and the
port's `step`, `updates` and `data_iter_state` (the loader's position),
and where they are kept the parameter EMA (`ema_params`, the device EMA
of TrainState or a HostEMA's), the --update_freq accumulation and what a
CLI adds (the best accuracy or mIoU so far, so a resume keeps
`checkpoint-best`).
Rank 0 alone writes it, to `.tmp` first and then `os.replace`, with an
`args.json` beside it; a `tag` names the file instead (`checkpoint-best`,
which auto-resume does not consider). Every load is
`torch.load(weights_only=True)`, with argparse.Namespace allow-listed for
the reference's own training checkpoints.

`load_checkpoint` (the --resume path) also takes such a reference
training checkpoint, which has no `step` or `updates`: its weights load
through the fine-tune start's surgeries (utils/torch_compat.py) and its
epoch is kept, while the optimizer and the counters start fresh, as the
JAX package does for a `.pth` (multimae_tpu/train/checkpoint.py:306-329).

Auto-resume walks the saves newest epoch first. Each candidate is read
in full and its every key and shape checked against the live state
before it is chosen, so a truncated or gutted newest save costs one
epoch and not the run; if every candidate is damaged the walk raises.
With several processes, rank 0 walks and broadcasts the epoch it chose,
and every rank loads that file.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from multimae_tpu_torch.parallel.dist import is_main_process, world_size
from multimae_tpu_torch.train.train_state import TrainState
from multimae_tpu_torch.utils.torch_compat import load_pretrained, torch_load_checkpoint

_NAME = re.compile(r"checkpoint-(\d+)\.pth$")


def save_checkpoint(output_dir: str, epoch: int, state: TrainState, *,
                    args: Optional[Dict[str, Any]] = None,
                    data_iter_state: Optional[Dict[str, int]] = None,
                    tag: Optional[str] = None,
                    extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Write checkpoint-{epoch}.pth (or {tag}.pth) on rank 0, with the
    plain values of `extra` as further keys; returns its path (None on the
    other ranks)."""
    if not is_main_process():
        return None
    os.makedirs(output_dir, exist_ok=True)
    payload = dict(state.state_dict(), epoch=int(epoch), args=dict(args or {}),
                   data_iter_state=data_iter_state, **(extra or {}))
    path = os.path.join(output_dir, f"{tag or f'checkpoint-{epoch}'}.pth")
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if args is not None:
        with open(os.path.join(output_dir, "args.json"), "w") as f:
            json.dump({k: str(v) for k, v in args.items()}, f, indent=2)
    return path


def checkpoint_candidates(output_dir: str) -> List[str]:
    """Every checkpoint-{epoch}.pth in output_dir, newest epoch first."""
    found = []
    for path in glob.glob(os.path.join(output_dir, "checkpoint-*.pth")):
        m = _NAME.search(path)
        if m:
            found.append((int(m.group(1)), path))
    return [p for _, p in sorted(found, reverse=True)]


def latest_checkpoint(output_dir: str) -> Optional[str]:
    cands = checkpoint_candidates(output_dir)
    return cands[0] if cands else None


def _check_tensors(saved: Dict[str, Any], live: Dict[str, torch.Tensor], what: str) -> None:
    if set(saved) != set(live):
        missing, extra = sorted(set(live) - set(saved)), sorted(set(saved) - set(live))
        raise ValueError(f"{what}: keys differ (missing {missing[:5]}, unexpected {extra[:5]})")
    for k, v in live.items():
        if not torch.is_tensor(saved[k]) or saved[k].shape != v.shape:
            raise ValueError(f"{what}.{k}: saved {getattr(saved[k], 'shape', saved[k])}, "
                             f"live {tuple(v.shape)}")


def validate_payload(payload: Any, state: TrainState) -> None:
    """Raise unless `payload` holds a complete save of a state shaped like
    `state`: every key and shape of the model, the balancer and the
    optimizer's per-parameter state, the epoch and the counters."""
    if not isinstance(payload, dict):
        raise ValueError(f"checkpoint holds a {type(payload).__name__}, not a dict")
    missing = {"model", "optimizer", "epoch", "loss_balancer", "step",
               "updates"} - set(payload)
    if missing:
        raise ValueError(f"checkpoint lacks {sorted(missing)}")
    _check_tensors(payload["model"], state.model.state_dict(), "model")
    if state.balancer is not None:
        _check_tensors(payload["loss_balancer"], state.balancer.state_dict(), "loss_balancer")
    if state.ema is not None and payload.get("ema_params") is not None:
        _check_tensors(payload["ema_params"], state.ema, "ema_params")
    saved_opt, groups = payload["optimizer"], state.optimizer.param_groups
    if len(saved_opt["param_groups"]) != len(groups) or any(
            len(s["params"]) != len(g["params"])
            for s, g in zip(saved_opt["param_groups"], groups)):
        raise ValueError("optimizer: parameter groups differ")
    params = [p for g in groups for p in g["params"]]
    for i, per_param in saved_opt["state"].items():
        for k, v in per_param.items():
            if torch.is_tensor(v) and v.dim() > 0 and v.shape != params[i].shape:
                raise ValueError(f"optimizer state {i}.{k}: saved {tuple(v.shape)}, "
                                 f"live {tuple(params[i].shape)}")
    int(payload["epoch"]), int(payload["step"]), int(payload["updates"])


def read_checkpoint(path: str, state: TrainState) -> Dict[str, Any]:
    """torch.load (weights only) and validate; raises on a damaged file."""
    payload = torch_load_checkpoint(path)
    validate_payload(payload, state)
    return payload


def is_reference_training_payload(payload: Any) -> bool:
    """A reference training checkpoint: weights without the port's counters."""
    return (isinstance(payload, dict) and isinstance(payload.get("model"), dict)
            and "step" not in payload and "updates" not in payload)


def load_checkpoint(path: str, state: TrainState) -> Tuple[int, Dict[str, Any]]:
    """Restore `state` in place from `path`; returns (epoch, payload). A
    reference training checkpoint restores the weights and the epoch only,
    and returns an empty payload (nothing else of it applies)."""
    payload = torch_load_checkpoint(path)
    if is_reference_training_payload(payload):
        load_pretrained(state.model, payload)
        print("[checkpoint] reference .pth resume: weights and epoch restored; the "
              "optimizer starts fresh", flush=True)
        return int(payload.get("epoch", -1)), {}
    validate_payload(payload, state)
    state.load_state_dict(payload)
    return int(payload["epoch"]), payload


def _broadcast_epoch(epoch: int) -> int:
    backend = torch.distributed.get_backend()
    t = torch.tensor([epoch], dtype=torch.int64,
                     device="cuda" if backend == "nccl" else "cpu")
    torch.distributed.broadcast(t, src=0)
    return int(t.item())


def auto_load_checkpoint(output_dir: str, state: TrainState) -> Tuple[int, Dict[str, Any]]:
    """Resume from the newest checkpoint that reads and validates; returns
    (start epoch = saved epoch + 1, payload), or (0, {}) where there is none.
    Raises if every checkpoint is damaged: training from scratch over a
    populated output_dir would destroy more than it saves."""
    cands = checkpoint_candidates(output_dir) if is_main_process() else []
    chosen, payload, last_err = -1, None, None
    for i, path in enumerate(cands):
        try:
            payload = read_checkpoint(path, state)
        except Exception as e:  # any damage: fall back one save
            last_err = e
            print(f"[checkpoint] {path} failed to load ({type(e).__name__}: {e}); "
                  "trying the previous checkpoint", flush=True)
            continue
        chosen = int(_NAME.search(path).group(1))
        if i:
            print(f"[checkpoint] skipped {i} damaged newer save(s)", flush=True)
        break
    else:
        if cands:
            chosen = -2
    if world_size() > 1:
        chosen = _broadcast_epoch(chosen)
        if chosen >= 0 and not is_main_process():
            payload = read_checkpoint(
                os.path.join(output_dir, f"checkpoint-{chosen}.pth"), state)
    if chosen == -2:
        raise RuntimeError(f"every checkpoint in {output_dir} failed to load"
                           + (f"; last error: {last_err}" if last_err else "")) from last_err
    if chosen == -1:
        return 0, {}
    state.load_state_dict(payload)
    print(f"[checkpoint] auto-resumed from {output_dir}/checkpoint-{chosen}.pth "
          f"(epoch {chosen})", flush=True)
    return chosen + 1, payload
