"""Where a training step's device time goes, by kernel and by module
(counterpart of the JAX package's tools/profile_step.py, which prints by
scope and by source line).

    python -m multimae_tpu_torch.tools.profile_step [--mode pretrain] [--large]
        [--batch N] [--steps 5] [--warmup 3] [--top 40] [--out DIR]

Modes: `pretrain` (cli/factory.build_pretrain_trainer: MultiMAE ViT-B, or
with --large pretrain_multimae_large, at batch 128, 64 with --large; K1
forward and backward in the decoders), and the fine-tune recipes, each
built by tools/bench_finetune.build_train_step: `finetune512` (semseg at
--input_size, batch 16), `cls` (224 px, batch 128), `depth256` and
`taskonomy384` (DPT heads, batch 32). --large swaps the ViT-L trunk into
the pretrain mode only, as in the JAX tool. After --warmup steps it runs
--steps steps under torch.profiler and prints the host time per step,
the device time per step by kind of kernel (cli/profile_forward.CATEGORIES)
and the largest kernels, then the same device time by module: each
kernel goes to the model part whose forward launched it (an input
adapter, the encoder, an output adapter), or whose forward recorded the
autograd node whose backward launched it, else to the optimizer or to
`other` (losses and the step's own work). --out DIR writes the chrome
trace there. On the CPU (--device cpu) the tables hold CPU operator time.
Runs on the card unless --device names another.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from typing import Dict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from multimae_tpu_torch.cli.factory import (
    build_pretrain_trainer,
    entry_device,
    make_synthetic_batch,
)
from multimae_tpu_torch.cli.profile_forward import device_kernels, print_kernels
from multimae_tpu_torch.tools import bench_finetune

SCOPE = "module:"
BACKWARD_SCOPE = 1  # torch's RecordScope::BACKWARD_FUNCTION
MODES = ("pretrain", "finetune512", "cls", "depth256", "taskonomy384")
FINETUNE = {"finetune512": ("semseg", None, 150), "cls": ("cls", 224, 1000),
            "depth256": ("depth", 256, 1), "taskonomy384": ("taskonomy", 384, 3)}


def model_parts(model):
    """(name, module) of each part a kernel is charged to."""
    for kind in ("input_adapters", "output_adapters"):
        for task, module in (getattr(model, kind) or {}).items():
            yield f"{kind}.{task}", module
    for block in model.encoder:
        yield "encoder", block


@contextlib.contextmanager
def module_scopes(model):
    """A record_function range `module:<part>` around each forward of each
    of the model's parts, for as long as the context lasts."""
    handles, ranges = [], []

    def enter(name):
        def pre(module, args):
            ranges.append(record_function(SCOPE + name))
            ranges[-1].__enter__()
        return pre

    def leave(module, args, out):
        ranges.pop().__exit__(None, None, None)

    for name, module in model_parts(model):
        handles += [module.register_forward_pre_hook(enter(name)),
                    module.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _forward_scope(e) -> str:
    while e is not None:
        if e.name.startswith(SCOPE):
            return e.name[len(SCOPE):]
        e = e.cpu_parent
    return "other"


def _scope(e, forward: Dict) -> str:
    while e is not None:
        if e.name.startswith(SCOPE):
            return e.name[len(SCOPE):]
        if e.scope == BACKWARD_SCOPE and e.sequence_nr >= 0:
            return forward.get((e.fwd_thread, e.sequence_nr), "other") + " (backward)"
        if e.name.startswith("Optimizer."):
            return "optimizer"
        e = e.cpu_parent
    return "other"


def by_module(events, steps: int, device: bool = True) -> Dict[str, float]:
    """{part: ms per step}: each CUDA kernel's device time (or, with
    device=False, each CPU operator's self time) charged to the model part
    that launched it, forward or backward (see the module docstring)."""
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    forward = {}
    for e in cpu:
        if e.scope != BACKWARD_SCOPE and e.sequence_nr >= 0:
            forward.setdefault((e.thread, e.sequence_nr), _forward_scope(e))
    table = {}
    for e in cpu:
        if getattr(e, "is_user_annotation", False):
            continue
        us = (sum(k.duration for k in e.kernels) if device
              else e.self_cpu_time_total)
        if us:
            name = _scope(e, forward)
            table[name] = table.get(name, 0.0) + us / steps / 1e3
    return dict(sorted(table.items(), key=lambda kv: -kv[1]))


def print_modules(table: Dict[str, float], total_ms: float, what: str) -> None:
    print(f"== by module ({what} ms/step) ==")
    for name, ms in table.items():
        print(f"{ms:9.3f}  {100 * ms / max(total_ms, 1e-9):5.1f}%  {name}")
    rest = total_ms - sum(table.values())
    if abs(rest) > 1e-3:
        print(f"{rest:9.3f}  {100 * rest / max(total_ms, 1e-9):5.1f}%  (not linked to a launch)")


def build(args, device):
    """(train_step, TrainState, batch) of `args.mode`."""
    if args.mode == "pretrain":
        name = "pretrain_multimae_large" if args.large else "pretrain_multimae_base"
        state, step = build_pretrain_trainer(batch_size=args.batch, model_name=name,
                                             device=device)
        return step, state, make_synthetic_batch(args.batch, device=device)
    task, size, classes = FINETUNE[args.mode]
    fargs = argparse.Namespace(task=task, batch=args.batch, num_classes=classes, steps=0,
                               input_size=size or args.input_size, large=False)
    return bench_finetune.build_train_step(fargs, device)


def profile_steps(step, state, batch, steps: int, warmup: int, device, out=None):
    """Run `warmup` steps, then `steps` under torch.profiler; returns
    (profiler, host ms per step)."""
    gen = torch.Generator(device=device).manual_seed(1)
    for _ in range(warmup):
        step(state, batch, generator=gen)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with module_scopes(state.model), profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            metrics = step(state, batch, generator=gen)
        float(metrics["loss"])
        if cuda:
            torch.cuda.synchronize(device)
        ms = (time.perf_counter() - t0) / steps * 1e3
    if out:
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, "trace.json"))
    return prof, ms


def report(prof, steps: int, host_ms: float, samples: int, device, top: int) -> dict:
    """Print the tables; returns {"by_kernel", "by_module"} in ms per step."""
    print(f"{steps} steps in {host_ms * steps:.1f} ms -> {samples / host_ms * 1e3:.1f} "
          f"samples/s ({host_ms:.2f} ms/step)")
    cuda = device.type == "cuda"
    kernels = device_kernels(prof, steps) if cuda else {}
    if cuda:
        print_kernels(kernels, host_ms, "step", top)
    table = by_module(prof.events(), steps, device=cuda)
    print_modules(table, sum(kernels.values()) if cuda else sum(table.values()),
                  "device" if cuda else "CPU")
    return {"by_kernel": kernels, "by_module": table}


def get_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="per-chip batch (default: 128 pretrain and cls, 64 with --large, 16 "
                         "finetune512, 32 depth256 and taskonomy384)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--out", default=None, help="directory for the chrome trace")
    ap.add_argument("--mode", choices=MODES, default="pretrain")
    ap.add_argument("--large", action="store_true",
                    help="pretrain mode: pretrain_multimae_large (ViT-L encoder)")
    ap.add_argument("--input_size", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = (16 if args.mode == "finetune512"
                      else 32 if args.mode in ("depth256", "taskonomy384")
                      else 64 if args.large else 128)
    return args


def main(argv=None) -> dict:
    args = get_args(argv)
    device = entry_device(args.device)
    step, state, batch = build(args, device)
    prof, host_ms = profile_steps(step, state, batch, args.steps, args.warmup, device, args.out)
    return report(prof, args.steps, host_ms, args.batch, device, args.top)


if __name__ == "__main__":
    main()
