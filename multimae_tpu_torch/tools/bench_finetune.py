"""Fine-tune train-step throughput on the card (counterpart of the JAX
package's tools/bench_finetune.py).

    python -m multimae_tpu_torch.tools.bench_finetune [--task semseg] [--batch 16]
        [--input_size 512] [--large] [--engine both|kernels|module]

Times the whole fine-tune step (forward in training mode, loss, backward,
grad norm, AdamW update) of a recipe's shape on one synthetic batch, with
random weights from a seeded CPU generator:
  * semseg: MultiViT rgb + depth at 512 px (2049 tokens) with the ConvNeXt
    head, 150 classes (the ADE20K / NYUv2 recipe shape): K2 forward and
    backward in every encoder block, K3b in the head's four blocks;
  * depth: rgb at 256 px with the DPT regression head and berhu (the NYUv2
    depth recipe's shape, here in bf16);
  * cls: rgb at 224 px with the linear head over 1000 classes, layer decay
    0.65 and soft targets as mixup leaves them (the ImageNet-1K recipe);
  * taskonomy: rgb at 384 px (577 tokens) with the DPT head over 3
    channels (surface normals), the L1 loss against mask_valid.
Per-chip batch defaults: semseg 16, depth 32, cls 128, Taskonomy 32; with
--large (multivit_large: 24 blocks, dim 1024, 16 heads; DPT hooks 5, 11,
17, 23) halved, semseg quartered. Each step runs with the port's default
dispatch (engine `kernels`) and with every encoder attention on the module
path (engine `module`: ops/attention.SHORT_KERNEL_MIN_KV set past any
sequence, restored after). Prints one JSON line per engine,
{"metric": "finetune_<task>_<size>px_[large_]throughput_<engine>", "value":
samples per second, "unit": "samples/sec/chip", "batch": ..., "peak_gib":
...}, then the ratio, "..._kernel_speedup", with both legs' batches. cls
at 197 tokens and depth at 257 sit below the attention gate's 512 keys:
both engines run the module path there, and cls is measured once, as
`module`. A leg that runs out of memory is measured again at half the
batch, and its line names the batch; the other leg then runs again at
that batch, so the ratio compares one batch.
Runs on the card unless --device names another.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import json
import time

import numpy as np
import torch

from multimae_tpu_torch.cli.factory import entry_device
from multimae_tpu_torch.cli.run_finetuning_semseg import seg_cross_entropy_parts
from multimae_tpu_torch.models import (
    ConvNeXtAdapter,
    DPTOutputAdapter,
    LinearOutputAdapter,
    PatchedInputAdapter,
)
from multimae_tpu_torch.models.registry import create_model
from multimae_tpu_torch.ops import attention
from multimae_tpu_torch.train.cross_entropy import soft_target_cross_entropy
from multimae_tpu_torch.train.finetune_step import make_cls_train_step, make_dense_train_step
from multimae_tpu_torch.train.optim_factory import LayerDecayValueAssigner, create_optimizer
from multimae_tpu_torch.train.regression_losses import (
    masked_berhu_loss_parts,
    masked_l1_loss_parts,
)
from multimae_tpu_torch.train.schedules import cosine_scheduler
from multimae_tpu_torch.train.train_state import TrainState

WARMUP = 3  # steps before the timed ones
DEFAULT_SIZE = {"semseg": 512, "depth": 256, "cls": 224, "taskonomy": 384}
DEFAULT_BATCH = {"semseg": 16, "depth": 32, "cls": 128, "taskonomy": 32}


def _trunk(args):
    """Registry name, depth and DPT hooks of the selected encoder: `--large`
    takes the 24-block dim-1024 trunk, with the hooks at the same relative
    depths as ViT-B's (2, 5, 8, 11 of 12 -> 5, 11, 17, 23 of 24), and the cls
    layer decay over its 24 blocks."""
    if getattr(args, "large", False):
        return "multivit_large", 24, (5, 11, 17, 23)
    return "multivit_base", 12, (2, 5, 8, 11)


def _inputs(args, channels):
    return {t: functools.partial(PatchedInputAdapter, num_channels=c, stride_level=1,
                                 patch_size_full=16, image_size=args.input_size)
            for t, c in channels}


def _model(args, dtype, channels, output_adapters):
    return create_model(_trunk(args)[0], input_adapters=_inputs(args, channels),
                        output_adapters=output_adapters, drop_path_rate=0.1, dtype=dtype)


def build(args, dtype):
    """The semseg model (rgb + depth, ConvNeXt head), weights unset."""
    return _model(args, dtype, (("rgb", 3), ("depth", 1)), {"semseg": functools.partial(
        ConvNeXtAdapter, num_classes=args.num_classes, preds_per_patch=16, depth=4,
        embed_dim=6144, patch_size=16, main_tasks=("rgb",))})


def build_depth(args, dtype):
    """The NYUv2 depth recipe's model: rgb -> the DPT regression head."""
    return _model(args, dtype, (("rgb", 3),), {"depth": functools.partial(
        DPTOutputAdapter, head_type="regression", stride_level=1, num_classes=1,
        patch_size=16, main_tasks=("rgb",), hooks=_trunk(args)[2])})


def build_cls(args, dtype):
    """The ImageNet-1K recipe's model: rgb -> the linear head."""
    return _model(args, dtype, (("rgb", 3),), {"cls": functools.partial(
        LinearOutputAdapter, num_classes=args.num_classes)})


def build_taskonomy(args, dtype):
    """The Taskonomy recipe's model: rgb -> a 3-channel DPT regression head."""
    return _model(args, dtype, (("rgb", 3),), {"normal": functools.partial(
        DPTOutputAdapter, head_type="regression", stride_level=1, num_classes=3,
        patch_size=16, main_tasks=("rgb",), hooks=_trunk(args)[2])})


BUILDERS = {"semseg": build, "depth": build_depth, "cls": build_cls,
            "taskonomy": build_taskonomy}


def make_batch(args, seed: int = 0):
    """The task's synthetic batch (numpy draws from `seed`) on the CPU."""
    rng = np.random.default_rng(seed)
    b, s = args.batch, args.input_size

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    batch = {"rgb": normal(b, s, s, 3)}
    if args.task == "taskonomy":
        batch["target"] = normal(b, s, s, 3)
        batch["mask_valid"] = torch.from_numpy(rng.random((b, s, s, 1)) > 0.1)
    elif args.task == "depth":
        batch["target"] = normal(b, s, s, 1)
    elif args.task == "cls":
        batch["target"] = torch.softmax(normal(b, args.num_classes) * 4.0, dim=-1)
    else:
        batch["depth"] = normal(b, s, s, 1)
        batch["target"] = torch.from_numpy(rng.integers(0, args.num_classes, (b, s, s)))
    return batch


def build_train_step(args, device="cuda", model=None):
    """(train_step, TrainState, batch) of `args.task` on `device`: bf16,
    random weights from a CPU generator seeded 0 (or `model` as given), AdamW
    (0.9, 0.999) with wd 0.05 and no decay on 1-D parameters and tokens
    (layer decay 0.65 for cls), the cosine LR from 1e-4 over 64 epochs of
    100 steps after 1 of warmup. The frozen sin-cos pos-embs get the
    gradients the JAX step's norm counts, never an update. Shared with
    tools/profile_step.py's fine-tune modes."""
    device = entry_device(device)
    if model is None:
        model = BUILDERS[args.task](args, torch.bfloat16)
        model.init_weights(torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        if name.endswith("pos_emb"):
            p.requires_grad_(True)
    model.to(device)
    batch = {k: v.to(device) for k, v in make_batch(args).items()}
    lr = cosine_scheduler(1e-4, 0.0, epochs=64, niter_per_ep=100, warmup_epochs=1)
    assigner = None
    if args.task == "cls":
        depth = _trunk(args)[1]
        assigner = LayerDecayValueAssigner([0.65 ** (depth + 1 - i) for i in range(depth + 2)])
    optimizer = create_optimizer(model, weight_decay=0.05, opt_betas=(0.9, 0.999),
                                 filter_bias_and_bn=True, layer_decay_assigner=assigner)
    state = TrainState(model, None, optimizer, lr)
    if args.task == "cls":
        step = make_cls_train_step(model, soft_target_cross_entropy)
    else:
        task, loss, domains = {
            "taskonomy": ("normal", masked_l1_loss_parts, ("rgb",)),
            "depth": ("depth", masked_berhu_loss_parts, ("rgb",)),
            "semseg": ("semseg", seg_cross_entropy_parts, ("rgb", "depth"))}[args.task]
        step = make_dense_train_step(model, task, loss, in_domains=domains)
    return step, state, batch


def metric_name(args, what: str) -> str:
    size = "large_" if getattr(args, "large", False) else ""
    return f"finetune_{args.task}_{args.input_size}px_{size}{what}"


def _timed(args, device, warmup: int) -> float:
    step, state, batch = build_train_step(args, device)
    gen = torch.Generator(device=device).manual_seed(2)
    for _ in range(warmup):
        step(state, batch, generator=gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        metrics = step(state, batch, generator=gen)
    float(metrics["loss"])
    return args.batch * args.steps / (time.perf_counter() - t0)


def measure(args, label: str, device="cuda", warmup: int = WARMUP) -> dict:
    """Samples per second of `args.steps` steps after `warmup`, ending in a
    host read; prints the JSON line and returns it. Out of memory, the leg
    runs again at half the batch (its line names the batch it ran, and
    "retried" how often)."""
    device = entry_device(device)
    leg, retried = copy.copy(args), 0
    while True:
        short = False
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        try:
            rate = _timed(leg, device, warmup)
        except torch.cuda.OutOfMemoryError:
            if leg.batch == 1:
                raise
            short = True
        if not short:
            break
        gc.collect()
        torch.cuda.empty_cache()
        leg.batch //= 2
        retried += 1
        print(f"{metric_name(leg, 'throughput_' + label)}: out of memory, again at batch "
              f"{leg.batch}", flush=True)
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if device.type == "cuda" else None
    line = {"metric": metric_name(leg, f"throughput_{label}"), "value": round(rate, 2),
            "unit": "samples/sec/chip", "batch": leg.batch, "peak_gib": peak,
            "retried": retried}
    print(json.dumps(line), flush=True)
    return line


@contextlib.contextmanager
def module_engine():
    """Every encoder attention on the module path: the attention gate's key
    floor past any sequence, restored after."""
    floor = attention.SHORT_KERNEL_MIN_KV
    attention.SHORT_KERNEL_MIN_KV = 10 ** 9
    try:
        yield
    finally:
        attention.SHORT_KERNEL_MIN_KV = floor


def get_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", choices=("semseg", "depth", "cls", "taskonomy"), default="semseg",
                    help="semseg: rgb+depth@512 ConvNeXt head (ADE/NYU recipe); depth: rgb@256 "
                         "DPT regression head (NYUv2 depth recipe); cls: rgb@224 linear head "
                         "(ImageNet-1K 100e recipe); taskonomy: rgb@384 surface-normal DPT "
                         "head, masked L1 (Taskonomy recipe)")
    ap.add_argument("--batch", type=int, default=None, help="per-chip batch")
    ap.add_argument("--input_size", type=int, default=None)
    ap.add_argument("--num_classes", type=int, default=150)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--large", action="store_true",
                    help="ViT-L trunk (multivit_large: 24 blocks, dim 1024, 16 heads); the "
                         "per-chip batch defaults drop 2x (semseg 4x)")
    ap.add_argument("--engine", choices=("both", "kernels", "module"), default="both",
                    help="measure one attention engine only")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.input_size is None:
        args.input_size = DEFAULT_SIZE[args.task]
    if args.batch is None:
        args.batch = DEFAULT_BATCH[args.task]
        if args.large:
            args.batch //= 4 if args.task == "semseg" else 2
    if args.task == "cls":
        args.num_classes = 1000
    return args


def speedup_line(args, kernels: dict, module: dict):
    """The ratio line of the two engines' legs, or None where they ran at
    different batches (a leg that ran out of memory runs smaller)."""
    if kernels["batch"] != module["batch"]:
        return None
    return {"metric": metric_name(args, "kernel_speedup"),
            "value": round(kernels["value"] / module["value"], 4), "unit": "x",
            "batch_kernels": kernels["batch"], "batch_module": module["batch"]}


def _leg(args, engine: str, warmup: int) -> dict:
    with module_engine() if engine == "module" else contextlib.nullcontext():
        return measure(args, engine, args.device, warmup)


def main(argv=None, warmup: int = WARMUP) -> dict:
    """Measure the engines `--engine` names; returns {engine: its JSON line}.
    Where the two legs ran at different batches, the larger one runs again
    at the smaller batch, so the ratio compares one batch."""
    args = get_args(argv)
    if args.task == "cls":  # 197 tokens: below the gate, one engine
        return {"module": _leg(args, "module", warmup)}
    rates = {e: _leg(args, e, warmup) for e in ("kernels", "module")
             if args.engine in ("both", e)}
    if len(rates) == 2:
        small = min(r["batch"] for r in rates.values())
        for engine, line in list(rates.items()):
            if line["batch"] != small:
                leg = copy.copy(args)
                leg.batch = small
                rates[engine] = _leg(leg, engine, warmup)
        ratio = speedup_line(args, rates["kernels"], rates["module"])
        if ratio is not None:
            print(json.dumps(ratio), flush=True)
    return rates


if __name__ == "__main__":
    main()
