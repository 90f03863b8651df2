"""ImageNet classification fine-tuning on the card (counterpart of
multimae_tpu/cli/run_finetuning_cls.py; reference run_finetuning_cls.py).

    python -m multimae_tpu_torch.cli.run_finetuning_cls \\
        -c cfgs/finetune/cls/ft_in1k_100e_multimae-b.yaml \\
        --finetune /path/to/pretrain/checkpoint-1599.pth \\
        --data_path /path/to/imagenet/train --eval_data_path /path/to/imagenet/val \\
        --output_dir output/finetune/cls/ft_in1k_100e_multimae-b

The same flags and YAML precedence as the JAX CLI (-c sets the parser's
defaults, flags override them), reading the shared cfgs/. It builds a
MultiViT with the rgb input adapter and the LinearOutputAdapter head,
starts it from a reference-layout `.pth` (--finetune: a 224-px
pretraining save's 14 x 14 pos-embs fit as they are; utils/torch_compat.py)
or from a JAX `.msgpack` by the JAX CLI's rule (every leaf whose flax path
and shape match, the head's too; `load_flax_start`),
reads an ImageFolder tree (--data_set IMNET or image_folder) or the
CIFAR-100 pickles (CIFAR) through the PIL-free RandAugment transforms
(data/cls_transforms.py) and the port's loader (or trains on one
synthetic batch with --synthetic_data), mixes the batch on the card with
mixup/cutmix (data/mixup.py) against the soft-target loss, else the
label-smoothing or plain cross entropy (train/cross_entropy.py), trains
with --opt (the recipe's AdamW; Adam and SGD with momentum too), layer
decay --layer_decay ** (depth + 1 - i), the cosine LR with warmup from
--blr * global batch * --update_freq / 256, the WD schedule, --update_freq
gradient accumulation and the parameter EMA (--model_ema: on the card,
or in host memory with --model_ema_force_cpu), evaluates top-1/5 after
every epoch over the whole validation set (the counts summed over
processes), saves checkpoint-best.pth whenever top-1 improves and
checkpoint-{epoch}.pth every --save_ckpt_freq epochs and at the end (with
--ckpt_backend msgpack or orbax the JAX package's .msgpack files or
.orbax/ directories instead),
writes a JSON line per epoch to log.txt, and auto-resumes from the
newest loadable save in --output_dir with the data order, the EMA and
the best top-1 so far (the JAX CLI starts every run from a best of 0, so
its first evaluation after a resume overwrites checkpoint-best). A JAX
training state (.msgpack or .orbax/: AdamW's moments, optax.MultiSteps's
accumulation under --update_freq, the device or host EMA, the counters)
resumes too, with no best top-1 and no data position the port reads
(utils/jax_state.py). Several
processes (torchrun, OpenMPI, SLURM; parallel/dist.py) train
data-parallel on the global batch, --batch_size per process; each mixes
its own slice of it (the JAX CLI mixes the global batch, reversed as a
whole).

Every random draw of the data path comes from the record's own
generator (data/loader.py): RandAugment and --train_interpolation random
included, which the JAX transforms draw from the process-global `random`.

It runs on the card unless --device cpu is given, and raises where the
card is asked for and torch sees none. A --finetune that is an orbax
directory raises SystemExit, as the JAX CLI, which open()s the file,
fails on one;
--log_wandb, --dist_eval, --pin_mem, --model_key and --model_prefix are
accepted and change nothing, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import math
import os
import sys
import time
from typing import Any, Dict

import numpy as np
import torch


def get_args(argv=None):
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("-c", "--config", default="", type=str, metavar="FILE")

    parser = argparse.ArgumentParser("MultiMAE classification fine-tuning script")
    parser.add_argument("--batch_size", default=128, type=int, help="Batch size per process")
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("--update_freq", default=1, type=int)
    parser.add_argument("--ckpt_backend", default=None, choices=["msgpack", "orbax"],
                        help="msgpack: save the JAX package's checkpoint-{epoch}.msgpack, "
                             "orbax its checkpoint-{epoch}.orbax/ directory, instead of "
                             "checkpoint-{epoch}.pth")
    parser.add_argument("--save_ckpt_freq", default=20, type=int)

    parser.add_argument("--model", default="multivit_base", type=str)
    parser.add_argument("--num_global_tokens", default=1, type=int)
    parser.add_argument("--patch_size", default=16, type=int)
    parser.add_argument("--input_size", default=224, type=int)
    parser.add_argument("--drop", type=float, default=0.0)
    parser.add_argument("--attn_drop_rate", type=float, default=0.0)
    parser.add_argument("--drop_path", type=float, default=0.1)
    parser.add_argument("--disable_eval_during_finetuning", action="store_true", default=False)
    parser.add_argument("--model_ema", action="store_true", default=False)
    parser.add_argument("--model_ema_decay", type=float, default=0.9999)
    parser.add_argument("--model_ema_force_cpu", action="store_true", default=False)

    parser.add_argument("--opt", default="adamw", type=str)
    parser.add_argument("--opt_eps", default=1e-8, type=float)
    parser.add_argument("--opt_betas", default=None, type=float, nargs="+")
    parser.add_argument("--clip_grad", type=float, default=None)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight_decay", type=float, default=0.05)
    parser.add_argument("--weight_decay_end", type=float, default=None)
    parser.add_argument("--blr", type=float, default=5e-4)
    parser.add_argument("--layer_decay", type=float, default=0.65)
    parser.add_argument("--warmup_lr", type=float, default=1e-6)
    parser.add_argument("--min_lr", type=float, default=1e-6)
    parser.add_argument("--warmup_epochs", type=int, default=5)
    parser.add_argument("--warmup_steps", type=int, default=-1)

    parser.add_argument("--color_jitter", type=float, default=0.4)
    parser.add_argument("--aa", type=str, default="rand-m9-mstd0.5-inc1")
    parser.add_argument("--smoothing", type=float, default=0.1)
    parser.add_argument("--train_interpolation", type=str, default="bicubic")
    parser.add_argument("--crop_pct", type=float, default=None)
    parser.add_argument("--reprob", type=float, default=0.0)
    parser.add_argument("--remode", type=str, default="pixel")
    parser.add_argument("--recount", type=int, default=1)
    parser.add_argument("--resplit", action="store_true", default=False)

    parser.add_argument("--mixup", type=float, default=0.8)
    parser.add_argument("--cutmix", type=float, default=1.0)
    parser.add_argument("--cutmix_minmax", type=float, nargs="+", default=None)
    parser.add_argument("--mixup_prob", type=float, default=1.0)
    parser.add_argument("--mixup_switch_prob", type=float, default=0.5)
    parser.add_argument("--mixup_mode", type=str, default="batch")

    parser.add_argument("--finetune", default="")
    parser.add_argument("--model_key", default="model|module", type=str)
    parser.add_argument("--model_prefix", default="", type=str)
    parser.add_argument("--init_scale", default=0.001, type=float)
    parser.add_argument("--use_mean_pooling", default=False, action="store_true")
    parser.add_argument("--no_mean_pooling", action="store_false", dest="use_mean_pooling")
    parser.set_defaults(use_mean_pooling=True)

    parser.add_argument("--data_path", default="", type=str)
    parser.add_argument("--eval_data_path", default="", type=str)
    parser.add_argument("--nb_classes", default=1000, type=int)
    parser.add_argument("--imagenet_default_mean_and_std", default=True, action="store_true")
    parser.add_argument("--data_set", default="IMNET", choices=["CIFAR", "IMNET", "image_folder"])
    parser.add_argument("--output_dir", default="")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; the card is never left for the CPU")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--resume", default="")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--no_auto_resume", action="store_false", dest="auto_resume")
    parser.set_defaults(auto_resume=True)
    parser.add_argument("--save_ckpt", action="store_true")
    parser.add_argument("--no_save_ckpt", action="store_false", dest="save_ckpt")
    parser.set_defaults(save_ckpt=True)
    parser.add_argument("--start_epoch", default=0, type=int)
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--dist_eval", action="store_true", default=False,
                        help="Accepted for the reference's recipes: eval is always "
                             "sharded over the processes and summed, so it changes nothing")
    parser.add_argument("--no_dist_eval", action="store_false", dest="dist_eval")
    parser.add_argument("--num_workers", default=10, type=int)
    parser.add_argument("--pin_mem", action="store_true")
    parser.add_argument("--no_pin_mem", action="store_false", dest="pin_mem")
    parser.set_defaults(pin_mem=True)
    parser.add_argument("--dtype", default="bfloat16", type=str,
                        choices=["bfloat16", "float32"])

    parser.add_argument("--log_wandb", default=False, action="store_true")
    parser.add_argument("--no_log_wandb", action="store_false", dest="log_wandb")
    parser.add_argument("--wandb_project", default=None, type=str)
    parser.add_argument("--wandb_entity", default=None, type=str)
    parser.add_argument("--wandb_run_name", default=None, type=str)

    # Distributed training parameters: the launcher's environment decides
    # (parallel/dist.py); these are accepted for the reference's command lines.
    parser.add_argument("--world_size", default=1, type=int)
    parser.add_argument("--local_rank", default=-1, type=int)
    parser.add_argument("--dist_on_itp", action="store_true")
    parser.add_argument("--dist_url", default="env://")

    parser.add_argument("--synthetic_data", action="store_true")
    parser.add_argument("--synthetic_steps_per_epoch", default=8, type=int)

    parser.add_argument("--model_parallel", default=1, type=int,
                        help="Tensor-parallel group size (Megatron over the encoder blocks, "
                             "parallel/tp.py); data parallelism on the remaining ranks")

    args_config, remaining = config_parser.parse_known_args(argv)
    if args_config.config:
        from multimae_tpu_torch.utils.config import load_flat_yaml

        cfg = load_flat_yaml(args_config.config)
        known = {a.dest for a in parser._actions}
        parser.set_defaults(**{k: v for k, v in cfg.items() if k in known})
    return parser.parse_args(remaining)


def main(args) -> Dict[str, Any]:
    """Fine-tune; returns a summary: the fine-tune start's report, where it
    started and resumed from, the per-step metrics and host times (wait
    for the batch, the step), each evaluation (top-1, top-5, ms per
    batch, images), the checkpoint save and load times, and each epoch's
    log line."""
    from multimae_tpu_torch.cli.factory import build_cls_model, entry_device
    from multimae_tpu_torch.cli.finetune_loop import step_seed
    from multimae_tpu_torch.data.cls_transforms import (
        ClsEvalTransform, ClsTrainTransform, ImageRecord)
    from multimae_tpu_torch.data.dataset_folder import CIFAR100, ImageFolder
    from multimae_tpu_torch.data.loader import EvalLoader, Loader
    from multimae_tpu_torch.data.mixup import Mixup
    from multimae_tpu_torch.parallel import dist as dist_lib
    from multimae_tpu_torch.train.checkpoint import (
        auto_load_checkpoint, jax_format, load_checkpoint, refuse_start, restore_data_order,
        save_checkpoint)
    from multimae_tpu_torch.train.cross_entropy import (
        cross_entropy, label_smoothing_cross_entropy, soft_target_cross_entropy)
    from multimae_tpu_torch.train.finetune_step import make_cls_eval_step, make_cls_train_step
    from multimae_tpu_torch.train.optim_factory import (
        LayerDecayValueAssigner, create_optimizer)
    from multimae_tpu_torch.train.schedules import cosine_scheduler
    from multimae_tpu_torch.train.train_state import HostEMA, TrainState
    from multimae_tpu_torch.utils.logger import MetricLogger, write_log_line
    from multimae_tpu_torch.utils.metrics import accuracy
    from multimae_tpu_torch.utils.torch_compat import load_flax_start, load_pretrained

    refuse_start("--finetune", args.finetune or "")
    ckpt_format = args.ckpt_backend or "pth"
    device = entry_device(args.device)
    from multimae_tpu_torch.parallel import mesh as mesh_lib, tp

    created = not (torch.distributed.is_available() and torch.distributed.is_initialized())
    dist_lib.initialize_distributed(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = mesh_lib.mesh_for_flags(model_parallel=args.model_parallel, device=device)
    layout = mesh_lib.batch_layout(mesh)
    rank, world = layout.rank, layout.size
    print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}), "
          f"{dist_lib.world_size()} process(es)" + (f", mesh {mesh}" if mesh is not None else ""))

    def finish():
        if created and torch.distributed.is_initialized():
            dist_lib.barrier()
            torch.distributed.destroy_process_group()

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = build_cls_model(model=args.model, patch_size=args.patch_size,
                            input_size=args.input_size, nb_classes=args.nb_classes,
                            use_mean_pooling=args.use_mean_pooling, init_scale=args.init_scale,
                            num_global_tokens=args.num_global_tokens, drop_path=args.drop_path,
                            drop=args.drop, attn_drop_rate=args.attn_drop_rate, dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    summary: Dict[str, Any] = {"finetune": None, "start_epoch": args.start_epoch,
                               "resumed_from": None, "load_s": None, "save_s": [],
                               "saved": [], "steps": [], "evals": [], "epochs": []}
    finetune = args.finetune or ""
    if finetune.endswith(".msgpack"):
        summary["finetune"] = load_flax_start(model, finetune, "merge")
    elif finetune:
        summary["finetune"] = load_pretrained(model, finetune)
    # The frozen sin-cos pos-embs get gradients that the optimizer never
    # applies: the JAX step's gradient norm, and so its clip, counts them.
    for name, p in model.named_parameters():
        if name.endswith("pos_emb"):
            p.requires_grad_(True)
    print(f"params: {sum(p.numel() for p in model.parameters()) / 1e6:.2f}M")
    mesh_lib.layout_model(model.to(device), mesh)

    global_batch = args.batch_size * world
    loader = eval_loader = synthetic = None
    if args.synthetic_data:
        num_steps_per_epoch = args.synthetic_steps_per_epoch
        rng = np.random.default_rng(0)
        s = args.input_size
        synthetic = {
            "image": torch.from_numpy(
                rng.standard_normal((args.batch_size, s, s, 3)).astype(np.float32)),
            "label": torch.from_numpy(rng.integers(0, args.nb_classes, args.batch_size))}
    else:
        train_tf = ClsTrainTransform(
            input_size=args.input_size, color_jitter=args.color_jitter,
            auto_augment=args.aa if args.aa and args.aa.lower() != "none" else None,
            interpolation=args.train_interpolation, re_prob=args.reprob, re_mode=args.remode,
            re_count=args.recount)
        eval_tf = ClsEvalTransform(input_size=args.input_size, crop_pct=args.crop_pct)
        if args.data_set == "CIFAR":
            if args.nb_classes != 100:
                raise SystemExit(f"--data_set CIFAR has 100 classes, not --nb_classes "
                                 f"{args.nb_classes}")
            dataset_train = CIFAR100(args.data_path, train=True)
            dataset_val = CIFAR100(args.data_path, train=False)
        else:
            dataset_train = ImageFolder(args.data_path)
            dataset_val = ImageFolder(args.eval_data_path)
            if args.data_set == "image_folder" and len(dataset_train.classes) != args.nb_classes:
                raise SystemExit(f"{args.data_path} has {len(dataset_train.classes)} classes, "
                                 f"--nb_classes {args.nb_classes}")
        pin = args.pin_mem and device.type == "cuda"
        loader = Loader(dataset_train, ImageRecord(train_tf), global_batch_size=global_batch,
                        seed=args.seed, num_workers=args.num_workers, shard_index=rank,
                        shard_count=world, pin_memory=pin)
        eval_loader = EvalLoader(dataset_val, ImageRecord(eval_tf),
                                 global_batch_size=global_batch, num_workers=args.num_workers,
                                 shard_index=rank, shard_count=world, pin_memory=pin)
        num_steps_per_epoch = loader.steps_per_epoch
        print(f"dataset: {len(dataset_train)} training and {len(dataset_val)} validation "
              f"samples, {num_steps_per_epoch} steps/epoch, global batch {global_batch}")

    mixup_fn = None
    if args.mixup > 0 or args.cutmix > 0.0 or args.cutmix_minmax is not None:
        mixup_fn = Mixup(mixup_alpha=args.mixup, cutmix_alpha=args.cutmix,
                         cutmix_minmax=args.cutmix_minmax, prob=args.mixup_prob,
                         switch_prob=args.mixup_switch_prob, mode=args.mixup_mode,
                         label_smoothing=args.smoothing, num_classes=args.nb_classes,
                         seed=args.seed)
    if mixup_fn is not None:
        loss_fn = soft_target_cross_entropy
    elif args.smoothing > 0.0:
        loss_fn = functools.partial(label_smoothing_cross_entropy, smoothing=args.smoothing)
    else:
        loss_fn = cross_entropy

    depth = len(model.encoder)
    assigner = None
    if args.layer_decay < 1.0:
        assigner = LayerDecayValueAssigner(
            [args.layer_decay ** (depth + 1 - i) for i in range(depth + 2)])
    lr = args.blr * global_batch * args.update_freq / 256.0
    updates_per_epoch = num_steps_per_epoch // args.update_freq
    lr_values = cosine_scheduler(lr, args.min_lr, args.epochs, updates_per_epoch,
                                 warmup_epochs=args.warmup_epochs,
                                 start_warmup_value=args.warmup_lr,
                                 warmup_steps=args.warmup_steps)
    wd_end = args.weight_decay_end if args.weight_decay_end is not None else args.weight_decay
    wd_values = cosine_scheduler(args.weight_decay, wd_end, args.epochs, updates_per_epoch)
    optimizer = create_optimizer(
        model, opt=args.opt, weight_decay=args.weight_decay,
        opt_betas=tuple(args.opt_betas) if args.opt_betas else (0.9, 0.999),
        opt_eps=args.opt_eps, momentum=args.momentum, filter_bias_and_bn=True,
        layer_decay_assigner=assigner)
    ema_on_card = args.model_ema and not args.model_ema_force_cpu
    state = TrainState(model, None, optimizer, lr_values, wd_values,
                       update_freq=args.update_freq,
                       ema_decay=args.model_ema_decay if ema_on_card else None)
    host_ema = (HostEMA(model, args.model_ema_decay)
                if args.model_ema and args.model_ema_force_cpu else None)

    start_epoch, payload = args.start_epoch, {}
    t0 = time.perf_counter()
    if args.resume:
        last_epoch, payload = load_checkpoint(args.resume, state)
        start_epoch = last_epoch + 1
        summary["resumed_from"] = args.resume
        print(f"[checkpoint] resumed from {args.resume} (epoch {last_epoch})")
    elif args.auto_resume and args.output_dir:
        start_epoch, payload = auto_load_checkpoint(args.output_dir, state)
        summary["resumed_from"] = payload.get("path")
    if summary["resumed_from"]:
        summary["load_s"] = time.perf_counter() - t0
    if payload:
        saved = payload["model"]
        live = state.state_dict()["model"]
        summary["resume_bit_equal"] = set(saved) == set(live) and all(
            torch.equal(v.cpu(), saved[k]) for k, v in live.items())
        if host_ema is not None and payload.get("ema_params") is not None:
            host_ema.load({k: tp.local_tensor(model, k, v)
                           for k, v in payload["ema_params"].items()})
        restore_data_order(loader, payload, summary["resumed_from"], start_epoch, args.seed)
        if jax_format(summary["resumed_from"]):
            print(f"[checkpoint] a {jax_format(summary['resumed_from'])} keeps no best acc1: it "
                  "starts at 0.0, as the JAX CLI's does, and the next evaluation writes "
                  "checkpoint-best", flush=True)
    summary["start_epoch"] = start_epoch

    step_fn = make_cls_train_step(model, loss_fn, clip_grad=args.clip_grad)
    eval_fn = make_cls_eval_step(model)
    generator = torch.Generator(device=device)

    def eval_batches():
        if eval_loader is None:
            yield synthetic
        else:
            yield from eval_loader

    def run_eval() -> Dict[str, Any]:
        sums = torch.zeros(3, dtype=torch.float64)  # top-1 and top-5 hits, images
        batches, compute_s = 0, 0.0
        t_eval = time.perf_counter()
        for b in eval_batches():
            x = b["image"].to(device, non_blocking=True)
            y = b["label"].to(device, non_blocking=True)
            t1 = time.perf_counter()
            acc1, acc5 = accuracy(eval_fn({"rgb": x}), y, topk=(1, 5))
            n = y.shape[0]
            sums += torch.tensor([float(acc1) * n, float(acc5) * n, n], dtype=torch.float64)
            compute_s += time.perf_counter() - t1
            batches += 1
        sums = dist_lib.sum_across_processes(sums, layout)
        count = max(float(sums[2]), 1.0)
        total_s = time.perf_counter() - t_eval
        return {"acc1": float(sums[0]) / count, "acc5": float(sums[1]) / count,
                "images": int(sums[2]), "batches": batches,
                "ms_per_batch": compute_s / max(batches, 1) * 1e3,
                "ms_per_batch_with_data": total_s / max(batches, 1) * 1e3}

    if args.eval:
        stats = run_eval()
        print(f"Eval: acc1 {stats['acc1']:.2f} acc5 {stats['acc5']:.2f} "
              f"over {stats['images']} images")
        summary["evals"].append(stats)
        if loader is not None:
            loader.close()
            eval_loader.close()
        finish()
        return summary

    fetch_s = [0.0]  # the wait for the last batch: the loader and the copy to the device

    def batches():
        for _ in range(num_steps_per_epoch):
            t1 = time.perf_counter()
            b = synthetic if loader is None else next(loader)
            x = b["image"].to(device, non_blocking=True)
            y = b["label"].to(device, non_blocking=True)
            if mixup_fn is not None:
                x, y = mixup_fn(x, y)
            fetch_s[0] = time.perf_counter() - t1
            yield {"rgb": x, "target": y}

    best_acc1 = float(payload.get("best_acc1", 0.0))
    print(f"Start training for {args.epochs} epochs")
    start_time = time.time()
    for epoch in range(start_epoch, args.epochs):
        metric_logger = MetricLogger(delimiter="  ")
        header = f"Epoch: [{epoch}]"
        for batch in metric_logger.log_every(batches(), 10, header, total=num_steps_per_epoch):
            t_step = time.perf_counter()
            generator.manual_seed(step_seed(args.seed, state.step, rank))
            step_idx, update_idx = state.step, state.updates
            metrics = {k: float(v) for k, v in step_fn(state, batch, generator=generator).items()}
            if host_ema is not None and not metrics["skipped"]:
                host_ema.update()
            summary["steps"].append({"epoch": epoch, "step": step_idx, "wait_s": fetch_s[0],
                                     "step_s": time.perf_counter() - t_step,
                                     "metrics": metrics})
            if not math.isfinite(metrics["loss"]):
                print(f"Loss is {metrics['loss']}, stopping training")
                sys.exit(1)
            metric_logger.update(loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                                 lr=float(lr_values[min(update_idx, len(lr_values) - 1)]))

        metric_logger.synchronize_between_processes()
        print("Averaged stats:", metric_logger)
        log_stats = {**{f"train_{k}": m.global_avg for k, m in metric_logger.meters.items()},
                     "epoch": epoch}

        def save(tag=None):
            extra = {"best_acc1": best_acc1}
            if host_ema is not None:
                extra["ema_params"] = {k: tp.full_tensor(model, k, v)
                                       for k, v in host_ema.params.items()}
            t1 = time.perf_counter()
            path = save_checkpoint(args.output_dir, epoch, state, args=vars(args), tag=tag,
                                   data_iter_state=None if loader is None
                                   else loader.get_state(), extra=extra, backend=ckpt_format)
            if path is not None:
                summary["save_s"].append(time.perf_counter() - t1)
                summary["saved"].append(path)
                print(f"[checkpoint] saved {path} in {summary['save_s'][-1]:.2f} s")

        if not args.disable_eval_during_finetuning and not args.synthetic_data:
            stats = run_eval()
            print(f"Accuracy on val: {stats['acc1']:.2f}% (top-5 {stats['acc5']:.2f}%) over "
                  f"{stats['images']} images")
            summary["evals"].append({"epoch": epoch, **stats})
            if stats["acc1"] > best_acc1:
                best_acc1 = stats["acc1"]
                if args.output_dir and args.save_ckpt:
                    save("checkpoint-best")
            print(f"Max accuracy: {best_acc1:.2f}%")
            log_stats.update({f"test_{k}": stats[k] for k in ("acc1", "acc5")},
                             best_acc1=best_acc1)

        if args.output_dir and args.save_ckpt and (
                (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs):
            save()
        write_log_line(args.output_dir, log_stats)
        summary["epochs"].append(log_stats)

    summary["best_acc1"] = best_acc1
    print(f"Training time {datetime.timedelta(seconds=int(time.time() - start_time))}")
    if loader is not None:
        loader.close()
        eval_loader.close()
    finish()
    return summary


if __name__ == "__main__":
    opts = get_args()
    if opts.output_dir:
        os.makedirs(opts.output_dir, exist_ok=True)
    main(opts)
