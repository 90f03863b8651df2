"""The dense fine-tune loop that the semseg, depth and Taskonomy CLIs share
(the main loops of multimae_tpu/cli/run_finetuning_{semseg,depth,taskonomy}.py).

`finetune` sets up the device and the processes, builds the model and
starts it from a reference-layout `.pth` (--finetune; the semseg CLI also
from a JAX `.msgpack`, by the JAX CLI's `_load_flax_trunk` rule), reads the training
and validation sets through the port's loaders (or trains on one
synthetic batch with --synthetic_data), trains with --opt, layer decay
--layer_decay ** (depth + 1 - i), the cosine LR with warmup and the WD
schedule, evaluates every --eval_freq epochs over the whole validation
set, saves checkpoint-best.pth whenever the tracked metric improves and
checkpoint-{epoch}.pth every --save_ckpt_freq epochs and at the end (with
--ckpt_backend msgpack or orbax the JAX package's .msgpack files or
.orbax/ directories instead),
writes a JSON line per epoch to log.txt, and auto-resumes from the newest
loadable save in --output_dir with the data order and the best metric so
far (the JAX CLIs restart from the worst value, so their first
evaluation after a resume overwrites checkpoint-best). A JAX training
state (.msgpack or .orbax/) resumes too, by --resume or auto-resume: its optimizer
state and counters map onto the port's (utils/jax_state.py); it keeps no
best metric, which starts at the worst value as in the JAX CLI, and no
data position the port reads, so its next epoch starts at batch 0 of the
port's own permutation. Several processes
(torchrun, OpenMPI, SLURM; parallel/dist.py) train data-parallel on the
global batch, --batch_size per data rank; with --model_parallel k each k
adjacent ranks split the encoder blocks Megatron-style (parallel/tp.py)
and see the same samples.

A run that computes in fp32 on the card turns off TF32 in torch's
matmuls and cuDNN's convolutions (cuDNN's is on by default) for its
duration, so that fp32 means fp32 on the card as on the CPU.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


def step_seed(seed: int, step: int, rank: int) -> int:
    """The drop_path generator's seed for one step of one rank: the draws
    depend on the step, so a resumed run draws what it would have."""
    return int(np.random.SeedSequence([seed, step, rank]).generate_state(1)[0])


def check_finetune_start(args, flax_start: Optional[str] = None) -> str:
    """SystemExit for a --finetune start the JAX CLI does not take either;
    returns the save format. `flax_start` names the JAX rule by which the
    CLI starts from a JAX `.msgpack` (utils/torch_compat.load_flax_start),
    where its JAX CLI does; None where its JAX CLI reads `.pth` files only."""
    from multimae_tpu_torch.train import checkpoint

    finetune = args.finetune or ""
    if finetune and flax_start is None and not finetune.endswith(".pth"):
        raise SystemExit(f"--finetune {finetune}: not a .pth file; the JAX CLI of this task "
                         "starts from .pth files only, so a JAX .msgpack or orbax checkpoint "
                         "is not read here either")
    checkpoint.refuse_start("--finetune", finetune)
    return args.ckpt_backend or "pth"


@contextlib.contextmanager
def exact_fp32(device: torch.device, dtype: torch.dtype):
    """TF32 off in matmuls and convolutions while an fp32 run is on the
    card; both flags as they were afterwards."""
    if device.type != "cuda" or dtype != torch.float32:
        yield
        return
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class WeightedMeans:
    """The regression CLIs' evaluation: each batch's metrics
    (`metrics_fn(pred, target, mask_valid)` -> {name: scalar}) weighted by
    its size, summed over the processes, over the images counted (JAX
    run_finetuning_depth.py:358-386)."""

    def __init__(self, metrics_fn: Callable):
        self.metrics_fn = metrics_fn
        self.sums, self.names, self.images = None, None, 0

    def add(self, pred: torch.Tensor, prep: Dict[str, torch.Tensor]) -> None:
        m = self.metrics_fn(pred.float(), prep["target"], prep.get("mask_valid"))
        self.names = self.names or sorted(m)
        part = torch.stack([m[k].double() for k in self.names]) * pred.shape[0]
        self.sums = part if self.sums is None else self.sums + part
        self.images += pred.shape[0]

    def finish(self, layout=None) -> Tuple[Dict[str, Any], Dict[str, float]]:
        from multimae_tpu_torch.parallel import dist as dist_lib

        total = dist_lib.sum_across_processes(torch.cat([
            self.sums, torch.tensor([float(self.images)], dtype=torch.float64,
                                    device=self.sums.device)]), layout)
        count = max(float(total[-1]), 1.0)
        means = {k: float(v) / count for k, v in zip(self.names, total[:-1].tolist())}
        return {**means, "images": int(total[-1])}, means


def finetune(args, *, dtype: torch.dtype, build: Callable, datasets: Callable,
             prepare: Callable, loss_parts_fn: Callable, evaluation: Callable,
             best: Tuple[str, str], synthetic: Callable, report: Callable,
             flax_start: Optional[str] = None) -> Dict[str, Any]:
    """Fine-tune by the CLI's flags; returns a summary.

    build(dtype) -> (model, input domains, task); datasets() -> (train
    dataset, train transform, val dataset, val transform); prepare(loader
    batch, device) -> the model's inputs, "target" and, where the batch
    has it, "mask_valid", on the device; loss_parts_fn(pred, target[,
    mask_valid=]) -> (sum, count); evaluation() -> a fresh accumulator for
    one evaluation, with add(pred, prepared batch) for each batch and
    finish(batch layout) -> (stats, logged), summed over the batch's
    shards (parallel/dist.BatchLayout), `logged` being
    what log.txt gets as val_<name>; best = (a name in `logged`, "max" or
    "min"): checkpoint-best follows it, and the checkpoints keep it as
    best_<name>; synthetic(batch size) -> a loader batch; report(stats)
    prints an evaluation; flax_start: the JAX rule that reads a JAX
    `.msgpack` --finetune (check_finetune_start), with the semseg head's names.

    The summary holds the fine-tune start's report, where it started and
    resumed from, the per-step metrics and host times (wait for the batch,
    the step), each evaluation (its stats, batches, images, ms per batch),
    the checkpoint save and load times, each epoch's log line and the best
    metric."""
    ckpt_format = check_finetune_start(args, flax_start)
    from multimae_tpu_torch.cli.factory import entry_device
    from multimae_tpu_torch.parallel import dist as dist_lib

    device = entry_device(args.device)
    created = not (torch.distributed.is_available() and torch.distributed.is_initialized())
    dist_lib.initialize_distributed(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    with exact_fp32(device, dtype):
        summary = _finetune(args, device, dtype, build, datasets, prepare, loss_parts_fn,
                            evaluation, best, synthetic, report, flax_start, ckpt_format)
    if created and torch.distributed.is_initialized():
        dist_lib.barrier()
        torch.distributed.destroy_process_group()
    return summary


def _finetune(args, device, dtype, build, datasets, prepare, loss_parts_fn, evaluation,
              best, synthetic, report, flax_start, ckpt_format) -> Dict[str, Any]:
    from multimae_tpu_torch.data.loader import EvalLoader, Loader
    from multimae_tpu_torch.parallel import dist as dist_lib
    from multimae_tpu_torch.train.checkpoint import (
        auto_load_checkpoint, jax_format, load_checkpoint, restore_data_order,
        save_checkpoint)
    from multimae_tpu_torch.train.finetune_step import (
        make_dense_eval_step, make_dense_train_step)
    from multimae_tpu_torch.train.optim_factory import (
        LayerDecayValueAssigner, create_optimizer)
    from multimae_tpu_torch.train.schedules import cosine_scheduler
    from multimae_tpu_torch.train.train_state import TrainState
    from multimae_tpu_torch.utils.logger import MetricLogger, write_log_line
    from multimae_tpu_torch.utils.torch_compat import load_flax_start, load_pretrained

    from multimae_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.mesh_for_flags(model_parallel=args.model_parallel, device=device)
    layout = mesh_lib.batch_layout(mesh)
    rank, world = layout.rank, layout.size
    print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}), "
          f"{dist_lib.world_size()} process(es), compute {dtype}"
          + (f", mesh {mesh}" if mesh is not None else ""))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    model, in_domains, task = build(dtype)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    best_key, direction = best
    summary: Dict[str, Any] = {"finetune": None, "start_epoch": args.start_epoch,
                               "resumed_from": None, "load_s": None, "save_s": [],
                               "saved": [], "steps": [], "evals": [], "epochs": []}
    finetune = args.finetune or ""
    if finetune.endswith(".msgpack"):
        summary["finetune"] = load_flax_start(model, finetune, flax_start, head_type="semseg")
    elif finetune:
        summary["finetune"] = load_pretrained(model, finetune)
    # The frozen sin-cos pos-embs get gradients that the optimizer never
    # applies: the JAX step's gradient norm, and so its clip, counts them.
    for name, p in model.named_parameters():
        if name.endswith("pos_emb"):
            p.requires_grad_(True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.2f}M")
    mesh_lib.layout_model(model.to(device), mesh)

    global_batch = args.batch_size * world
    loader = eval_loader = None
    if args.synthetic_data:
        num_steps_per_epoch = args.synthetic_steps_per_epoch
    else:
        dataset_train, train_tf, dataset_val, val_tf = datasets()
        pin = args.pin_mem and device.type == "cuda"
        loader = Loader(dataset_train, train_tf, global_batch_size=global_batch,
                        seed=args.seed, num_workers=args.num_workers, shard_index=rank,
                        shard_count=world, pin_memory=pin)
        eval_loader = EvalLoader(dataset_val, val_tf, global_batch_size=global_batch,
                                 num_workers=args.num_workers, shard_index=rank,
                                 shard_count=world, pin_memory=pin)
        num_steps_per_epoch = loader.steps_per_epoch
        print(f"dataset: {len(dataset_train)} training and {len(dataset_val)} validation "
              f"samples, {num_steps_per_epoch} steps/epoch, global batch {global_batch}")

    depth = len(model.encoder)
    assigner = None
    if args.layer_decay < 1.0:
        assigner = LayerDecayValueAssigner(
            [args.layer_decay ** (depth + 1 - i) for i in range(depth + 2)])
    lr_values = cosine_scheduler(args.lr, args.min_lr, args.epochs, num_steps_per_epoch,
                                 warmup_epochs=args.warmup_epochs,
                                 warmup_steps=args.warmup_steps)
    wd_end = args.weight_decay_end if args.weight_decay_end is not None else args.weight_decay
    wd_values = cosine_scheduler(args.weight_decay, wd_end, args.epochs, num_steps_per_epoch)
    optimizer = create_optimizer(
        model, opt=args.opt, weight_decay=args.weight_decay,
        opt_betas=tuple(args.opt_betas), opt_eps=args.opt_eps, momentum=args.momentum,
        filter_bias_and_bn=True,
        layer_decay_assigner=assigner, learnable_pos_emb=args.learnable_pos_emb)
    state = TrainState(model, None, optimizer, lr_values, wd_values)

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
    best_value = float(payload.get(f"best_{best_key}",
                                   0.0 if direction == "max" else float("inf")))
    if payload:
        saved, live = payload["model"], state.state_dict()["model"]
        summary["resume_bit_equal"] = set(saved) == set(live) and all(
            torch.equal(v.cpu(), saved[k]) for k, v in live.items())
        restore_data_order(loader, payload, summary["resumed_from"], start_epoch, args.seed)
        if jax_format(summary["resumed_from"]):
            print(f"[checkpoint] a {jax_format(summary['resumed_from'])} keeps no best "
                  f"{best_key}: it starts at "
                  f"{best_value}, as the JAX CLI's does, and the next evaluation writes "
                  "checkpoint-best", flush=True)
    summary["start_epoch"] = start_epoch

    step_fn = make_dense_train_step(model, task, loss_parts_fn, in_domains=tuple(in_domains),
                                    clip_grad=args.clip_grad)
    eval_fwd = make_dense_eval_step(model, task, in_domains=tuple(in_domains))
    generator = torch.Generator(device=device)

    def run_eval() -> Tuple[Dict[str, Any], Dict[str, float]]:
        acc = evaluation()
        batches = images = 0
        compute_s = 0.0
        t_eval = time.perf_counter()
        for b in eval_loader:
            prep = prepare(b, device)
            t1 = time.perf_counter()
            acc.add(eval_fwd(prep), prep)
            sync()
            compute_s += time.perf_counter() - t1
            batches += 1
            images += int(prep["target"].shape[0])
        stats, logged = acc.finish(layout)
        total_s = time.perf_counter() - t_eval
        return {"batches": batches, "images": images, **stats,
                "ms_per_batch": compute_s / max(batches, 1) * 1e3,
                "ms_per_batch_with_data": total_s / max(batches, 1) * 1e3}, logged

    def close_loaders():
        if loader is not None:
            loader.close()
            eval_loader.close()

    if args.eval and not args.synthetic_data:
        stats, _ = run_eval()
        report(stats)
        summary["evals"].append(stats)
        close_loaders()
        return summary

    synthetic_prepared = None
    if loader is None:
        synthetic_prepared = prepare(synthetic(args.batch_size), device)
    fetch_s = [0.0]  # the wait for the last batch: the loader and the copy to the device

    def batches():
        for _ in range(num_steps_per_epoch):
            if loader is None:
                yield synthetic_prepared
            else:
                t1 = time.perf_counter()
                b = prepare(next(loader), device)
                fetch_s[0] = time.perf_counter() - t1
                yield b

    print(f"Start training for {args.epochs} epochs")
    start_time = time.time()
    for epoch in range(start_epoch, args.epochs):
        metric_logger = MetricLogger(delimiter="  ")
        header = f"Epoch: [{epoch}]"
        for batch in metric_logger.log_every(batches(), 20, header, total=num_steps_per_epoch):
            t_step = time.perf_counter()
            generator.manual_seed(step_seed(args.seed, state.step, rank))
            step_idx = state.step
            metrics = {k: float(v) for k, v in step_fn(state, batch, generator=generator).items()}
            summary["steps"].append({"epoch": epoch, "step": step_idx, "wait_s": fetch_s[0],
                                     "step_s": time.perf_counter() - t_step,
                                     "metrics": metrics})
            if not math.isfinite(metrics["loss"]):
                print(f"Loss is {metrics['loss']}, stopping training")
                sys.exit(1)
            metric_logger.update(loss=metrics["loss"], grad_norm=metrics["grad_norm"],
                                 lr=float(lr_values[min(step_idx, len(lr_values) - 1)]))

        metric_logger.synchronize_between_processes()
        print("Averaged stats:", metric_logger)
        log_stats = {**{f"train_{k}": m.global_avg for k, m in metric_logger.meters.items()},
                     "epoch": epoch}

        def save(tag=None):
            t1 = time.perf_counter()
            path = save_checkpoint(args.output_dir, epoch, state, args=vars(args), tag=tag,
                                   data_iter_state=None if loader is None
                                   else loader.get_state(),
                                   extra={f"best_{best_key}": best_value}, backend=ckpt_format)
            if path is not None:
                summary["save_s"].append(time.perf_counter() - t1)
                summary["saved"].append(path)
                print(f"[checkpoint] saved {path} in {summary['save_s'][-1]:.2f} s")

        if not args.synthetic_data and (epoch + 1) % args.eval_freq == 0:
            stats, logged = run_eval()
            report(stats)
            summary["evals"].append({"epoch": epoch, **stats})
            value = logged[best_key]
            if value > best_value if direction == "max" else value < best_value:
                best_value = value
                if args.output_dir and args.save_ckpt:
                    save("checkpoint-best")
            log_stats.update({f"val_{k}": v for k, v in logged.items()})
            log_stats[f"best_{best_key}"] = best_value

        if args.output_dir and args.save_ckpt and (
                (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs):
            save()
        write_log_line(args.output_dir, log_stats)
        summary["epochs"].append(log_stats)

    summary[f"best_{best_key}"] = best_value
    print(f"Training time {datetime.timedelta(seconds=int(time.time() - start_time))}")
    close_loaders()
    return summary
