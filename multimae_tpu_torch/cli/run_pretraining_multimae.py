"""MultiMAE pretraining on the card (counterpart of
multimae_tpu/cli/run_pretraining_multimae.py; reference
run_pretraining_multimae.py).

    python -m multimae_tpu_torch.cli.run_pretraining_multimae \\
        -c cfgs/pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml \\
        --data_path /path/to/train --output_dir output/pretrain

The same flags and YAML precedence as the JAX CLI (-c sets the parser's
defaults, flags override them), reading the shared cfgs/. It builds the
model, losses and balancer, reads a MultiTaskImageFolder tree (or makes
synthetic batches with --synthetic_data) through the port's loader,
trains with AdamW under the cosine LR/WD schedules (lr = blr x global
batch / 256), saves checkpoint-{epoch}.pth every --save_ckpt_freq epochs
and at the end, and auto-resumes from the newest loadable save in
--output_dir together with the data order. Several processes (torchrun,
OpenMPI, SLURM; parallel/dist.py) train data-parallel on the global
batch, --batch_size per data rank: the global batch is --batch_size x
world / (--model_parallel x --pipeline_parallel). --fsdp shards the
parameters and moments over the data axis, --model_parallel k splits the
encoder blocks over k adjacent ranks, --pipeline_parallel S runs them as
S GPipe stages of --pipeline_microbatches, --dcn_data_parallel N groups
the ranks by host (parallel/mesh.py); whatever the layout, a checkpoint
holds the canonical tensors and resumes under any other.

It runs on the card unless --device cpu is given, and raises where the
card is asked for and torch sees none. Flags whose function is not
ported raise SystemExit naming the ROADMAP.md item that brings it.
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch


def get_args(argv=None):
    config_parser = argparse.ArgumentParser(description="Training Config", add_help=False)
    config_parser.add_argument("-c", "--config", default="", type=str, metavar="FILE")

    parser = argparse.ArgumentParser("MultiMAE pre-training script", add_help=True)
    parser.add_argument("--batch_size", default=256, type=int,
                        help="Batch size per process")
    parser.add_argument("--epochs", default=1600, type=int)
    parser.add_argument("--ckpt_backend", default=None, choices=["msgpack", "orbax"],
                        help="JAX-package checkpoint formats: not ported (the port "
                             "writes checkpoint-{epoch}.pth); only the default is taken")
    parser.add_argument("--save_ckpt_freq", default=20, type=int)

    # Task parameters
    parser.add_argument("--in_domains", default="rgb-depth-semseg", type=str)
    parser.add_argument("--out_domains", default="rgb-depth-semseg", type=str)
    parser.add_argument("--standardize_depth", action="store_true")
    parser.add_argument("--no_standardize_depth", action="store_false", dest="standardize_depth")
    parser.set_defaults(standardize_depth=False)
    parser.add_argument("--extra_norm_pix_loss", action="store_true")
    parser.add_argument("--no_extra_norm_pix_loss", action="store_false",
                        dest="extra_norm_pix_loss")
    parser.set_defaults(extra_norm_pix_loss=True)

    # Model parameters
    parser.add_argument("--model", default="pretrain_multimae_base", type=str)
    parser.add_argument("--num_encoded_tokens", default=98, type=int)
    parser.add_argument("--num_global_tokens", default=1, type=int)
    parser.add_argument("--patch_size", default=16, type=int)
    parser.add_argument("--input_size", default=224, type=int)
    parser.add_argument("--alphas", type=float, default=1.0)
    parser.add_argument("--sample_tasks_uniformly", default=False, action="store_true")
    parser.add_argument("--decoder_use_task_queries", default=True, action="store_true")
    parser.add_argument("--decoder_use_xattn", default=True, action="store_true")
    parser.add_argument("--decoder_dim", default=256, type=int)
    parser.add_argument("--decoder_depth", default=2, type=int)
    parser.add_argument("--decoder_num_heads", default=8, type=int)
    parser.add_argument("--drop_path", type=float, default=0.0)
    parser.add_argument("--loss_on_unmasked", default=False, action="store_true")
    parser.add_argument("--no_loss_on_unmasked", action="store_false", dest="loss_on_unmasked")
    parser.set_defaults(loss_on_unmasked=False)

    # Optimizer parameters
    parser.add_argument("--opt", default="adamw", type=str)
    parser.add_argument("--opt_eps", default=1e-8, type=float)
    parser.add_argument("--opt_betas", default=[0.9, 0.95], type=float, nargs="+")
    parser.add_argument("--clip_grad", type=float, default=None)
    parser.add_argument("--skip_grad", type=float, default=None)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight_decay", type=float, default=0.05)
    parser.add_argument("--weight_decay_end", type=float, default=None)
    parser.add_argument("--decoder_decay", type=float, default=None)
    parser.add_argument("--blr", type=float, default=1e-4)
    parser.add_argument("--warmup_lr", type=float, default=1e-6)
    parser.add_argument("--min_lr", type=float, default=0.0)
    parser.add_argument("--task_balancer", type=str, default="none")
    parser.add_argument("--balancer_lr_scale", type=float, default=1.0)
    parser.add_argument("--warmup_epochs", type=int, default=40)
    parser.add_argument("--warmup_steps", type=int, default=-1)
    parser.add_argument("--fp32_output_adapters", type=str, default="")

    # Augmentation parameters
    parser.add_argument("--hflip", type=float, default=0.5)
    parser.add_argument("--train_interpolation", type=str, default="bicubic")

    # Dataset parameters
    parser.add_argument("--data_path", default="", type=str)
    parser.add_argument("--imagenet_default_mean_and_std", default=True, action="store_true")

    # Misc.
    parser.add_argument("--output_dir", default="")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu; the card is never left for the CPU")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--resume", default="")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--no_auto_resume", action="store_false", dest="auto_resume")
    parser.set_defaults(auto_resume=True)
    parser.add_argument("--start_epoch", default=0, type=int)
    parser.add_argument("--num_workers", default=10, type=int)
    parser.add_argument("--pin_mem", action="store_true")
    parser.add_argument("--no_pin_mem", action="store_false", dest="pin_mem")
    parser.set_defaults(pin_mem=True)
    parser.add_argument("--find_unused_params", action="store_true")
    parser.add_argument("--no_find_unused_params", action="store_false",
                        dest="find_unused_params")
    parser.set_defaults(find_unused_params=True)

    parser.add_argument("--dtype", default="bfloat16", type=str,
                        choices=["bfloat16", "float32"], help="Compute dtype")

    # Wandb logging
    parser.add_argument("--log_wandb", default=False, action="store_true")
    parser.add_argument("--no_log_wandb", action="store_false", dest="log_wandb")
    parser.set_defaults(log_wandb=False)
    parser.add_argument("--wandb_project", default=None, type=str)
    parser.add_argument("--wandb_entity", default=None, type=str)
    parser.add_argument("--wandb_run_name", default=None, type=str)
    parser.add_argument("--show_user_warnings", default=False, action="store_true")

    # Distributed training parameters: the launcher's environment decides
    # (parallel/dist.py); these are accepted for the reference's command lines.
    parser.add_argument("--world_size", default=1, type=int)
    parser.add_argument("--local_rank", default=-1, type=int)
    parser.add_argument("--dist_on_itp", action="store_true")
    parser.add_argument("--dist_url", default="env://")

    parser.add_argument("--profile_dir", default="", type=str,
                        help="Write a torch.profiler trace of steps 10-13 of the first "
                             "epoch into this directory")
    parser.add_argument("--approx_gelu", action="store_true",
                        help="tanh-approximate GELU: not ported (the kernels compute erf)")

    # Scaling (parallel/mesh.py, tp.py, fsdp.py, pp.py)
    parser.add_argument("--fsdp", action="store_true",
                        help="Shard parameters and AdamW moments over the data axis "
                             "(FSDP2, ZeRO-3)")
    parser.add_argument("--model_parallel", default=1, type=int,
                        help="Tensor-parallel group size over the 'model' axis (Megatron: "
                             "encoder blocks split, two all_reduces per block); data "
                             "parallelism on the remaining ranks; composes with --fsdp")
    parser.add_argument("--pipeline_parallel", default=1, type=int,
                        help="GPipe stages over the 'stage' axis (the encoder depth must "
                             "divide); composes with --fsdp; exclusive with "
                             "--model_parallel and --dcn_data_parallel")
    parser.add_argument("--pipeline_microbatches", default=0, type=int,
                        help="Microbatches per pipeline step (default 2 x stages; "
                             "bubble = (S-1)/(M+S-1))")
    parser.add_argument("--dcn_data_parallel", default=0, type=int,
                        help="Number of hosts: a ('dcn', 'data', 'model') mesh grouped by "
                             "host, where only the gradient mean crosses hosts and FSDP and "
                             "TP stay inside one; -1 = one group per discovered host")

    # Synthetic-data mode for smoke tests without a dataset
    parser.add_argument("--synthetic_data", action="store_true",
                        help="Train on random data (no --data_path needed)")
    parser.add_argument("--synthetic_steps_per_epoch", default=32, type=int)

    args_config, remaining = config_parser.parse_known_args(argv)
    if args_config.config:
        from multimae_tpu_torch.utils.config import load_flat_yaml

        cfg = load_flat_yaml(args_config.config)
        known = {a.dest for a in parser._actions}
        parser.set_defaults(**{k: v for k, v in cfg.items() if k in known})

    return parser.parse_args(remaining)


def refuse_unported(args) -> None:
    """SystemExit for every flag whose function the port does not have."""
    refused = [
        (args.ckpt_backend is not None,
         "--ckpt_backend: msgpack and orbax are JAX-package formats; the port writes "
         "checkpoint-{epoch}.pth (ROADMAP.md queue 1 item 10)"),
        (args.approx_gelu,
         "--approx_gelu is not ported (the kernels compute the exact erf GELU; "
         "ROADMAP.md queue 1 item 12)"),
        (not (args.decoder_use_task_queries and args.decoder_use_xattn),
         "decoders without task queries or cross-attention are not ported yet "
         "(ROADMAP.md queue 1, the open parts of item 4)"),
    ]
    for bad, msg in refused:
        if bad:
            raise SystemExit(msg)


def build_mesh(args, device):
    """The mesh the scaling flags ask for (JAX :221-240); None for plain
    data parallelism."""
    from multimae_tpu_torch.parallel import mesh as mesh_lib

    if args.pipeline_parallel > 1 and (args.model_parallel > 1 or args.dcn_data_parallel):
        raise SystemExit("--pipeline_parallel is exclusive with "
                         "--model_parallel/--dcn_data_parallel")
    dcn = args.dcn_data_parallel
    return mesh_lib.mesh_for_flags(
        fsdp=args.fsdp, model_parallel=args.model_parallel,
        pipeline_parallel=args.pipeline_parallel,
        dcn_data_parallel=-1 if dcn < 0 else dcn, device=device)


def mask_seed(seed: int, step: int, rank: int) -> int:
    """The masking generator's seed for one step of one rank: the draws
    depend on the step, so a resumed run draws what it would have."""
    return int(np.random.SeedSequence([seed, step, rank]).generate_state(1)[0])


def main(args) -> Dict[str, Any]:
    """Train; returns a summary: where it started and resumed from, the
    per-step metrics and host times (wait for the batch, the step), the
    checkpoint save and load times, and each epoch's log line."""
    refuse_unported(args)
    from multimae_tpu_torch.cli.factory import (
        build_pretrain_losses, build_pretrain_model, entry_device, make_synthetic_batch)
    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder
    from multimae_tpu_torch.data.loader import Loader
    from multimae_tpu_torch.data.pretrain_transforms import DataAugmentationForMultiMAE
    from multimae_tpu_torch.parallel import dist as dist_lib
    from multimae_tpu_torch.train.checkpoint import (
        auto_load_checkpoint, load_checkpoint, save_checkpoint)
    from multimae_tpu_torch.train.optim_factory import create_optimizer
    from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step
    from multimae_tpu_torch.train.schedules import cosine_scheduler
    from multimae_tpu_torch.train.task_balancing import build_balancer
    from multimae_tpu_torch.train.train_state import TrainState
    from multimae_tpu_torch.utils.logger import MetricLogger, WandbLogger, write_log_line

    from multimae_tpu_torch.parallel.mesh import batch_layout, layout_model

    device = entry_device(args.device)
    created = not (torch.distributed.is_available() and torch.distributed.is_initialized())
    dist_lib.initialize_distributed(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    mesh = build_mesh(args, device)
    # The batch's shards: the loader's, the synthetic batch's and the
    # masks' seeds follow the data rank, so that the ranks of one model or
    # stage group see the same samples and masks.
    layout = batch_layout(mesh)
    rank, world = layout.rank, layout.size
    print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}), "
          f"{dist_lib.world_size()} process(es)" + (f", mesh {mesh}" if mesh is not None else ""))

    in_domains = args.in_domains.split("-")
    out_domains = args.out_domains.split("-")
    all_domains = sorted(set(in_domains) | set(out_domains))
    fp32_adapters = [t for t in args.fp32_output_adapters.split("-") if t]
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32

    # pos_emb_grads: the JAX step's grad norm, and so its clip and skip,
    # counts the frozen sin-cos pos-embs (ROADMAP.md queue 3).
    model = build_pretrain_model(
        model_name=args.model, in_domains=in_domains, out_domains=out_domains,
        patch_size=args.patch_size, input_size=args.input_size,
        decoder_dim=args.decoder_dim, decoder_depth=args.decoder_depth,
        decoder_num_heads=args.decoder_num_heads,
        extra_norm_pix_loss=args.extra_norm_pix_loss,
        num_global_tokens=args.num_global_tokens, drop_path=args.drop_path,
        fp32_output_adapters=fp32_adapters, dtype=dtype, decoder_return_patches=True,
        pos_emb_grads=True, seed=args.seed, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    layout_model(model, mesh, fsdp=args.fsdp, n_micro=(
        args.pipeline_microbatches or 2 * args.pipeline_parallel)
        if args.pipeline_parallel > 1 else 0)
    tasks_loss_fn = build_pretrain_losses(out_domains, patch_size=args.patch_size,
                                          extra_norm_pix_loss=args.extra_norm_pix_loss)
    out_tasks = list(out_domains) + (["norm_rgb"] if args.extra_norm_pix_loss else [])
    balancer = build_balancer(args.task_balancer, out_tasks).to(device)

    global_batch = args.batch_size * world
    loader = None
    if args.synthetic_data:
        num_steps_per_epoch = args.synthetic_steps_per_epoch
        dataset_len = global_batch * num_steps_per_epoch
    else:
        transform = DataAugmentationForMultiMAE(
            input_size=args.input_size, hflip=args.hflip,
            imagenet_default_mean_and_std=args.imagenet_default_mean_and_std)
        dataset = MultiTaskImageFolder(args.data_path, all_domains)
        dataset_len = len(dataset)
        loader = Loader(dataset, transform, global_batch_size=global_batch, seed=args.seed,
                        num_workers=args.num_workers, shard_index=rank, shard_count=world,
                        pin_memory=args.pin_mem and device.type == "cuda")
        num_steps_per_epoch = loader.steps_per_epoch
    print(f"dataset: {dataset_len} samples, {num_steps_per_epoch} steps/epoch, "
          f"global batch {global_batch}")

    # LR rule: lr = blr * global_batch / 256 (reference :372-373)
    lr = args.blr * global_batch / 256.0
    lr_values = cosine_scheduler(
        lr, args.min_lr, args.epochs, num_steps_per_epoch,
        warmup_epochs=args.warmup_epochs, warmup_steps=args.warmup_steps,
        start_warmup_value=args.warmup_lr)
    wd_end = args.weight_decay_end if args.weight_decay_end is not None else args.weight_decay
    wd_values = cosine_scheduler(args.weight_decay, wd_end, args.epochs, num_steps_per_epoch)

    optimizer = create_optimizer(
        model, balancer, opt=args.opt, weight_decay=args.weight_decay,
        opt_betas=tuple(args.opt_betas), opt_eps=args.opt_eps, momentum=args.momentum,
        filter_bias_and_bn=False,  # reference dict-model quirk (:138-150)
        balancer_lr_scale=args.balancer_lr_scale)
    state = TrainState(model, balancer, optimizer, lr_values, wd_values)
    n_params += sum(p.numel() for p in balancer.parameters())
    print(f"params: {n_params / 1e6:.2f}M")

    summary: Dict[str, Any] = {"start_epoch": args.start_epoch, "resumed_from": None,
                               "load_s": None, "save_s": [], "steps": [], "epochs": []}
    start_epoch, payload = args.start_epoch, {}
    t0 = time.perf_counter()
    if args.resume:
        last_epoch, payload = load_checkpoint(args.resume, state)
        start_epoch = last_epoch + 1
        summary["resumed_from"] = args.resume
        print(f"[checkpoint] resumed from {args.resume} (epoch {last_epoch})")
    elif args.auto_resume and args.output_dir:
        start_epoch, payload = auto_load_checkpoint(args.output_dir, state)
        if payload:
            summary["resumed_from"] = os.path.join(args.output_dir,
                                                   f"checkpoint-{start_epoch - 1}.pth")
    if payload:
        summary["load_s"] = time.perf_counter() - t0
        live = {**{f"model.{k}": v for k, v in state.state_dict()["model"].items()},
                **{f"loss_balancer.{k}": v for k, v in balancer.state_dict().items()}}
        saved = {**{f"model.{k}": v for k, v in payload["model"].items()},
                 **{f"loss_balancer.{k}": v for k, v in (payload["loss_balancer"] or {}).items()}}
        summary["resume_bit_equal"] = set(live) == set(saved) and all(
            torch.equal(v.cpu(), saved[k]) for k, v in live.items())
        print(f"[checkpoint] loaded in {summary['load_s']:.2f} s; parameters bit-equal to "
              f"the save: {summary['resume_bit_equal']}")
        # Exact data-order resume (beyond the reference, which restarts the epoch).
        if loader is not None and payload.get("data_iter_state"):
            try:
                loader.set_state(payload["data_iter_state"])
                print("[checkpoint] data iterator state restored")
            except ValueError as e:
                print(f"[checkpoint] data iterator restore failed ({e}); "
                      "continuing with a fresh shuffle")
    summary["start_epoch"] = start_epoch

    step_fn = make_pretrain_train_step(
        model, balancer, tasks_loss_fn, num_encoded_tokens=args.num_encoded_tokens,
        in_domains=tuple(in_domains), alphas=args.alphas,
        sample_tasks_uniformly=args.sample_tasks_uniformly,
        standardize_depth_flag=args.standardize_depth,
        extra_norm_pix_loss=args.extra_norm_pix_loss,
        loss_on_unmasked=args.loss_on_unmasked,
        clip_grad=args.clip_grad, skip_grad=args.skip_grad)
    generator = torch.Generator(device=device)
    log_writer = WandbLogger(args) if (args.log_wandb and dist_lib.is_main_process()) else None

    # --synthetic_data repeats one random batch, as the JAX CLI does.
    synthetic = None if loader is not None else make_synthetic_batch(
        args.batch_size, input_size=args.input_size, in_domains=all_domains, seed=rank,
        device=device)

    fetch_s = [0.0]  # the wait for the last batch: the loader and the copy to the device

    def batches():
        for _ in range(num_steps_per_epoch):
            if loader is None:
                yield synthetic
            else:
                t0 = time.perf_counter()
                b = next(loader)
                b = {k: v.to(device, non_blocking=True) for k, v in b.items() if k != "label"}
                fetch_s[0] = time.perf_counter() - t0
                yield b

    print(f"Start training for {args.epochs} epochs")
    start_time = time.time()
    print_freq = 10
    for epoch in range(start_epoch, args.epochs):
        metric_logger = MetricLogger(delimiter="  ")
        header = f"Epoch: [{epoch}]"
        pending: List = []

        # Metrics are read every `print_freq` steps and at the epoch's end
        # (the NaN stop fires with up to that much delay).
        def drain():
            for step_idx, m, record in pending:
                host = {k: float(v) for k, v in m.items()}
                if not math.isfinite(host["loss"]):
                    print(f"Loss is {host['loss']}, stopping training")
                    sys.exit(1)
                metric_logger.update(loss=host["loss"], grad_norm=host["grad_norm"],
                                     lr=float(lr_values[min(step_idx, len(lr_values) - 1)]))
                metric_logger.update(**{k: v for k, v in host.items()
                                        if k.endswith("_loss") or k.endswith("_loss_weighted")})
                record["metrics"] = host
                if log_writer is not None:
                    log_writer.update(host)
                    log_writer.set_step()
            pending.clear()

        step_in_epoch = 0
        profiler = None
        for batch in metric_logger.log_every(batches(), print_freq, header,
                                             total=num_steps_per_epoch):
            if args.profile_dir and epoch == start_epoch:
                if step_in_epoch == 10:
                    profiler = torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA])
                    profiler.start()
                elif step_in_epoch == 14 and profiler is not None:
                    profiler.stop()
                    os.makedirs(args.profile_dir, exist_ok=True)
                    trace = os.path.join(args.profile_dir, f"trace_rank{dist_lib.process_index()}.json")
                    profiler.export_chrome_trace(trace)
                    profiler = None
                    print(f"[profiler] trace written to {trace}")
            t_step = time.perf_counter()
            generator.manual_seed(mask_seed(args.seed, state.step, rank))
            step_idx = state.step
            metrics = step_fn(state, batch, generator=generator)
            t_end = time.perf_counter()
            record = {"epoch": epoch, "step": step_idx, "wait_s": fetch_s[0],
                      "step_s": t_end - t_step}
            summary["steps"].append(record)
            pending.append((step_idx, metrics, record))
            step_in_epoch += 1
            if step_in_epoch % print_freq == 0 or step_in_epoch == num_steps_per_epoch:
                drain()
        drain()
        if profiler is not None:
            profiler.stop()

        metric_logger.synchronize_between_processes()
        print("Averaged stats:", metric_logger)
        train_stats = {"[Epoch] " + k: m.global_avg for k, m in metric_logger.meters.items()}

        if args.output_dir and (
                (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs):
            t0 = time.perf_counter()
            path = save_checkpoint(args.output_dir, epoch, state, args=vars(args),
                                   data_iter_state=None if loader is None else loader.get_state())
            if path is not None:
                summary["save_s"].append(time.perf_counter() - t0)
                print(f"[checkpoint] saved {path} in {summary['save_s'][-1]:.2f} s")

        log_stats = {**train_stats, "epoch": epoch, "n_parameters": int(n_params)}
        write_log_line(args.output_dir, log_stats)
        summary["epochs"].append(log_stats)

    total_time = time.time() - start_time
    print(f"Training time {datetime.timedelta(seconds=int(total_time))}")
    if loader is not None:
        loader.close()
    if created and torch.distributed.is_initialized():
        dist_lib.barrier()
        torch.distributed.destroy_process_group()
    return summary


if __name__ == "__main__":
    opts = get_args()
    if opts.output_dir:
        os.makedirs(opts.output_dir, exist_ok=True)
    main(opts)
