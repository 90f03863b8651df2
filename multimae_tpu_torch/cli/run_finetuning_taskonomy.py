"""Taskonomy dense-regression fine-tuning on the card (counterpart of
multimae_tpu/cli/run_finetuning_taskonomy.py; reference
run_finetuning_taskonomy.py).

    python -m multimae_tpu_torch.cli.run_finetuning_taskonomy \\
        -c cfgs/finetune/taskonomy/rgb2depth-1k/ft_rgb2depth_multimae-b.yaml \\
        --finetune /path/to/pretrain/checkpoint-1599.pth \\
        --data_path /path/to/taskonomy --splits_dir /path/to/splits \\
        --output_dir output/finetune/taskonomy/rgb2depth

rgb -> one of the Taskonomy dense tasks (depth, edges, keypoints, normal,
curvature, reshading) with the same flags and YAML precedence as the JAX
CLI: a MultiViT with the DPT (or ConvNeXt) head, started from a
reference-layout `.pth`, reading root/<task>/<building>/point_P_view_V_
domain_<task>.png through the CSV split <splits_dir>/<variant>_<split>.csv
(data/taskonomy.py, PNGs decoded and resized without PIL), trained with
the masked L1 loss against mask_valid and evaluated with the masked L1,
checkpoint-best.pth on the lowest L1 (kept across a resume; the JAX CLI
restarts from infinity). The model computes in bf16 unless --no_fp16: at
the recipe's 384 px (577 tokens) every encoder block's training attention
runs the K2 kernel forward and backward and its eval blocks K4. The
training loop, checkpoints and processes are those of the semseg and
depth CLIs (cli/finetune_loop.py).

It runs on the card unless --device cpu is given. Flags whose function is
not ported raise SystemExit naming the ROADMAP.md item that brings it;
--log_wandb, --log_images_wandb, --dist_eval and --pin_mem are accepted
and change nothing.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Any, Dict

import torch

from multimae_tpu_torch.cli.finetune_loop import WeightedMeans, finetune
from multimae_tpu_torch.cli.run_finetuning_depth import (
    build_regression_model,
    prepare_batch,
    synthetic_batch,
)

# The 9-domain table (reference run_finetuning_taskonomy.py:66-121, JAX :23-35).
TASKONOMY_DOMAINS = {
    "rgb": 3,
    "depth_euclidean": 1,
    "depth_zbuffer": 1,
    "edge_occlusion": 1,
    "edge_texture": 1,
    "keypoints2d": 1,
    "keypoints3d": 1,
    "normal": 3,
    "principal_curvature": 2,
    "reshading": 1,
}


def get_args(argv=None):
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("-c", "--config", default="", type=str, metavar="FILE")

    parser = argparse.ArgumentParser("MultiMAE taskonomy fine-tuning script")
    parser.add_argument("--batch_size", default=32, type=int, help="Batch size per process")
    parser.add_argument("--epochs", default=100, type=int)
    parser.add_argument("--ckpt_backend", default=None, choices=["msgpack", "orbax"],
                        help="JAX-package checkpoint formats: not ported (the port "
                             "writes checkpoint-{epoch}.pth); only the default is taken")
    parser.add_argument("--save_ckpt_freq", default=20, type=int)

    parser.add_argument("--in_domains", default="rgb", type=str)
    parser.add_argument("--out_domains", default="depth_zbuffer", type=str)
    parser.add_argument("--use_mask_valid", action="store_true")
    parser.add_argument("--no_mask_valid", action="store_false", dest="use_mask_valid")
    parser.set_defaults(use_mask_valid=True)

    parser.add_argument("--model", default="multivit_base", type=str)
    parser.add_argument("--num_global_tokens", default=1, type=int)
    parser.add_argument("--patch_size", default=16, type=int)
    parser.add_argument("--input_size", default=256, type=int)
    parser.add_argument("--drop_path_encoder", type=float, default=0.0)
    parser.add_argument("--learnable_pos_emb", action="store_true")
    parser.add_argument("--no_learnable_pos_emb", action="store_false", dest="learnable_pos_emb")
    parser.set_defaults(learnable_pos_emb=False)
    parser.add_argument("--output_adapter", type=str, default="dpt", choices=["dpt", "convnext"])
    parser.add_argument("--decoder_main_tasks", type=str, default="rgb")

    parser.add_argument("--opt", default="adamw", type=str)
    parser.add_argument("--opt_eps", default=1e-8, type=float)
    parser.add_argument("--opt_betas", default=[0.9, 0.999], type=float, nargs="+")
    parser.add_argument("--clip_grad", type=float, default=None)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--weight_decay_end", type=float, default=None)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--warmup_lr", type=float, default=1e-6)
    parser.add_argument("--min_lr", type=float, default=0.0)
    parser.add_argument("--layer_decay", type=float, default=0.75)
    parser.add_argument("--warmup_epochs", type=int, default=1)
    parser.add_argument("--warmup_steps", type=int, default=-1)

    parser.add_argument("--finetune", default="")
    parser.add_argument("--data_path", default="", type=str)
    parser.add_argument("--variant", default="tiny", type=str,
                        choices=["debug", "tiny", "medium", "full", "fullplus"])
    parser.add_argument("--splits_dir", default=None, type=str,
                        help="Directory containing <variant>_<split>.csv manifests")
    parser.add_argument("--max_train_images", default=None, type=int)
    parser.add_argument("--max_val_images", default=None, type=int)
    parser.add_argument("--max_test_images", default=None, type=int)
    parser.add_argument("--eval_freq", default=5, type=int)

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
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--dist_eval", action="store_true", default=False,
                        help="Accepted for the reference's recipes: eval is always "
                             "sharded over the processes and summed, so it changes nothing")
    parser.add_argument("--num_workers", default=16, type=int)
    parser.add_argument("--pin_mem", action="store_true")
    parser.add_argument("--no_pin_mem", action="store_false", dest="pin_mem")
    parser.set_defaults(pin_mem=True)
    parser.add_argument("--fp16", action="store_true", help="bf16 compute (the default)")
    parser.add_argument("--no_fp16", action="store_false", dest="fp16")
    parser.set_defaults(fp16=True)

    parser.add_argument("--log_wandb", default=False, action="store_true")
    parser.add_argument("--wandb_project", default=None, type=str)
    parser.add_argument("--wandb_entity", default=None, type=str)
    parser.add_argument("--wandb_run_name", default=None, type=str)
    parser.add_argument("--log_images_wandb", action="store_true")
    parser.add_argument("--log_images_freq", default=5, type=int)
    parser.add_argument("--show_user_warnings", default=False, action="store_true")

    parser.add_argument("--world_size", default=1, type=int)
    parser.add_argument("--local_rank", default=-1, type=int)
    parser.add_argument("--dist_on_itp", action="store_true")
    parser.add_argument("--dist_url", default="env://")

    parser.add_argument("--synthetic_data", action="store_true")
    parser.add_argument("--synthetic_steps_per_epoch", default=4, type=int)

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


def build_model_from_args(args, dtype: torch.dtype):
    """(model, input domains, the task it trains) for the CLI's flags."""
    in_domains, out_domains = args.in_domains.split("-"), args.out_domains.split("-")
    model = build_regression_model(
        model=args.model, in_channels={d: TASKONOMY_DOMAINS[d] for d in in_domains},
        out_channels={d: TASKONOMY_DOMAINS[d] for d in out_domains},
        patch_size=args.patch_size, input_size=args.input_size,
        output_adapter=args.output_adapter,
        decoder_main_tasks=args.decoder_main_tasks.split("-"),
        drop_path_encoder=args.drop_path_encoder, dtype=dtype)
    return model, in_domains, out_domains[0]


def taskonomy_datasets(args, all_domains, twin: bool = False):
    """(train, None, val, None): the datasets transform as they load."""
    from multimae_tpu_torch.data.taskonomy import TaskonomyDataset

    kw = dict(variant=args.variant, image_size=args.input_size, splits_dir=args.splits_dir,
              twin=twin)
    return (TaskonomyDataset(args.data_path, all_domains, split="train",
                             max_images=args.max_train_images, **kw), None,
            TaskonomyDataset(args.data_path, all_domains, split="val",
                             max_images=args.max_val_images, **kw), None)


def main(args) -> Dict[str, Any]:
    """Fine-tune on a Taskonomy task; returns cli/finetune_loop.py
    `finetune`'s summary."""
    from multimae_tpu_torch.train.regression_losses import (
        masked_l1_loss, masked_l1_loss_parts)

    in_domains, out_domains = args.in_domains.split("-"), args.out_domains.split("-")
    all_domains = sorted(set(in_domains) | set(out_domains))
    if args.use_mask_valid:
        all_domains.append("mask_valid")
    return finetune(
        args, dtype=torch.bfloat16 if args.fp16 else torch.float32,
        build=functools.partial(build_model_from_args, args),
        datasets=lambda: taskonomy_datasets(args, all_domains),
        prepare=lambda b, device: prepare_batch(b, in_domains, out_domains[0], device),
        loss_parts_fn=masked_l1_loss_parts,
        evaluation=lambda: WeightedMeans(
            lambda pred, target, mask: {"l1": masked_l1_loss(pred, target, mask)}),
        best=("l1", "min"),
        synthetic=lambda b: synthetic_batch(
            b, args.input_size, {d: TASKONOMY_DOMAINS[d] for d in set(in_domains)},
            TASKONOMY_DOMAINS[out_domains[0]]),
        report=lambda stats: print(f"* L1 {stats['l1']:.4f}"))


if __name__ == "__main__":
    opts = get_args()
    if opts.output_dir:
        os.makedirs(opts.output_dir, exist_ok=True)
    main(opts)
