"""NYUv2 depth fine-tuning on the card (counterpart of
multimae_tpu/cli/run_finetuning_depth.py; reference run_finetuning_depth.py).

    python -m multimae_tpu_torch.cli.run_finetuning_depth \\
        -c cfgs/finetune/depth/ft_nyu_2000e_multimae-b.yaml \\
        --finetune /path/to/pretrain/checkpoint-1599.pth \\
        --data_path /path/to/nyu/train --eval_data_path /path/to/nyu/val \\
        --output_dir output/finetune/depth/nyu

The same flags and YAML precedence as the JAX CLI (-c sets the parser's
defaults, flags override them), reading the shared cfgs/. It builds a
MultiViT with the DPT head (or the ConvNeXt head, preds_per_patch 64)
over the encoder's every layer, starts it from a reference-layout `.pth`
(--finetune: pos-embs resized to the input size, utils/torch_compat.py),
reads MultiTaskImageFolder trees (rgb, 16-bit depth, mask_valid) through
the cv2-free NYU augmentations (data/regression_transforms.py) and the
port's loader (or trains on one synthetic batch with --synthetic_data),
and trains the berhu, L1 or MSE loss over the valid pixels in the shared
fine-tune loop (cli/finetune_loop.py: the recipe's AdamW, layer decay,
the cosine schedules, checkpoints and auto-resume, several processes). It
evaluates the NYU depth metrics every --eval_freq epochs over the whole
validation set (each batch's metrics weighted by its size and summed
over processes, as the JAX CLI does) and keeps checkpoint-best.pth on
delta_1, whose best value survives a resume (the JAX CLI restarts from a
best of 0, so its first evaluation after a resume overwrites
checkpoint-best).

The recipe computes in fp32 (the JAX CLI's "depth recipe runs fp32"): the
encoder's attention and MLPs take the module path there, as in the JAX
package (K2 and K4 are bf16 kernels), and the loop turns off TF32 in
torch's matmuls and cuDNN's convolutions for the run (cuDNN's is on by
default), so that fp32 means fp32 on the card as on the CPU.

The DPT head hooks encoder layers (2, 5, 8, 11); an encoder of fewer than
12 blocks (the tiny test model) hooks the last block of each quarter of
its depth instead, where the JAX CLI stops with an IndexError.

It runs on the card unless --device cpu is given, and raises where the
card is asked for and torch sees none. A --finetune that is not a .pth
raises SystemExit;
--log_wandb, --log_images_wandb, --dist_eval, --pin_mem and the flags the
JAX CLI parses but never reads are accepted and change nothing.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Any, Dict, Sequence

import numpy as np
import torch

from multimae_tpu_torch.cli.finetune_loop import WeightedMeans, finetune
from multimae_tpu_torch.models import ConvNeXtAdapter, DPTOutputAdapter, PatchedInputAdapter
from multimae_tpu_torch.models.output_adapters import set_dpt_hooks
from multimae_tpu_torch.models.registry import create_model


def get_args(argv=None):
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("-c", "--config", default="", type=str, metavar="FILE")

    parser = argparse.ArgumentParser("MultiMAE depth fine-tuning script")
    parser.add_argument("--batch_size", default=64, type=int, help="Batch size per process")
    parser.add_argument("--epochs", default=2000, type=int)
    parser.add_argument("--ckpt_backend", default=None, choices=["msgpack", "orbax"],
                        help="msgpack: save the JAX package's checkpoint-{epoch}.msgpack, "
                             "orbax its checkpoint-{epoch}.orbax/ directory, instead of "
                             "checkpoint-{epoch}.pth")
    parser.add_argument("--save_ckpt_freq", default=200, type=int)

    parser.add_argument("--in_domains", default="rgb", type=str)
    parser.add_argument("--out_domains", default="depth", type=str)
    parser.add_argument("--standardize_depth", action="store_true")
    parser.add_argument("--no_standardize_depth", action="store_false", dest="standardize_depth")
    parser.set_defaults(standardize_depth=False)
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
    parser.add_argument("--freeze_transformer", action="store_true")

    parser.add_argument("--opt", default="adamw", type=str)
    parser.add_argument("--opt_eps", default=1e-8, type=float)
    parser.add_argument("--opt_betas", default=[0.9, 0.999], type=float, nargs="+")
    parser.add_argument("--clip_grad", type=float, default=None)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight_decay", type=float, default=1e-4)
    parser.add_argument("--weight_decay_end", type=float, default=None)
    parser.add_argument("--decoder_decay", type=float, default=None)
    parser.add_argument("--no_lr_scale_list", type=str, default="")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--warmup_lr", type=float, default=1e-6)
    parser.add_argument("--min_lr", type=float, default=0.0)
    parser.add_argument("--layer_decay", type=float, default=0.75)
    parser.add_argument("--warmup_epochs", type=int, default=100)
    parser.add_argument("--warmup_steps", type=int, default=-1)

    parser.add_argument("--loss", default="berhu", choices=["berhu", "l1", "mse"])
    parser.add_argument("--aug_name", default="nyu-augs", type=str)
    parser.add_argument("--color_augs", default=False, action="store_true")
    parser.add_argument("--no_color_augs", dest="color_augs", default=False, action="store_false")

    parser.add_argument("--finetune", default="")
    parser.add_argument("--dataset_name", default="nyu", type=str)
    parser.add_argument("--data_path", default="", type=str)
    parser.add_argument("--eval_data_path", default="", type=str)
    parser.add_argument("--test_data_path", default=None, type=str)
    parser.add_argument("--max_train_images", default=None, type=int)
    parser.add_argument("--max_val_images", default=None, type=int)
    parser.add_argument("--max_test_images", default=None, type=int)
    parser.add_argument("--eval_freq", default=250, type=int)

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
    parser.add_argument("--find_unused_params", action="store_true")
    parser.add_argument("--no_find_unused_params", action="store_false", dest="find_unused_params")
    parser.set_defaults(find_unused_params=True)
    parser.add_argument("--fp32", action="store_true", default=True)

    parser.add_argument("--log_wandb", default=False, action="store_true")
    parser.add_argument("--wandb_project", default=None, type=str)
    parser.add_argument("--wandb_entity", default=None, type=str)
    parser.add_argument("--wandb_run_name", default=None, type=str)
    parser.add_argument("--log_images_wandb", action="store_true")
    parser.add_argument("--log_images_freq", default=250, type=int)
    parser.add_argument("--show_user_warnings", default=False, action="store_true")

    # Distributed training parameters: the launcher's environment decides
    # (parallel/dist.py); these are accepted for the reference's command lines.
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


def build_regression_model(*, model: str, in_channels: Dict[str, int],
                           out_channels: Dict[str, int], patch_size: int, input_size: int,
                           output_adapter: str, decoder_main_tasks: Sequence[str],
                           drop_path_encoder: float, dtype: torch.dtype):
    """MultiViT with a patch input adapter per `in_channels` domain and a
    DPT regression head (or the ConvNeXt head, preds_per_patch 64) per
    `out_channels` domain (the JAX CLIs' build_depth_model and
    build_taskonomy_model), the DPT hooks set by `dpt_hooks` from the
    encoder's depth; weights left empty: the caller fills them."""
    input_adapters = {
        d: functools.partial(PatchedInputAdapter, num_channels=c, stride_level=1,
                             patch_size_full=patch_size, image_size=input_size)
        for d, c in in_channels.items()
    }
    heads = {
        "dpt": functools.partial(DPTOutputAdapter, head_type="regression", stride_level=1),
        "convnext": functools.partial(ConvNeXtAdapter, preds_per_patch=64),
    }
    output_adapters = {
        d: functools.partial(heads[output_adapter], num_classes=c, patch_size=patch_size,
                             main_tasks=tuple(decoder_main_tasks))
        for d, c in out_channels.items()
    }
    return set_dpt_hooks(create_model(model, input_adapters=input_adapters,
                                      output_adapters=output_adapters,
                                      drop_path_rate=drop_path_encoder, dtype=dtype))


DOMAIN_CHANNELS = {"rgb": 3, "depth": 1}


def build_model_from_args(args, dtype: torch.dtype):
    """(model, input domains, the task it trains) for the CLI's flags."""
    in_domains, out_domains = args.in_domains.split("-"), args.out_domains.split("-")
    model = build_regression_model(
        model=args.model, in_channels={d: DOMAIN_CHANNELS[d] for d in in_domains},
        out_channels={d: DOMAIN_CHANNELS[d] for d in out_domains},
        patch_size=args.patch_size, input_size=args.input_size,
        output_adapter=args.output_adapter,
        decoder_main_tasks=args.decoder_main_tasks.split("-"),
        drop_path_encoder=args.drop_path_encoder, dtype=dtype)
    return model, in_domains, out_domains[0]


def prepare_batch(b: Dict[str, torch.Tensor], in_domains: Sequence[str], task: str,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """The model's inputs, "target" (the task's array) and "mask_valid" from
    a loader batch (JAX :336-341)."""
    out = {d: b[d] for d in in_domains if d in b}
    out["target"] = b["target"] if "target" in b else b[task]
    if "mask_valid" in b:
        out["mask_valid"] = b["mask_valid"]
    return {k: v.to(device, non_blocking=True) for k, v in out.items()}


def synthetic_batch(b: int, input_size: int, channels: Dict[str, int],
                    target_channels: int) -> Dict[str, torch.Tensor]:
    """The JAX CLIs' example_batch: the same numpy draws (an input per
    `channels` domain in the order given, then the target and mask_valid)."""
    rng = np.random.default_rng(0)
    s = input_size
    out = {d: rng.standard_normal((b, s, s, c)).astype(np.float32) for d, c in channels.items()}
    out["target"] = rng.standard_normal((b, s, s, target_channels)).astype(np.float32)
    out["mask_valid"] = rng.random((b, s, s, 1)) > 0.2
    return {k: torch.from_numpy(v) for k, v in out.items()}


def nyu_datasets(args, all_domains: Sequence[str], twin: bool = False):
    """(train, train transform, val, val transform) of the NYU trees."""
    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder
    from multimae_tpu_torch.data.regression_transforms import (
        DataAugmentationForRegression, NYUTransform)

    train_tf = DataAugmentationForRegression(NYUTransform(
        train=True, input_size=args.input_size, color_aug=args.color_augs, twin=twin))
    val_tf = DataAugmentationForRegression(NYUTransform(
        train=False, input_size=args.input_size, twin=twin))
    train = MultiTaskImageFolder(args.data_path, all_domains, max_images=args.max_train_images,
                                 twin=twin)
    val = MultiTaskImageFolder(args.eval_data_path, all_domains, max_images=args.max_val_images,
                               twin=twin)
    return train, train_tf, val, val_tf


def main(args) -> Dict[str, Any]:
    """Fine-tune for depth; returns cli/finetune_loop.py `finetune`'s summary."""
    from multimae_tpu_torch.train.regression_losses import LOSS_PARTS, masked_nyu_metrics

    in_domains, out_domains = args.in_domains.split("-"), args.out_domains.split("-")
    all_domains = sorted(set(in_domains) | set(out_domains))
    if args.use_mask_valid:
        all_domains.append("mask_valid")

    def report(stats):
        print(" ".join(f"{k} {stats[k]:.4f}" for k in
                       ("rmse", "rel", "srel", "log10", "delta_1", "delta_2", "delta_3")))

    return finetune(
        args, dtype=torch.float32,  # the depth recipe runs fp32 (JAX :239)
        build=functools.partial(build_model_from_args, args),
        datasets=lambda: nyu_datasets(args, all_domains),
        prepare=lambda b, device: prepare_batch(b, in_domains, out_domains[0], device),
        loss_parts_fn=LOSS_PARTS[args.loss],
        evaluation=lambda: WeightedMeans(masked_nyu_metrics), best=("delta_1", "max"),
        synthetic=lambda b: synthetic_batch(b, args.input_size, {"rgb": 3},
                                            DOMAIN_CHANNELS[out_domains[0]]),
        report=report)


if __name__ == "__main__":
    opts = get_args()
    if opts.output_dir:
        os.makedirs(opts.output_dir, exist_ok=True)
    main(opts)
