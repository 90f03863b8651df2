"""Semantic segmentation fine-tuning on the card (counterpart of
multimae_tpu/cli/run_finetuning_semseg.py; reference
run_finetuning_semseg.py).

    python -m multimae_tpu_torch.cli.run_finetuning_semseg \\
        -c cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml \\
        --finetune /path/to/pretrain/checkpoint-1599.pth \\
        --data_path /path/to/nyu/train --eval_data_path /path/to/nyu/val \\
        --output_dir output/finetune/semseg/nyu

The same flags and YAML precedence as the JAX CLI (-c sets the parser's
defaults, flags override them), reading the shared cfgs/. It builds a
MultiViT with the Segmenter, ConvNeXt or DPT head (the void label adds a
class; a pseudo_semseg input becomes the semseg input adapter with a
zero void row; the DPT head hooks encoder layers 2, 5, 8 and 11, or the
last block of each quarter of a shallower encoder's depth), starts it from a reference-layout `.pth` (--finetune:
pos-embs resized to the input size, utils/torch_compat.py), reads
MultiTaskImageFolder trees through the cv2-free augmentations
(data/semseg_transforms.py) and the port's loader (or trains on one
synthetic batch with --synthetic_data), and trains in the shared
fine-tune loop (cli/finetune_loop.py: --opt, the recipes' AdamW, layer
decay 0.75 ** (depth + 1 - i), the cosine schedules, checkpoints and
auto-resume, several processes). It evaluates mIoU every --eval_freq
epochs over the whole validation set (the confusion matrix summed over
processes) and keeps checkpoint-best.pth on mIoU, whose best value
survives a resume (the JAX CLI forgets it, so its first evaluation after
a resume overwrites checkpoint-best).

It runs on the card unless --device cpu is given, and raises where the
card is asked for and torch sees none. A --finetune that is an orbax
directory raises SystemExit, as the JAX CLI's `_load_flax_trunk`, which
open()s the file, fails on one;
--log_wandb and --log_images_wandb are accepted and ignored, as the JAX
CLI ignores them.
"""

from __future__ import annotations

import argparse
import functools
import os
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multimae_tpu_torch.cli.finetune_loop import finetune
from multimae_tpu_torch.models import (
    ConvNeXtAdapter,
    DPTOutputAdapter,
    PatchedInputAdapter,
    SegmenterMaskTransformerAdapter,
    SemSegInputAdapter,
)
from multimae_tpu_torch.models.output_adapters import set_dpt_hooks
from multimae_tpu_torch.models.registry import create_model
from multimae_tpu_torch.utils.data_constants import COCO_SEMSEG_NUM_CLASSES, SEG_IGNORE_INDEX


def get_args(argv=None):
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("-c", "--config", default="", type=str, metavar="FILE")

    parser = argparse.ArgumentParser("MultiMAE semantic segmentation fine-tuning script")
    parser.add_argument("--batch_size", default=4, type=int, help="Batch size per process")
    parser.add_argument("--epochs", default=64, type=int)
    parser.add_argument("--ckpt_backend", default=None, choices=["msgpack", "orbax"],
                        help="msgpack: save the JAX package's checkpoint-{epoch}.msgpack, "
                             "orbax its checkpoint-{epoch}.orbax/ directory, instead of "
                             "checkpoint-{epoch}.pth")
    parser.add_argument("--save_ckpt_freq", default=20, type=int)

    parser.add_argument("--in_domains", default="rgb", type=str)
    parser.add_argument("--standardize_depth", action="store_true")
    parser.add_argument("--no_standardize_depth", action="store_false", dest="standardize_depth")
    parser.set_defaults(standardize_depth=True)
    parser.add_argument("--use_mask_valid", action="store_true")
    parser.add_argument("--no_mask_valid", action="store_false", dest="use_mask_valid")
    parser.set_defaults(use_mask_valid=False)
    parser.add_argument("--load_pseudo_depth", action="store_true")
    parser.add_argument("--no_load_pseudo_depth", action="store_false", dest="load_pseudo_depth")
    parser.set_defaults(load_pseudo_depth=False)

    parser.add_argument("--model", default="multivit_base", type=str)
    parser.add_argument("--num_global_tokens", default=1, type=int)
    parser.add_argument("--patch_size", default=16, type=int)
    parser.add_argument("--input_size", default=512, type=int)
    parser.add_argument("--drop_path_encoder", type=float, default=0.1)
    parser.add_argument("--learnable_pos_emb", action="store_true")
    parser.add_argument("--no_learnable_pos_emb", action="store_false", dest="learnable_pos_emb")
    parser.set_defaults(learnable_pos_emb=False)

    parser.add_argument("--output_adapter", type=str, default="convnext",
                        choices=["segmenter", "convnext", "dpt"])
    parser.add_argument("--decoder_dim", default=6144, type=int)
    parser.add_argument("--decoder_depth", default=4, type=int)
    parser.add_argument("--drop_path_decoder", type=float, default=0.0)
    parser.add_argument("--decoder_preds_per_patch", type=int, default=16)
    parser.add_argument("--decoder_interpolate_mode", type=str, default="bilinear",
                        choices=["bilinear", "nearest"])
    parser.add_argument("--decoder_main_tasks", type=str, default="rgb")

    parser.add_argument("--opt", default="adamw", type=str)
    parser.add_argument("--opt_eps", default=1e-8, type=float)
    parser.add_argument("--opt_betas", default=[0.9, 0.999], type=float, nargs="+")
    parser.add_argument("--clip_grad", type=float, default=None)
    parser.add_argument("--momentum", type=float, default=0.9)
    parser.add_argument("--weight_decay", type=float, default=0.05)
    parser.add_argument("--weight_decay_end", type=float, default=None)
    parser.add_argument("--decoder_decay", type=float, default=None)
    parser.add_argument("--no_lr_scale_list", type=str, default="")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--warmup_lr", type=float, default=1e-6)
    parser.add_argument("--min_lr", type=float, default=0.0)
    parser.add_argument("--layer_decay", type=float, default=0.75)
    parser.add_argument("--warmup_epochs", type=int, default=1)
    parser.add_argument("--warmup_steps", type=int, default=-1)

    parser.add_argument("--aug_name", type=str, default="simple", choices=["simple"])
    parser.add_argument("--finetune", default="")

    parser.add_argument("--num_classes", default=150, type=int)
    parser.add_argument("--dataset_name", default="ade20k", type=str)
    parser.add_argument("--data_path", default="", type=str)
    parser.add_argument("--eval_data_path", default="", type=str)
    parser.add_argument("--test_data_path", default=None, type=str)
    parser.add_argument("--max_val_images", default=None, type=int)
    parser.add_argument("--eval_freq", default=1, type=int)
    parser.add_argument("--seg_reduce_zero_label", action="store_true")
    parser.add_argument("--seg_use_void_label", action="store_true")

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


INPUT_ADAPTERS = {
    "rgb": functools.partial(PatchedInputAdapter, num_channels=3, stride_level=1),
    "depth": functools.partial(PatchedInputAdapter, num_channels=1, stride_level=1),
    # the pseudo_semseg input (JAX :176-180): COCO's classes and a zero void row
    "semseg": functools.partial(
        SemSegInputAdapter, num_classes=COCO_SEMSEG_NUM_CLASSES, stride_level=4,
        dim_class_emb=64, interpolate_class_emb=False,
        emb_padding_idx=COCO_SEMSEG_NUM_CLASSES),
}


def build_semseg_model(*, model: str = "multivit_base",
                       in_domains: Sequence[str] = ("rgb",), patch_size: int = 16,
                       input_size: int = 512, num_classes: int = 150,
                       drop_path_encoder: float = 0.1, output_adapter: str = "convnext",
                       decoder_dim: int = 6144, decoder_depth: int = 4,
                       drop_path_decoder: float = 0.0, decoder_preds_per_patch: int = 16,
                       decoder_interpolate_mode: str = "bilinear",
                       decoder_main_tasks: Sequence[str] = ("rgb",),
                       dtype: torch.dtype = torch.float32):
    """MultiViT with the `output_adapter` head over `num_classes` classes
    (the JAX `build_semseg_model`, :157-225, after its void-label and
    pseudo_semseg handling: the caller passes the class count and input
    domains that come out of it), weights left empty: the caller fills
    them (`init_weights(generator)` or a state_dict)."""
    input_adapters = {
        d: functools.partial(INPUT_ADAPTERS[d], patch_size_full=patch_size,
                             image_size=input_size)
        for d in in_domains
    }
    heads = {
        "segmenter": functools.partial(
            SegmenterMaskTransformerAdapter, depth=decoder_depth,
            drop_path_rate=drop_path_decoder, embed_dim=decoder_dim),
        "convnext": functools.partial(
            ConvNeXtAdapter, embed_dim=decoder_dim, preds_per_patch=decoder_preds_per_patch,
            depth=decoder_depth, interpolate_mode=decoder_interpolate_mode),
        "dpt": functools.partial(DPTOutputAdapter, stride_level=1, head_type="semseg"),
    }
    output_adapters = {
        "semseg": functools.partial(heads[output_adapter], num_classes=num_classes,
                                    main_tasks=tuple(decoder_main_tasks),
                                    patch_size=patch_size),
    }
    return set_dpt_hooks(create_model(model, input_adapters=input_adapters,
                                      output_adapters=output_adapters,
                                      drop_path_rate=drop_path_encoder, dtype=dtype))


def model_domains(args) -> Tuple[list, int]:
    """(the model's input domains, its class count): pseudo_semseg is the
    semseg input, and the void label adds a class (JAX :168-192)."""
    in_domains = args.in_domains.split("-")
    if "pseudo_semseg" in in_domains:
        in_domains.remove("pseudo_semseg")
        in_domains.append("semseg")
    return in_domains, args.num_classes + (1 if args.seg_use_void_label else 0)


def build_model_from_args(args, dtype: torch.dtype):
    """(model, input domains, classes with the void one) for the CLI's flags."""
    in_domains, num_classes = model_domains(args)
    model = build_semseg_model(
        model=args.model, in_domains=in_domains, patch_size=args.patch_size,
        input_size=args.input_size, num_classes=num_classes,
        drop_path_encoder=args.drop_path_encoder, output_adapter=args.output_adapter,
        decoder_dim=args.decoder_dim, decoder_depth=args.decoder_depth,
        drop_path_decoder=args.drop_path_decoder,
        decoder_preds_per_patch=args.decoder_preds_per_patch,
        decoder_interpolate_mode=args.decoder_interpolate_mode,
        decoder_main_tasks=args.decoder_main_tasks.split("-"), dtype=dtype)
    return model, in_domains, num_classes


def seg_cross_entropy_parts(logits: torch.Tensor, target: torch.Tensor,
                            ignore_index: int = SEG_IGNORE_INDEX):
    """(summed NLL, count) over the pixels whose target is not
    ignore_index, NHWC logits in fp32 (reference :483). A target at or past
    the classes (NYUv2's label 40 under the 40-class recipe: the prepared
    tree keeps 0 as void and 1..40) counts with an NLL of 0, as the JAX
    function's empty one-hot row gives it (JAX :228-242)."""
    logits = logits.float()
    valid = target != ignore_index
    known = valid & (target < logits.shape[-1])
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(known, target, 0).long().unsqueeze(-1)).squeeze(-1)
    return torch.where(known, nll, 0.0).sum(), valid.sum().to(logits.dtype)


def prepare_batch(b: Dict[str, torch.Tensor], in_domains: Sequence[str],
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """The model's inputs and "target" from a loader batch (JAX :429-441):
    pseudo_semseg ids past COCO's classes go to the void row."""
    out = {}
    for task in in_domains:
        if task == "semseg" and "pseudo_semseg" in b:
            ps = b["pseudo_semseg"]
            out["semseg"] = torch.where(ps > COCO_SEMSEG_NUM_CLASSES - 1,
                                        COCO_SEMSEG_NUM_CLASSES, ps)
        elif task in b:
            out[task] = b[task]
    out["target"] = b["semseg" if "semseg" in b else "target"]
    return {k: v.to(device, non_blocking=True) for k, v in out.items()}


def synthetic_batch(b: int, args, in_domains: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The JAX CLI's example_batch (:301-316): the same numpy draws."""
    rng = np.random.default_rng(0)
    s = args.input_size
    out = {"rgb": rng.standard_normal((b, s, s, 3)).astype(np.float32),
           "target": rng.integers(0, args.num_classes, (b, s, s)).astype(np.int64)}
    if "depth" in in_domains:
        out["depth"] = rng.standard_normal((b, s, s, 1)).astype(np.float32)
    if "semseg" in in_domains:
        out["semseg"] = rng.integers(0, COCO_SEMSEG_NUM_CLASSES,
                                     (b, s // 4, s // 4)).astype(np.int64)
    return {k: torch.from_numpy(v) for k, v in out.items()}


class ConfusionEval:
    """The semseg CLI's evaluation: the confusion matrix of the argmax
    predictions, summed over the processes, and mIoU, aAcc and mAcc from
    it; log.txt gets mIoU in percent as val_mIoU (JAX :443-472)."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.cm = None

    def add(self, pred: torch.Tensor, prep: Dict[str, torch.Tensor]) -> None:
        from multimae_tpu_torch.utils.metrics import confusion_matrix

        cm = confusion_matrix(pred.argmax(dim=-1), prep["target"], self.num_classes,
                              ignore_index=SEG_IGNORE_INDEX)
        self.cm = cm if self.cm is None else self.cm + cm

    def finish(self, layout=None) -> Tuple[Dict[str, Any], Dict[str, float]]:
        from multimae_tpu_torch.parallel import dist as dist_lib
        from multimae_tpu_torch.utils.metrics import miou_from_confusion

        cm = dist_lib.sum_across_processes(self.cm, layout)
        stats = miou_from_confusion(cm)
        return ({"mIoU": stats["mIoU"], "aAcc": stats["aAcc"], "mAcc": stats["mAcc"],
                 "pixels": int(cm.sum())}, {"mIoU": stats["mIoU"] * 100})


def semseg_datasets(args, all_domains: Sequence[str]):
    """(train, train transform, val, val transform) of the
    MultiTaskImageFolder trees."""
    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder
    from multimae_tpu_torch.data.semseg_transforms import (
        DataAugmentationForSemSeg, SimpleTransform)

    def transform(train):
        return DataAugmentationForSemSeg(
            SimpleTransform(train=train, input_size=args.input_size),
            seg_num_classes=args.num_classes, standardize_depth=args.standardize_depth,
            seg_reduce_zero_label=args.seg_reduce_zero_label,
            seg_use_void_label=args.seg_use_void_label)

    prefixes = {"depth": "pseudo_"} if args.load_pseudo_depth else None
    return (MultiTaskImageFolder(args.data_path, all_domains, prefixes=prefixes),
            transform(True),
            MultiTaskImageFolder(args.eval_data_path, all_domains, prefixes=prefixes,
                                 max_images=args.max_val_images),
            transform(False))


def main(args) -> Dict[str, Any]:
    """Fine-tune; returns cli/finetune_loop.py `finetune`'s summary (each
    evaluation with mIoU, aAcc, mAcc and the pixels counted)."""
    in_domains, _ = model_domains(args)
    all_domains = sorted(set(args.in_domains.split("-")) | {"semseg", "rgb"})
    if args.use_mask_valid:
        all_domains.append("mask_valid")

    def report(stats):
        print(f"* mIoU {stats['mIoU'] * 100:.3f} aAcc {stats['aAcc'] * 100:.3f} "
              f"Acc {stats['mAcc'] * 100:.3f}")

    return finetune(
        args, dtype=torch.bfloat16 if args.fp16 else torch.float32,
        build=lambda dtype: build_model_from_args(args, dtype)[:2] + ("semseg",),
        datasets=lambda: semseg_datasets(args, all_domains),
        prepare=lambda b, device: prepare_batch(b, in_domains, device),
        loss_parts_fn=seg_cross_entropy_parts,
        evaluation=lambda: ConfusionEval(args.num_classes), best=("mIoU", "max"),
        synthetic=lambda b: synthetic_batch(b, args, in_domains), report=report,
        flax_start="trunk")


if __name__ == "__main__":
    opts = get_args()
    if opts.output_dir:
        os.makedirs(opts.output_dir, exist_ok=True)
    main(opts)
