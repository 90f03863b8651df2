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
MultiViT with the Segmenter or ConvNeXt head (the void label adds a
class; a pseudo_semseg input becomes the semseg input adapter with a
zero void row), starts it from a reference-layout `.pth` (--finetune:
pos-embs resized to the input size, utils/torch_compat.py), reads
MultiTaskImageFolder trees through the cv2-free augmentations
(data/semseg_transforms.py) and the port's loader (or trains on one
synthetic batch with --synthetic_data), trains with --opt (the recipes'
AdamW), layer decay 0.75 ** (depth + 1 - i), the cosine LR with warmup and
the WD schedule,
evaluates mIoU every --eval_freq epochs over the whole validation set
(the confusion matrix summed over processes), saves checkpoint-best.pth
whenever mIoU improves and checkpoint-{epoch}.pth every --save_ckpt_freq
epochs and at the end, writes a JSON line per epoch to log.txt, and
auto-resumes from the newest loadable save in --output_dir with the data
order and the best mIoU so far (the JAX CLI forgets the best mIoU on a
resume, so its first evaluation overwrites checkpoint-best). Several
processes (torchrun, OpenMPI, SLURM; parallel/dist.py) train
data-parallel on the global batch, --batch_size per process.

It runs on the card unless --device cpu is given, and raises where the
card is asked for and torch sees none. Flags whose function is not
ported raise SystemExit naming the ROADMAP.md item that brings it;
--log_wandb and --log_images_wandb are accepted and ignored, as the JAX
CLI ignores them.
"""

from __future__ import annotations

import argparse
import datetime
import functools
import math
import os
import sys
import time
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from multimae_tpu_torch.models import (
    ConvNeXtAdapter,
    PatchedInputAdapter,
    SegmenterMaskTransformerAdapter,
    SemSegInputAdapter,
)
from multimae_tpu_torch.models.registry import create_model
from multimae_tpu_torch.utils.data_constants import COCO_SEMSEG_NUM_CLASSES, SEG_IGNORE_INDEX


def get_args(argv=None):
    config_parser = argparse.ArgumentParser(add_help=False)
    config_parser.add_argument("-c", "--config", default="", type=str, metavar="FILE")

    parser = argparse.ArgumentParser("MultiMAE semantic segmentation fine-tuning script")
    parser.add_argument("--batch_size", default=4, type=int, help="Batch size per process")
    parser.add_argument("--epochs", default=64, type=int)
    parser.add_argument("--ckpt_backend", default=None, choices=["msgpack", "orbax"],
                        help="JAX-package checkpoint formats: not ported (the port "
                             "writes checkpoint-{epoch}.pth); only the default is taken")
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
                        help="Tensor-parallel group size: not ported")

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
        (args.model_parallel > 1,
         "--model_parallel > 1 is not ported yet: ROADMAP.md queue 1 item 18 (FSDP, TP, "
         "PP, the hybrid mesh)"),
        (args.output_adapter == "dpt",
         "--output_adapter dpt is not ported yet: ROADMAP.md queue 1 item 16 (DPT)"),
        (bool(args.finetune) and not args.finetune.endswith(".pth"),
         f"--finetune {args.finetune}: not a .pth file; the port starts from "
         "reference-layout .pth files (the JAX package's msgpack and orbax checkpoints "
         "are not read)"),
    ]
    for bad, msg in refused:
        if bad:
            raise SystemExit(msg)


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
    }
    if output_adapter not in heads:
        raise SystemExit(f"--output_adapter {output_adapter} is not ported yet: ROADMAP.md "
                         "queue 1 item 16 (DPT)")
    output_adapters = {
        "semseg": functools.partial(heads[output_adapter], num_classes=num_classes,
                                    main_tasks=tuple(decoder_main_tasks),
                                    patch_size=patch_size),
    }
    return create_model(model, input_adapters=input_adapters,
                        output_adapters=output_adapters,
                        drop_path_rate=drop_path_encoder, dtype=dtype)


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
    ignore_index, NHWC logits in fp32 (reference :483)."""
    logits = logits.float()
    valid = target != ignore_index
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, target, 0).long().unsqueeze(-1)).squeeze(-1)
    return torch.where(valid, nll, 0.0).sum(), valid.sum().to(logits.dtype)


def step_seed(seed: int, step: int, rank: int) -> int:
    """The drop_path generator's seed for one step of one rank: the draws
    depend on the step, so a resumed run draws what it would have."""
    return int(np.random.SeedSequence([seed, step, rank]).generate_state(1)[0])


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


def main(args) -> Dict[str, Any]:
    """Fine-tune; returns a summary: the fine-tune start's report, where it
    started and resumed from, the per-step metrics and host times (wait
    for the batch, the step), each evaluation (mIoU, aAcc, mAcc, ms per
    batch, images), the checkpoint save and load times, and each epoch's
    log line."""
    refuse_unported(args)
    from multimae_tpu_torch.cli.factory import entry_device
    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder
    from multimae_tpu_torch.data.loader import EvalLoader, Loader
    from multimae_tpu_torch.data.semseg_transforms import (
        DataAugmentationForSemSeg, SimpleTransform)
    from multimae_tpu_torch.parallel import dist as dist_lib
    from multimae_tpu_torch.train.checkpoint import (
        auto_load_checkpoint, load_checkpoint, save_checkpoint)
    from multimae_tpu_torch.train.finetune_step import (
        make_dense_eval_step, make_dense_train_step)
    from multimae_tpu_torch.train.optim_factory import (
        LayerDecayValueAssigner, create_optimizer)
    from multimae_tpu_torch.train.schedules import cosine_scheduler
    from multimae_tpu_torch.train.train_state import TrainState
    from multimae_tpu_torch.utils.logger import MetricLogger, write_log_line
    from multimae_tpu_torch.utils.metrics import confusion_matrix, miou_from_confusion
    from multimae_tpu_torch.utils.torch_compat import load_pretrained

    device = entry_device(args.device)
    created = not (torch.distributed.is_available() and torch.distributed.is_initialized())
    created &= dist_lib.initialize_distributed(args.device)
    rank, world = dist_lib.process_index(), dist_lib.world_size()
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    print(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}), "
          f"{world} process(es)")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    dtype = torch.bfloat16 if args.fp16 else torch.float32
    model, in_domains, num_classes = build_model_from_args(args, dtype)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    raw_in_domains = args.in_domains.split("-")
    all_domains = sorted(set(raw_in_domains) | {"semseg", "rgb"})
    if args.use_mask_valid:
        all_domains.append("mask_valid")

    summary: Dict[str, Any] = {"finetune": None, "start_epoch": args.start_epoch,
                               "resumed_from": None, "load_s": None, "save_s": [],
                               "saved": [], "steps": [], "evals": [], "epochs": []}
    if args.finetune:
        summary["finetune"] = load_pretrained(model, args.finetune)
    # The frozen sin-cos pos-embs get gradients that the optimizer never
    # applies: the JAX step's gradient norm, and so its clip, counts them.
    for name, p in model.named_parameters():
        if name.endswith("pos_emb"):
            p.requires_grad_(True)
    model.to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.2f}M")

    global_batch = args.batch_size * world
    loader = eval_loader = None
    if args.synthetic_data:
        num_steps_per_epoch = args.synthetic_steps_per_epoch
    else:
        def transform(train):
            return DataAugmentationForSemSeg(
                SimpleTransform(train=train, input_size=args.input_size),
                seg_num_classes=args.num_classes, standardize_depth=args.standardize_depth,
                seg_reduce_zero_label=args.seg_reduce_zero_label,
                seg_use_void_label=args.seg_use_void_label)

        prefixes = {"depth": "pseudo_"} if args.load_pseudo_depth else None
        dataset_train = MultiTaskImageFolder(args.data_path, all_domains, prefixes=prefixes)
        dataset_val = MultiTaskImageFolder(args.eval_data_path, all_domains, prefixes=prefixes,
                                           max_images=args.max_val_images)
        pin = args.pin_mem and device.type == "cuda"
        loader = Loader(dataset_train, transform(True), global_batch_size=global_batch,
                        seed=args.seed, num_workers=args.num_workers, shard_index=rank,
                        shard_count=world, pin_memory=pin)
        eval_loader = EvalLoader(dataset_val, transform(False),
                                 global_batch_size=global_batch, num_workers=args.num_workers,
                                 shard_index=rank, shard_count=world, pin_memory=pin)
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
        if payload:
            summary["resumed_from"] = os.path.join(args.output_dir,
                                                   f"checkpoint-{start_epoch - 1}.pth")
    if summary["resumed_from"]:
        summary["load_s"] = time.perf_counter() - t0
    if payload:
        saved = payload["model"]
        summary["resume_bit_equal"] = set(saved) == set(model.state_dict()) and all(
            torch.equal(v.cpu(), saved[k]) for k, v in model.state_dict().items())
        if loader is not None and payload.get("data_iter_state"):
            try:
                loader.set_state(payload["data_iter_state"])
                print("[checkpoint] data iterator state restored")
            except ValueError as e:
                print(f"[checkpoint] data iterator restore failed ({e}); "
                      "continuing with a fresh shuffle")
    summary["start_epoch"] = start_epoch

    step_fn = make_dense_train_step(model, "semseg", seg_cross_entropy_parts,
                                    in_domains=tuple(in_domains), clip_grad=args.clip_grad)
    eval_fwd = make_dense_eval_step(model, "semseg", in_domains=tuple(in_domains))
    generator = torch.Generator(device=device)

    def run_eval() -> Dict[str, Any]:
        cm = torch.zeros((args.num_classes, args.num_classes), dtype=torch.int64,
                         device=device)
        batches = images = 0
        compute_s = 0.0
        t_eval = time.perf_counter()
        for b in eval_loader:
            prep = prepare_batch(b, in_domains, device)
            t1 = time.perf_counter()
            pred = eval_fwd(prep).argmax(dim=-1)
            cm += confusion_matrix(pred, prep["target"], args.num_classes,
                                   ignore_index=SEG_IGNORE_INDEX)
            sync()
            compute_s += time.perf_counter() - t1
            batches += 1
            images += int(prep["target"].shape[0])
        cm = dist_lib.sum_across_processes(cm)
        stats = miou_from_confusion(cm)
        total_s = time.perf_counter() - t_eval
        return {"mIoU": stats["mIoU"], "aAcc": stats["aAcc"], "mAcc": stats["mAcc"],
                "batches": batches, "images": images, "pixels": int(cm.sum()),
                "ms_per_batch": compute_s / max(batches, 1) * 1e3,
                "ms_per_batch_with_data": total_s / max(batches, 1) * 1e3}

    def report(stats):
        print(f"* mIoU {stats['mIoU'] * 100:.3f} aAcc {stats['aAcc'] * 100:.3f} "
              f"Acc {stats['mAcc'] * 100:.3f}")

    if args.eval and not args.synthetic_data:
        stats = run_eval()
        report(stats)
        summary["evals"].append(stats)
        if eval_loader is not None:
            loader.close()
            eval_loader.close()
        return summary

    synthetic = None
    if loader is None:
        synthetic = prepare_batch(synthetic_batch(args.batch_size, args, in_domains),
                                  in_domains, device)
    fetch_s = [0.0]  # the wait for the last batch: the loader and the copy to the device

    def batches():
        for _ in range(num_steps_per_epoch):
            if loader is None:
                yield synthetic
            else:
                t1 = time.perf_counter()
                b = prepare_batch(next(loader), in_domains, device)
                fetch_s[0] = time.perf_counter() - t1
                yield b

    best_miou = float(payload.get("best_mIoU", 0.0))
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
                                   else loader.get_state(), extra={"best_mIoU": best_miou})
            if path is not None:
                summary["save_s"].append(time.perf_counter() - t1)
                summary["saved"].append(path)
                print(f"[checkpoint] saved {path} in {summary['save_s'][-1]:.2f} s")

        if not args.synthetic_data and (epoch + 1) % args.eval_freq == 0:
            stats = run_eval()
            report(stats)
            summary["evals"].append({"epoch": epoch, **stats})
            miou = stats["mIoU"] * 100
            if miou > best_miou:
                best_miou = miou
                if args.output_dir and args.save_ckpt:
                    save("checkpoint-best")
            log_stats.update({"val_mIoU": miou, "best_mIoU": best_miou})

        if args.output_dir and args.save_ckpt and (
                (epoch + 1) % args.save_ckpt_freq == 0 or epoch + 1 == args.epochs):
            save()
        write_log_line(args.output_dir, log_stats)
        summary["epochs"].append(log_stats)

    print(f"Training time {datetime.timedelta(seconds=int(time.time() - start_time))}")
    if loader is not None:
        loader.close()
        eval_loader.close()
    if created:
        dist_lib.barrier()
        torch.distributed.destroy_process_group()
    return summary


if __name__ == "__main__":
    opts = get_args()
    if opts.output_dir:
        os.makedirs(opts.output_dir, exist_ok=True)
    main(opts)
