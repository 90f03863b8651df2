"""Domain configuration, the pretrain model/loss/trainer factory
(counterpart of multimae_tpu/cli/factory.py; reference
run_pretraining_multimae.py:49-72, :243-331, :353-390), and the
semantic segmentation fine-tune trainer (the NYUv2 RGB + depth recipe)."""

from __future__ import annotations

import functools
from typing import Dict, Sequence

import numpy as np
import torch

from multimae_tpu_torch.models import (
    MaskedCrossEntropyLoss,
    MaskedL1Loss,
    MaskedMSELoss,
    PatchedInputAdapter,
    SemSegInputAdapter,
    SpatialOutputAdapter,
)
from multimae_tpu_torch.cli.run_finetuning_semseg import build_semseg_model, seg_cross_entropy
from multimae_tpu_torch.models.registry import create_model
from multimae_tpu_torch.train.finetune_step import make_dense_train_step
from multimae_tpu_torch.train.optim_factory import LayerDecayValueAssigner, create_optimizer
from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step, standardize_depth
from multimae_tpu_torch.train.schedules import cosine_scheduler
from multimae_tpu_torch.train.task_balancing import build_balancer
from multimae_tpu_torch.train.train_state import TrainState
from multimae_tpu_torch.utils.data_constants import COCO_SEMSEG_NUM_CLASSES

def entry_device(device="cuda") -> torch.device:
    """The device an entry point builds on: the CUDA card unless the caller
    names another (the CPU tests pass device="cpu"). Raises where the card
    is asked for and torch sees none, instead of carrying on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible to torch; pass device='cpu' "
                           "to build on the CPU")
    return device


DOMAIN_CONF = {
    "rgb": {
        "channels": 3,
        "stride_level": 1,
        "input_adapter": functools.partial(PatchedInputAdapter, num_channels=3),
        "output_adapter": functools.partial(SpatialOutputAdapter, num_channels=3),
        "loss": MaskedMSELoss,
    },
    "depth": {
        "channels": 1,
        "stride_level": 1,
        "input_adapter": functools.partial(PatchedInputAdapter, num_channels=1),
        "output_adapter": functools.partial(SpatialOutputAdapter, num_channels=1),
        "loss": MaskedL1Loss,
    },
    "semseg": {
        "num_classes": COCO_SEMSEG_NUM_CLASSES,
        "stride_level": 4,
        "input_adapter": functools.partial(
            SemSegInputAdapter, num_classes=COCO_SEMSEG_NUM_CLASSES,
            dim_class_emb=64),
        "output_adapter": functools.partial(
            SpatialOutputAdapter, num_channels=COCO_SEMSEG_NUM_CLASSES),
        "loss": functools.partial(MaskedCrossEntropyLoss, label_smoothing=0.0),
    },
}


def build_pretrain_model(
    *,
    model_name: str = "pretrain_multimae_base",
    in_domains: Sequence[str] = ("rgb", "depth", "semseg"),
    out_domains: Sequence[str] = ("rgb", "depth", "semseg"),
    patch_size: int = 16,
    input_size: int = 224,
    decoder_dim: int = 256,
    decoder_depth: int = 2,
    decoder_num_heads: int = 8,
    extra_norm_pix_loss: bool = True,
    num_global_tokens: int = 1,
    fp32_output_adapters: Sequence[str] = (),
    dtype: torch.dtype = torch.float32,
    decoder_return_patches: bool = False,
    pos_emb_grads: bool = False,
    seed: int = 0,
    device="cuda",
):
    """Reference get_model (run_pretraining_multimae.py:243-293), with
    weights drawn from a CPU torch.Generator seeded with `seed`, then
    moved to `device`. decoder_return_patches=True is the training fast
    path (JAX cli/factory.py:75-105): decoders emit (B, N, C*p*p) token
    patches and the masked losses take them directly.

    pos_emb_grads=True gives the fixed sin-cos pos-embs gradients (they
    stay out of every optimizer group, so they are never updated). The
    JAX step differentiates every parameter, frozen ones included, so its
    gradient norm, and with it clip and skip, counts the pos-embs: a
    training model that is to match it takes them into its norm too."""
    device = entry_device(device)
    input_adapters = {
        d: functools.partial(
            DOMAIN_CONF[d]["input_adapter"],
            stride_level=DOMAIN_CONF[d]["stride_level"],
            patch_size_full=patch_size, image_size=input_size)
        for d in in_domains
    }

    def out_spec(domain, task):
        return functools.partial(
            DOMAIN_CONF[domain]["output_adapter"],
            stride_level=DOMAIN_CONF[domain]["stride_level"],
            patch_size_full=patch_size, image_size=input_size,
            dim_tokens=decoder_dim, depth=decoder_depth,
            num_heads=decoder_num_heads, task=task,
            context_tasks=tuple(in_domains),
            return_patches=decoder_return_patches)

    output_adapters = {d: out_spec(d, d) for d in out_domains}
    if extra_norm_pix_loss:
        output_adapters["norm_rgb"] = out_spec("rgb", "rgb")

    model = create_model(
        model_name, input_adapters=input_adapters,
        output_adapters=output_adapters, num_global_tokens=num_global_tokens,
        dtype=dtype, fp32_output_adapters=tuple(fp32_output_adapters))
    model.init_weights(torch.Generator().manual_seed(seed))
    if pos_emb_grads:
        for name, p in model.named_parameters():
            if name.endswith("pos_emb"):
                p.requires_grad_(True)
    return model.to(device)


def build_pretrain_losses(out_domains: Sequence[str], patch_size: int = 16,
                          extra_norm_pix_loss: bool = True) -> Dict[str, object]:
    """Reference run_pretraining_multimae.py:317-331."""
    losses = {
        d: DOMAIN_CONF[d]["loss"](patch_size=patch_size,
                                  stride=DOMAIN_CONF[d]["stride_level"])
        for d in out_domains
    }
    if extra_norm_pix_loss:
        losses["norm_rgb"] = DOMAIN_CONF["rgb"]["loss"](
            patch_size=patch_size, stride=1, norm_pix=True)
    return losses


def make_synthetic_batch(batch: int, input_size: int = 224,
                         in_domains: Sequence[str] = ("rgb", "depth", "semseg"),
                         seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Random NHWC batch shaped like the real pipeline's output; the same
    numpy draws as multimae_tpu.cli.factory.make_synthetic_batch."""
    device = entry_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for d in in_domains:
        if d == "semseg":
            arr = rng.integers(0, COCO_SEMSEG_NUM_CLASSES,
                               (batch, input_size // 4, input_size // 4))
            out[d] = torch.from_numpy(arr.astype(np.int64))
        else:
            c = DOMAIN_CONF[d]["channels"]
            arr = rng.standard_normal((batch, input_size, input_size, c))
            out[d] = torch.from_numpy(arr.astype(np.float32))
    return {d: t.to(device) for d, t in out.items()}


def build_pretrain_trainer(*, batch_size: int, seed: int = 0, device="cuda"):
    """(TrainState, train_step) of the flagship pretraining recipe
    (cfgs/pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml, as the JAX
    package's bench.py:96-137 runs it): MultiMAE ViT-B in bf16 with the
    fp32 semseg decoder and `return_patches`, the masked losses, the
    uncertainty balancer, AdamW (0.9, 0.95), wd 0.05, with the reference's
    dict-model groups (filter_bias_and_bn=False), and the cosine LR from
    blr 1e-4 * batch_size / 256 (reference :372-373) to 0 over 1600 epochs
    of 100 steps, without warmup (with warmup the first step's LR is 0)."""
    device = entry_device(device)
    domains = ("rgb", "depth", "semseg")
    model = build_pretrain_model(dtype=torch.bfloat16, fp32_output_adapters=("semseg",),
                                 decoder_return_patches=True, pos_emb_grads=True,
                                 seed=seed, device=device)
    balancer = build_balancer("uncertainty", domains + ("norm_rgb",)).to(device)
    optimizer = create_optimizer(model, balancer, weight_decay=0.05, opt_betas=(0.9, 0.95),
                                 filter_bias_and_bn=False)
    lr = cosine_scheduler(1e-4 * batch_size / 256, 0.0, epochs=1600, niter_per_ep=100)
    state = TrainState(model, balancer, optimizer, lr)
    return state, make_pretrain_train_step(model, balancer, build_pretrain_losses(domains))


# The NYUv2 semantic segmentation fine-tune from RGB + depth
# (cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml with the
# JAX CLI's defaults, multimae_tpu/cli/run_finetuning_semseg.py:27-124),
# written out here: the card has no YAML reader.
SEMSEG_RECIPE = dict(
    model="multivit_base", in_domains=("rgb", "depth"), input_size=512, patch_size=16,
    num_classes=40, drop_path_encoder=0.1, output_adapter="convnext", decoder_dim=6144,
    decoder_depth=4, decoder_preds_per_patch=16, decoder_main_tasks=("rgb",),
    epochs=200, lr=1e-4, min_lr=0.0, weight_decay=0.05, opt_betas=(0.9, 0.999),
    layer_decay=0.75, clip_grad=None, fp16=True, train_images=795,
)


def build_semseg_trainer(*, batch_size: int, seed: int = 0, device="cuda", **overrides):
    """(TrainState, train_step) of the NYUv2 RGB + depth recipe: MultiViT-B
    at 512 px (2 x 1024 + 1 tokens) with the ConvNeXt head, 40 classes, in
    bf16 (the CLI's --fp16 default), drop_path 0.1 rising over the blocks,
    AdamW (0.9, 0.999) with wd 0.05 and no decay on 1-D parameters and
    tokens, layer-wise LR decay 0.75, and the cosine LR from 1e-4 to 0 over
    200 epochs of NYUv2's 795 training images at `batch_size`, without
    the recipe's 1-epoch warmup (with warmup the first step's LR is ~0).
    Weights are random, drawn from a CPU generator seeded with `seed`.
    `overrides` replace recipe entries (the CPU tests' tiny model).

    The frozen sin-cos pos-embs get gradients that the optimizer never
    applies: the JAX step's gradient norm counts them."""
    device = entry_device(device)
    r = dict(SEMSEG_RECIPE, **overrides)
    dtype = torch.bfloat16 if r["fp16"] else torch.float32
    model = build_semseg_model(
        model=r["model"], in_domains=r["in_domains"], patch_size=r["patch_size"],
        input_size=r["input_size"], num_classes=r["num_classes"],
        drop_path_encoder=r["drop_path_encoder"], decoder_dim=r["decoder_dim"],
        decoder_depth=r["decoder_depth"],
        decoder_preds_per_patch=r["decoder_preds_per_patch"],
        decoder_main_tasks=r["decoder_main_tasks"], dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    for name, p in model.named_parameters():
        if name.endswith("pos_emb"):
            p.requires_grad_(True)
    model.to(device)
    depth = len(model.encoder)
    assigner = LayerDecayValueAssigner(
        [r["layer_decay"] ** (depth + 1 - i) for i in range(depth + 2)])
    optimizer = create_optimizer(model, weight_decay=r["weight_decay"],
                                 opt_betas=r["opt_betas"], filter_bias_and_bn=True,
                                 layer_decay_assigner=assigner)
    lr = cosine_scheduler(r["lr"], r["min_lr"], epochs=r["epochs"],
                          niter_per_ep=max(1, r["train_images"] // batch_size))
    state = TrainState(model, None, optimizer, lr)
    step = make_dense_train_step(model, "semseg", seg_cross_entropy,
                                 in_domains=r["in_domains"], clip_grad=r["clip_grad"])
    return state, step


def make_synthetic_semseg_batch(batch: int, input_size: int = 512, num_classes: int = 40,
                                seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Random NHWC rgb, truncated-standardised depth (as the data pipeline
    gives it) and an int64 target in [0, num_classes) with about 5% of the
    pixels at the ignore index 255."""
    device = entry_device(device)
    rng = np.random.default_rng(seed)
    s = input_size
    rgb = rng.standard_normal((batch, s, s, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 10.0, (batch, s, s, 1)).astype(np.float32)
    target = rng.integers(0, num_classes, (batch, s, s))
    target[rng.random((batch, s, s)) < 0.05] = 255
    out = {"rgb": torch.from_numpy(rgb),
           "depth": standardize_depth(torch.from_numpy(depth)),
           "target": torch.from_numpy(target.astype(np.int64))}
    return {k: v.to(device) for k, v in out.items()}
