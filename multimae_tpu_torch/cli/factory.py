"""Domain configuration, the pretrain model/loss/trainer factory
(counterpart of multimae_tpu/cli/factory.py; reference
run_pretraining_multimae.py:49-72, :243-331, :353-390), the semantic
segmentation fine-tune trainer (the NYUv2 RGB + depth recipe), the
classification model and trainer (the ImageNet-1K recipe; the JAX
`build_cls_model`, multimae_tpu/cli/run_finetuning_cls.py:149-176), and
the dense-regression trainers with the DPT head (the NYUv2 depth recipe,
fp32, and the Taskonomy rgb -> depth_zbuffer recipe, bf16 at 384 px)."""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from multimae_tpu_torch.models import (
    LinearOutputAdapter,
    MaskedCrossEntropyLoss,
    MaskedL1Loss,
    MaskedMSELoss,
    PatchedInputAdapter,
    SemSegInputAdapter,
    SpatialOutputAdapter,
)
from multimae_tpu_torch.cli.run_finetuning_depth import build_regression_model
from multimae_tpu_torch.cli.run_finetuning_semseg import (
    build_semseg_model,
    seg_cross_entropy_parts,
)
from multimae_tpu_torch.models.registry import create_model
from multimae_tpu_torch.train.cross_entropy import soft_target_cross_entropy
from multimae_tpu_torch.train.finetune_step import make_cls_train_step, make_dense_train_step
from multimae_tpu_torch.train.optim_factory import LayerDecayValueAssigner, create_optimizer
from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step, standardize_depth
from multimae_tpu_torch.train.regression_losses import LOSS_PARTS
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
    drop_path: float = 0.0,
    fp32_output_adapters: Sequence[str] = (),
    dtype: torch.dtype = torch.float32,
    decoder_return_patches: bool = False,
    pos_emb_grads: bool = False,
    seed: int = 0,
    device="cuda",
    depth: Optional[int] = None,
):
    """Reference get_model (run_pretraining_multimae.py:243-293), with
    weights drawn from a CPU torch.Generator seeded with `seed`, then
    moved to `device`. decoder_return_patches=True is the training fast
    path (JAX cli/factory.py:75-105): decoders emit (B, N, C*p*p) token
    patches and the masked losses take them directly.

    `depth` replaces the registry entry's encoder depth (the pipeline
    tests and bench_pp_bubble take deeper tiny models).

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
        drop_path_rate=drop_path, dtype=dtype,
        fp32_output_adapters=tuple(fp32_output_adapters),
        **({} if depth is None else {"depth": depth}))
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


def build_pretrain_trainer(*, batch_size: int, seed: int = 0, device="cuda",
                           model_name: str = "pretrain_multimae_base", parallel=None):
    """(TrainState, train_step) of the flagship pretraining recipe
    (cfgs/pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml, as the JAX
    package's bench.py:96-137 runs it): MultiMAE ViT-B in bf16 with the
    fp32 semseg decoder and `return_patches`, the masked losses, the
    uncertainty balancer, AdamW (0.9, 0.95), wd 0.05, with the reference's
    dict-model groups (filter_bias_and_bn=False), and the cosine LR from
    blr 1e-4 * batch_size / 256 (reference :372-373) to 0 over 1600 epochs
    of 100 steps, without warmup (with warmup the first step's LR is 0).
    `model_name` picks the encoder (pretrain_multimae_large for ViT-L);
    `parallel(model)`, where given, lays the model out (parallel/mesh.py
    layout_model) before the optimizer is built."""
    device = entry_device(device)
    domains = ("rgb", "depth", "semseg")
    model = build_pretrain_model(model_name=model_name, dtype=torch.bfloat16,
                                 fp32_output_adapters=("semseg",),
                                 decoder_return_patches=True, pos_emb_grads=True,
                                 seed=seed, device=device)
    if parallel is not None:
        parallel(model)
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


def build_semseg_trainer(*, batch_size: int, seed: int = 0, device="cuda", parallel=None,
                         **overrides):
    """(TrainState, train_step) of the NYUv2 RGB + depth recipe: MultiViT-B
    at 512 px (2 x 1024 + 1 tokens) with the ConvNeXt head, 40 classes, in
    bf16 (the CLI's --fp16 default), drop_path 0.1 rising over the blocks,
    AdamW (0.9, 0.999) with wd 0.05 and no decay on 1-D parameters and
    tokens, layer-wise LR decay 0.75, and the cosine LR from 1e-4 to 0 over
    200 epochs of NYUv2's 795 training images at `batch_size`, without
    the recipe's 1-epoch warmup (with warmup the first step's LR is ~0).
    Weights are random, drawn from a CPU generator seeded with `seed`.
    `overrides` replace recipe entries (the CPU tests' tiny model);
    `parallel(model)`, where given, lays the model out (parallel/mesh.py
    layout_model) before the optimizer is built.

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
    if parallel is not None:
        parallel(model)
    depth = len(model.encoder)
    assigner = LayerDecayValueAssigner(
        [r["layer_decay"] ** (depth + 1 - i) for i in range(depth + 2)])
    optimizer = create_optimizer(model, weight_decay=r["weight_decay"],
                                 opt_betas=r["opt_betas"], filter_bias_and_bn=True,
                                 layer_decay_assigner=assigner)
    lr = cosine_scheduler(r["lr"], r["min_lr"], epochs=r["epochs"],
                          niter_per_ep=max(1, r["train_images"] // batch_size))
    state = TrainState(model, None, optimizer, lr)
    step = make_dense_train_step(model, "semseg", seg_cross_entropy_parts,
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


def build_cls_model(*, model: str = "multivit_base", patch_size: int = 16,
                    input_size: int = 224, nb_classes: int = 1000,
                    use_mean_pooling: bool = True, init_scale: float = 0.001,
                    num_global_tokens: int = 1, drop_path: float = 0.1, drop: float = 0.0,
                    attn_drop_rate: float = 0.0, dtype: torch.dtype = torch.float32):
    """MultiViT with the rgb input adapter and the `cls` LinearOutputAdapter
    (the JAX `build_cls_model`), weights left empty: the caller fills them
    (`init_weights(generator)` or a state_dict)."""
    input_adapters = {"rgb": functools.partial(
        PatchedInputAdapter, num_channels=3, stride_level=1, patch_size_full=patch_size,
        image_size=input_size)}
    output_adapters = {"cls": functools.partial(
        LinearOutputAdapter, num_classes=nb_classes, use_mean_pooling=use_mean_pooling,
        init_scale=init_scale)}
    return create_model(model, input_adapters=input_adapters, output_adapters=output_adapters,
                        num_global_tokens=num_global_tokens, drop_path_rate=drop_path,
                        drop_rate=drop, attn_drop_rate=attn_drop_rate, dtype=dtype)


# The ImageNet-1K classification fine-tune
# (cfgs/finetune/cls/ft_in1k_100e_multimae-b.yaml with the JAX CLI's
# defaults, multimae_tpu/cli/run_finetuning_cls.py:22-146), written out here.
CLS_RECIPE = dict(
    model="multivit_base", input_size=224, patch_size=16, nb_classes=1000,
    drop_path=0.1, init_scale=0.001, epochs=100, blr=5e-4, min_lr=1e-6, weight_decay=0.05,
    opt_betas=(0.9, 0.999), layer_decay=0.65, clip_grad=None, model_ema_decay=None,
    dtype=torch.bfloat16, train_images=1281167,
)


def build_cls_trainer(*, batch_size: int, seed: int = 0, device="cuda", **overrides):
    """(TrainState, train_step) of the ImageNet-1K recipe: MultiViT-B at 224
    px (196 + 1 tokens) with the mean-pooling head over 1000 classes, bf16,
    drop_path 0.1 rising over the blocks, AdamW (0.9, 0.999) with wd 0.05,
    layer-wise LR decay 0.65, the cosine LR from 5e-4 * batch_size / 256 to
    1e-6 over 100 epochs of ImageNet's 1281167 images, without the recipe's
    5-epoch warmup, and the soft-target loss of mixup. Weights are random,
    drawn from a CPU generator seeded with `seed`; `overrides` replace
    recipe entries (the CPU tests' tiny model, an EMA decay). The frozen
    sin-cos pos-embs get the gradients the JAX step's norm counts."""
    device = entry_device(device)
    r = dict(CLS_RECIPE, **overrides)
    model = build_cls_model(model=r["model"], patch_size=r["patch_size"],
                            input_size=r["input_size"], nb_classes=r["nb_classes"],
                            init_scale=r["init_scale"], drop_path=r["drop_path"],
                            dtype=r["dtype"])
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
    lr = cosine_scheduler(r["blr"] * batch_size / 256, r["min_lr"], epochs=r["epochs"],
                          niter_per_ep=max(1, r["train_images"] // batch_size))
    state = TrainState(model, None, optimizer, lr, ema_decay=r["model_ema_decay"])
    return state, make_cls_train_step(model, soft_target_cross_entropy,
                                      clip_grad=r["clip_grad"])


def make_synthetic_cls_batch(batch: int, input_size: int = 224, nb_classes: int = 1000,
                             seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Random NHWC rgb and (batch, nb_classes) soft targets, two classes
    mixed per sample as mixup leaves them."""
    device = entry_device(device)
    rng = np.random.default_rng(seed)
    rgb = rng.standard_normal((batch, input_size, input_size, 3)).astype(np.float32)
    lam = rng.uniform(0.5, 1.0, batch).astype(np.float32)
    a, b = rng.integers(0, nb_classes, (2, batch))
    target = np.zeros((batch, nb_classes), np.float32)
    target[np.arange(batch), a] += lam
    target[np.arange(batch), b] += 1.0 - lam
    return {"rgb": torch.from_numpy(rgb).to(device), "target": torch.from_numpy(target).to(device)}


# The NYUv2 depth fine-tune (cfgs/finetune/depth/ft_nyu_2000e_multimae-b.yaml
# with the JAX CLI's defaults, multimae_tpu/cli/run_finetuning_depth.py:23-145)
# and the Taskonomy rgb -> depth_zbuffer fine-tune
# (cfgs/finetune/taskonomy/rgb2depth-1k/ft_rgb2depth_multimae-b.yaml with the
# JAX CLI's defaults, multimae_tpu/cli/run_finetuning_taskonomy.py:38-135),
# written out here.
DEPTH_RECIPE = dict(
    model="multivit_base", input_size=256, patch_size=16, output_adapter="dpt",
    task="depth", channels=1, loss="berhu", drop_path_encoder=0.0, epochs=2000, lr=1e-4,
    min_lr=0.0, weight_decay=1e-4, opt_betas=(0.9, 0.999), layer_decay=0.75, clip_grad=None,
    dtype=torch.float32, train_images=795,
)
TASKONOMY_RECIPE = dict(
    DEPTH_RECIPE, input_size=384, task="depth_zbuffer", loss="l1", drop_path_encoder=0.1,
    epochs=100, lr=3e-4, dtype=torch.bfloat16, train_images=800,
)


def build_regression_trainer(recipe: dict, *, batch_size: int, seed: int = 0,
                             device="cuda", **overrides):
    """(TrainState, train_step) of a dense-regression recipe: MultiViT with
    the rgb input and the DPT regression head (hooks 2/5/8/11, layer dims
    96/192/384/768, features 256) over `task`, AdamW (0.9, 0.999) with no
    decay on 1-D parameters and tokens, layer-wise LR decay, the cosine LR
    over the recipe's epochs of its training images at `batch_size`
    without its warmup, and the masked loss against mask_valid. Weights
    are random, drawn from a CPU generator seeded with `seed`; `overrides`
    replace recipe entries (the CPU tests' tiny model). The frozen sin-cos
    pos-embs get the gradients the JAX step's norm counts."""
    device = entry_device(device)
    r = dict(recipe, **overrides)
    model = build_regression_model(
        model=r["model"], in_channels={"rgb": 3}, out_channels={r["task"]: r["channels"]},
        patch_size=r["patch_size"], input_size=r["input_size"],
        output_adapter=r["output_adapter"], decoder_main_tasks=("rgb",),
        drop_path_encoder=r["drop_path_encoder"], dtype=r["dtype"])
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
    step = make_dense_train_step(model, r["task"], LOSS_PARTS[r["loss"]], in_domains=("rgb",),
                                 clip_grad=r["clip_grad"])
    return state, step


def build_depth_trainer(*, batch_size: int, seed: int = 0, device="cuda", **overrides):
    """The NYUv2 depth recipe: MultiViT-B at 256 px (257 tokens), fp32, the
    berhu loss, lr 1e-4 over 2000 epochs of NYUv2's 795 training images,
    layer decay 0.75, no drop_path (build_regression_trainer)."""
    return build_regression_trainer(DEPTH_RECIPE, batch_size=batch_size, seed=seed,
                                    device=device, **overrides)


def build_taskonomy_trainer(*, batch_size: int, seed: int = 0, device="cuda", **overrides):
    """The Taskonomy rgb -> depth_zbuffer recipe: MultiViT-B at 384 px (577
    tokens), bf16 (the K2 kernels train every encoder block's attention),
    drop_path 0.1, the masked L1 loss, lr 3e-4 over 100 epochs of 800
    images, layer decay 0.75 (build_regression_trainer)."""
    return build_regression_trainer(TASKONOMY_RECIPE, batch_size=batch_size, seed=seed,
                                    device=device, **overrides)


def make_synthetic_regression_batch(batch: int, input_size: int, channels: int = 1,
                                    seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Random NHWC rgb, a smooth target of `channels` channels and a
    mask_valid with about a fifth of the pixels invalid (B, H, W, 1)."""
    device = entry_device(device)
    rng = np.random.default_rng(seed)
    s = input_size
    rgb = rng.standard_normal((batch, s, s, 3)).astype(np.float32)
    ramp = np.linspace(-1.0, 1.0, s, dtype=np.float32)
    target = (ramp[None, :, None, None] * rng.uniform(0.5, 2.0, (batch, 1, 1, channels))
              + rng.normal(0, 0.1, (batch, s, s, channels))).astype(np.float32)
    mask = rng.random((batch, s, s, 1)) > 0.2
    return {"rgb": torch.from_numpy(rgb).to(device), "target": torch.from_numpy(target).to(device),
            "mask_valid": torch.from_numpy(mask).to(device)}
