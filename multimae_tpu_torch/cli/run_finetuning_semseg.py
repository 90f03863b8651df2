"""Semantic segmentation fine-tuning: the model and the loss (counterpart
of multimae_tpu/cli/run_finetuning_semseg.py:157-242; reference
run_finetuning_semseg.py:371-407, :483). The argument parser, `main`,
the data pipeline and checkpoints are not ported yet."""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from multimae_tpu_torch.models import ConvNeXtAdapter, PatchedInputAdapter
from multimae_tpu_torch.models.registry import create_model
from multimae_tpu_torch.utils.data_constants import SEG_IGNORE_INDEX

INPUT_ADAPTERS = {
    "rgb": functools.partial(PatchedInputAdapter, num_channels=3, stride_level=1),
    "depth": functools.partial(PatchedInputAdapter, num_channels=1, stride_level=1),
}


def build_semseg_model(*, model: str = "multivit_base",
                       in_domains: Sequence[str] = ("rgb",), patch_size: int = 16,
                       input_size: int = 512, num_classes: int = 150,
                       drop_path_encoder: float = 0.1, decoder_dim: int = 6144,
                       decoder_depth: int = 4, decoder_preds_per_patch: int = 16,
                       decoder_interpolate_mode: str = "bilinear",
                       decoder_main_tasks: Sequence[str] = ("rgb",),
                       dtype: torch.dtype = torch.float32):
    """MultiViT with the ConvNeXt head (JAX `build_semseg_model` with
    output_adapter="convnext", no void label), weights left empty: the
    caller fills them (`init_weights(generator)` or a state_dict)."""
    input_adapters = {
        d: functools.partial(INPUT_ADAPTERS[d], patch_size_full=patch_size,
                             image_size=input_size)
        for d in in_domains
    }
    output_adapters = {
        "semseg": functools.partial(
            ConvNeXtAdapter, num_classes=num_classes, embed_dim=decoder_dim,
            preds_per_patch=decoder_preds_per_patch, depth=decoder_depth,
            interpolate_mode=decoder_interpolate_mode,
            main_tasks=tuple(decoder_main_tasks), patch_size=patch_size),
    }
    return create_model(model, input_adapters=input_adapters,
                        output_adapters=output_adapters,
                        drop_path_rate=drop_path_encoder, dtype=dtype)


def seg_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                      ignore_index: int = SEG_IGNORE_INDEX) -> torch.Tensor:
    """Mean cross-entropy over the pixels whose target is not ignore_index
    (0 if there are none), NHWC logits in fp32 (reference :483)."""
    logits = logits.float()
    valid = target != ignore_index
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, torch.where(valid, target, 0).long().unsqueeze(-1)).squeeze(-1)
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp_min(1)
