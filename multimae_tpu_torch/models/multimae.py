"""MultiMAE, the masked multi-modal pretraining model, and MultiViT, its
dense forward for fine-tuning (counterpart of
multimae_tpu/models/multimae.py:40-300; reference multimae/multimae.py:40-539).

Adapters are passed as dicts of constructor partials and completed here
with the encoder width and the compute dtype, as in the JAX package.
Adapters named in `fp32_output_adapters` compute in fp32 and receive
fp32 encoder tokens (reference :367-377).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from multimae_tpu_torch.models.output_adapters import DPTOutputAdapter
from multimae_tpu_torch.models.registry import register_model
from multimae_tpu_torch.models.vit import Block, trunc_normal_
from multimae_tpu_torch.ops import masking
from multimae_tpu_torch.ops.gather import gather_tokens

AdapterSpec = Callable[..., nn.Module]


def generate_input_info(num_tokens_per_task: Dict[str, int],
                        image_size: Tuple[int, int],
                        num_global_tokens: int) -> Dict[str, Any]:
    """Static bookkeeping dict (reference multimae/multimae.py:250-269)."""
    info: Dict[str, Any] = {"tasks": {}}
    i = 0
    for domain, num_tokens in num_tokens_per_task.items():
        info["tasks"][domain] = {"num_tokens": num_tokens, "has_2d_posemb": True,
                                 "start_idx": i, "end_idx": i + num_tokens}
        i += num_tokens
    info["image_size"] = image_size
    info["num_task_tokens"] = i
    info["num_global_tokens"] = num_global_tokens
    return info


def infer_image_size(x: Dict[str, torch.Tensor],
                     semseg_stride: int = 4) -> Tuple[int, int]:
    """Full-resolution (H, W): rgb/depth are NHWC, semseg (B, H/4, W/4)."""
    if "rgb" in x:
        return x["rgb"].shape[1], x["rgb"].shape[2]
    if "semseg" in x:
        return x["semseg"].shape[1] * semseg_stride, x["semseg"].shape[2] * semseg_stride
    first = next(iter(x.values()))
    return first.shape[1], first.shape[2]


class MultiMAE(nn.Module):
    """Multi-task multi-modal masked autoencoder."""

    def __init__(self, input_adapters: Dict[str, AdapterSpec],
                 output_adapters: Optional[Dict[str, AdapterSpec]],
                 num_global_tokens: int = 1, dim_tokens: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 fp32_output_adapters: Sequence[str] = ()):
        super().__init__()
        self.dtype = dtype
        self.num_global_tokens = num_global_tokens
        self.fp32_output_adapters = tuple(fp32_output_adapters)
        self.input_adapters = nn.ModuleDict({
            task: spec(dim_tokens=dim_tokens, dtype=dtype)
            for task, spec in input_adapters.items()
        })
        self.output_adapters = None
        if output_adapters is not None:
            self.output_adapters = nn.ModuleDict({
                task: spec(dim_tokens_enc=dim_tokens,
                           dtype=torch.float32 if task in self.fp32_output_adapters
                           else dtype)
                for task, spec in output_adapters.items()
            })
        self.global_tokens = nn.Parameter(torch.empty(1, num_global_tokens, dim_tokens))
        # stochastic depth rising linearly over the blocks (JAX :124-126)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, depth)]
        self.encoder = nn.ModuleList([
            Block(dim_tokens, num_heads, mlp_ratio, qkv_bias, dtype, drop_path_rate=dpr[i],
                  drop=drop_rate, attn_drop=attn_drop_rate)
            for i in range(depth)
        ])

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MultiMAE":
        """Fill every parameter from `generator` (a CPU generator), in
        module order: xavier-uniform Linear/Conv weights (per-part fan-out
        for fused qkv/kv), zero biases, trunc-normal(0.02) global tokens,
        task embeddings and class embeddings, unit/zero LayerNorms."""
        trunc_normal_(self.global_tokens, generator)
        for module in self.modules():
            # torch's own modules (Conv2d, Embedding) would draw from the
            # global RNG; their owners here initialise them instead.
            if (type(module).__module__.startswith("multimae_tpu_torch")
                    and hasattr(module, "reset_parameters")):
                module.reset_parameters(generator)
        return self

    def tokenize(self, x: Dict[str, torch.Tensor]):
        tokens = {d: self.input_adapters[d](t) for d, t in x.items()
                  if d in self.input_adapters}
        info = generate_input_info({d: t.shape[1] for d, t in tokens.items()},
                                   infer_image_size(x), self.num_global_tokens)
        return tokens, info

    def run_encoder(self, tokens: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    all_layers: bool = False) -> Union[torch.Tensor, List[torch.Tensor]]:
        """The encoder blocks in order; in training each block draws its
        drop_path numbers from `generator`. The last block's tokens, or with
        `all_layers` every block's, in order (the DPT head's hooks; JAX
        :155-168). A model that parallel/pp.attach made a pipeline stage
        runs the blocks over the GPipe schedule instead (JAX :158-162),
        except in all-layers mode."""
        pipe = getattr(self, "pipeline", None)
        if pipe is not None and not all_layers:
            from multimae_tpu_torch.parallel.pp import pipelined_encoder

            return pipelined_encoder(self.encoder, tokens, pipe, generator)
        outs = []
        for blk in self.encoder:
            tokens = blk(tokens, generator)
            if all_layers:
                outs.append(tokens)
        return outs if all_layers else tokens

    def forward(self, x: Union[Dict[str, torch.Tensor], torch.Tensor], *,
                mask_inputs: bool = True,
                task_masks: Optional[Dict[str, torch.Tensor]] = None,
                num_encoded_tokens: int = 128,
                alphas: Union[float, Sequence[float]] = 1.0,
                sample_tasks_uniformly: bool = False,
                generator: Optional[torch.Generator] = None,
                encode_only: bool = False):
        """Masked forward (reference multimae/multimae.py:271-379).

        Returns (preds, task_masks): NHWC predictions per output adapter
        and (B, N_task) int64 masks (1 = masked). Without `task_masks` the
        masks are drawn from `generator`, which must lie on the inputs'
        device; in training the encoder's drop_path draws from it next.
        `encode_only` skips the output adapters and returns (encoder
        tokens, task_masks, ids_keep, ids_restore, input_info), as the JAX
        model does (JAX :180-230), for feature extraction and probing."""
        if not isinstance(x, dict):
            x = {"rgb": x}
        tokens, info = self.tokenize(x)
        b = next(iter(tokens.values())).shape[0]
        counts = [t.shape[1] for t in tokens.values()]
        k = num_encoded_tokens if mask_inputs else sum(counts)

        if task_masks is None:
            if generator is None:
                raise ValueError("random masking needs a torch.Generator")
            mask_list, ids_keep, ids_restore = masking.generate_random_masks(
                generator, b, counts, k, alphas=alphas,
                sample_tasks_uniformly=sample_tasks_uniformly)
            task_masks = dict(zip(tokens.keys(), mask_list))
        else:
            task_masks = {d: task_masks[d] for d in tokens}
            ids_keep, ids_restore = masking.masks_to_indices(task_masks, k)

        input_tokens = gather_tokens(torch.cat(list(tokens.values()), dim=1), ids_keep)
        global_tokens = self.global_tokens.to(input_tokens.dtype).expand(b, -1, -1)
        h = self.run_encoder(torch.cat([input_tokens, global_tokens], dim=1), generator)

        if encode_only:
            return h, task_masks, ids_keep, ids_restore, info
        if self.output_adapters is None:
            return h, task_masks
        preds = {}
        for domain, adapter in self.output_adapters.items():
            tokens_in = h.float() if domain in self.fp32_output_adapters else h
            preds[domain] = adapter(tokens_in, info, ids_keep, ids_restore)
        return preds, task_masks


class MultiViT(MultiMAE):
    """Dense (unmasked) forward for fine-tuning and inference (JAX
    :250-300; reference multimae/multimae.py:419-539)."""

    def process_input(self, x: Union[Dict[str, torch.Tensor], torch.Tensor]):
        """Every input token, then the global tokens: (B, N + G, D) and the
        input info."""
        if not isinstance(x, dict):
            x = {"rgb": x}
        tokens, info = self.tokenize(x)
        input_tokens = torch.cat(list(tokens.values()), dim=1)
        b = input_tokens.shape[0]
        global_tokens = self.global_tokens.to(input_tokens.dtype).expand(b, -1, -1)
        return torch.cat([input_tokens, global_tokens], dim=1), info

    def forward(self, x: Union[Dict[str, torch.Tensor], torch.Tensor], *,
                generator: Optional[torch.Generator] = None,
                return_all_layers: bool = False):
        """{task: NHWC pred} of every output adapter, or the encoder tokens
        without adapters. The encoder returns every layer's tokens where a
        DPT head is present or `return_all_layers` is asked (JAX :267-300):
        a DPT head takes the list, every other head the last layer's, and
        without adapters the list comes back. In training
        (`model.train()`) drop_path and dropout draw from `generator`,
        which lies on the inputs' device: the encoder's blocks first, then
        a head's own (the Segmenter's blocks, the DPT semseg head's
        dropout)."""
        input_tokens, info = self.process_input(x)
        all_layers = return_all_layers or any(isinstance(a, DPTOutputAdapter)
                                              for a in (self.output_adapters or {}).values())
        out = self.run_encoder(input_tokens, generator, all_layers=all_layers)
        if self.output_adapters is None:
            return out
        preds = {}
        for domain, adapter in self.output_adapters.items():
            h = out if isinstance(adapter, DPTOutputAdapter) else (
                out[-1] if all_layers else out)
            if domain in self.fp32_output_adapters:
                h = [t.float() for t in h] if isinstance(h, list) else h.float()
            preds[domain] = adapter(h, info, generator=generator)
        return preds


def _mae(dim, depth, heads, cls=MultiMAE):
    """A registry entry's builder; `depth` may be overridden (a model of
    another depth at the entry's width, as bench_pp_bubble takes)."""
    def build(input_adapters, output_adapters, **kwargs):
        kwargs = {"depth": depth, **kwargs}
        return cls(input_adapters=input_adapters, output_adapters=output_adapters,
                   dim_tokens=dim, num_heads=heads, mlp_ratio=4.0, qkv_bias=True, **kwargs)
    return build


@register_model
def pretrain_multimae_base(input_adapters, output_adapters, **kwargs):
    return _mae(768, 12, 12)(input_adapters, output_adapters, **kwargs)


@register_model
def pretrain_multimae_large(input_adapters, output_adapters, **kwargs):
    return _mae(1024, 24, 16)(input_adapters, output_adapters, **kwargs)


@register_model
def pretrain_multimae_tiny(input_adapters, output_adapters, **kwargs):
    """Not in the reference registry: CPU tests; base's structure at 1/12."""
    return _mae(64, 2, 4)(input_adapters, output_adapters, **kwargs)


@register_model
def multivit_base(input_adapters, output_adapters, **kwargs):
    return _mae(768, 12, 12, MultiViT)(input_adapters, output_adapters, **kwargs)


@register_model
def multivit_large(input_adapters, output_adapters, **kwargs):
    return _mae(1024, 24, 16, MultiViT)(input_adapters, output_adapters, **kwargs)


@register_model
def multivit_tiny(input_adapters, output_adapters, **kwargs):
    """Not in the reference registry: CPU tests; base's structure at 1/12."""
    return _mae(64, 2, 4, MultiViT)(input_adapters, output_adapters, **kwargs)
