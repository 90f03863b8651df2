"""Output adapters: SpatialOutputAdapter, the pretraining decoder
(counterpart of multimae_tpu/models/output_adapters.py:39-345; reference
multimae/output_adapters.py:33-282), the classification head
LinearOutputAdapter (JAX :347-376), and the semantic segmentation heads,
SegmenterMaskTransformerAdapter (JAX :390-479; reference :359-478) and
ConvNeXtAdapter (JAX :482-531; reference :481-573), and the DPT head for
dense regression and segmentation, DPTOutputAdapter (JAX :534-686;
reference :576-759).

Queries are the task's own token positions (the visible encoder token
where the position was kept, else the mask token) plus the task and
positional embeddings; the context is the visible encoder tokens plus
their embeddings, then the global tokens. The decoder body (cross-
attention, MLP, `depth` blocks) runs as the fused_decoder_core kernel
where `fused_decoder.supported` admits the shape, on every device, as the
JAX adapter consults its gate (JAX :295-303); the module path below it
runs what the kernel does not take (depth 0, other dtypes, head widths
other than 32 and 64, key sets past the backward's shared memory, a
decoder without cross-attention) and is the reference the core is tested
against. Outputs
are NHWC images with the reference's (c, ph, pw) patch order, or, with
`return_patches` (the training fast path, JAX :67-70, :336-338), the
(B, N, C*ph*pw) token patches that the masked losses take directly.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimae_tpu_torch.models.conv_utils import (
    BatchNorm,
    ConvNeXtBlock,
    FeatureFusionBlock,
    conv2d_nhwc,
    conv_transpose2d_nhwc,
    lecun_normal_,
    make_conv,
    make_deconv,
)
from multimae_tpu_torch.models.input_adapters import pair, pos_tokens, sincos_pos_emb
from multimae_tpu_torch.models.vit import (
    Block,
    CrossAttention,
    Dense,
    LayerNorm,
    Mlp,
    dropout,
    trunc_normal_,
)
from multimae_tpu_torch.ops import fused_decoder
from multimae_tpu_torch.ops.functional import fp32
from multimae_tpu_torch.ops.gather import gather_tokens
from multimae_tpu_torch.ops.resize import interpolate_2d


class SpatialOutputAdapter(nn.Module):
    """Cross-attention decoder for spatial outputs. `use_task_queries=False`
    makes every decoder's queries the mask token plus the bilinearly resized
    pos-emb and the task's own embedding (JAX :245-254), whether or not the
    task was an input; `use_xattn=False` drops the cross-attention and its
    MLP and norms (no `decoder`, `context_norm`, `query_norm`, `out_norm` or
    `mlp`): the queries go through `decoder_transformer` alone, on the
    module path (JAX :322-332)."""

    def __init__(self, num_channels: int, stride_level: int,
                 patch_size_full: Union[int, Tuple[int, int]],
                 dim_tokens_enc: int, dim_tokens: int = 256, depth: int = 0,
                 image_size: Union[int, Tuple[int, int]] = 224,
                 mlp_ratio: float = 4.0, num_heads: int = 8,
                 qkv_bias: bool = True, task: Optional[str] = None,
                 context_tasks: Optional[Sequence[str]] = None,
                 return_patches: bool = False, use_task_queries: bool = True,
                 use_xattn: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.return_patches = return_patches
        self.use_task_queries = use_task_queries
        self.use_xattn = use_xattn
        self.num_channels = num_channels
        self.stride_level = stride_level
        self.dim_tokens = dim_tokens
        self.depth = depth
        self.num_heads = num_heads
        self.task = task
        self.dtype = dtype
        p = pair(patch_size_full)
        self.patch_hw = (max(1, p[0] // stride_level), max(1, p[1] // stride_level))
        img = pair(image_size)
        ph, pw = self.patch_hw

        self.task_embeddings = nn.ParameterDict({
            t: nn.Parameter(torch.empty(1, 1, dim_tokens))
            for t in (context_tasks or ())
        })
        self.mask_token = nn.Parameter(torch.zeros(1, 1, dim_tokens))
        self.pos_emb = sincos_pos_emb(img[0] // (stride_level * ph),
                                      img[1] // (stride_level * pw), dim_tokens)
        self.proj_context = Dense(dim_tokens_enc, dim_tokens, dtype=dtype)
        if use_xattn:
            self.query_norm = LayerNorm(dim_tokens, dtype)
            self.context_norm = LayerNorm(dim_tokens, dtype)
            self.decoder = CrossAttention(dim_tokens, num_heads, qkv_bias, dtype)
            self.out_norm = LayerNorm(dim_tokens, dtype)
            self.mlp = Mlp(dim_tokens, int(dim_tokens * mlp_ratio), dtype)
        self.decoder_transformer = nn.ModuleList([
            Block(dim_tokens, num_heads, mlp_ratio, qkv_bias, dtype)
            for _ in range(depth)
        ])
        self.out_proj = Dense(dim_tokens, num_channels * ph * pw, dtype=dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for t in self.task_embeddings.values():
            trunc_normal_(t, generator)

    # ------------------------------------------------------------------

    def core_weights(self) -> fused_decoder.DecoderCoreWeights:
        """The decoder body's parameters in the kernel's field order."""
        blocks = [b.block_weights() for b in self.decoder_transformer]

        def stack(i):
            return torch.stack([bw[i] for bw in blocks])

        x, m = self.decoder, self.mlp
        return fused_decoder.DecoderCoreWeights(
            self.query_norm.weight, self.query_norm.bias,
            self.context_norm.weight, self.context_norm.bias,
            self.out_norm.weight, self.out_norm.bias,
            x.q.weight, x.q.bias, x.kv.weight, x.kv.bias, x.proj.weight, x.proj.bias,
            m.fc1.weight, m.fc1.bias, m.fc2.weight, m.fc2.bias,
            *[stack(i) for i in range(12)],
        )

    def decode_modules(self, queries: torch.Tensor,
                       context: torch.Tensor) -> torch.Tensor:
        """The decoder body through the submodules; without cross-attention
        the queries go through the transformer blocks alone."""
        x = queries
        if self.use_xattn:
            x = self.decoder(self.query_norm(queries), self.context_norm(context))
            x = x + self.mlp(self.out_norm(x))
        for blk in self.decoder_transformer:
            x = blk(x)
        return x

    def context_embeddings(self, input_info: Dict, size: Tuple[int, int],
                           device) -> torch.Tensor:
        """(1, N, D) task + positional embeddings of every input token
        (reference :160-181), summed in fp32 and cast to the compute dtype."""
        pe = pos_tokens(self.pos_emb, size, "bilinear", fp32(self.pos_emb).dtype)
        embs = []
        for task, info in input_info["tasks"].items():
            if info["num_tokens"] != pe.shape[1]:
                raise ValueError(f"task {task}: {info['num_tokens']} tokens, "
                                 f"pos-emb grid has {pe.shape[1]}")
            if task in self.task_embeddings:
                emb = fp32(self.task_embeddings[task]) + pe
            else:
                emb = pe
            embs.append(emb.to(self.dtype))
        return torch.cat(embs, dim=1).to(device)

    def get_queries_and_context(self, context_tokens: torch.Tensor,
                                input_info: Dict, ids_keep: torch.Tensor,
                                ids_restore: torch.Tensor):
        """JAX :196-269: only two pieces of the unshuffled sequence are
        used, so they are gathered directly:
          queries[p] = rank[p] < K ? tokens[rank[p]] : mask_token, plus the
                       embedding of position p, over the task's own slice;
          context    = visible tokens + their embeddings, then the globals."""
        b = context_tokens.shape[0]
        h, w = input_info["image_size"]
        ph, pw = self.patch_hw
        nh, nw = h // (self.stride_level * ph), w // (self.stride_level * pw)
        num_global = input_info.get("num_global_tokens", 0)
        k = ids_keep.shape[1]
        visible_tokens = context_tokens[:, :k]
        ctx_emb = self.context_embeddings(input_info, (nh, nw),
                                          context_tokens.device)
        mask_token = self.mask_token.to(self.dtype)

        if self.use_task_queries and self.task in input_info["tasks"]:
            info = input_info["tasks"][self.task]
            rank = ids_restore[:, info["start_idx"]:info["end_idx"]]
            visible = rank < k
            q_tokens = gather_tokens(visible_tokens,
                                     torch.where(visible, rank, torch.zeros_like(rank)))
            queries = torch.where(visible.unsqueeze(-1), q_tokens, mask_token)
            queries = queries + ctx_emb[:, info["start_idx"]:info["end_idx"]]
        else:  # no task queries, or no input of the task: mask tokens + embeddings
            queries = mask_token.expand(b, nh * nw, -1) + pos_tokens(
                self.pos_emb, (nh, nw), "bilinear", self.dtype)
            if self.task in self.task_embeddings:
                queries = queries + self.task_embeddings[self.task].to(self.dtype)

        context = visible_tokens + gather_tokens(ctx_emb.expand(b, -1, -1), ids_keep)
        if num_global > 0:
            context = torch.cat([context, context_tokens[:, -num_global:]], dim=1)
        return queries, context

    def forward(self, encoder_tokens: torch.Tensor, input_info: Dict,
                ids_keep: torch.Tensor, ids_restore: torch.Tensor) -> torch.Tensor:
        h, w = input_info["image_size"]
        ph, pw = self.patch_hw
        nh, nw = h // (self.stride_level * ph), w // (self.stride_level * pw)

        context_tokens = self.proj_context(encoder_tokens.to(self.dtype))
        queries, context = self.get_queries_and_context(
            context_tokens, input_info, ids_keep, ids_restore)
        # K1's gate requires the cross-attention form (JAX :156-170).
        if self.use_xattn and fused_decoder.supported(
                queries.shape[1], context.shape[1], self.dim_tokens, self.num_heads,
                self.depth, self.dtype, self.mlp.fc1.weight.shape[0]):
            x = fused_decoder.fused_decoder_core(
                queries.contiguous(), context.contiguous(), self.core_weights(),
                self.num_heads, self.depth)
        else:
            x = self.decode_modules(queries, context)

        x = self.out_proj(x)
        if self.return_patches:
            return x  # (B, nh*nw, C*ph*pw), (c, ph, pw) minor order
        # (B, nh*nw, C*ph*pw) -> NHWC with (c, ph, pw) patch order (JAX :340-344)
        b = x.shape[0]
        x = x.reshape(b, nh, nw, self.num_channels, ph, pw)
        x = x.permute(0, 1, 4, 2, 5, 3)
        return x.reshape(b, nh * ph, nw * pw, self.num_channels)


class LinearOutputAdapter(nn.Module):
    """The classification head (JAX :347-376; reference :285-356): the mean
    of every encoder token, global tokens included (or the last token, the
    global one, without mean pooling), a LayerNorm and a Dense to the
    classes, its weight drawn trunc-normal(0.02) times `init_scale`."""

    def __init__(self, num_classes: int, dim_tokens_enc: int = 768,
                 use_mean_pooling: bool = True, init_scale: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.use_mean_pooling = use_mean_pooling
        self.norm = LayerNorm(dim_tokens_enc, dtype)
        self.head = Dense(dim_tokens_enc, num_classes, dtype=dtype, init_std=0.02 * init_scale)

    def forward(self, encoder_tokens: torch.Tensor, input_info: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, num_classes) logits in the compute dtype; the mean is summed
        in fp32 and rounded to the tokens' dtype, as jnp.mean does."""
        if self.use_mean_pooling:
            x = encoder_tokens.float().mean(dim=1).to(encoder_tokens.dtype)
        else:
            x = encoder_tokens[:, -1]
        return self.head(self.norm(x))


def adapt_tokens(encoder_tokens: torch.Tensor, input_info: Dict,
                 main_tasks: Sequence[str]) -> torch.Tensor:
    """The main tasks' token slices, concatenated channel-wise (reference
    :439-448, JAX :379-387)."""
    return torch.cat([encoder_tokens[:, input_info["tasks"][t]["start_idx"]:
                                     input_info["tasks"][t]["end_idx"]]
                      for t in main_tasks], dim=-1)


class SegmenterMaskTransformerAdapter(nn.Module):
    """Segmenter's mask transformer: the main tasks' tokens projected to
    embed_dim, one learned embedding per class appended, `depth` ViT
    blocks (drop_path rising linearly to drop_path_rate) over both, a
    LayerNorm, bias-free projections of the patch and class tokens, each
    l2-normalised in fp32, their products accumulated in fp32, a fp32
    LayerNorm over the classes (eps 1e-6) and a bilinear resize of the
    (H/16, W/16) masks to the image. The blocks take the kernels' gates as
    the encoder's do: K2 in training for bf16 key sets of 512 and more,
    K4 in eval."""

    def __init__(self, num_classes: int, depth: int = 2, num_heads: int = 12,
                 embed_dim: int = 768, mlp_ratio: float = 4.0,
                 drop_path_rate: float = 0.1, qkv_bias: bool = True,
                 main_tasks: Sequence[str] = ("rgb",), patch_size: int = 16,
                 dim_tokens_enc: int = 768, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.main_tasks = tuple(main_tasks)
        self.patch_size = patch_size
        self.dtype = dtype
        self.proj_dec = Dense(dim_tokens_enc * len(self.main_tasks), embed_dim, dtype=dtype,
                              init_std=0.02)
        self.cls_emb = nn.Parameter(torch.empty(1, num_classes, embed_dim))
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, dtype, drop_path_rate=dpr[i])
            for i in range(depth)])
        self.decoder_norm = LayerNorm(embed_dim, dtype)
        self.patch_proj = Dense(embed_dim, embed_dim, bias=False, dtype=dtype, init_std=0.02)
        self.classes_proj = Dense(embed_dim, embed_dim, bias=False, dtype=dtype,
                                  init_std=0.02)
        self.mask_norm = nn.LayerNorm(num_classes, eps=1e-6)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.cls_emb, generator)

    def _l2norm(self, v: torch.Tensor) -> torch.Tensor:
        v = v.float()
        return (v / torch.linalg.vector_norm(v, dim=2, keepdim=True).clamp_min(1e-12)
                ).to(self.dtype)

    def forward(self, encoder_tokens: torch.Tensor, input_info: Dict,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, num_classes) fp32 masks; in training the blocks'
        drop_path draws from `generator`."""
        h, w = input_info["image_size"]
        nh, nw = h // self.patch_size, w // self.patch_size
        x = self.proj_dec(adapt_tokens(encoder_tokens, input_info,
                                       self.main_tasks).to(self.dtype))
        b, c = x.shape[0], self.num_classes
        x = torch.cat([x, self.cls_emb.to(self.dtype).expand(b, -1, -1)], dim=1)
        for blk in self.blocks:
            x = blk(x, generator)
        x = self.decoder_norm(x)
        patches = self._l2norm(self.patch_proj(x[:, :-c]))
        classes = self._l2norm(self.classes_proj(x[:, -c:]))
        masks = torch.matmul(patches.float(), classes.float().transpose(1, 2))
        masks = F.layer_norm(masks, (c,), self.mask_norm.weight, self.mask_norm.bias, eps=1e-6)
        return interpolate_2d(masks.reshape(b, nh, nw, c), (h, w), mode="bilinear",
                              align_corners=False)


class ConvNeXtAdapter(nn.Module):
    """Semantic segmentation head: a Dense to preds_per_patch sub-pixels of
    embed_dim / preds_per_patch channels per token, the sub-pixel reshape
    to a (H/4, W/4) map, `depth` ConvNeXt blocks, a 1x1 conv to the classes
    and a bilinear resize to the image (JAX :482-531)."""

    def __init__(self, num_classes: int, embed_dim: int = 6144,
                 preds_per_patch: int = 16, main_tasks: Sequence[str] = ("rgb",),
                 patch_size: int = 16, depth: int = 4,
                 interpolate_mode: str = "bilinear", dim_tokens_enc: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.main_tasks = tuple(main_tasks)
        self.patch_size = patch_size
        self.preds_per_patch = preds_per_patch
        self.class_dim = embed_dim // preds_per_patch
        self.interpolate_mode = interpolate_mode
        self.dtype = dtype
        self.proj_dec = Dense(dim_tokens_enc * len(self.main_tasks), embed_dim,
                              dtype=dtype, init_std=0.02)
        self.blocks = nn.ModuleList([ConvNeXtBlock(self.class_dim, dtype=dtype)
                                     for _ in range(depth)])
        self.final_layer = make_conv(self.class_dim, num_classes, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.final_layer, generator)

    def forward(self, encoder_tokens: torch.Tensor, input_info: Dict,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, H, W, num_classes) logits; `generator` is unused (the head has
        no stochastic depth)."""
        h, w = input_info["image_size"]
        nh, nw = h // self.patch_size, w // self.patch_size
        sub = int(self.preds_per_patch ** 0.5)
        x = self.proj_dec(adapt_tokens(encoder_tokens, input_info,
                                       self.main_tasks).to(self.dtype))
        # (B, N, p*c): the sub-pixel index p is (ph, pw) row-major
        # (reference :562-566, JAX :514-518).
        b = x.shape[0]
        x = x.reshape(b, nh, nw, sub, sub, self.class_dim)
        x = x.permute(0, 1, 3, 2, 4, 5)  # (B, nh, ph, nw, pw, c)
        x = x.reshape(b, nh * sub, nw * sub, self.class_dim)
        for blk in self.blocks:
            x = blk(x)
        x = conv2d_nhwc(x, self.final_layer, self.dtype)
        return interpolate_2d(x, (h, w), mode=self.interpolate_mode, align_corners=False)


DPT_HOOKS = (2, 5, 8, 11)


def dpt_hooks(depth: int) -> Tuple[int, ...]:
    """The DPT head's hooked encoder layers: the reference's (2, 5, 8, 11),
    or for an encoder of fewer than 12 blocks (the tiny test model, which
    the JAX CLIs cannot run: their DPT head indexes past its layers) the
    last block of each quarter of its depth."""
    if depth >= 12:
        return DPT_HOOKS
    return tuple(max(0, depth * (i + 1) // 4 - 1) for i in range(4))


def set_dpt_hooks(model: nn.Module) -> nn.Module:
    """`model` with each DPT head hooking `dpt_hooks` of its encoder's depth."""
    for adapter in (model.output_adapters or {}).values():
        if isinstance(adapter, DPTOutputAdapter):
            adapter.hooks = dpt_hooks(len(model.encoder))
    return model


class DPTOutputAdapter(nn.Module):
    """The DPT head over four hooked encoder layers (JAX :534-686;
    reference :576-759). Each hooked layer's main-task tokens become a
    (H/16, W/16) map; 1x1 convs and a stride-4 and a stride-2 transposed
    conv, nothing, and a stride-2 3x3 conv make a pyramid at 1/4, 1/8,
    1/16 and 1/32; 3x3 convs (`scratch.layer*_rn`) project each to
    feature_dim; the RefineNet fusion blocks merge it from the coarsest
    up, to 1/2. The `regression` head: a 3x3 conv to feature_dim / 2, a 2x
    bilinear upsample (align_corners=True), a 3x3 conv to 32, ReLU and a
    1x1 conv to num_classes; the `semseg` head: a bias-free 3x3 conv,
    BatchNorm with use_bn, ReLU, dropout 0.1 drawn from the caller's
    generator in training, a 1x1 conv and the 2x upsample. Modules carry
    the reference's names (`act_*_postprocess.<i>`, `scratch.*`,
    `head.<i>`), so its state_dicts load as they are. Takes the list of
    every encoder layer's tokens (MultiViT's all-layers forward); NHWC
    out."""

    def __init__(self, num_classes: int = 3, stride_level: int = 1,
                 patch_size: Union[int, Tuple[int, int]] = 16,
                 main_tasks: Sequence[str] = ("rgb",), hooks: Sequence[int] = DPT_HOOKS,
                 layer_dims: Sequence[int] = (96, 192, 384, 768), feature_dim: int = 256,
                 use_bn: bool = False, dim_tokens_enc: int = 768,
                 head_type: str = "regression", dtype: torch.dtype = torch.float32):
        super().__init__()
        if head_type not in ("regression", "semseg"):
            raise ValueError('DPT head_type must be "regression" or "semseg".')
        self.stride_level = stride_level
        p = pair(patch_size)
        self.patch_hw = (max(1, p[0] // stride_level), max(1, p[1] // stride_level))
        self.main_tasks = tuple(main_tasks)
        self.hooks = tuple(hooks)
        self.head_type = head_type
        self.dtype = dtype
        d = dim_tokens_enc * len(self.main_tasks)
        l0, l1, l2, l3 = layer_dims
        self.act_1_postprocess = nn.Sequential(make_conv(d, l0, 1), make_deconv(l0, 4))
        self.act_2_postprocess = nn.Sequential(make_conv(d, l1, 1), make_deconv(l1, 2))
        self.act_3_postprocess = nn.Sequential(make_conv(d, l2, 1))
        self.act_4_postprocess = nn.Sequential(make_conv(d, l3, 1),
                                               make_conv(l3, l3, 3, stride=2))
        self.scratch = nn.Module()
        for i, dim in enumerate(layer_dims):
            setattr(self.scratch, f"layer{i + 1}_rn", make_conv(dim, feature_dim, 3, bias=False))
        for i in range(1, 5):
            setattr(self.scratch, f"refinenet{i}",
                    FeatureFusionBlock(feature_dim, use_bn, dtype, with_residual=i < 4))
        # the reference's nn.Sequential indices: (conv, interpolate, conv,
        # ReLU, conv) and (conv, BatchNorm or identity, ReLU, dropout, conv,
        # interpolate)
        if head_type == "regression":
            self.head = nn.Sequential(make_conv(feature_dim, feature_dim // 2, 3), nn.Identity(),
                                      make_conv(feature_dim // 2, 32, 3), nn.Identity(),
                                      make_conv(32, num_classes, 1))
        else:
            self.head = nn.Sequential(
                make_conv(feature_dim, feature_dim, 3, bias=False),
                BatchNorm(feature_dim, dtype) if use_bn else nn.Identity(), nn.Identity(),
                nn.Identity(), make_conv(feature_dim, num_classes, 1))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The convs outside the fusion blocks, which fill their own."""
        rn = [getattr(self.scratch, f"layer{i}_rn") for i in range(1, 5)]
        for m in [*self.act_1_postprocess, *self.act_2_postprocess, *self.act_3_postprocess,
                  *self.act_4_postprocess, *rn, *self.head]:
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                lecun_normal_(m, generator)

    def forward(self, encoder_tokens: Sequence[torch.Tensor], input_info: Dict,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not isinstance(encoder_tokens, (list, tuple)):
            raise TypeError("DPTOutputAdapter needs every encoder layer's tokens "
                            "(MultiViT's all-layers forward)")
        if max(self.hooks) >= len(encoder_tokens):
            raise ValueError(f"DPT hooks {self.hooks} need {max(self.hooks) + 1} encoder "
                             f"layers; the encoder has {len(encoder_tokens)}")
        h, w = input_info["image_size"]
        ph, pw = self.patch_hw
        nh, nw = h // (self.stride_level * ph), w // (self.stride_level * pw)
        dt = self.dtype
        layers = []
        for hook in self.hooks:
            x = adapt_tokens(encoder_tokens[hook], input_info, self.main_tasks).to(dt)
            layers.append(x.reshape(x.shape[0], nh, nw, x.shape[-1]))

        a1, a2, a3, a4 = (self.act_1_postprocess, self.act_2_postprocess,
                          self.act_3_postprocess, self.act_4_postprocess)
        pyramid = [conv_transpose2d_nhwc(conv2d_nhwc(layers[0], a1[0], dt), a1[1], dt),
                   conv_transpose2d_nhwc(conv2d_nhwc(layers[1], a2[0], dt), a2[1], dt),
                   conv2d_nhwc(layers[2], a3[0], dt),
                   conv2d_nhwc(conv2d_nhwc(layers[3], a4[0], dt), a4[1], dt, padding=1,
                               stride=2)]
        sc = self.scratch
        pyramid = [conv2d_nhwc(x, getattr(sc, f"layer{i + 1}_rn"), dt, padding=1)
                   for i, x in enumerate(pyramid)]
        path = sc.refinenet4(pyramid[3])
        path = sc.refinenet3(path, pyramid[2])
        path = sc.refinenet2(path, pyramid[1])
        path = sc.refinenet1(path, pyramid[0])

        head = self.head
        if self.head_type == "regression":
            x = conv2d_nhwc(path, head[0], dt, padding=1)
            x = interpolate_2d(x, (2 * x.shape[1], 2 * x.shape[2]), mode="bilinear",
                               align_corners=True)
            x = F.relu(conv2d_nhwc(x, head[2], dt, padding=1))
            return conv2d_nhwc(x, head[4], dt)
        x = conv2d_nhwc(path, head[0], dt, padding=1)
        if isinstance(head[1], BatchNorm):
            x = head[1](x)
        x = dropout(F.relu(x), 0.1, self.training, generator)
        x = conv2d_nhwc(x, head[4], dt)
        return interpolate_2d(x, (2 * x.shape[1], 2 * x.shape[2]), mode="bilinear",
                              align_corners=True)
