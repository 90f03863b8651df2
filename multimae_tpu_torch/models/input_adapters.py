"""Input adapters: tokenize per-modality inputs into encoder tokens
(counterpart of multimae_tpu/models/input_adapters.py; reference
multimae/input_adapters.py:27-241).

Inputs are NHWC as in the JAX package. The patch projection is a
Conv2d with kernel == stride on the input permuted to NCHW (the JAX
package's patchify + Dense is the same product); the semseg class map
goes through an nn.Embedding first. Sin-cos positional embeddings are
frozen parameters stored (1, D, h, w) as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from multimae_tpu_torch.models.vit import trunc_normal_, xavier_uniform_
from multimae_tpu_torch.ops.posemb import build_2d_sincos_posemb
from multimae_tpu_torch.ops.resize import interpolate_2d


def pair(t):
    return t if isinstance(t, tuple) else (t, t)


def sincos_pos_emb(h: int, w: int, dim: int) -> nn.Parameter:
    """Frozen (1, D, h, w) sin-cos embedding (reference requires_grad=False)."""
    pe = torch.from_numpy(build_2d_sincos_posemb(h, w, dim)).permute(0, 3, 1, 2)
    return nn.Parameter(pe.contiguous(), requires_grad=False)


def pos_tokens(pos_emb: torch.Tensor, size: Tuple[int, int], mode: str,
               dtype: torch.dtype) -> torch.Tensor:
    """(1, D, h, w) embedding resized to `size` -> (1, nh*nw, D) in dtype."""
    pe = interpolate_2d(pos_emb.permute(0, 2, 3, 1), size, mode=mode)
    return pe.reshape(1, size[0] * size[1], -1).to(dtype)


def patch_project(x_nchw: torch.Tensor, proj: nn.Conv2d,
                  dtype: torch.dtype) -> torch.Tensor:
    """Patch projection in `dtype` -> (B, nh*nw, D); the bias is added
    after the product is rounded, as the JAX package's Dense does."""
    y = F.conv2d(x_nchw.to(dtype), proj.weight.to(dtype), stride=proj.stride)
    y = y + proj.bias.to(dtype)[:, None, None]
    return y.flatten(2).transpose(1, 2)


class PatchedInputAdapter(nn.Module):
    """Dense-image tokenizer (reference input_adapters.py:27-119)."""

    def __init__(self, num_channels: int, stride_level: int,
                 patch_size_full: Union[int, Tuple[int, int]], dim_tokens: int,
                 image_size: Union[int, Tuple[int, int]] = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_channels = num_channels
        self.dtype = dtype
        p = pair(patch_size_full)
        self.patch_hw = (max(1, p[0] // stride_level), max(1, p[1] // stride_level))
        img = pair(image_size)
        ph, pw = self.patch_hw
        self.pos_emb = sincos_pos_emb(img[0] // (stride_level * ph),
                                      img[1] // (stride_level * pw), dim_tokens)
        self.proj = nn.Conv2d(num_channels, dim_tokens, kernel_size=self.patch_hw,
                              stride=self.patch_hw, device="meta")
        self.proj.weight = nn.Parameter(torch.empty(self.proj.weight.shape))
        self.proj.bias = nn.Parameter(torch.empty(dim_tokens))

    def reset_parameters(self, generator: torch.Generator) -> None:
        xavier_uniform_(self.proj.weight, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) at this modality's stride level -> (B, N, D)."""
        b, h, w, c = x.shape
        ph, pw = self.patch_hw
        if h % ph or w % pw:
            raise ValueError(f"image {h}x{w} not divisible by patch {ph}x{pw}")
        tokens = patch_project(x.permute(0, 3, 1, 2), self.proj, self.dtype)
        return tokens + pos_tokens(self.pos_emb, (h // ph, w // pw), "bicubic",
                                   self.dtype)


class _Embedding(torch.autograd.Function):
    """F.embedding(ids, table) whose table gradient is onehot(ids)^T @ g, a
    matmul that adds in a fixed order: torch's CUDA embedding backward adds
    with atomics, in an order that changes from run to run (the JAX
    package's lookup is this one-hot product, forward and backward)."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1, 1)
        onehot = torch.zeros(flat.shape[0], ctx.rows, dtype=g.dtype, device=g.device)
        onehot.scatter_(1, flat, 1.0)
        return None, onehot.t() @ g.reshape(-1, g.shape[-1])


class SemSegInputAdapter(nn.Module):
    """Class-map tokenizer (reference input_adapters.py:122-241, JAX
    :130-245); input is an int class map (B, H/stride, W/stride).

    With `emb_padding_idx` the class embedding has one more row, the void
    class the fine-tune CLI maps invalid pseudo labels to, and that row is
    zero in every forward and gets no gradient (JAX :191-195; the
    reference's nn.Embedding(padding_idx=...)). With
    `interpolate_class_emb` the per-pixel embeddings are resized
    bilinearly to the patch grid and projected by a 1x1 convolution
    (JAX :211-224) instead of the patch-sized one."""

    def __init__(self, num_classes: int, stride_level: int,
                 patch_size_full: Union[int, Tuple[int, int]], dim_tokens: int,
                 image_size: Union[int, Tuple[int, int]] = 224,
                 dim_class_emb: int = 64, interpolate_class_emb: bool = False,
                 emb_padding_idx: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.interpolate_class_emb = interpolate_class_emb
        self.emb_padding_idx = emb_padding_idx
        p = pair(patch_size_full)
        self.patch_hw = (max(1, p[0] // stride_level), max(1, p[1] // stride_level))
        img = pair(image_size)
        ph, pw = self.patch_hw
        self.pos_emb = sincos_pos_emb(img[0] // (stride_level * ph),
                                      img[1] // (stride_level * pw), dim_tokens)
        rows = num_classes + (emb_padding_idx is not None)
        self.class_emb = nn.Embedding(rows, dim_class_emb, device="meta")
        self.class_emb.weight = nn.Parameter(torch.empty(rows, dim_class_emb))
        kernel = (1, 1) if interpolate_class_emb else self.patch_hw
        self.proj = nn.Conv2d(dim_class_emb, dim_tokens, kernel_size=kernel,
                              stride=kernel, device="meta")
        self.proj.weight = nn.Parameter(torch.empty(self.proj.weight.shape))
        self.proj.bias = nn.Parameter(torch.empty(dim_tokens))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.class_emb.weight, generator)
        xavier_uniform_(self.proj.weight, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w = x.shape
        ph, pw = self.patch_hw
        if h % ph or w % pw:
            raise ValueError(f"class map {h}x{w} not divisible by patch {ph}x{pw}")
        nh, nw = h // ph, w // pw
        table = self.class_emb.weight
        if self.emb_padding_idx is not None:
            table = table.index_fill(
                0, torch.tensor([self.emb_padding_idx], device=table.device), 0.0)
        emb = _Embedding.apply(x.long(), table).to(self.dtype)  # (B, h, w, 64)
        if self.interpolate_class_emb:
            emb = interpolate_2d(emb, (nh, nw), mode="bilinear")
        tokens = patch_project(emb.permute(0, 3, 1, 2), self.proj, self.dtype)
        return tokens + pos_tokens(self.pos_emb, (nh, nw), "bilinear", self.dtype)
