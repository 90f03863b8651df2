"""Attention dispatch in the (B, N, H, dh) layout (counterpart of
multimae_tpu/ops/attention.py:62-86, :224-307).

`fused_attention_bnhd` takes the K2 kernel (ops/short_attention.py) for
CUDA bf16 tensors with at least SHORT_KERNEL_MIN_KV keys, else the einsum
path with the reference's numerics.

K2 also serves the JAX package's flash wrapper (`flash_attention_padded`,
multimae_tpu/ops/attention.py:176, around JAX's shipped TPU flash kernel,
taken at :297-302 where MULTIMAE_TPU_FLASH_ATTENTION=1 is set and the K2
gate refused): that wrapper computes K2's function with 128-padding and
segment ids, and every shape its gate takes (bf16, Nk >= 512, Nq >= 128,
head widths 32, 64 and 128; its 256 fits no model in the repo) passes
K2's gate, so it needs no kernel of its own: padding and segment ids are
what K2's masked ragged tails already do.
The TPU package's tensor-parallel, mesh and environment switches (the
flash switch among them) and its remat and light-residual variants have
no counterpart here.
"""

from __future__ import annotations

import torch

from multimae_tpu_torch.ops import short_attention as sa
from multimae_tpu_torch.ops.functional import attention

# The JAX package's threshold (multimae_tpu/ops/attention.py:232), carried
# over so that both packages take the same path at every shape. It was
# measured on a TPU v5e, not on this card: chip_smoke.py times K2 against
# its twin and against torch's scaled_dot_product_attention at 197, 577,
# 1025 and 2049 keys so that it can be set from the card's own numbers.
SHORT_KERNEL_MIN_KV = 512


def einsum_attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: float) -> torch.Tensor:
    """Dense softmax attention, (B, N, H, dh) in and out, with the
    reference's numerics (ops/functional.attention on the head-major view)."""
    out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), sm_scale)
    return out.transpose(1, 2)


def use_short_kernel(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX gate (`_use_short_kernel`), on the card."""
    return (q.is_cuda and q.dtype == torch.bfloat16
            and k.shape[1] >= SHORT_KERNEL_MIN_KV and sa.supported(q, k))


def fused_attention_bnhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         sm_scale: float) -> torch.Tensor:
    """q (B, Nq, H, dh), k and v (B, Nk, H, dh) -> (B, Nq, H, dh)."""
    if use_short_kernel(q, k):
        return sa.short_attention(q, k, v, sm_scale)
    return einsum_attention_bnhd(q, k, v, sm_scale)
