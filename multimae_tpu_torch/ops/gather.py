"""Token gathers (counterpart of multimae_tpu/ops/gather.py).

The JAX package writes these as one-hot matmuls for the TPU's matrix
unit; on the GPU a plain `torch.gather` is the natural form.
"""

from __future__ import annotations

import torch


def gather_tokens(values: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """out[b, i] = values[b, ids[b, i]]; values (B, N, D), ids (B, M)."""
    idx = ids.long().unsqueeze(-1).expand(-1, -1, values.shape[-1])
    return torch.gather(values, 1, idx)
