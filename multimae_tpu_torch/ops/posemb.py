"""2D sin-cos positional embeddings (MoCo-v3 style).

Numerically matches the reference `build_2d_sincos_posemb`
(reference: multimae/multimae_utils.py:29-45) but returns NHWC layout
(1, h, w, embed_dim) instead of torch's (1, embed_dim, h, w).

The reference builds its grid with `torch.meshgrid(arange(w), arange(h))`
('ij' indexing, so axis 0 of the grids is the *w* range), flattens
w-major, and then reshapes `(h w) -> h w` h-major. For the square grids
the model actually uses, the net effect is that the first half of the
channels encodes the FIRST spatial axis ("w" frequencies on rows) and the
second half the second axis. We reproduce the exact op sequence so the
values match bit-for-bit for any (h, w).
"""

from __future__ import annotations

import numpy as np


def build_2d_sincos_posemb(
    h: int, w: int, embed_dim: int = 768, temperature: float = 10000.0
) -> np.ndarray:
    """Returns a (1, h, w, embed_dim) float32 numpy array.

    Computed with numpy at trace/setup time (static shapes); callers embed
    it as a constant or a frozen parameter.
    """
    assert embed_dim % 4 == 0, "embed_dim must be divisible by 4 for 2D sin-cos posemb"
    grid_w, grid_h = np.meshgrid(
        np.arange(w, dtype=np.float32),
        np.arange(h, dtype=np.float32),
        indexing="ij",
    )
    pos_dim = embed_dim // 4
    omega = np.arange(pos_dim, dtype=np.float32) / pos_dim
    omega = 1.0 / (temperature**omega)
    out_w = grid_w.reshape(-1)[:, None] * omega[None, :]
    out_h = grid_h.reshape(-1)[:, None] * omega[None, :]
    pos_emb = np.concatenate(
        [np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1
    )
    # Reference flattens w-major then rearranges h-major; reproduce exactly.
    pos_emb = pos_emb.reshape(h, w, embed_dim)
    return pos_emb[None, ...].astype(np.float32)
