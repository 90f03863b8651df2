"""Dirichlet task-sampled token masking (counterpart of
multimae_tpu/ops/masking.py; reference multimae/multimae.py:148-248).

Every random draw comes from an explicit `torch.Generator`, whose device
decides where the draws are made. The JAX and torch random streams
differ, so tests compare the samplers by their statistics and run the
models against each other with fixed masks (`masks_to_indices`).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

Alphas = Union[float, Sequence[float]]


def _alpha_list(alphas: Alphas, n_tasks: int) -> List[float]:
    if isinstance(alphas, (int, float)):
        return [float(alphas)] * n_tasks
    return [float(a) for a in alphas]


def sample_alphas(generator: torch.Generator, batch: int, n_tasks: int,
                  alphas: Alphas = 1.0, eps: float = 1e-5) -> torch.Tensor:
    """Uniformly choose a non-empty task subset per sample, scale by
    alphas; excluded tasks get concentration `eps` (reference :148-162)."""
    device = generator.device
    choices = torch.tensor(
        [list(c) for c in itertools.product([0, 1], repeat=n_tasks)][1:],
        dtype=torch.float32, device=device,
    )
    idx = torch.randint(0, choices.shape[0], (batch,), generator=generator,
                        device=device)
    alphas_t = torch.tensor(_alpha_list(alphas, n_tasks), dtype=torch.float32,
                            device=device)
    return choices[idx] * alphas_t + eps


def _gamma(generator: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha) by Marsaglia-Tsang on (alpha + 1) with the U^(1/alpha)
    boost, so one rejection loop serves every alpha > 0 (the boost
    underflows to 0 for the eps-sized concentrations of excluded tasks,
    which is the intended "this task gets no tokens")."""
    device = alpha.device
    tiny = torch.finfo(torch.float32).tiny
    d = alpha.float() + 1.0 - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.ones_like(d)
    pending = torch.ones_like(d, dtype=torch.bool)
    while bool(pending.any()):
        x = torch.randn(d.shape, generator=generator, device=device)
        u = torch.rand(d.shape, generator=generator, device=device).clamp_min(tiny)
        w = 1.0 + c * x
        v = w * w * w
        ok = (w > 0) & (
            torch.log(u)
            < 0.5 * x * x + d - d * v + d * torch.log(torch.where(w > 0, v, 1.0))
        )
        out = torch.where(ok & pending, d * v, out)
        pending &= ~ok
    boost = torch.rand(d.shape, generator=generator, device=device).clamp_min(tiny)
    return out * torch.exp(torch.log(boost) / alpha.float())


def dirichlet_task_proportions(generator: torch.Generator, batch: int,
                               n_tasks: int, alphas: Alphas = 1.0,
                               sample_tasks_uniformly: bool = False
                               ) -> torch.Tensor:
    """(B, n_tasks) rows on the simplex; the flat Dirichlet(1, ..., 1) of
    the default recipe is sampled exactly as normalised Exp(1) draws."""
    device = generator.device
    if sample_tasks_uniformly:
        gammas = _gamma(generator, sample_alphas(generator, batch, n_tasks, alphas))
    else:
        alpha_list = _alpha_list(alphas, n_tasks)
        if all(a == 1.0 for a in alpha_list):
            gammas = torch.empty((batch, n_tasks), device=device).exponential_(
                generator=generator)
        else:
            gammas = _gamma(generator, torch.tensor(
                alpha_list, dtype=torch.float32, device=device
            ).expand(batch, n_tasks))
    return gammas / gammas.sum(dim=-1, keepdim=True)


def generate_random_masks(generator: torch.Generator, batch: int,
                          num_tokens_per_task: Sequence[int],
                          num_encoded_tokens: int, alphas: Alphas = 1.0,
                          sample_tasks_uniformly: bool = False
                          ) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Sample visible-token ids across tasks (reference :164-218).

    Returns (task_masks, ids_keep, ids_restore): a list of (B, n_t) int64
    masks (0 = visible, 1 = masked), the (B, num_encoded_tokens) indices
    of the visible tokens in the concatenated sequence, and the (B, N)
    inverse shuffle."""
    device = generator.device
    total = int(sum(num_tokens_per_task))
    props = dirichlet_task_proportions(generator, batch,
                                       len(num_tokens_per_task), alphas,
                                       sample_tasks_uniformly)
    samples_per_task = torch.round(props * num_encoded_tokens).long()

    task_masks = []
    for i, n_t in enumerate(num_tokens_per_task):
        noise = torch.rand((batch, n_t), generator=generator, device=device)
        perm = torch.argsort(noise, dim=1)
        task_masks.append((perm >= samples_per_task[:, i:i + 1]).long())

    mask_all = torch.cat(task_masks, dim=1)
    tie_noise = torch.rand((batch, total), generator=generator, device=device)
    ids_shuffle = torch.argsort(mask_all.float() + tie_noise, dim=1)
    ids_restore = torch.argsort(ids_shuffle, dim=1)
    ids_keep = ids_shuffle[:, :num_encoded_tokens]

    # Exactly num_encoded_tokens visible after the rounding (reference :209-216).
    mask_all = (ids_restore >= num_encoded_tokens).long()
    return (list(torch.split(mask_all, list(num_tokens_per_task), dim=1)),
            ids_keep, ids_restore)


def make_mask(n_h: int, n_w: int, xy_idxs: Dict[str, Sequence],
              full_tasks: Sequence[str] = (), indicate_visible: bool = True,
              flatten: bool = True) -> Dict[str, torch.Tensor]:
    """Per-task masks from lists of visible (x, y) patch coordinates
    (reference :220-248); 0 = visible when indicate_visible."""
    task_masks = {k: np.ones((n_h, n_w), np.int64) for k in xy_idxs}
    for k, coords in xy_idxs.items():
        coords = np.asarray(list(coords), np.int64).reshape(-1, 2)
        if len(coords):
            task_masks[k][coords[:, 1], coords[:, 0]] = 0
    for task in full_tasks:
        task_masks[task][:] = 0
    if not indicate_visible:
        task_masks = {k: 1 - v for k, v in task_masks.items()}
    if flatten:
        task_masks = {k: v.reshape(1, -1) for k, v in task_masks.items()}
    return {k: torch.from_numpy(v) for k, v in task_masks.items()}


def masks_to_indices(task_masks: Dict[str, torch.Tensor],
                     num_encoded_tokens: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids_keep, ids_restore) from binary masks; the stable sorts make
    the result exact (JAX :212-227)."""
    mask_all = torch.cat([m.long() for m in task_masks.values()], dim=1)
    ids_shuffle = torch.argsort(mask_all, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    return ids_shuffle[:, :num_encoded_tokens], ids_restore
