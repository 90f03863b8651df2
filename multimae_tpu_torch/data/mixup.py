"""Mixup and CutMix with smoothed soft targets (counterpart of
multimae_tpu/data/mixup.py; reference utils/mixup.py:96-227).

The draws are the JAX module's, from a seeded np.random.default_rng in
the same order: whether to mix, mixup or cutmix, lambda, the box. The
mixing itself runs in torch on the batch's device (the loader's NHWC
float32 batch, on the card in the CLI), with the JAX module's float32
arithmetic, so the mixed batch and the soft targets equal what the JAX
module returns for the same batch and seed. Modes: 'batch' (one lambda
for the batch, mixed with the batch reversed), 'pair' and 'elem'. CutMix
boxes take the lambda-derived ratio or `cutmix_minmax`, and lambda is
corrected to the box's area.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch


def mixup_target(targets: torch.Tensor, num_classes: int,
                 lam: Union[float, torch.Tensor], smoothing: float = 0.0) -> torch.Tensor:
    """(B, num_classes) float32: the smoothed one-hot targets mixed with
    those of the batch reversed, lam a float or a (B,) tensor."""
    off_value = smoothing / num_classes
    on_value = 1.0 - smoothing + off_value
    y1 = torch.full((targets.shape[0], num_classes), off_value, dtype=torch.float32,
                    device=targets.device)
    y1.scatter_(1, targets.long().reshape(-1, 1), on_value)
    y2 = y1.flip(0)
    if torch.is_tensor(lam):
        lam = lam.reshape(-1, 1)
    return y1 * lam + y2 * (1.0 - lam)


def rand_bbox(shape, lam: float, rng: np.random.Generator, margin: float = 0.0,
              count: int = 1):
    """The lambda-ratio box (reference mixup.py:30-48); shape (..., H, W, C)."""
    img_h, img_w = shape[-3], shape[-2]
    ratio = np.sqrt(1 - lam)
    cut_h, cut_w = int(img_h * ratio), int(img_w * ratio)
    margin_y, margin_x = int(margin * cut_h), int(margin * cut_w)
    cy = rng.integers(0 + margin_y, img_h - margin_y, size=count)
    cx = rng.integers(0 + margin_x, img_w - margin_x, size=count)
    yl = np.clip(cy - cut_h // 2, 0, img_h)
    yh = np.clip(cy + cut_h // 2, 0, img_h)
    xl = np.clip(cx - cut_w // 2, 0, img_w)
    xh = np.clip(cx + cut_w // 2, 0, img_w)
    return yl, yh, xl, xh


def rand_bbox_minmax(shape, minmax: Sequence[float], rng: np.random.Generator,
                     count: int = 1):
    img_h, img_w = shape[-3], shape[-2]
    cut_h = rng.integers(int(img_h * minmax[0]), int(img_h * minmax[1]), size=count)
    cut_w = rng.integers(int(img_w * minmax[0]), int(img_w * minmax[1]), size=count)
    yl = rng.integers(0, img_h - cut_h, size=count)
    xl = rng.integers(0, img_w - cut_w, size=count)
    return yl, yl + cut_h, xl, xl + cut_w


def cutmix_bbox_and_lam(shape, lam: float, ratio_minmax, correct_lam: bool,
                        rng: np.random.Generator) -> Tuple[Tuple[int, int, int, int], float]:
    """((y0, y1, x0, x1), lambda corrected to the box's area)."""
    if ratio_minmax is not None:
        box = rand_bbox_minmax(shape, ratio_minmax, rng)
    else:
        box = rand_bbox(shape, lam, rng)
    yl, yu, xl, xu = (int(np.asarray(v).reshape(-1)[0]) for v in box)
    if correct_lam or ratio_minmax is not None:
        lam = 1.0 - (yu - yl) * (xu - xl) / float(shape[-3] * shape[-2])
    return (yl, yu, xl, xu), lam


class Mixup:
    def __init__(self, mixup_alpha: float = 1.0, cutmix_alpha: float = 0.0,
                 cutmix_minmax: Optional[Sequence[float]] = None, prob: float = 1.0,
                 switch_prob: float = 0.5, mode: str = "batch", correct_lam: bool = True,
                 label_smoothing: float = 0.1, num_classes: int = 1000,
                 seed: Optional[int] = None):
        if mode not in ("batch", "pair", "elem"):
            raise ValueError(f"mixup mode {mode!r}: one of batch, pair, elem")
        self.mixup_alpha = mixup_alpha
        self.cutmix_alpha = cutmix_alpha
        self.cutmix_minmax = cutmix_minmax
        if cutmix_minmax is not None:
            if len(cutmix_minmax) != 2:
                raise ValueError(f"cutmix_minmax takes two values, not {cutmix_minmax}")
            self.cutmix_alpha = 1.0
        self.mix_prob = prob
        self.switch_prob = switch_prob
        self.mode = mode
        self.correct_lam = correct_lam
        self.label_smoothing = label_smoothing
        self.num_classes = num_classes
        self.rng = np.random.default_rng(seed)

    def _params_per_batch(self) -> Tuple[float, bool]:
        lam, use_cutmix = 1.0, False
        if self.rng.random() < self.mix_prob:
            if self.mixup_alpha > 0.0 and self.cutmix_alpha > 0.0:
                use_cutmix = self.rng.random() < self.switch_prob
                lam = float(self.rng.beta(self.cutmix_alpha, self.cutmix_alpha) if use_cutmix
                            else self.rng.beta(self.mixup_alpha, self.mixup_alpha))
            elif self.mixup_alpha > 0.0:
                lam = float(self.rng.beta(self.mixup_alpha, self.mixup_alpha))
            elif self.cutmix_alpha > 0.0:
                use_cutmix = True
                lam = float(self.rng.beta(self.cutmix_alpha, self.cutmix_alpha))
        return lam, use_cutmix

    def _mix_batch(self, x: torch.Tensor) -> float:
        lam, use_cutmix = self._params_per_batch()
        if lam == 1.0:
            return 1.0
        if use_cutmix:
            (yl, yh, xl, xh), lam = cutmix_bbox_and_lam(x.shape, lam, self.cutmix_minmax,
                                                        self.correct_lam, self.rng)
            x[:, yl:yh, xl:xh] = x.flip(0)[:, yl:yh, xl:xh]
        else:
            x_flipped = x.flip(0) * (1.0 - lam)
            x.mul_(lam).add_(x_flipped)
        return lam

    def _mix_pair_or_elem(self, x: torch.Tensor, pair: bool) -> torch.Tensor:
        b = x.shape[0]
        n = b // 2 if pair else b
        lam_batch = np.ones(b, np.float32)
        for i in range(n):
            j = b - i - 1
            lam, use_cutmix = self._params_per_batch()
            if lam == 1.0:
                continue
            if use_cutmix:
                (yl, yh, xl, xh), lam = cutmix_bbox_and_lam(x[i].shape, lam, self.cutmix_minmax,
                                                            self.correct_lam, self.rng)
                x[i, yl:yh, xl:xh] = x[j, yl:yh, xl:xh]
                if pair:
                    x[j, yl:yh, xl:xh] = x[i, yl:yh, xl:xh]
            else:
                x[i] = x[i] * lam + x[j] * (1 - lam)
                if pair:
                    x[j] = x[j] * lam + x[i] * (1 - lam)
            lam_batch[i] = lam
            if pair:
                lam_batch[j] = lam
        return torch.from_numpy(lam_batch).to(x.device)

    def __call__(self, x: torch.Tensor, target: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mixed float32 copy of the NHWC batch x, (B, num_classes) soft
        targets), on x's device."""
        if x.shape[0] % 2:
            raise ValueError(f"mixup needs an even batch, not {x.shape[0]}")
        x = x.to(torch.float32, copy=True)
        if self.mode == "batch":
            lam = self._mix_batch(x)
        else:
            lam = self._mix_pair_or_elem(x, pair=(self.mode == "pair"))
        return x, mixup_target(target.to(x.device), self.num_classes, lam,
                               self.label_smoothing)
