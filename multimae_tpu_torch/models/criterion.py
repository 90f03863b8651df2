"""Masked reconstruction losses (counterpart of
multimae_tpu/models/criterion.py; reference multimae/criterion.py).

Each loss takes an NHWC image prediction, or (B, N, C*p*p) token patches
straight from a decoder built with `return_patches` (the training path,
JAX :59-128, :158-168, :200-234): a 3-D input takes the patch path, which
skips the pixel-space reshapes and mask upsampling. Sums over a patch do
not depend on the order of its elements, so both paths give the same
loss.

Each sample's masked loss sum is divided by its masked-pixel count, then
the batch takes the mean over samples that have any masked pixel (0 if
none has), the reference's nanmean without NaNs. `parts` returns that
mean's numerator and denominator (without a mask: the loss sum and the
element count), so data-parallel ranks can sum them into the loss of the
global batch; calling a loss returns num / max(den, 1).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _upsample_mask(mask: torch.Tensor, hw, scale: int) -> torch.Tensor:
    """(B, nh*nw) token mask -> (B, H, W) fp32 pixel mask (nearest)."""
    h, w = hw
    m = mask.reshape(mask.shape[0], h // scale, w // scale).float()
    return m.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)


def _over_valid(per_sample: torch.Tensor, mask_sums: torch.Tensor):
    """(sum of the per-sample losses of non-empty samples, their count)."""
    valid = mask_sums > 0
    return torch.where(valid, per_sample, 0.0).sum(), valid.sum().float()


def _all_parts(loss: torch.Tensor):
    """Unmasked: (loss sum, element count)."""
    return loss.sum(), torch.full((), float(loss.numel()), device=loss.device)


def ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """The loss from its parts: num / max(den, 1)."""
    return num / den.clamp_min(1.0)


def _masked_parts(loss_pix: torch.Tensor, mask_pix: torch.Tensor):
    """Per-sample sum / mask-sum, over non-empty samples."""
    b = loss_pix.shape[0]
    loss_flat = loss_pix.reshape(b, -1)
    mask_flat = mask_pix.reshape(b, -1)
    mask_sums = mask_flat.sum(dim=1)
    per_sample = (loss_flat * mask_flat).sum(dim=1) / mask_sums.clamp_min(1.0)
    return _over_valid(per_sample, mask_sums)


def _norm_pix(target: torch.Tensor, scale: int) -> torch.Tensor:
    """Per-patch standardisation of a (B, H, W, C) target over each
    scale x scale patch's pixels and channels (criterion.py:89-95)."""
    b, h, w, c = target.shape
    nh, nw = h // scale, w // scale
    t = target.reshape(b, nh, scale, nw, scale, c).permute(0, 1, 3, 2, 4, 5)
    t = t.reshape(b, nh, nw, scale * scale * c)
    mean = t.mean(dim=-1, keepdim=True)
    var = t.var(dim=-1, keepdim=True, unbiased=False)
    t = (t - mean) / torch.sqrt(var + 1e-6)
    t = t.reshape(b, nh, nw, scale, scale, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, w, c)


def patchify_cpp(img: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, C*p*p) with (c, ph, pw) minor order, the
    SpatialOutputAdapter's patch layout."""
    b, h, w, c = img.shape
    x = img.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def _norm_pix_patches(t: torch.Tensor) -> torch.Tensor:
    """Per-patch standardisation of (B, N, D) patch targets, the patch-space
    form of _norm_pix."""
    mean = t.mean(dim=-1, keepdim=True)
    var = t.var(dim=-1, keepdim=True, unbiased=False)
    return (t - mean) / torch.sqrt(var + 1e-6)


def _masked_token_parts(tok_loss: torch.Tensor, mask: torch.Tensor,
                        pixels_per_token: int):
    """Per-sample sum over masked tokens / masked pixels, over non-empty
    samples: _masked_parts after the nearest mask upsampling, since each
    token covers `pixels_per_token` pixels of one mask value."""
    m = mask.float()
    mask_sums = m.sum(dim=1) * pixels_per_token
    per_sample = (tok_loss * m).sum(dim=1) / mask_sums.clamp_min(1.0)
    return _over_valid(per_sample, mask_sums)


class _PixelLoss:
    def __init__(self, patch_size: int = 16, stride: int = 1,
                 norm_pix: bool = False):
        self.scale = patch_size // stride
        self.norm_pix = norm_pix

    def _pixel_loss(self, input, target):
        raise NotImplementedError

    def _patch_call(self, input, target, mask):
        p = self.scale
        channels = target.shape[-1]
        tgt = patchify_cpp(target, p)
        if self.norm_pix:
            tgt = _norm_pix_patches(tgt)
        loss = self._pixel_loss(input, tgt)
        if mask is None:
            return _all_parts(loss)
        return _masked_token_parts(loss.sum(dim=-1) / channels, mask, p * p)

    def parts(self, input: torch.Tensor, target: torch.Tensor,
              mask: Optional[torch.Tensor] = None):
        """input: (B, H, W, C) or (B, N, C*p*p) patches; target:
        (B, H, W, C); mask: (B, nh*nw), 1 = masked."""
        input = input.float()
        target = target.float()
        if input.dim() == 3:
            return self._patch_call(input, target, mask)
        if self.norm_pix:
            target = _norm_pix(target, self.scale)
        loss = self._pixel_loss(input, target)
        if mask is None:
            return _all_parts(loss)
        mask_pix = _upsample_mask(mask, input.shape[1:3], self.scale)
        return _masked_parts(loss.mean(dim=-1), mask_pix)

    def __call__(self, input: torch.Tensor, target: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return ratio(*self.parts(input, target, mask))


class MaskedMSELoss(_PixelLoss):
    """reference criterion.py:60-114."""

    def _pixel_loss(self, input, target):
        return (input - target) ** 2


class MaskedL1Loss(_PixelLoss):
    """reference criterion.py:117-171."""

    def _pixel_loss(self, input, target):
        return (input - target).abs()


class MaskedCrossEntropyLoss:
    """reference criterion.py:23-57: NHWC logits or (B, N, classes*p*p)
    patches, (B, H, W) int targets."""

    def __init__(self, patch_size: int = 16, stride: int = 1,
                 label_smoothing: float = 0.0):
        self.scale = patch_size // stride
        self.label_smoothing = label_smoothing

    def _nll(self, logp: torch.Tensor, target: torch.Tensor, dim: int) -> torch.Tensor:
        nll = -torch.gather(logp, dim, target.long().unsqueeze(dim)).squeeze(dim)
        if self.label_smoothing > 0.0:
            nll = ((1.0 - self.label_smoothing) * nll
                   - self.label_smoothing * logp.mean(dim=dim))
        return nll

    def _patch_call(self, input, target, mask):
        """input: (B, N, classes*p*p) with (class, ph, pw) minor order;
        target: (B, H, W) int at the modality's stride resolution."""
        p = self.scale
        b, n, d = input.shape
        logp = F.log_softmax(input.reshape(b, n, d // (p * p), p * p), dim=2)
        h, w = target.shape[1], target.shape[2]
        tgt = target.reshape(b, h // p, p, w // p, p).permute(0, 1, 3, 2, 4)
        nll = self._nll(logp, tgt.reshape(b, n, p * p), dim=2)
        if mask is None:
            return _all_parts(nll)
        return _masked_token_parts(nll.sum(dim=-1), mask, p * p)

    def parts(self, input: torch.Tensor, target: torch.Tensor,
              mask: Optional[torch.Tensor] = None):
        if input.dim() == 3:
            return self._patch_call(input.float(), target, mask)
        nll = self._nll(F.log_softmax(input.float(), dim=-1), target, dim=-1)
        if mask is None:
            return _all_parts(nll)
        mask_pix = _upsample_mask(mask, input.shape[1:3], self.scale)
        return _masked_parts(nll, mask_pix)

    def __call__(self, input: torch.Tensor, target: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return ratio(*self.parts(input, target, mask))
