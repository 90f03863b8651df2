"""The port's ops and losses against the JAX package's, on numpy inputs.

posemb, masks_to_indices, make_mask and the gathers are exact; the
resize matches within 1e-5 (both follow torch's F.interpolate), its
bilinear gradient (the adjoint as two matmuls) torch's own backward and
jax.vjp's, and the class embedding's gradient (a one-hot product) torch's; the
random masking is checked by its invariants and the Dirichlet sampler by
its statistics, since the JAX and torch random streams differ; the
losses match within 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.models import criterion as jcrit
from multimae_tpu.ops import gather as jgather
from multimae_tpu.ops import masking as jmasking
from multimae_tpu.ops import posemb as jposemb
from multimae_tpu.ops import resize as jresize
from multimae_tpu_torch.models import criterion as tcrit
from multimae_tpu_torch.ops import gather as tgather
from multimae_tpu_torch.ops import masking as tmasking
from multimae_tpu_torch.ops import posemb as tposemb
from multimae_tpu_torch.ops import resize as tresize


@pytest.mark.parametrize("h,w,dim", [(14, 14, 768), (14, 14, 256), (4, 6, 64)])
def test_posemb_bit_equal(h, w, dim):
    np.testing.assert_array_equal(tposemb.build_2d_sincos_posemb(h, w, dim),
                                  jposemb.build_2d_sincos_posemb(h, w, dim))


@pytest.mark.parametrize("mode,size", [("bicubic", (7, 9)), ("bilinear", (20, 12))])
def test_resize_matches_jax(mode, size):
    x = np.random.default_rng(0).standard_normal((2, 14, 10, 8)).astype(np.float32)
    ref = np.asarray(jresize.interpolate_2d(jnp.asarray(x), size, mode=mode))
    out = tresize.interpolate_2d(torch.from_numpy(x), size, mode=mode).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hw,size,align_corners", [
    ((8, 6), (32, 24), False), ((8, 6), (16, 12), True), ((7, 5), (3, 4), False),
    ((5, 4), (5, 9), True), ((1, 3), (4, 6), False), ((4, 4), (1, 1), True)])
def test_bilinear_gradient_is_its_adjoint_and_jax_s(hw, size, align_corners):
    """The bilinear resize's gradient (two matmuls) against torch's own
    F.interpolate backward (float64, to rounding) and jax.vjp of the JAX
    resize (fp32, within 1e-5)."""
    import jax

    rng = np.random.default_rng(len(size))
    x = rng.standard_normal((2, *hw, 3))
    g = rng.standard_normal((2, *size, 3))
    t = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(
        tresize.interpolate_2d(t, size, align_corners=align_corners), t, torch.from_numpy(g))
    ref = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    out = torch.nn.functional.interpolate(ref, size=size, mode="bilinear",
                                          align_corners=align_corners)
    (want,) = torch.autograd.grad(out, ref, torch.from_numpy(g).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(), rtol=0,
                               atol=1e-12)
    _, vjp = jax.vjp(lambda a: jresize.interpolate_2d(a, size, mode="bilinear",
                                                      align_corners=align_corners),
                     jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g, jnp.float32))[0]),
                               rtol=0, atol=1e-5)


def test_class_embedding_gradient_is_the_one_hot_product():
    from multimae_tpu_torch.models.input_adapters import _Embedding

    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 7, (2, 5, 5)))
    table = torch.from_numpy(rng.standard_normal((7, 4))).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((2, 5, 5, 4)))
    out = _Embedding.apply(ids, table)
    assert torch.equal(out, torch.nn.functional.embedding(ids, table))
    (got,) = torch.autograd.grad(out, table, g)
    (want,) = torch.autograd.grad(torch.nn.functional.embedding(ids, table), table, g)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


def test_resize_identity_returns_input():
    x = torch.randn(1, 4, 4, 8)
    assert tresize.interpolate_2d(x, (4, 4)) is x


def test_gather_tokens_exact():
    rng = np.random.default_rng(0)
    values = rng.standard_normal((3, 12, 5)).astype(np.float32)
    ids = rng.integers(0, 12, (3, 7))
    ref = np.asarray(jgather.gather_tokens(jnp.asarray(values), jnp.asarray(ids)))
    out = tgather.gather_tokens(torch.from_numpy(values), torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(), ref)


def _fixed_masks(seed, batch=4, counts=(16, 16, 16), visible=24):
    rng = np.random.default_rng(seed)
    total = sum(counts)
    m = np.ones((batch, total), np.int32)
    for i in range(batch):
        m[i, rng.permutation(total)[:visible]] = 0
    bounds = np.cumsum((0,) + counts)
    return {f"t{j}": m[:, bounds[j]:bounds[j + 1]] for j in range(len(counts))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masks_to_indices_exact(seed):
    masks = _fixed_masks(seed)
    jk, jr = jmasking.masks_to_indices({k: jnp.asarray(v) for k, v in masks.items()}, 24)
    tk, tr = tmasking.masks_to_indices({k: torch.from_numpy(v) for k, v in masks.items()}, 24)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_make_mask_matches_jax():
    xy = {"rgb": [(0, 0), (3, 1), (2, 2)], "depth": [], "semseg": [(1, 3)]}
    for kwargs in ({}, {"full_tasks": ("depth",)}, {"indicate_visible": False},
                   {"flatten": False}):
        ref = jmasking.make_mask(4, 4, xy, **kwargs)
        out = tmasking.make_mask(4, 4, xy, **kwargs)
        for k in xy:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("alphas,uniform", [(1.0, False), ((0.5, 1.0, 2.0), False),
                                            (1.0, True)])
def test_generate_random_masks_invariants(alphas, uniform):
    g = torch.Generator().manual_seed(0)
    counts, k, b = (196, 196, 196), 98, 64
    masks, ids_keep, ids_restore = tmasking.generate_random_masks(
        g, b, counts, k, alphas=alphas, sample_tasks_uniformly=uniform)
    mask_all = torch.cat(masks, dim=1)
    assert [m.shape for m in masks] == [(b, n) for n in counts]
    assert (mask_all == 0).sum(dim=1).eq(k).all()
    # ids_restore is a permutation; its inverse starts with ids_keep
    ids_shuffle = torch.argsort(ids_restore, dim=1)
    assert torch.equal(torch.sort(ids_restore, dim=1).values,
                       torch.arange(sum(counts)).expand(b, -1))
    assert torch.equal(ids_shuffle[:, :k], ids_keep)
    assert torch.equal(torch.gather(ids_restore, 1, ids_shuffle),
                       torch.arange(sum(counts)).expand(b, -1))
    # the masks agree with ids_keep
    visible = torch.zeros_like(mask_all).scatter_(1, ids_keep, 1)
    assert torch.equal(visible, 1 - mask_all)


@pytest.mark.parametrize("alphas", [(1.0, 1.0, 1.0), (0.5, 1.0, 2.0), (3.0, 0.2, 1.0)])
def test_dirichlet_mean(alphas):
    g = torch.Generator().manual_seed(0)
    props = tmasking.dirichlet_task_proportions(g, 4000, 3, alphas)
    a = np.asarray(alphas)
    assert torch.allclose(props.sum(dim=1), torch.ones(4000))
    assert (props >= 0).all()
    # std of each mean over 4000 draws is below 0.008 for these alphas
    np.testing.assert_allclose(props.mean(dim=0).numpy(), a / a.sum(), atol=0.025)


@pytest.mark.parametrize("alpha", [1e-5, 0.3, 1.0, 2.5])
def test_gamma_mean(alpha):
    g = torch.Generator().manual_seed(1)
    draws = tmasking._gamma(g, torch.full((4000,), alpha))
    assert (draws >= 0).all() and torch.isfinite(draws).all()
    # Gamma(alpha, 1) has mean alpha and std sqrt(alpha)
    assert abs(float(draws.mean()) - alpha) <= 4 * (alpha / 4000) ** 0.5 + 1e-6


def test_sample_alphas_excludes_tasks_with_eps():
    g = torch.Generator().manual_seed(0)
    a = tmasking.sample_alphas(g, 256, 3, alphas=2.0)
    included = a > 1
    torch.testing.assert_close(a[included], torch.full_like(a[included], 2.00001))
    torch.testing.assert_close(a[~included], torch.full_like(a[~included], 1e-5))
    assert (included.sum(dim=1) >= 1).all()


def _loss_inputs(seed, b=3, h=32, c=3, empty_sample=True):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal((b, h, h, c)).astype(np.float32)
    tgt = rng.standard_normal((b, h, h, c)).astype(np.float32)
    mask = rng.integers(0, 2, (b, (h // 16) ** 2)).astype(np.int32)
    if empty_sample:
        mask[0] = 0
    return pred, tgt, mask


@pytest.mark.parametrize("name,kwargs", [("MaskedMSELoss", {}),
                                         ("MaskedMSELoss", {"norm_pix": True}),
                                         ("MaskedL1Loss", {})])
@pytest.mark.parametrize("with_mask", [True, False])
def test_pixel_losses_match_jax(name, kwargs, with_mask):
    pred, tgt, mask = _loss_inputs(0)
    jl = getattr(jcrit, name)(patch_size=16, stride=1, **kwargs)
    tl = getattr(tcrit, name)(patch_size=16, stride=1, **kwargs)
    ref = float(jl(jnp.asarray(pred), jnp.asarray(tgt),
                   mask=jnp.asarray(mask) if with_mask else None))
    out = float(tl(torch.from_numpy(pred), torch.from_numpy(tgt),
                   mask=torch.from_numpy(mask) if with_mask else None))
    assert abs(out - ref) <= 1e-5 * abs(ref), (out, ref)


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(smoothing):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((3, 16, 16, 133)).astype(np.float32) * 3
    tgt = rng.integers(0, 133, (3, 16, 16))
    mask = rng.integers(0, 2, (3, 16)).astype(np.int32)
    jl = jcrit.MaskedCrossEntropyLoss(patch_size=16, stride=4, label_smoothing=smoothing)
    tl = tcrit.MaskedCrossEntropyLoss(patch_size=16, stride=4, label_smoothing=smoothing)
    ref = float(jl(jnp.asarray(logits), jnp.asarray(tgt), mask=jnp.asarray(mask)))
    out = float(tl(torch.from_numpy(logits), torch.from_numpy(tgt),
                   mask=torch.from_numpy(mask)))
    assert abs(out - ref) <= 1e-5 * abs(ref), (out, ref)


def test_all_empty_masks_give_zero_loss():
    pred, tgt, mask = _loss_inputs(2)
    mask[:] = 0
    out = tcrit.MaskedMSELoss()(torch.from_numpy(pred), torch.from_numpy(tgt),
                                mask=torch.from_numpy(mask))
    assert float(out) == 0.0
