"""The CUDA kernels (K4, K1 forward and backward, K2 forward and backward,
K3a and K3b forward and backward) against their plain twins, the CLIs'
first steps on the card (pretraining, semseg, cls, Taskonomy against the
plain twins; depth against the CPU), and the wrappers' dispatch. Imports neither jax nor multimae_tpu,
so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Without a card the kernel tests (marker `cuda`) skip and the dispatch
tests run. Kernel vs twin tolerance: ops/functional.TWIN_TOLERANCE, and
GRAD_TOLERANCE for the backward's gradients.
"""

import contextlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from multimae_tpu_torch.cli import factory
from multimae_tpu_torch.ops import (
    attention,
    functional,
    fused_block,
    fused_decoder,
    fused_mlp,
    short_attention,
)
from multimae_tpu_torch.ops.functional import assert_matches_twin


def _rnd(rng, *shape, scale, offset=0.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale + offset)
                            .astype(np.float32))


def block_weights(d, hidden, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    w = fused_block.BlockWeights(
        _rnd(rng, d, scale=0.1, offset=1.0), _rnd(rng, d, scale=0.1),
        _rnd(rng, 3 * d, d, scale=d ** -0.5), _rnd(rng, 3 * d, scale=0.02),
        _rnd(rng, d, d, scale=d ** -0.5), _rnd(rng, d, scale=0.02),
        _rnd(rng, d, scale=0.1, offset=1.0), _rnd(rng, d, scale=0.1),
        _rnd(rng, hidden, d, scale=d ** -0.5), _rnd(rng, hidden, scale=0.02),
        _rnd(rng, d, hidden, scale=hidden ** -0.5), _rnd(rng, d, scale=0.02))
    return fused_block.BlockWeights(*[t.to(device) for t in w])


def decoder_weights(d, depth, seed=0, device="cpu"):
    blocks = [block_weights(d, 4 * d, seed + i, device) for i in range(depth + 1)]
    x = blocks[0]
    return fused_decoder.DecoderCoreWeights(
        x.n1_g, x.n1_b, x.n2_g, x.n2_b, x.n1_g.flip(0), x.n1_b.flip(0),
        x.wp, x.bp, x.wqkv[:2 * d], x.bqkv[:2 * d], x.wqkv[2 * d:], x.bqkv[2 * d:],
        x.w1, x.b1, x.w2, x.b2,
        *[torch.stack([bw[i] for bw in blocks[1:]]) for i in range(12)])


def randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


# ------------------------------------------------------------- dispatch --


def test_cpu_block_takes_the_twin_without_a_launch():
    w = block_weights(128, 512)
    x = randn(1, 2, 13, 128).to(torch.bfloat16)
    before = fused_block.LAUNCHES
    out = fused_block.fused_block_infer(x, w, 4)
    assert fused_block.LAUNCHES == before
    torch.testing.assert_close(out, fused_block.block_infer_ref(x, w, 4), rtol=0, atol=0)


def test_cpu_decoder_takes_the_twin_without_a_launch():
    w = decoder_weights(64, 2)
    q, c = randn(1, 2, 16, 64), randn(2, 2, 9, 64)
    before = fused_decoder.LAUNCHES
    out = fused_decoder.fused_decoder_core(q, c, w, 4, 2)
    assert fused_decoder.LAUNCHES == before
    torch.testing.assert_close(out, fused_decoder.decoder_core_ref(q, c, w, 4, 2),
                               rtol=0, atol=0)


def test_non_cuda_device_raises_instead_of_falling_back():
    x = torch.empty((2, 13, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_block.fused_block_infer(x, block_weights(128, 512, device="meta"), 4)
    q = torch.empty((2, 16, 128), device="meta")
    c = torch.empty((2, 9, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_decoder.fused_decoder_core(q, c, decoder_weights(128, 2, device="meta"), 4, 2)


def test_decoder_backward_on_non_cuda_device_raises():
    q = torch.empty((2, 16, 128), device="meta")
    c = torch.empty((2, 9, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_decoder.fused_decoder_core_bwd(q, c, decoder_weights(128, 2, device="meta"),
                                             torch.empty_like(q), 4, 2)


@pytest.mark.parametrize("d,heads,hidden,nk", [(100, 4, 400, 16),     # d % 32
                                               (768, 48, 3072, 99),   # dh 16
                                               (768, 12, 3070, 99),   # hidden
                                               (2048, 16, 8192, 99),  # LN row
                                               (768, 6, 3072, 4096)])  # smem
def test_kernel_shape_checks_raise(d, heads, hidden, nk):
    with pytest.raises(ValueError):
        fused_block.check_kernel_shapes(d, heads, hidden, nk)


def test_serving_shapes_pass_the_checks():
    fused_block.check_kernel_shapes(768, 12, 3072, 99)   # encoder, ViT-B
    fused_block.check_kernel_shapes(256, 8, 1024, 196)   # decoders


def test_bf16_block_takes_any_key_count():
    """K4 in bf16 runs its attention as the key-tiled K2 forward where K/V
    do not fit in shared memory; fp32 still has no such path."""
    fused_block.check_kernel_shapes(768, 12, 3072, 2049, torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        fused_block.check_kernel_shapes(768, 12, 3072, 2049, torch.float32)


def qkv_views(seed, b, n, h, dh, device="cpu", dtype=torch.bfloat16):
    """q, k, v as the (B, N, H, dh) slices of one fused (B, N, 3, H, dh)
    projection output, the layout the model hands to K2."""
    qkv = randn(seed, b, n, 3, h, dh).to(device, dtype)
    return qkv.unbind(2)


def test_cpu_short_attention_takes_the_twins_without_a_launch():
    q, k, v = (t.float().requires_grad_() for t in qkv_views(1, 2, 19, 2, 32))
    fwd, bwd = short_attention.LAUNCHES, short_attention.LAUNCHES_BWD
    out = short_attention.short_attention(q, k, v, 32 ** -0.5)
    out.backward(randn(2, 2, 19, 2, 32))
    assert (short_attention.LAUNCHES, short_attention.LAUNCHES_BWD) == (fwd, bwd)
    ref, _ = short_attention.short_attention_ref(q, k, v, 32 ** -0.5)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert q.grad is not None and k.grad is not None and v.grad is not None


def mlp_weights(k, h, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    w = fused_mlp.MlpWeights(
        _rnd(rng, k, scale=0.1, offset=1.0), _rnd(rng, k, scale=0.1),
        _rnd(rng, h, k, scale=k ** -0.5), _rnd(rng, h, scale=0.02),
        _rnd(rng, k, h, scale=h ** -0.5), _rnd(rng, k, scale=0.02))
    return fused_mlp.MlpWeights(*[t.to(device) for t in w])


def test_cpu_fused_mlp_takes_the_twins_without_a_launch():
    x, res = randn(1, 40, 64).requires_grad_(), randn(2, 40, 64).requires_grad_()
    w = fused_mlp.MlpWeights(*[t.requires_grad_() for t in mlp_weights(64, 256)])
    fwd, bwd = fused_mlp.LAUNCHES, fused_mlp.LAUNCHES_BWD
    out = fused_mlp.fused_ln_mlp_res(x, res, w)
    out.backward(randn(3, 40, 64))
    assert (fused_mlp.LAUNCHES, fused_mlp.LAUNCHES_BWD) == (fwd, bwd)
    torch.testing.assert_close(out, fused_mlp.fused_ln_mlp_res_ref(x, res, w), rtol=0, atol=0)
    assert torch.equal(res.grad, randn(3, 40, 64))


def test_new_kernels_on_non_cuda_device_raise():
    q, k, v = (torch.empty((2, 600, 2, 64), dtype=torch.bfloat16, device="meta")
               for _ in range(3))
    with pytest.raises(ValueError, match="no kernel"):
        short_attention.short_attention(q, k, v, 64 ** -0.5)
    x = torch.empty((16384, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp.fused_ln_mlp_res(x, x, mlp_weights(128, 512, device="meta"))


def mlp_core_weights(k, h, seed=0, device="cpu"):
    return fused_mlp.MlpCoreWeights(*mlp_weights(k, h, seed, device)[2:])


def test_fused_mlp_on_non_cuda_device_raises():
    x = torch.empty((16384, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp.fused_mlp(x, mlp_core_weights(128, 512, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp.fused_mlp_bwd(x, x, mlp_core_weights(128, 512, device="meta"))


ENTRY_POINTS = {
    "build_pretrain_model": lambda dev: factory.build_pretrain_model(
        model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
        decoder_num_heads=4, device=dev),
    "make_synthetic_batch": lambda dev: factory.make_synthetic_batch(2, input_size=64,
                                                                     device=dev),
    "build_pretrain_trainer": lambda dev: factory.build_pretrain_trainer(batch_size=2,
                                                                         device=dev),
    "build_semseg_trainer": lambda dev: factory.build_semseg_trainer(
        batch_size=2, model="multivit_tiny", input_size=64, decoder_dim=256,
        decoder_depth=1, device=dev),
    "make_synthetic_semseg_batch": lambda dev: factory.make_synthetic_semseg_batch(
        2, input_size=64, device=dev),
    "build_cls_trainer": lambda dev: factory.build_cls_trainer(
        batch_size=2, model="multivit_tiny", input_size=32, nb_classes=10, device=dev),
    "make_synthetic_cls_batch": lambda dev: factory.make_synthetic_cls_batch(
        2, input_size=32, nb_classes=10, device=dev),
    "build_depth_trainer": lambda dev: factory.build_depth_trainer(
        batch_size=2, model="multivit_tiny", input_size=32, device=dev),
    "build_taskonomy_trainer": lambda dev: factory.build_taskonomy_trainer(
        batch_size=2, model="multivit_tiny", input_size=32, device=dev),
    "make_synthetic_regression_batch": lambda dev: factory.make_synthetic_regression_batch(
        2, input_size=32, device=dev),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card_and_raise_without_one(name, monkeypatch):
    """The factory builds on the CUDA card unless the caller names another
    device, and refuses, instead of carrying on on the CPU, where torch
    sees no card."""
    assert inspect.signature(getattr(factory, name)).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        ENTRY_POINTS[name]("cuda")


# ------------------------------------------------------------- the card --


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,heads", [(2, 13, 128, 4), (3, 99, 768, 12),
                                         (2, 197, 256, 8), (3, 99, 256, 2)])
def test_block_kernel_matches_twin(cuda, b, n, d, heads):
    w = block_weights(d, 4 * d, device=cuda)
    x = randn(1, b, n, d).to(cuda, torch.bfloat16)
    before = fused_block.LAUNCHES
    with torch.inference_mode():
        out = fused_block.fused_block_infer(x, w, heads)
        torch.cuda.synchronize()
        assert fused_block.LAUNCHES == before + 1
        assert_matches_twin(out, fused_block.block_infer_ref(x, w, heads), "K4")


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 128])
def test_block_kernel_matches_twin_at_the_cls_eval_shape(cuda, b):
    """K4 at the classification eval's (B, 197, 768), 12 heads: within
    TWIN_TOLERANCE of its twin, bit-equal over two runs."""
    w = block_weights(768, 3072, device=cuda)
    x = randn(2, b, 197, 768).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        out = fused_block.fused_block_infer(x, w, 12)
        again = fused_block.fused_block_infer(x, w, 12)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert_matches_twin(out, fused_block.block_infer_ref(x, w, 12), f"K4 ({b},197,768)")


@pytest.mark.cuda
def test_block_kernel_refuses_fp32(cuda):
    w = block_weights(128, 512, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fused_block.fused_block_infer(randn(1, 2, 13, 128).to(cuda), w, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nc,d,heads", [(2, 16, 9, 128, 4),
                                             (3, 196, 99, 256, 8)])
def test_decoder_kernel_matches_twin(cuda, dtype, b, nq, nc, d, heads):
    w = decoder_weights(d, 2, device=cuda)
    q = randn(1, b, nq, d).to(cuda, dtype)
    c = randn(2, b, nc, d).to(cuda, dtype)
    before = fused_decoder.LAUNCHES
    with torch.inference_mode():
        out = fused_decoder.fused_decoder_core(q, c, w, heads, 2)
        torch.cuda.synchronize()
        assert fused_decoder.LAUNCHES == before + 1
        assert_matches_twin(out, fused_decoder.decoder_core_ref(q, c, w, heads, 2),
                            f"K1 {dtype}")


def decoder_bwd_inputs(cuda, dtype, b, nq, nc, d):
    return (randn(1, b, nq, d).to(cuda, dtype), randn(2, b, nc, d).to(cuda, dtype),
            randn(3, b, nq, d).to(cuda, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,nq,nc,d,heads", [(2, 16, 9, 128, 4),
                                             (3, 196, 99, 256, 8)])
def test_decoder_backward_kernel_matches_twin(cuda, dtype, b, nq, nc, d, heads):
    w = decoder_weights(d, 2, device=cuda)
    q, c, g = decoder_bwd_inputs(cuda, dtype, b, nq, nc, d)
    before = fused_decoder.LAUNCHES_BWD
    dq, dc, dw = fused_decoder.fused_decoder_core_bwd(q, c, w, g, heads, 2)
    torch.cuda.synchronize()
    assert fused_decoder.LAUNCHES_BWD == before + 1
    rq, rc, rw = fused_decoder.decoder_core_bwd_ref(q, c, w, g, heads, 2)
    assert_matches_twin(dq, rq, f"K1 bwd {dtype} dq", grad_of=dtype)
    assert_matches_twin(dc, rc, f"K1 bwd {dtype} dc", grad_of=dtype)
    for name, a, r in zip(fused_decoder.DecoderCoreWeights._fields, dw, rw):
        assert a.dtype == torch.float32
        assert_matches_twin(a, r, f"K1 bwd {dtype} d{name}", grad_of=dtype)


@pytest.mark.cuda
def test_fp32_decoder_backward_where_context_tokens_share_their_value(cuda):
    """The inputs of the pretraining step's fp32 (semseg) decoder at batch
    32, made: a context whose tokens share a vector 10x their spread, so
    the attention is near uniform and dP - rowsum(dP * P) cancels. K1's
    fp32 backward takes the keys' mean out of V before dP, as its twin
    does: each output within GRAD_TOLERANCE of the twin, and dq within
    1e-5 of float64 autograd (4.7e-5 without the centring)."""
    rng = np.random.default_rng(7)
    b, nq, nc, d = 32, 196, 99, 256
    base = rng.standard_normal((1, 1, d))
    q, c, g = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (
        rng.standard_normal((b, nq, d)), 10 * base + rng.standard_normal((b, nc, d)),
        rng.standard_normal((b, nq, d))))
    w = decoder_weights(d, 2, device=cuda)
    dq, dc, dw = fused_decoder.fused_decoder_core_bwd(q, c, w, g, 8, 2)
    rq, rc, rw = fused_decoder.decoder_core_bwd_ref(q, c, w, g, 8, 2)
    names = ["dq", "dc"] + [f"d{n}" for n in fused_decoder.DecoderCoreWeights._fields]
    for name, a, r in zip(names, [dq, dc, *dw], [rq, rc, *rw]):
        assert_matches_twin(a, r, f"K1 bwd fp32 {name}", grad_of=torch.float32)
    exact = fused_decoder.decoder_core_f64(q, c, w, g, 8, 2)[1]
    err = float(((dq.double() - exact) ** 2).mean().sqrt() / (exact ** 2).mean().sqrt())
    assert err <= 1e-5, err

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decoder_backward_kernel_is_bit_deterministic(cuda, dtype):
    w = decoder_weights(256, 2, device=cuda)
    q, c, g = decoder_bwd_inputs(cuda, dtype, 3, 196, 99, 256)
    first = fused_decoder.fused_decoder_core_bwd(q, c, w, g, 8, 2)
    second = fused_decoder.fused_decoder_core_bwd(q, c, w, g, 8, 2)
    torch.cuda.synchronize()
    for a, b in zip([first[0], first[1], *first[2]], [second[0], second[1], *second[2]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_decoder_backward_launches_once_per_call(cuda):
    w = fused_decoder.DecoderCoreWeights(*[t.requires_grad_() for t in
                                           decoder_weights(128, 2, device=cuda)])
    q, c, g = decoder_bwd_inputs(cuda, torch.bfloat16, 2, 16, 9, 128)
    q.requires_grad_()
    c.requires_grad_()
    fwd, bwd = fused_decoder.LAUNCHES, fused_decoder.LAUNCHES_BWD
    for _ in range(2):
        fused_decoder.fused_decoder_core(q, c, w, 4, 2).backward(g)
    torch.cuda.synchronize()
    assert (fused_decoder.LAUNCHES - fwd, fused_decoder.LAUNCHES_BWD - bwd) == (2, 2)
    assert q.grad.dtype == torch.bfloat16 and w.wqkv.grad.dtype == torch.float32
    assert torch.isfinite(q.grad).all() and torch.isfinite(w.wqkv.grad).all()


@pytest.mark.cuda
def test_decoder_backward_refuses_unsupported_head_width(cuda):
    w = decoder_weights(256, 2, device=cuda)
    q, c, g = decoder_bwd_inputs(cuda, torch.bfloat16, 2, 16, 9, 256)
    with pytest.raises(ValueError, match="head width"):
        fused_decoder.fused_decoder_core_bwd(q, c, w, g, 2, 2)  # dh 128


# The ragged shapes the K1 tiles mask: 16-row mma tiles, 64-row blocks and
# 64-key chunks (196 = 3 * 64 + 4 queries, 99 = 64 + 35 keys; 200 and 197
# past the 192-row mark); head widths 32 (8 heads) and 64 (4 heads) at
# d 256.
K1_RAGGED = [(1, 1, 1), (2, 17, 9), (3, 196, 99), (2, 200, 197)]


def decoder_inputs(cuda, dtype, b, nq, nc, d, depth, seed=0):
    w = decoder_weights(d, max(depth, 1), seed=seed, device=cuda)
    w = fused_decoder.DecoderCoreWeights(*w[:16], *[t[:depth] for t in w[16:]])
    return (w, randn(seed + 1, b, nq, d).to(cuda, dtype),
            randn(seed + 2, b, nc, d).to(cuda, dtype), randn(seed + 3, b, nq, d).to(cuda, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("b,nq,nc", K1_RAGGED)
def test_decoder_kernel_matches_twin_at_ragged_shapes(cuda, dtype, heads, depth, b, nq, nc):
    w, q, c, _ = decoder_inputs(cuda, dtype, b, nq, nc, 256, depth)
    with torch.inference_mode():
        out = fused_decoder.fused_decoder_core(q, c, w, heads, depth)
        torch.cuda.synchronize()
        assert_matches_twin(out, fused_decoder.decoder_core_ref(q, c, w, heads, depth),
                            f"K1 {dtype} ({b},{nq},{nc}) heads {heads} depth {depth}")


def _bwd_refused(dtype, heads, nq, nc):
    """The backward's shared-memory gate: fp32 K and V rows of width 64
    fit up to 166 keys."""
    return dtype == torch.float32 and heads == 4 and max(nq, nc) > 166


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads", [8, 4])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("b,nq,nc", K1_RAGGED)
def test_decoder_backward_matches_twin_at_ragged_shapes(cuda, dtype, heads, depth, b, nq, nc):
    w, q, c, g = decoder_inputs(cuda, dtype, b, nq, nc, 256, depth)
    if _bwd_refused(dtype, heads, nq, nc):
        with pytest.raises(ValueError, match="exceed shared memory"):
            fused_decoder.fused_decoder_core_bwd(q, c, w, g, heads, depth)
        return
    dq, dc, dw = fused_decoder.fused_decoder_core_bwd(q, c, w, g, heads, depth)
    torch.cuda.synchronize()
    rq, rc, rw = fused_decoder.decoder_core_bwd_ref(q, c, w, g, heads, depth)
    what = f"K1 bwd {dtype} ({b},{nq},{nc}) heads {heads} depth {depth}"
    assert_matches_twin(dq, rq, f"{what} dq", grad_of=dtype)
    assert_matches_twin(dc, rc, f"{what} dc", grad_of=dtype)
    for name, a, r in zip(fused_decoder.DecoderCoreWeights._fields, dw, rw):
        assert_matches_twin(a, r, f"{what} d{name}", grad_of=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decoder_kernel_is_bit_deterministic(cuda, dtype):
    w, q, c, _ = decoder_inputs(cuda, dtype, 3, 196, 99, 256, 2)
    with torch.inference_mode():
        first = fused_decoder.fused_decoder_core(q, c, w, 8, 2)
        second = fused_decoder.fused_decoder_core(q, c, w, 8, 2)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decoder_kernels_match_twins_at_the_pretraining_batch(cuda, dtype):
    """Forward and backward at the pretraining step's shape (B=128)."""
    w, q, c, g = decoder_inputs(cuda, dtype, 128, 196, 99, 256, 2)
    with torch.inference_mode():
        out = fused_decoder.fused_decoder_core(q, c, w, 8, 2)
        torch.cuda.synchronize()
        assert_matches_twin(out, fused_decoder.decoder_core_ref(q, c, w, 8, 2),
                            f"K1 {dtype} B=128")
    dq, dc, dw = fused_decoder.fused_decoder_core_bwd(q, c, w, g, 8, 2)
    torch.cuda.synchronize()
    rq, rc, rw = fused_decoder.decoder_core_bwd_ref(q, c, w, g, 8, 2)
    for name, a, r in zip(["dq", "dc"] + ["d" + f for f in fused_decoder.DecoderCoreWeights._fields],
                          [dq, dc, *dw], [rq, rc, *rw]):
        assert_matches_twin(a, r, f"K1 bwd {dtype} B=128 {name}", grad_of=dtype)


# ------------------------------------------------------------ K2 on the card --


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nk,h,dh", [(2, 40, 40, 2, 32), (3, 130, 130, 4, 64),
                                          (1, 577, 577, 2, 128), (2, 2049, 2049, 3, 64),
                                          (2, 100, 700, 2, 64), (2, 1, 2049, 3, 64),
                                          (2, 2049, 1, 3, 64), (1, 2049, 2049, 2, 32),
                                          (1, 2049, 2049, 2, 128)])
def test_short_attention_kernels_match_twins(cuda, b, nq, nk, h, dh):
    scale = dh ** -0.5
    q = qkv_views(1, b, nq, h, dh, cuda)[0]
    _, k, v = qkv_views(2, b, nk, h, dh, cuda)
    before = short_attention.LAUNCHES
    o, lse = short_attention.short_attention_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert short_attention.LAUNCHES == before + 1
    ro, rlse = short_attention.short_attention_ref(q, k, v, scale)
    assert_matches_twin(o, ro, "K2 fwd o")
    assert_matches_twin(lse, rlse, "K2 fwd lse")
    g = randn(3, b, nq, h, dh).to(cuda, torch.bfloat16)
    before = short_attention.LAUNCHES_BWD
    out = short_attention.short_attention_bwd(q, k, v, o, lse, g, scale)
    again = short_attention.short_attention_bwd(q, k, v, o, lse, g, scale)
    torch.cuda.synchronize()
    assert short_attention.LAUNCHES_BWD == before + 2
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    delta = short_attention.attention_delta(o, g)
    ref = short_attention.short_attention_bwd_ref(q, k, v, g, lse, delta, scale)
    for name, a, r in zip(("dq", "dk", "dv"), out, ref):
        if nk == 1 and name != "dv":
            # One key: p = 1 whatever s is, so dp - delta, and with it dq
            # and dk, vanish; both sides hold fp32 rounding noise of their
            # own summation orders, far below a bf16 ulp of do . v.
            assert torch.isfinite(a).all()
            assert float(a.float().abs().max()) <= 1e-3 and float(r.float().abs().max()) <= 1e-3
            continue
        assert_matches_twin(a, r, f"K2 bwd {name}", grad_of=torch.bfloat16)


@pytest.mark.cuda
def test_short_attention_autograd_launches_both_kernels(cuda):
    qkv = randn(1, 2, 600, 3, 2, 64).to(cuda, torch.bfloat16).requires_grad_()
    q, k, v = qkv.unbind(2)
    fwd, bwd = short_attention.LAUNCHES, short_attention.LAUNCHES_BWD
    short_attention.short_attention(q, k, v, 64 ** -0.5).float().sum().backward()
    torch.cuda.synchronize()
    assert (short_attention.LAUNCHES - fwd, short_attention.LAUNCHES_BWD - bwd) == (1, 1)
    assert qkv.grad.dtype == torch.bfloat16 and torch.isfinite(qkv.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("nk,launches", [(511, 0), (512, 1)])
def test_attention_gate_launches_k2_from_512_keys(cuda, nk, launches):
    q = randn(1, 2, 64, 2, 64).to(cuda, torch.bfloat16)
    k, v = (randn(s, 2, nk, 2, 64).to(cuda, torch.bfloat16) for s in (2, 3))
    before = short_attention.LAUNCHES
    out = attention.fused_attention_bnhd(q, k, v, 64 ** -0.5)
    torch.cuda.synchronize()
    assert short_attention.LAUNCHES - before == launches
    assert_matches_twin(out, attention.einsum_attention_bnhd(q, k, v, 64 ** -0.5), "gate")


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("nq,nk", [(128, 512), (130, 577), (2049, 2049)])
def test_flash_regime_goes_to_one_k2_launch(cuda, nq, nk, dh):
    """Every shape the JAX flash wrapper takes (bf16, dh 32-128, Nk >= 512,
    Nq >= 128; multimae_tpu/ops/attention.py:176, :297-302) is served by
    exactly one K2 forward launch through the attention dispatch."""
    q = randn(1, 2, nq, 2, dh).to(cuda, torch.bfloat16)
    k, v = (randn(s, 2, nk, 2, dh).to(cuda, torch.bfloat16) for s in (2, 3))
    before = (short_attention.LAUNCHES, short_attention.LAUNCHES_BWD)
    out = attention.fused_attention_bnhd(q, k, v, dh ** -0.5)
    torch.cuda.synchronize()
    assert (short_attention.LAUNCHES - before[0], short_attention.LAUNCHES_BWD - before[1]) \
        == (1, 0)
    assert_matches_twin(out, attention.einsum_attention_bnhd(q, k, v, dh ** -0.5), "flash")


@pytest.mark.cuda
def test_short_attention_refuses_fp32(cuda):
    q, k, v = qkv_views(1, 2, 600, 2, 64, cuda, torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        short_attention.short_attention(q, k, v, 64 ** -0.5)


# ----------------------------------------------------------- K3b on the card --


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,h", [(20000, 128, 512), (65536, 384, 1536), (20000, 384, 1536)])
def test_fused_mlp_kernels_match_twins(cuda, m, k, h):
    w = mlp_weights(k, h, device=cuda)
    x = randn(1, m, k).to(cuda, torch.bfloat16)
    res = randn(2, m, k).to(cuda, torch.bfloat16)
    before = fused_mlp.LAUNCHES
    with torch.inference_mode():
        out = fused_mlp.fused_ln_mlp_res(x, res, w)
        torch.cuda.synchronize()
    assert fused_mlp.LAUNCHES == before + 1
    assert_matches_twin(out, fused_mlp.fused_ln_mlp_res_ref(x, res, w), "K3b fwd")
    dy = randn(3, m, k).to(cuda, torch.bfloat16)
    before = fused_mlp.LAUNCHES_BWD
    dx, dw = fused_mlp.fused_ln_mlp_res_bwd(x, dy, w)
    dx2, dw2 = fused_mlp.fused_ln_mlp_res_bwd(x, dy, w)
    torch.cuda.synchronize()
    assert fused_mlp.LAUNCHES_BWD == before + 2
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dw, dw2))
    rdx, rdw = fused_mlp.fused_ln_mlp_res_bwd_ref(x, dy, w)
    assert_matches_twin(dx, rdx, "K3b bwd dx", grad_of=torch.bfloat16)
    for name, a, r in zip(fused_mlp.MlpWeights._fields, dw, rdw):
        assert a.dtype == torch.float32
        assert_matches_twin(a, r, f"K3b bwd d{name}", grad_of=torch.bfloat16)


# ----------------------------------------------------------- K3a on the card --


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,h", [(20000, 128, 512), (65536, 384, 1536), (20000, 384, 1536)])
def test_fused_mlp_core_kernels_match_twins(cuda, m, k, h):
    w = mlp_core_weights(k, h, device=cuda)
    x = randn(1, m, k).to(cuda, torch.bfloat16)
    before = fused_mlp.LAUNCHES_MLP
    with torch.inference_mode():
        out = fused_mlp.fused_mlp(x, w)
        torch.cuda.synchronize()
    assert fused_mlp.LAUNCHES_MLP == before + 1
    assert_matches_twin(out, fused_mlp.fused_mlp_ref(x, w), "K3a fwd")
    dy = randn(3, m, k).to(cuda, torch.bfloat16)
    before = fused_mlp.LAUNCHES_MLP_BWD
    dx, dw = fused_mlp.fused_mlp_bwd(x, dy, w)
    dx2, dw2 = fused_mlp.fused_mlp_bwd(x, dy, w)
    torch.cuda.synchronize()
    assert fused_mlp.LAUNCHES_MLP_BWD == before + 2
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dw, dw2))
    rdx, rdw = fused_mlp.fused_mlp_bwd_ref(x, dy, w)
    assert_matches_twin(dx, rdx, "K3a bwd dx", grad_of=torch.bfloat16)
    for name, a, r in zip(fused_mlp.MlpCoreWeights._fields, dw, rdw):
        assert a.dtype == torch.float32
        assert_matches_twin(a, r, f"K3a bwd d{name}", grad_of=torch.bfloat16)


@pytest.mark.cuda
def test_fused_mlp_core_autograd_launches_both_kernels(cuda):
    w = fused_mlp.MlpCoreWeights(*[t.requires_grad_() for t in
                                   mlp_core_weights(128, 512, device=cuda)])
    x = randn(1, 16384, 128).to(cuda, torch.bfloat16).requires_grad_()
    counts = (fused_mlp.LAUNCHES_MLP, fused_mlp.LAUNCHES_MLP_BWD,
              fused_mlp.LAUNCHES, fused_mlp.LAUNCHES_BWD)
    fused_mlp.fused_mlp(x, w).float().sum().backward()
    torch.cuda.synchronize()
    assert (fused_mlp.LAUNCHES_MLP - counts[0], fused_mlp.LAUNCHES_MLP_BWD - counts[1],
            fused_mlp.LAUNCHES - counts[2], fused_mlp.LAUNCHES_BWD - counts[3]) == (1, 1, 0, 0)
    assert x.grad.dtype == torch.bfloat16 and w.w1.grad.dtype == torch.float32


# --------------------------------------------------- K4 at long sequences --


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [12, 8])  # head widths 64 and 96
def test_block_kernel_matches_twin_at_2049_tokens(cuda, heads):
    """K4 at the 512-px fine-tune's eval shape: its attention step runs
    the K2 forward kernel without an lse, as K/V of 2049 keys do not fit in
    shared memory."""
    w = block_weights(768, 3072, device=cuda)
    x = randn(1, 4, 2049, 768).to(cuda, torch.bfloat16)
    before = fused_block.LAUNCHES
    with torch.inference_mode():
        out = fused_block.fused_block_infer(x, w, heads)
        torch.cuda.synchronize()
        assert fused_block.LAUNCHES == before + 1
        assert_matches_twin(out, fused_block.block_infer_ref(x, w, heads),
                            f"K4 at 2049 tokens, {heads} heads")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(256, 197), (16, 2049)])
def test_block_kernel_matches_twin_at_vit_l_width(cuda, b, n):
    """K4 at ViT-L's width (D 1024, 16 heads, hidden 4096: a LayerNorm row
    at the chain's limit, 16 and 64 wgmma k-steps) at bench_infer's cls
    and semseg shapes: within TWIN_TOLERANCE, bit-equal over two runs."""
    w = block_weights(1024, 4096, device=cuda)
    x = randn(4, b, n, 1024).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        out = fused_block.fused_block_infer(x, w, 16)
        again = fused_block.fused_block_infer(x, w, 16)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert_matches_twin(out, fused_block.block_infer_ref(x, w, 16), f"K4 ({b},{n},1024)")


@pytest.mark.cuda
def test_short_attention_matches_twins_at_16_heads(cuda):
    """K2 at ViT-L's 16 heads and bench_finetune --large's 512-px shape
    (4, 2049, 16, 64): forward and backward within their tolerances, each
    bit-equal over two runs."""
    b, n, h, dh = 4, 2049, 16, 64
    q, k, v = qkv_views(5, b, n, h, dh, cuda)
    outs = [short_attention.short_attention_fwd(q, k, v, dh ** -0.5) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    (o, lse), (ro, rlse) = outs[0], short_attention.short_attention_ref(q, k, v, dh ** -0.5)
    assert_matches_twin(o, ro, "K2 fwd o, 16 heads")
    assert_matches_twin(lse, rlse, "K2 fwd lse, 16 heads")
    g = randn(6, b, n, h, dh).to(cuda, torch.bfloat16)
    grads = [short_attention.short_attention_bwd(q, k, v, o, lse, g, dh ** -0.5)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*grads))
    ref = short_attention.short_attention_bwd_ref(q, k, v, g, lse,
                                                  short_attention.attention_delta(o, g),
                                                  dh ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv"), grads[0], ref):
        assert_matches_twin(a, r, f"K2 bwd {name}, 16 heads", grad_of=torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [8, 6], ids=["vit_l_tp2", "vit_b_tp2"])
def test_short_attention_at_tensor_parallel_local_heads(cuda, h):
    """K2 at the head counts one rank of a TP 2 group runs at 512 px
    (parallel/tp.py: ViT-L's 16 / 2 and ViT-B's 12 / 2 heads), on the q, k
    and v views of the rank's fused qkv output, forward and backward through
    the autograd Function: one launch each, within their tolerances against
    the twins, each bit-equal over two runs."""
    b, n, dh = 4, 2049, 64
    q, k, v = qkv_views(7, b, n, h, dh, cuda)
    assert q.stride(1) == 3 * h * dh  # the local reshape's strided views
    outs = [short_attention.short_attention_fwd(q, k, v, dh ** -0.5) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    (o, lse), (ro, rlse) = outs[0], short_attention.short_attention_ref(q, k, v, dh ** -0.5)
    assert_matches_twin(o, ro, f"K2 fwd o, {h} heads")
    assert_matches_twin(lse, rlse, f"K2 fwd lse, {h} heads")
    g = randn(8, b, n, h, dh).to(cuda, torch.bfloat16)
    grads = [short_attention.short_attention_bwd(q, k, v, o, lse, g, dh ** -0.5)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*grads))
    ref = short_attention.short_attention_bwd_ref(q, k, v, g, lse,
                                                  short_attention.attention_delta(o, g),
                                                  dh ** -0.5)
    for name, a, r in zip(("dq", "dk", "dv"), grads[0], ref):
        assert_matches_twin(a, r, f"K2 bwd {name}, {h} heads", grad_of=torch.bfloat16)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = short_attention.LAUNCHES, short_attention.LAUNCHES_BWD
    attention.fused_attention_bnhd(*leaves, dh ** -0.5).backward(g)
    torch.cuda.synchronize()
    assert (short_attention.LAUNCHES - fwd, short_attention.LAUNCHES_BWD - bwd) == (1, 1)


@pytest.mark.parametrize("rows,batch,heads,ok", [
    (256 * 197, 256, 16, True),           # bench_infer --large cls
    (32 * 1024 * 16, 1, 1, True),         # K3b at bench_infer's semseg batch
    (2700 * 197, 2700, 16, True),         # 2.18e9 hidden elements: size_t offsets
    (65535 * 128 + 1, 1, 1, False),       # a GEMM grid's rows
    (65536 * 2, 65536, 1, False)])        # an attention grid's samples
def test_index_gate(rows, batch, heads, ok):
    """functional.check_grid: the kernels' launch grids bound a shape."""
    if ok:
        functional.check_grid("k", rows, batch, heads)
    else:
        with pytest.raises(ValueError, match="k: .* exceed"):
            functional.check_grid("k", rows, batch, heads)


def test_gates_refuse_shapes_past_the_index_ranges():
    """A shape a gate takes but whose launch would leave the grids raises
    with the reason rather than taking the module path; one the gate does
    not take is refused quietly whatever its size."""
    assert fused_block.supported(197, 1024, 16, 4096, torch.bfloat16, 2700)
    with pytest.raises(ValueError, match="fused_block_infer: .* rows exceed"):
        fused_block.supported(197, 1024, 16, 4096, torch.bfloat16, 50000)
    assert not fused_block.supported(197, 1024, 16, 4096, torch.float32, 50000)
    assert fused_mlp.supported(2 ** 21, 384, 1536, torch.bfloat16)
    with pytest.raises(ValueError, match="fused_ln_mlp_res: .* rows exceed"):
        fused_mlp.supported(2 ** 23 + 2 ** 20, 384, 1536, torch.bfloat16)
    q = torch.empty((70000, 8, 2, 64), device="meta")
    assert short_attention.supported(q[:4], q[:4])
    with pytest.raises(ValueError, match="short_attention: 70000 samples"):
        short_attention.supported(q, q)
    assert not short_attention.supported(q[..., :48], q[..., :48])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K4", "K3b", "K2"])
def test_kernels_past_2_31_elements(cuda, kernel):
    """Each kernel at a shape the gates take whose largest buffer holds more
    than 2**31 elements: K4 at (2700, 197, 1024) with hidden 4096, K3b at
    2**21 rows of 384 with hidden 1536, K2 forward and backward at (1024,
    2049, 16, 64) over a fused qkv. The first and the last samples (or
    rows), whose offsets pass 2**31, against the twin run on those alone."""
    gen = torch.Generator(device=cuda).manual_seed(31)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=cuda, dtype=torch.bfloat16)

    ends = (slice(0, 2), slice(-2, None))
    if kernel == "K4":
        w = block_weights(1024, 4096, device=cuda)
        x = rnd(2700, 197, 1024)
        assert fused_block.supported(197, 1024, 16, 4096, torch.bfloat16, 2700)
        with torch.inference_mode():
            out = fused_block.fused_block_infer(x, w, 16)
            for e in ends:
                assert_matches_twin(out[e], fused_block.block_infer_ref(x[e], w, 16),
                                    f"K4 (2700,197,1024), samples {e}")
    elif kernel == "K3b":
        m, ends = 2 ** 21, (slice(0, 65536), slice(-65536, None))
        w = mlp_weights(384, 1536, device=cuda)
        x, res = rnd(m, 384), rnd(m, 384)
        assert fused_mlp.supported(m, 384, 1536, torch.bfloat16)
        with torch.inference_mode():
            out = fused_mlp.fused_ln_mlp_res(x, res, w)
            for e in ends:
                assert_matches_twin(out[e], fused_mlp.fused_ln_mlp_res_ref(x[e], res[e], w),
                                    f"K3b ({m},384), rows {e}")
    else:
        b, n, h, dh = 1024, 2049, 16, 64
        q, k, v = rnd(b, n, 3, h, dh).unbind(2)
        assert short_attention.supported(q, k)
        o, lse = short_attention.short_attention_fwd(q, k, v, dh ** -0.5)
        g = rnd(b, n, h, dh)
        grads = short_attention.short_attention_bwd(q, k, v, o, lse, g, dh ** -0.5)
        for e in ends:
            ro, rlse = short_attention.short_attention_ref(q[e], k[e], v[e], dh ** -0.5)
            assert_matches_twin(o[e], ro, f"K2 fwd o, samples {e}")
            assert_matches_twin(lse[e], rlse, f"K2 fwd lse, samples {e}")
            ref = short_attention.short_attention_bwd_ref(
                q[e], k[e], v[e], g[e], lse[e], short_attention.attention_delta(o[e], g[e]),
                dh ** -0.5)
            for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
                assert_matches_twin(a[e], r, f"K2 bwd {name}, samples {e}",
                                    grad_of=torch.bfloat16)


# ------------------------------------------------ the gates on the card --


def _adapter(cuda, dtype, heads, d=256, depth=2, dim_enc=768, seed=0):
    from multimae_tpu_torch.models.output_adapters import SpatialOutputAdapter

    m = SpatialOutputAdapter(num_channels=3, stride_level=1, patch_size_full=16,
                             dim_tokens_enc=dim_enc, dim_tokens=d, depth=depth,
                             image_size=224, num_heads=heads, context_tasks=("rgb",),
                             task="rgb", dtype=dtype)
    rng = np.random.default_rng(seed)
    state = {}
    for k, v in m.state_dict().items():
        scale = 0.02 if v.dim() > 1 else 0.1
        offset = 1.0 if k.endswith(".weight") and "norm" in k.split(".")[-2] else 0.0
        state[k] = _rnd(rng, *v.shape, scale=scale, offset=offset)
    m.load_state_dict(state, strict=True)
    return m.to(cuda)


def _key_part(name, n):
    """The key part of an attention in-projection bias of n elements, or
    None: its exact gradient is 0 (a bias on every key adds the same logit
    to a whole softmax row), so both paths hold rounding noise there."""
    if name.endswith("attn.qkv.bias"):
        return slice(n // 3, 2 * n // 3)
    if name.endswith("decoder.kv.bias"):
        return slice(0, n // 2)
    return None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,heads", [(torch.bfloat16, 2), (torch.float32, 4)])
def test_adapter_takes_its_modules_on_the_card_where_k1_refuses(cuda, dtype, heads,
                                                                monkeypatch):
    """bf16 at head width 128, and fp32 at head width 64 with 196 queries
    (past the backward's 166 keys): the adapter's gate sends the decoder
    body to its submodules, forward and backward, with no K1 launch; the
    output and every gradient match the same adapter driven through K1's
    plain twins (fused_decoder_core in "plain" mode)."""
    from multimae_tpu_torch.models.multimae import generate_input_info
    from multimae_tpu_torch.ops import masking

    b, n, k, d, depth = 2, 196, 98, 256, 2
    m = _adapter(cuda, dtype, heads)
    assert not fused_decoder.supported(n, k + 1, d, heads, depth, dtype, 4 * d)
    rng = np.random.default_rng(1)
    mask = np.ones((b, n), np.int64)
    for i in range(b):
        mask[i, rng.permutation(n)[:k]] = 0
    ids_keep, ids_restore = masking.masks_to_indices(
        {"rgb": torch.from_numpy(mask).to(cuda)}, k)
    info = generate_input_info({"rgb": n}, (224, 224), 1)
    tokens = randn(2, b, k + 1, 768).to(cuda, dtype)
    g = randn(3, b, 224, 224, 3).to(cuda, dtype)

    def run():
        m.zero_grad(set_to_none=True)
        t = tokens.clone().requires_grad_()
        out = m(t, info, ids_keep, ids_restore)
        out.backward(g)
        torch.cuda.synchronize()
        return {"out": out.detach(), "dtokens": t.grad,
                **{name: p.grad for name, p in m.named_parameters()}}

    core = fused_decoder.fused_decoder_core

    def refuse(*args, **kw):
        raise AssertionError("fused_decoder_core called at a shape its gate refuses")

    monkeypatch.setattr(fused_decoder, "fused_decoder_core", refuse)
    launches = (fused_decoder.LAUNCHES, fused_decoder.LAUNCHES_BWD)
    got = run()
    assert (fused_decoder.LAUNCHES, fused_decoder.LAUNCHES_BWD) == launches
    with torch.inference_mode():  # eval: the decoder blocks' K4 gate, then
        before = fused_block.LAUNCHES
        inferred = m.eval()(tokens, info, ids_keep, ids_restore)
        torch.cuda.synchronize()
    # bf16 decoder blocks of width 256 at head width 128 run K4 at eval
    assert fused_block.LAUNCHES - before == (depth if dtype == torch.bfloat16 else 0)
    assert_matches_twin(inferred, got["out"], f"adapter {dtype} eval vs training forward")

    monkeypatch.setattr(fused_decoder, "fused_decoder_core", core)
    monkeypatch.setattr(fused_decoder, "supported", lambda *a, **kw: True)
    fused_decoder.set_force_mode("plain")
    try:
        ref = run()
    finally:
        fused_decoder.set_force_mode(None)
    assert set(got) == set(ref)
    assert_matches_twin(got["out"], ref["out"], f"adapter {dtype} out")
    for name, a in got.items():
        r = ref[name]
        if name == "out" or (a is None and r is None):
            continue
        key = _key_part(name, a.shape[0])
        if key is not None:
            keep = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
            keep[key] = False
            assert torch.isfinite(a).all()
            a, r = a[keep], r[keep]
        assert_matches_twin(a, r, f"adapter {dtype} d{name}", grad_of=dtype)


@pytest.mark.cuda
def test_decoder_gate_copies_the_cuda_shared_memory_figure(cuda):
    """fused_decoder.supported's Python copy of the backward's shared-memory
    figure equals mm_fused_decoder_bwd_workspace's over a grid of shapes."""
    import ctypes

    from multimae_tpu_torch.ops import _build

    lib = _build.load()
    t, f, smem = ctypes.c_longlong(), ctypes.c_longlong(), ctypes.c_longlong()
    for dtype in (torch.bfloat16, torch.float32):
        for heads in (8, 4):  # head widths 32 and 64 at d 256
            for nq in (1, 17, 166, 167, 196, 287, 400, 784):
                for nc in (9, 99, 210, 347):
                    lib.mm_fused_decoder_bwd_workspace(2, nq, nc, 256, heads, 1024, 2,
                                                       int(dtype == torch.float32),
                                                       ctypes.byref(t), ctypes.byref(f),
                                                       ctypes.byref(smem))
                    assert smem.value == fused_decoder.bwd_attention_smem(
                        max(nq, nc), 256 // heads, dtype), (dtype, heads, nq, nc)


@pytest.mark.cuda
@pytest.mark.parametrize("d,heads,launches", [(64, 4, 0), (128, 4, 1)])
def test_block_gate_on_the_card(cuda, d, heads, launches):
    """At eval in bf16 the ViT block launches K4 where its gate admits the
    shape and takes its submodules where it does not (the tiny models'
    head width of 16); both match the plain twin."""
    from multimae_tpu_torch.models.vit import Block

    blk = Block(d, heads, dtype=torch.bfloat16).to(cuda).eval()
    w = block_weights(d, 4 * d, device=cuda)
    with torch.no_grad():
        for p, t in zip(blk.block_weights(), w):
            p.copy_(t)
    x = randn(1, 2, 13, d).to(cuda, torch.bfloat16)
    before = fused_block.LAUNCHES
    with torch.inference_mode():
        out = blk(x)
        torch.cuda.synchronize()
    assert fused_block.LAUNCHES - before == launches
    assert_matches_twin(out, fused_block.block_infer_ref(x, w, heads),
                        f"block d {d} heads {heads}")


@pytest.mark.cuda
def test_fused_mlp_refuses_widths_its_gate_refuses(cuda):
    """K3b takes K and H in whole 64-wide k-steps: K = 96 raises."""
    x = randn(1, 16384, 96).to(cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        fused_mlp.fused_ln_mlp_res(x, x, mlp_weights(96, 384, device=cuda))


@pytest.mark.cuda
def test_cli_first_step_on_the_card_matches_the_plain_twins(cuda, tmp_path):
    """One ViT-B step of the flagship recipe at phase 7's batch of 128 from
    a written tree: K1 fwd and bwd launch 4 times each, and the losses and
    grad norm match the same step on the plain twins within phase 7's
    limit, 2e-5 relative."""
    import chip_smoke
    from multimae_tpu_torch.cli import run_pretraining_multimae as tcli
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    tree = str(tmp_path / "tree")
    write_random_tree(tree, chip_smoke.TRAIN_BATCH, (256, 320))
    cfg = Path(__file__).resolve().parents[1] / "cfgs/pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml"
    args = ["-c", str(cfg),
            "--data_path", tree, "--batch_size", str(chip_smoke.TRAIN_BATCH), "--epochs", "1",
            "--warmup_epochs", "0",
            "--num_workers", "0", "--no_auto_resume"]
    fused_decoder.LAUNCHES = fused_decoder.LAUNCHES_BWD = 0
    kern = tcli.main(tcli.get_args(args))["steps"][0]["metrics"]
    assert (fused_decoder.LAUNCHES, fused_decoder.LAUNCHES_BWD) == (4, 4)
    with chip_smoke.plain_twins():
        plain = tcli.main(tcli.get_args(args))["steps"][0]["metrics"]
    for k, v in plain.items():
        if k != "skipped":
            assert abs(kern[k] - v) <= chip_smoke.STEP_TOLERANCE * abs(v), (k, kern[k], v)


@pytest.mark.cuda
@pytest.mark.parametrize("options", [{"decoder_use_task_queries": False},
                                     {"approx_gelu": True}],
                         ids=["no_task_queries", "approx_gelu"])
def test_decoder_variant_steps_on_the_card_match_the_plain_twins(cuda, options):
    """chip_smoke.py phase 19's ViT-B pretraining steps at batch 128: K1 fwd
    and bwd launch 4 times a step under queries without task queries (the
    mask token, the pos-emb and the task's embedding, the same in every
    sample) and under --approx_gelu (the encoder's tanh GELU around K1's
    erf); the first step's losses, grad norm and decoder gradients within
    phase 7's limits of the plain twins."""
    import chip_smoke

    expect, first = chip_smoke.variant_steps(torch, cuda, "card", str(options), **options)
    assert (expect["fused_decoder_fwd"], expect["fused_decoder_bwd"]) == (4, 4)
    assert np.isfinite(first["loss"])


# The semseg CLI's first loss against the plain twins reads, relative, on
# an H100 at 700 W (this test, pytest -s): with the kernels 2.42e-5,
# 4.23e-6, 2.17e-7 on the trees of seeds 0, 1, 2 and 6.29e-6 on the
# synthetic batch; with K2 alone on its twin at most 1.96e-6; with K3b
# alone on its twin 2.55e-5 at most; and the twins themselves move by
# 1.42e-5 on tree 0 when K2's P stays in fp32. So K2's bf16 roundings of P
# move the loss, and tree 0 is the batch most sensitive to them. The
# limit is about four times the largest reading, as phase 11's are; the
# grad norm and gradients hold phase 11's limits on every batch.
SEMSEG_CLI_LOSS_TOLERANCE = 1e-4

# The first batches the CLI's first step is read on: written NYUv2-shaped
# trees of 4 samples from three seeds, and the CLI's --synthetic_data batch.
SEMSEG_CLI_DATA = ("tree-0", "tree-1", "tree-2", "synthetic")


def fp32_p_attention(q, k, v, scale):
    """short_attention_ref with the probabilities left in fp32 in P . V: the
    twin's own bf16 rounding of P, taken out."""
    s = torch.matmul(short_attention._bhnd(q), short_attention._bhnd(k).transpose(-1, -2))
    s = s * scale
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e / den, short_attention._bhnd(v))
    return o.permute(0, 2, 1, 3).to(q.dtype), m + torch.log(den)


# What runs on its plain twin in each mode of the card test, and what
# short_attention_ref is replaced by.
SEMSEG_CLI_MODES = {
    "kernels": ((), None),
    "K2-on-its-twin": (("short_attention",), None),
    "K3b-on-its-twin": (("fused_mlp",), None),
    "twins-with-fp32-P": (("fused_block", "fused_decoder", "fused_mlp", "short_attention"),
                          fp32_p_attention),
}
KERNEL_OF = {"short_attention": ("short_attention_fwd", "short_attention_bwd"),
             "fused_mlp": ("fused_ln_mlp_res_fwd", "fused_ln_mlp_res_bwd")}


@pytest.fixture(scope="module")
def semseg_cli_first_step(tmp_path_factory):
    """run(data, mode) -> (metrics, gradients, launches) of the semseg CLI's
    first step: the NYU rgb-depth recipe (MultiViT-B at 512 px, ConvNeXt
    head, batch 4) from a --finetune start (a 224-px pretraining .pth of
    the port's ViT-B, seed 0), one epoch of one step, with the kernels
    that `mode` names on their plain twins ("plain": every one). The
    launches are those of the step and those of the rest of the run (its
    eval batch). Nothing is built before the first call; the plain runs
    are kept."""
    import chip_smoke
    from multimae_tpu_torch.cli import run_finetuning_semseg as scli
    from multimae_tpu_torch.data.dataset_folder import write_random_tree
    from multimae_tpu_torch.train import finetune_step

    root, kept = None, {}
    modules = {m.__name__.rsplit(".", 1)[-1]: m
               for m in (fused_block, fused_decoder, fused_mlp, short_attention)}

    def args(data):
        nonlocal root
        if root is None:
            root = tmp_path_factory.mktemp("semseg_cli_card")
            torch.save({"model": factory.build_pretrain_model(seed=0, device="cpu")
                        .state_dict(), "epoch": 0}, root / "pretrain.pth")
        cfg = Path(__file__).resolve().parents[1] / chip_smoke.FT_YAML
        out = ["-c", str(cfg), "--finetune", str(root / "pretrain.pth"), "--epochs", "1",
               "--num_workers", "0", "--no_auto_resume"]
        if data == "synthetic":
            return out + ["--synthetic_data", "--synthetic_steps_per_epoch", "1"]
        tree = root / data
        if not tree.exists():
            write_random_tree(str(tree), chip_smoke.SEMSEG_BATCH, (480, 640),
                              seed=int(data.split("-")[1]), semseg_classes=40,
                              ignore_patches=True, mask_valid=True)
        return out + ["--data_path", str(tree), "--eval_data_path", str(tree)]

    def run(data, mode):
        if (data, mode) in kept:
            return kept[data, mode]
        twins, attention_twin = (tuple(modules), None) if mode == "plain" else \
            SEMSEG_CLI_MODES[mode]
        make, first = finetune_step.make_dense_train_step, {}

        def keep_first_step(model, *a, **kw):
            step = make(model, *a, **kw)

            def run_step(state, batch, **k):
                metrics = step(state, batch, **k)
                if not first:
                    first["grads"] = {n: p.grad.float().clone()
                                      for n, p in model.named_parameters()
                                      if p.grad is not None}
                    first["launches"] = chip_smoke.launch_counts()
                return metrics
            return run_step

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(finetune_step, "make_dense_train_step", keep_first_step)
            if attention_twin is not None:
                mp.setattr(short_attention, "short_attention_ref", attention_twin)
            for name in twins:
                modules[name].set_force_mode("plain")
            try:
                chip_smoke.reset_launch_counts()
                metrics = scli.main(scli.get_args(args(data)))["steps"][0]["metrics"]
                total = chip_smoke.launch_counts()
            finally:
                for name in twins:
                    modules[name].set_force_mode(None)
        rest = {k: n - first["launches"][k] for k, n in total.items()}
        result = metrics, first["grads"], (first["launches"], rest)
        if mode == "plain":
            kept[data, mode] = result
        return result

    return run


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(SEMSEG_CLI_MODES))
@pytest.mark.parametrize("data", SEMSEG_CLI_DATA)
def test_semseg_cli_first_step_on_the_card_matches_the_plain_twins(cuda, semseg_cli_first_step,
                                                                    data, mode):
    """The semseg fine-tune CLI's first step from a --finetune start, on the
    card and on the plain twins from the same data and drop_path draws:
    with the kernels, K2 fwd and bwd launch 12 times and K3b fwd and bwd 4
    times in the step, K4 12 and K3b fwd 4 more in the eval batch; the
    loss within SEMSEG_CLI_LOSS_TOLERANCE relative, the grad norm within
    phase 11's 2.5e-4 and every parameter's gradient within its relative
    RMS 2.5e-2. The other modes put K2 or K3b alone on its twin, or run
    the twins with K2's P in fp32 (which of them moves the loss), to the
    same bounds."""
    import chip_smoke

    kern, grads, (in_step, rest) = semseg_cli_first_step(data, mode)
    expect_step = dict.fromkeys(in_step, 0)
    expect_step.update(short_attention_fwd=12, short_attention_bwd=12,
                       fused_ln_mlp_res_fwd=4, fused_ln_mlp_res_bwd=4)
    for name in SEMSEG_CLI_MODES[mode][0]:
        expect_step.update(dict.fromkeys(KERNEL_OF.get(name, ()), 0))
    assert in_step == expect_step
    if mode == "kernels":
        expect_rest = dict.fromkeys(rest, 0)
        if data != "synthetic":
            expect_rest.update(fused_block_infer=12, fused_ln_mlp_res_fwd=4)
        assert rest == expect_rest
    plain, plain_grads, _ = semseg_cli_first_step(data, "plain")
    assert set(grads) == set(plain_grads)
    rels = {n: chip_smoke.rel_rms(g, plain_grads[n]) for n, g in grads.items()}
    worst = max(rels, key=rels.get)
    loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    norm_rel = abs(kern["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])
    print(f"{data} {mode}: loss {kern['loss']} / {plain['loss']} (rel {loss_rel:.3e}), "
          f"grad norm {kern['grad_norm']} / {plain['grad_norm']} (rel {norm_rel:.3e}), worst "
          f"gradient {worst} rel RMS {rels[worst]:.3e}")
    assert loss_rel <= SEMSEG_CLI_LOSS_TOLERANCE
    assert norm_rel <= chip_smoke.SEMSEG_NORM_TOLERANCE
    assert rels[worst] <= chip_smoke.SEMSEG_GRAD_TOLERANCE, (worst, rels[worst])


# The cls CLI's first step against the plain twins. Its training step runs
# no kernel (the 197-key attention is below the K2 gate, and K4 serves eval
# only), so both paths run the same operations in the step: on an H100 at
# 700 W the loss, the grad norm and every gradient read equal on both (this
# test with -s, two runs: relative differences 0). CLS_CLI_STEP_TOLERANCE
# allows the last bits of an fp32 sum and no more. The eval batch runs K4
# in all 12 blocks; its logits read 3.05e-3 relative RMS from the twins'
# (both runs) against the eval limit of the other slices,
# chip_smoke.SLICE_TOLERANCE (3e-2).
CLS_CLI_STEP_TOLERANCE = 1e-6


@pytest.mark.cuda
def test_cls_cli_first_step_on_the_card_matches_the_plain_twins(cuda, tmp_path):
    """The ImageNet-1K recipe's first step at batch 128 from a --finetune
    start (a 224-px pretraining .pth of the port's ViT-B, seed 0) over a
    tree of the JPEG fixtures, with RandAugment, mixup/cutmix and the EMA:
    no kernel launches in the step and K4 12 times in the eval batch; the
    loss and grad norm within CLS_CLI_STEP_TOLERANCE relative of the same
    step on the plain twins, every gradient within it in relative RMS, and
    the eval logits within SLICE_TOLERANCE."""
    import chip_smoke
    from multimae_tpu_torch.cli import run_finetuning_cls as ccli
    from multimae_tpu_torch.data.dataset_folder import write_imagenet_tree
    from multimae_tpu_torch.train import finetune_step

    photos = sorted(str(p) for p in (Path(chip_smoke.JPEG_FIXTURES)).glob("photo_*.jpg"))
    train, val = write_imagenet_tree(str(tmp_path / "tree"), photos, chip_smoke.CLS_BATCH,
                                     chip_smoke.CLS_BATCH, chip_smoke.CLS_CLASSES)
    torch.save({"model": factory.build_pretrain_model(seed=0, device="cpu").state_dict(),
                "epoch": 0}, tmp_path / "pretrain.pth")
    cfg = Path(__file__).resolve().parents[1] / chip_smoke.CLS_YAML
    argv = ["-c", str(cfg), "--finetune", str(tmp_path / "pretrain.pth"),
            "--data_set", "image_folder", "--nb_classes", str(chip_smoke.CLS_CLASSES),
            "--data_path", train, "--eval_data_path", val, "--warmup_epochs", "0",
            "--epochs", "1", "--num_workers", "0", "--model_ema", "--no_auto_resume"]

    def run():
        make_train, make_eval, seen = (finetune_step.make_cls_train_step,
                                       finetune_step.make_cls_eval_step, {})

        def keep_train(model, *a, **kw):
            step = make_train(model, *a, **kw)

            def run_step(state, batch, **k):
                metrics = step(state, batch, **k)
                seen["grads"] = {n: p.grad.float().clone() for n, p in model.named_parameters()
                                 if p.grad is not None}
                seen["launches"] = chip_smoke.launch_counts()
                return metrics
            return run_step

        def keep_eval(model):
            fn = make_eval(model)

            def run_eval(batch):
                logits = fn(batch)
                seen.setdefault("logits", logits.float().clone())
                return logits
            return run_eval

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(finetune_step, "make_cls_train_step", keep_train)
            mp.setattr(finetune_step, "make_cls_eval_step", keep_eval)
            chip_smoke.reset_launch_counts()
            summary = ccli.main(ccli.get_args(argv))
            total = chip_smoke.launch_counts()
        rest = {k: n - seen["launches"][k] for k, n in total.items()}
        return summary["steps"][0]["metrics"], seen, rest

    kern, seen, rest = run()
    assert seen["launches"] == dict.fromkeys(seen["launches"], 0)
    assert rest == dict(dict.fromkeys(rest, 0), fused_block_infer=12)
    with chip_smoke.plain_twins():
        plain, plain_seen, _ = run()
    rels = {n: chip_smoke.rel_rms(g, plain_seen["grads"][n]) for n, g in seen["grads"].items()}
    worst = max(rels, key=rels.get)
    loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    norm_rel = abs(kern["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])
    logits_rel = chip_smoke.rel_rms(seen["logits"], plain_seen["logits"])
    print(f"cls: loss {kern['loss']} / {plain['loss']} (rel {loss_rel:.3e}), grad norm "
          f"{kern['grad_norm']} / {plain['grad_norm']} (rel {norm_rel:.3e}), worst gradient "
          f"{worst} rel RMS {rels[worst]:.3e}, eval logits rel RMS {logits_rel:.3e}")
    assert loss_rel <= CLS_CLI_STEP_TOLERANCE and norm_rel <= CLS_CLI_STEP_TOLERANCE
    assert rels[worst] <= CLS_CLI_STEP_TOLERANCE, (worst, rels[worst])
    assert logits_rel <= chip_smoke.SLICE_TOLERANCE


@pytest.mark.cuda
def test_short_attention_kernels_at_the_taskonomy_shape(cuda):
    """K2 forward and backward at the Taskonomy recipe's (8, 577, 12, 64),
    bf16 (384 px: 24 x 24 + 1 tokens): within TWIN_TOLERANCE and
    GRAD_TOLERANCE of the twins, each bit-equal over two runs."""
    b, n, h, dh = 8, 577, 12, 64
    scale = dh ** -0.5
    q, k, v = (t.contiguous() for t in qkv_views(4, b, n, h, dh, cuda))
    g = randn(5, b, n, h, dh).to(cuda, torch.bfloat16)
    o, lse = short_attention.short_attention_fwd(q, k, v, scale)
    o2, lse2 = short_attention.short_attention_fwd(q, k, v, scale)
    grads = short_attention.short_attention_bwd(q, k, v, o, lse, g, scale)
    again = short_attention.short_attention_bwd(q, k, v, o, lse, g, scale)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    ro, rlse = short_attention.short_attention_ref(q, k, v, scale)
    assert_matches_twin(o, ro, "K2 fwd o at (8, 577)")
    assert_matches_twin(lse, rlse, "K2 fwd lse at (8, 577)")
    ref = short_attention.short_attention_bwd_ref(q, k, v, g, lse,
                                                  short_attention.attention_delta(o, g), scale)
    for name, a, r in zip(("dq", "dk", "dv"), grads, ref):
        assert_matches_twin(a, r, f"K2 bwd {name} at (8, 577)", grad_of=torch.bfloat16)


@pytest.mark.cuda
def test_block_kernel_matches_twin_at_the_taskonomy_eval_shape(cuda):
    """K4 at the Taskonomy eval's (8, 577, 768), 12 heads, its attention on
    the K2 forward: within TWIN_TOLERANCE, bit-equal over two runs."""
    w = block_weights(768, 3072, device=cuda)
    x = randn(6, 8, 577, 768).to(cuda, torch.bfloat16)
    with torch.inference_mode():
        out = fused_block.fused_block_infer(x, w, 12)
        again = fused_block.fused_block_infer(x, w, 12)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert_matches_twin(out, fused_block.block_infer_ref(x, w, 12), "K4 (8,577,768)")


def first_dense_step(cli, argv, *, plain=False):
    """(first step's metrics, its gradients, the step's launches, the rest
    of the run's launches, the first eval batch's pred) of a dense CLI run,
    with every kernel on its plain twin if `plain`."""
    import chip_smoke
    from multimae_tpu_torch.train import finetune_step

    make_train, make_eval, seen = (finetune_step.make_dense_train_step,
                                   finetune_step.make_dense_eval_step, {})

    def keep_train(model, *a, **kw):
        step = make_train(model, *a, **kw)

        def run_step(state, batch, **k):
            metrics = step(state, batch, **k)
            if "grads" not in seen:
                seen["grads"] = {n: p.grad.float().clone() for n, p in model.named_parameters()}
                seen["launches"] = chip_smoke.launch_counts()
            return metrics
        return run_step

    def keep_eval(model, *a, **kw):
        fn = make_eval(model, *a, **kw)

        def run_eval(batch):
            pred = fn(batch)
            seen.setdefault("pred", pred.float().clone())
            return pred
        return run_eval

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(finetune_step, "make_dense_train_step", keep_train)
        mp.setattr(finetune_step, "make_dense_eval_step", keep_eval)
        with chip_smoke.plain_twins() if plain else contextlib.nullcontext():
            chip_smoke.reset_launch_counts()
            summary = cli.main(cli.get_args(argv))
            total = chip_smoke.launch_counts()
    rest = {k: n - seen["launches"][k] for k, n in total.items()}
    return summary["steps"][0]["metrics"], seen["grads"], seen["launches"], rest, seen.get("pred")


# The Taskonomy CLI's first step against the plain twins: K2 runs the
# training attention of all 12 blocks (577 keys), so its bf16 roundings of
# P reach the loss and every gradient, as in the semseg CLI's test. The
# loss and grad norm bounds are chip_smoke.TK_CLI_LOSS_TOLERANCE and
# TK_CLI_NORM_TOLERANCE; the gradient bound is phase 11's. Readings on an
# H100 at 700 W: loss 2.49e-4, grad norm 7.4e-5 to 9.0e-5, the worst
# gradient (the rgb pos-emb's) 6.2e-3 relative RMS, eval preds 2.48e-3.
TK_CLI_GRAD_TOLERANCE = 2.5e-2


# Faulty twins of K2 as controls: the keys past 512 dropped (a kernel that
# skips the ragged last tile), which the bounds must catch (read: loss
# 2.71e-2, grad norm 1.60e-2), and the scores rounded to bf16 before the
# softmax (a kernel that keeps S in bf16), which a first step cannot tell
# from K2's own bf16 roundings (read: loss 4.38e-4, grad norm 8.8e-5; H100,
# 700 W): K2 must only sit closer to the twins' loss than it.
def _bf16_scores(q, k, scale):
    return torch.matmul(q.transpose(1, 2), k.transpose(1, 2).transpose(-1, -2)).float() * scale


def _bf16_scores_fwd(q, k, v, scale):
    s = _bf16_scores(q, k, scale)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    den = e.sum(dim=-1, keepdim=True)
    o = torch.matmul((e / den).to(q.dtype).float(), v.float().transpose(1, 2))
    return o.transpose(1, 2).to(q.dtype), m + torch.log(den)


def _bf16_scores_bwd(q, k, v, do, lse, delta, scale):
    dtype = q.dtype
    qf, kf, vf, dof = (t.float().transpose(1, 2) for t in (q, k, v, do))
    p = torch.exp(_bf16_scores(q, k, scale) - lse)
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), dof)
    ds = (p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale).to(dtype).float()
    return tuple(t.transpose(1, 2).to(dtype)
                 for t in (torch.matmul(ds, kf), torch.matmul(ds.transpose(-1, -2), qf), dv))


_TWIN_FWD, _TWIN_BWD = short_attention.short_attention_ref, short_attention.short_attention_bwd_ref


def _tail_dropped_fwd(q, k, v, scale):
    return _TWIN_FWD(q, k[:, :512], v[:, :512], scale)


def _tail_dropped_bwd(q, k, v, do, lse, delta, scale):
    dq, dk, dv = _TWIN_BWD(q, k[:, :512], v[:, :512], do, lse, delta, scale)
    pad = torch.zeros_like(k[:, 512:])
    return dq, torch.cat([dk, pad], dim=1), torch.cat([dv, pad], dim=1)


TK_CONTROLS = {"bf16_scores": (_bf16_scores_fwd, _bf16_scores_bwd),
               "tail_dropped": (_tail_dropped_fwd, _tail_dropped_bwd)}


@pytest.mark.cuda
def test_taskonomy_cli_first_step_on_the_card_matches_the_plain_twins(cuda, tmp_path):
    """The rgb2depth_zbuffer recipe's first step at batch 8 and 384 px from
    a --finetune start (a 224-px pretraining .pth of the port's ViT-B, seed
    0) over a written Taskonomy tree: K2 forward and backward 12 times in
    the step, K4 12 times in the eval batch; the loss within
    chip_smoke.TK_CLI_LOSS_TOLERANCE relative of the same step on the plain
    twins (same data, same drop_path draws), the grad norm within
    chip_smoke.TK_CLI_NORM_TOLERANCE, every gradient within TK_CLI_GRAD_TOLERANCE
    relative RMS, the eval preds within chip_smoke.SLICE_TOLERANCE; the
    same step with the ragged tail dropped outside both bounds, and with
    bf16 scores farther from the twins' loss than the kernels' step."""
    import chip_smoke
    from multimae_tpu_torch.cli import run_finetuning_taskonomy as tcli
    from multimae_tpu_torch.data.taskonomy import write_taskonomy_tree

    write_taskonomy_tree(str(tmp_path), ["rgb", "depth_zbuffer", "mask_valid"],
                         {"train": chip_smoke.TK_BATCH, "val": chip_smoke.TK_BATCH},
                         hw=chip_smoke.TK_HW)
    torch.save({"model": factory.build_pretrain_model(seed=0, device="cpu").state_dict(),
                "epoch": 0}, tmp_path / "pretrain.pth")
    cfg = Path(__file__).resolve().parents[1] / chip_smoke.TK_YAML
    argv = ["-c", str(cfg), "--finetune", str(tmp_path / "pretrain.pth"), "--data_path",
            str(tmp_path), "--epochs", "1", "--warmup_epochs", "0", "--eval_freq", "1",
            "--num_workers", "0", "--no_auto_resume", "--no_save_ckpt"]
    kern, grads, in_step, rest, pred = first_dense_step(tcli, argv)
    assert in_step == dict(dict.fromkeys(in_step, 0), short_attention_fwd=12,
                           short_attention_bwd=12)
    assert rest == dict(dict.fromkeys(rest, 0), fused_block_infer=12)
    plain, plain_grads, _, _, plain_pred = first_dense_step(tcli, argv, plain=True)
    rels = {n: chip_smoke.rel_rms(g, plain_grads[n]) for n, g in grads.items()
            if float(plain_grads[n].abs().max()) > 0}
    worst = max(rels, key=rels.get)
    loss_rel = abs(kern["loss"] - plain["loss"]) / abs(plain["loss"])
    norm_rel = abs(kern["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])
    pred_rel = chip_smoke.rel_rms(pred, plain_pred)
    print(f"taskonomy: loss {kern['loss']} / {plain['loss']} (rel {loss_rel:.3e}), grad norm "
          f"{kern['grad_norm']} / {plain['grad_norm']} (rel {norm_rel:.3e}), worst gradient "
          f"{worst} rel RMS {rels[worst]:.3e}, eval preds rel RMS {pred_rel:.3e}")
    controls = {}
    for name, (fwd, bwd) in TK_CONTROLS.items():
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(short_attention, "short_attention_ref", fwd)
            mp.setattr(short_attention, "short_attention_bwd_ref", bwd)
            bad = first_dense_step(tcli, argv, plain=True)[0]
        controls[name] = tuple(abs(bad[m] - plain[m]) / abs(plain[m])
                               for m in ("loss", "grad_norm"))
        print(f"taskonomy control {name}: loss rel {controls[name][0]:.3e}, grad norm rel "
              f"{controls[name][1]:.3e}")
    assert controls["tail_dropped"][0] > chip_smoke.TK_CLI_LOSS_TOLERANCE
    assert controls["tail_dropped"][1] > chip_smoke.TK_CLI_NORM_TOLERANCE
    assert controls["bf16_scores"][0] > loss_rel
    assert loss_rel <= chip_smoke.TK_CLI_LOSS_TOLERANCE
    assert norm_rel <= chip_smoke.TK_CLI_NORM_TOLERANCE
    assert rels[worst] <= TK_CLI_GRAD_TOLERANCE, (worst, rels[worst])
    assert pred_rel <= chip_smoke.SLICE_TOLERANCE


# The depth CLI's first step on the card against the same step on the CPU:
# the recipe runs fp32 with TF32 off on the card (run_finetuning_depth.py),
# no kernel on its path, so the two differ by fp32 summation orders alone.
# Readings (H100, 700 W, against the card machine's CPU): loss 1.81e-7,
# grad norm 9.49e-7, the worst gradient (scratch.layer1_rn's) 3.42e-5
# relative RMS; the bounds are about five times those.
DEPTH_CARD_CPU_TOLERANCE = 5e-6
DEPTH_CARD_CPU_GRAD_TOLERANCE = 2e-4


@pytest.mark.cuda
def test_depth_cli_first_step_on_the_card_matches_the_cpu(cuda, tmp_path):
    """The NYUv2 depth recipe's first step at batch 64 and 256 px (fp32,
    berhu against mask_valid) from a --finetune start over a written
    NYUv2-shaped tree: no kernel launches; the loss and grad norm within
    DEPTH_CARD_CPU_TOLERANCE relative of the same step on the CPU, every
    gradient within DEPTH_CARD_CPU_GRAD_TOLERANCE relative RMS."""
    import chip_smoke
    from multimae_tpu_torch.cli import run_finetuning_depth as dcli
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    nyu = dict(semseg_classes=40, mask_valid=True, smooth=True)
    write_random_tree(str(tmp_path / "written"), 16, (480, 640), **nyu)
    chip_smoke.link_records(str(tmp_path / "written"), str(tmp_path / "train"),
                            chip_smoke.DEPTH_BATCH // 16)
    torch.save({"model": factory.build_pretrain_model(seed=0, device="cpu").state_dict(),
                "epoch": 0}, tmp_path / "pretrain.pth")
    cfg = Path(__file__).resolve().parents[1] / chip_smoke.DEPTH_YAML
    argv = ["-c", str(cfg), "--finetune", str(tmp_path / "pretrain.pth"),
            "--data_path", str(tmp_path / "train"), "--eval_data_path", str(tmp_path / "written"),
            "--epochs", "1", "--warmup_epochs", "0", "--eval_freq", "100", "--num_workers", "0",
            "--no_auto_resume", "--no_save_ckpt"]
    kern, grads, in_step, rest, _ = first_dense_step(dcli, argv)
    assert in_step == dict.fromkeys(in_step, 0) and rest == dict.fromkeys(rest, 0)
    cpu, cpu_grads, _, _, _ = first_dense_step(dcli, argv + ["--device", "cpu"])
    rels = {n: chip_smoke.rel_rms(g.cpu(), cpu_grads[n]) for n, g in grads.items()
            if float(cpu_grads[n].abs().max()) > 0}
    worst = max(rels, key=rels.get)
    loss_rel = abs(kern["loss"] - cpu["loss"]) / abs(cpu["loss"])
    norm_rel = abs(kern["grad_norm"] - cpu["grad_norm"]) / abs(cpu["grad_norm"])
    print(f"depth: loss {kern['loss']} / {cpu['loss']} on the CPU (rel {loss_rel:.3e}), grad "
          f"norm {kern['grad_norm']} / {cpu['grad_norm']} (rel {norm_rel:.3e}), worst gradient "
          f"{worst} rel RMS {rels[worst]:.3e}")
    assert loss_rel <= DEPTH_CARD_CPU_TOLERANCE and norm_rel <= DEPTH_CARD_CPU_TOLERANCE
    assert rels[worst] <= DEPTH_CARD_CPU_GRAD_TOLERANCE, (worst, rels[worst])
