"""The CUDA kernels (K4, K1 forward and K1 backward) against their plain
twins, and the wrappers' dispatch. Imports neither jax nor multimae_tpu,
so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Without a card the kernel tests (marker `cuda`) skip and the dispatch
tests run. Kernel vs twin tolerance: ops/functional.TWIN_TOLERANCE, and
GRAD_TOLERANCE for the backward's gradients.
"""

import numpy as np
import pytest
import torch

from multimae_tpu_torch.ops import fused_block, fused_decoder
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
                                         (2, 197, 256, 8)])
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
