"""The CUDA kernels (K4, K1 forward and backward, K2 forward and backward,
K3a and K3b forward and backward) against their plain twins, and the
wrappers' dispatch. Imports neither jax nor multimae_tpu,
so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Without a card the kernel tests (marker `cuda`) skip and the dispatch
tests run. Kernel vs twin tolerance: ops/functional.TWIN_TOLERANCE, and
GRAD_TOLERANCE for the backward's gradients.
"""

import inspect

import numpy as np
import pytest
import torch

from multimae_tpu_torch.cli import factory
from multimae_tpu_torch.ops import (
    attention,
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
@pytest.mark.parametrize("m,k,h", [(20000, 128, 512), (65536, 384, 1536)])
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
@pytest.mark.parametrize("m,k,h", [(20000, 128, 512), (65536, 384, 1536)])
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
