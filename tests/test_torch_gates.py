"""The kernel gates of the port: fused_decoder.supported (K1),
fused_block.supported (K4) and fused_mlp.supported (K3b), and the module
paths that serve the shapes they refuse, against the JAX package.

- A MultiMAE whose decoders K1 refuses (dim 256, 2 heads: head width 128)
  runs every decoder through its submodules: its fp32 preds and first-step
  gradients match the JAX package's (whose decoders take their module
  path on the CPU), and fused_decoder_core is never called.
- The tiny ViT block (dim 64, 4 heads: head width 16), which K4 refuses,
  matches the JAX block through the module path.

Tolerances: fp32 preds and block outputs within 5e-4 absolute (the bar of
the JAX package's goldens); each gradient within 2e-5 of its tensor's
largest |gradient|, as in test_torch_train_step.py (measured: preds 6e-6,
gradients 2e-6; summation order only, both sides run the module path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.cli import factory as jfactory
from multimae_tpu.models import vit as jvit
from multimae_tpu.models.criterion import (
    MaskedCrossEntropyLoss as JCE,
    MaskedL1Loss as JL1,
    MaskedMSELoss as JMSE,
)
from multimae_tpu_torch.cli import factory as tfactory
from multimae_tpu_torch.models.vit import Block
from multimae_tpu_torch.ops import fused_block, fused_decoder, fused_mlp
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict

BF16, F32 = torch.bfloat16, torch.float32

# ------------------------------------------------------------- the gates --

# (nq, nc, dim, heads, depth, dtype, hidden, admitted)
K1_CASES = [
    (196, 99, 256, 8, 2, BF16, 1024, True),    # the shipped 224-px decoders
    (196, 99, 256, 8, 2, F32, 1024, True),     # ... with the fp32 semseg one
    (196, 99, 256, 4, 2, BF16, 1024, True),    # head width 64
    (16, 25, 256, 2, 2, BF16, 1024, False),    # head width 128
    (16, 25, 256, 2, 2, F32, 1024, False),
    (16, 25, 64, 4, 2, F32, 256, False),       # head width 16 (the tiny models)
    (196, 99, 256, 8, 0, BF16, 1024, False),   # depth 0: no backward kernel
    (196, 99, 256, 8, 2, torch.float16, 1024, False),
    (166, 99, 256, 4, 2, F32, 1024, True),     # fp32, width 64: the backward
    (167, 99, 256, 4, 2, F32, 1024, False),    # ... holds up to 166 keys
    (196, 99, 256, 4, 2, F32, 1024, False),
    (99, 286, 256, 8, 2, F32, 1024, True),     # fp32, width 32: up to 286
    (99, 287, 256, 8, 2, F32, 1024, False),
    (400, 99, 256, 4, 2, F32, 1024, False),    # past the fp32 forward's too
    (209, 99, 256, 4, 2, BF16, 1024, True),    # bf16, width 64: up to 209
    (210, 99, 256, 4, 2, BF16, 1024, False),
    (784, 99, 256, 8, 2, BF16, 1024, False),   # 448-px queries, width 32
]


@pytest.mark.parametrize("nq,nc,dim,heads,depth,dtype,hidden,ok", K1_CASES)
def test_decoder_gate(nq, nc, dim, heads, depth, dtype, hidden, ok):
    assert fused_decoder.supported(nq, nc, dim, heads, depth, dtype, hidden) == ok


@pytest.mark.parametrize("nk,dh,dtype,limit", [(166, 64, F32, True), (167, 64, F32, False),
                                               (286, 32, F32, True), (287, 32, F32, False),
                                               (209, 64, BF16, True), (210, 64, BF16, False),
                                               (346, 32, BF16, True), (347, 32, BF16, False)])
def test_decoder_gate_shared_memory_edges(nk, dh, dtype, limit):
    """The backward's shared-memory figure (a copy of the CUDA side's, held
    against it on the card) at the last key counts that fit."""
    assert (fused_decoder.bwd_attention_smem(nk, dh, dtype) <= fused_decoder.SMEM_LIMIT) == limit


# (n, d, heads, hidden, dtype, admitted)
K4_CASES = [
    (99, 768, 12, 3072, BF16, True),       # the serving encoder
    (2049, 768, 12, 3072, BF16, True),     # the 512-px eval (attention on K2)
    (2049, 768, 8, 3072, BF16, True),      # head width 96
    (197, 256, 8, 1024, BF16, True),
    (13, 128, 4, 512, BF16, True),
    (99, 256, 2, 1024, BF16, True),        # head width 128
    (99, 768, 12, 3072, F32, False),       # bf16 only, as the JAX gate
    (13, 64, 4, 256, BF16, False),         # the tiny models: head width 16
    (99, 96, 3, 384, BF16, False),         # not whole 64-wide k-steps
    (99, 768, 12, 3040, BF16, False),
    (99, 2048, 16, 8192, BF16, False),     # a LayerNorm row past 1024
    (99, 768, 5, 3072, BF16, False),       # heads do not divide the width
]


@pytest.mark.parametrize("n,d,heads,hidden,dtype,ok", K4_CASES)
def test_block_gate(n, d, heads, hidden, dtype, ok):
    assert fused_block.supported(n, d, heads, hidden, dtype) == ok


@pytest.mark.parametrize("m,k,h,dtype,ok", [
    (65536, 384, 1536, BF16, True), (65536, 128, 512, BF16, True),
    (65536, 96, 384, BF16, False), (65536, 384, 1504, BF16, False),
    (65536, 1088, 4352, BF16, False), (65536, 384, 1536, F32, False)])
def test_mlp_gate_widths(m, k, h, dtype, ok):
    """K3b takes K and H in whole 64-wide k-steps, K up to 1024."""
    assert fused_mlp.supported(m, k, h, dtype) == ok


# ------------------------------------ a decoder K1 refuses, against JAX --

PROJ_SHAPES = {"rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)}
WIDE = dict(model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=256,
            decoder_num_heads=2, decoder_depth=2)
K, B = 24, 2


def fixed_masks(seed=3):
    rng = np.random.default_rng(seed)
    masks = np.ones((B, 48), np.int32)
    for i in range(B):
        masks[i, rng.permutation(48)[:K]] = 0
    return {t: masks[:, 16 * j:16 * (j + 1)] for j, t in enumerate(("rgb", "depth", "semseg"))}


def jax_losses():
    return {"rgb": JMSE(16, 1), "depth": JL1(16, 1), "semseg": JCE(16, 4),
            "norm_rgb": JMSE(16, 1, norm_pix=True)}


@pytest.fixture(scope="module")
def wide_run():
    """JAX: params, preds and the gradients of the summed losses."""
    model = jfactory.build_pretrain_model(**WIDE)
    batch = jfactory.make_synthetic_batch(B, input_size=64, seed=1)
    masks = {t: jnp.asarray(m) for t, m in fixed_masks().items()}
    params = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        batch, num_encoded_tokens=K)["params"])()
    losses = jax_losses()

    def loss_fn(p):
        preds, m = model.apply({"params": p}, batch, train=True, num_encoded_tokens=K,
                               task_masks=masks)
        total = sum(losses[t](pr.astype(jnp.float32), batch["rgb" if t == "norm_rgb" else t],
                              mask=m["rgb" if t == "norm_rgb" else t])
                    for t, pr in preds.items())
        return total, preds

    grads, preds = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    tree = jax.tree.map(np.array, (params, preds, grads))
    return tree


def test_decoders_k1_refuses_match_jax_without_the_core(wide_run, monkeypatch):
    params, jpreds, jgrads = wide_run
    calls = []

    def spy(*args, **kw):
        calls.append(args)
        raise AssertionError("fused_decoder_core called at a shape its gate refuses")

    monkeypatch.setattr(fused_decoder, "fused_decoder_core", spy)
    model = tfactory.build_pretrain_model(**WIDE, pos_emb_grads=True, device="cpu")
    sd = jax_params_to_state_dict(params, PROJ_SHAPES)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    adapter = model.output_adapters["rgb"]
    assert not fused_decoder.supported(16, K + 1, 256, 2, 2, F32,
                                       adapter.mlp.fc1.weight.shape[0])
    batch = tfactory.make_synthetic_batch(B, input_size=64, seed=1, device="cpu")
    masks = {t: torch.from_numpy(m) for t, m in fixed_masks().items()}
    losses = tfactory.build_pretrain_losses(("rgb", "depth", "semseg"))
    model.train()
    preds, _ = model(batch, num_encoded_tokens=K, task_masks=masks)
    total = sum(losses[t](p.float(), batch["rgb" if t == "norm_rgb" else t],
                          mask=masks["rgb" if t == "norm_rgb" else t])
                for t, p in preds.items())
    total.backward()
    assert not calls
    assert set(preds) == set(jpreds)
    for t, p in preds.items():
        np.testing.assert_allclose(p.detach().numpy(), jpreds[t], rtol=0, atol=5e-4,
                                   err_msg=t)
    ref = jax_params_to_state_dict(jgrads, PROJ_SHAPES)
    named = dict(model.named_parameters())
    assert set(ref) == set(named)
    for k, v in ref.items():
        np.testing.assert_allclose(named[k].grad.numpy(), v, rtol=0,
                                   atol=2e-5 * max(float(np.abs(v).max()), 1e-12), err_msg=k)


# --------------------------------------- a block K4 refuses, against JAX --


@pytest.mark.parametrize("shape", [(2, 13, 64, 4), (3, 17, 64, 4)])
def test_tiny_block_k4_refuses_matches_jax(shape, monkeypatch):
    b, n, d, heads = shape
    x = np.random.default_rng(5).standard_normal((b, n, d)).astype(np.float32)
    jblk = jvit.Block(num_heads=heads)
    params = jblk.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: np.array(a) + np.random.default_rng(a.size).standard_normal(
        a.shape).astype(np.float32) * 0.05, params)
    ref = np.asarray(jblk.apply({"params": params}, jnp.asarray(x)))
    assert not fused_block.supported(n, d, heads, 4 * d, BF16)

    def refuse(*args, **kw):
        raise AssertionError("fused_block_infer called at a shape its gate refuses")

    monkeypatch.setattr(fused_block, "fused_block_infer", refuse)
    blk = Block(d, heads)
    blk.load_state_dict({k: torch.from_numpy(v)
                         for k, v in jax_params_to_state_dict(params).items()}, strict=True)
    with torch.inference_mode():
        out = blk.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-4)


@pytest.mark.parametrize("heads,calls", [(2, 4), (4, 0)])
def test_adapters_consult_the_gate_on_the_cpu(heads, calls, monkeypatch):
    """The decoders of dim 64 take K1's op (its plain twin on the CPU) at
    head width 32 and their submodules at head width 16, as the JAX
    adapter consults its gate on every backend."""
    seen = []
    core = fused_decoder.fused_decoder_core

    def spy(*args, **kw):
        seen.append(args[3])
        return core(*args, **kw)

    monkeypatch.setattr(fused_decoder, "fused_decoder_core", spy)
    model = tfactory.build_pretrain_model(model_name="pretrain_multimae_tiny", input_size=64,
                                          decoder_dim=64, decoder_num_heads=heads,
                                          decoder_depth=1, device="cpu").eval()
    batch = tfactory.make_synthetic_batch(B, input_size=64, seed=1, device="cpu")
    masks = {t: torch.from_numpy(m) for t, m in fixed_masks().items()}
    with torch.inference_mode():
        preds, _ = model(batch, num_encoded_tokens=K, task_masks=masks)
    assert len(seen) == calls and all(h == heads for h in seen)
    assert all(bool(torch.isfinite(p).all()) for p in preds.values())
