"""Megatron tensor parallelism in the port (multimae_tpu_torch/parallel/tp.py)
with real gloo processes on the CPU (worker: tests/_torch_parallel_worker.py),
against the JAX package's jit_tp on data 2 x model 2 and against the
port's one-process step (case, bars: tests/_torch_parallel.py).

* The split rules, as tests/test_tp.py:35-55 has the JAX package's: fc1
  column-parallel, fc2 and proj row-parallel, only inside encoder blocks;
  a model whose heads or MLP width do not divide is refused (the JAX
  package leaves such a leaf replicated: with the split written out, a
  block split in part would compute another function); qkv here by head
  (the JAX package keeps it replicated for want of a contiguous GSPMD
  split).
* TP 2 (2 processes), TP 4 and data 2 x model 2 (4 processes), and
  --fsdp --model_parallel 2 (data 2 x model 2 with FSDP2 over data),
  each against JAX's jit_tp on data 2 x model 2 (tests/_torch_parallel.py).
* A semseg fine-tune step under TP 2 with the ConvNeXt head against the
  one-process step (which tests/test_torch_semseg.py holds against JAX).
"""

import functools
from types import SimpleNamespace

import pytest
import torch

import _torch_parallel as P
from multimae_tpu_torch.parallel import tp


def test_split_rules():
    """What a model split over 2 ranks holds in pieces: fc1 by rows (column-
    parallel), fc2 and proj by columns (row-parallel), qkv by head, only in
    encoder blocks; every other tensor whole. Where a dim does not divide,
    shard_model refuses (test_shard_model_refuses_a_partial_split)."""
    split = SimpleNamespace(tp=(None, 0, 2))
    kind = functools.partial(tp.split_kind, split)
    assert kind("encoder.3.mlp.fc1.weight") == "rows"
    assert kind("encoder.3.mlp.fc1.bias") == "rows"
    assert kind("encoder.0.mlp.fc2.weight") == "cols"
    assert kind("encoder.0.attn.proj.weight") == "cols"
    assert kind("encoder.0.attn.qkv.weight") == "qkv"
    assert kind("encoder.0.attn.qkv.bias") == "qkv"
    # whole: the biases added after the sum, norms, decoder blocks, adapters
    for name in ("encoder.0.attn.proj.bias", "encoder.0.mlp.fc2.bias", "encoder.0.norm1.weight",
                 "output_adapters.rgb.decoder.0.mlp.fc1.weight",
                 "input_adapters.rgb.proj.weight", "global_tokens"):
        assert kind(name) is None, name
    assert tp.split_kind(SimpleNamespace(), "encoder.0.mlp.fc1.weight") is None  # no split


@pytest.mark.parametrize("k", [2, 4])
def test_pieces_are_heads_and_join_back(k):
    h, dh, d = 4, 16, 64
    w = torch.randn(3 * h * dh, d)
    pieces = [tp.local_piece("qkv", w, r, k) for r in range(k)]
    per = h // k
    for r, piece in enumerate(pieces):
        q, kk, v = piece.reshape(3, per * dh, d)
        full = w.reshape(3, h, dh, d)
        assert torch.equal(q, full[0, r * per:(r + 1) * per].reshape(-1, d))
        assert torch.equal(v, full[2, r * per:(r + 1) * per].reshape(-1, d))
    assert torch.equal(tp.join_pieces("qkv", pieces), w)
    for kind in ("rows", "cols"):
        assert torch.equal(tp.join_pieces(kind, [tp.local_piece(kind, w, r, k)
                                                 for r in range(k)]), w)
    assert tp.full_shape("cols", (64, 32), k) == (64, 32 * k)


def test_shard_model_refuses_a_partial_split():
    from multimae_tpu_torch.cli import factory

    model = factory.build_pretrain_model(model_name="pretrain_multimae_tiny", input_size=64,
                                         decoder_dim=64, decoder_num_heads=4, device="cpu")
    with pytest.raises(ValueError, match="block 0 has 4 heads"):
        tp.shard_model(model, None, 0, 3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    jc = P.JaxCase()
    case = jc.case(out / "case.pt")
    four = P.start(4, MODE="layouts", LAYOUTS="tp4,d2m2,fsdp_d2m2", CASE=case, OUT=out)
    two = P.start(2, MODE="layouts,semseg", LAYOUTS="tp2", CASE=case, OUT=out)
    jax_runs = P.run_jax({"d2m2": (jc, "tp", 4, 2, 1)})
    ref = P.one_process(case)
    P.finish(four)
    P.finish(two)
    return out, jax_runs, ref


@pytest.mark.parametrize("layout", ["tp2", "tp4", "d2m2", "fsdp_d2m2"])
def test_tp_step_matches_jax_and_one_process(runs, layout):
    out, jax_runs, ref = runs
    got = P.load(out, layout)
    P.check_one_process(got, ref, layout, grad_tol=1e-5)
    P.check_jax(got, jax_runs["d2m2"], ref, layout)


def test_tp_semseg_step_matches_one_process(runs):
    """Loss and grad norm within 1e-5 relative, every gradient within 1e-5
    of its tensor's largest (tests/_torch_parallel.py: TP's sums in another
    order; measured 1.1e-6, a LayerNorm bias of the ConvNeXt head)."""
    from test_torch_dist import semseg_batch, semseg_trainer

    got = P.load(runs[0], "semseg_tp")
    state, step = semseg_trainer()
    metrics = {k: float(v) for k, v in step(state, semseg_batch()).items()}
    for k in ("loss", "grad_norm"):
        assert abs(got["metrics"][k] - metrics[k]) <= 1e-5 * abs(metrics[k]), k
    for k, p in state.model.named_parameters():
        g = got["grads"][k].double() - p.grad.double()
        assert float(g.abs().max()) <= 1e-5 * float(p.grad.abs().max()), k
