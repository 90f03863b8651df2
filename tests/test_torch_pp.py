"""GPipe pipeline parallelism in the port (multimae_tpu_torch/parallel/pp.py)
with real gloo processes on the CPU (worker: tests/_torch_parallel_worker.py),
against the JAX package's jit_pp with S 2 and M 2 and against the
port's one-process step (case, bars: tests/_torch_parallel.py).

* On a depth-4 encoder: S 2 with M 2 (two steps: the second step's loss
  and grad norm too, and the parameters after both against JAX's) and
  M 4; S 4 with M 2 (4 processes).
* Every check of the JAX package's pipeline, with its message.
"""

from types import SimpleNamespace

import pytest
import torch

import _torch_parallel as P
from multimae_tpu_torch.cli import factory
from multimae_tpu_torch.parallel import pp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    jc = P.JaxCase(depth=4)
    case = jc.case(out / "case.pt", depth=4)
    two = P.start(2, MODE="layouts", LAYOUTS="pp_s2m2:2,pp_s2m4", CASE=case, OUT=out)
    four = P.start(4, MODE="layouts", LAYOUTS="pp_s4m2", CASE=case, OUT=out)
    jax_runs = P.run_jax({"pp_s2m2": (jc, "pp", 2, 2, 2)})
    ref = P.one_process(case, steps=2)
    P.finish(two)
    P.finish(four)
    return out, jax_runs, ref


@pytest.mark.parametrize("layout", ["pp_s2m2", "pp_s2m4", "pp_s4m2"])
def test_pp_step_matches_jax_and_one_process(runs, layout):
    out, jax_runs, ref = runs
    got = P.load(out, layout)
    P.check_one_process(got, ref, layout, grad_tol=1e-5)
    P.check_jax(got, jax_runs["pp_s2m2"], ref, layout)


def test_pp_second_step(runs):
    """The second step's metrics against the one-process second step and
    JAX's (the first step's checked above; the parameters after both
    steps against JAX's in test_pp_step_matches_jax_and_one_process)."""
    out, jax_runs, ref = runs
    got = P.load(out, "pp_s2m2")
    assert len(got["metrics"]) == 2
    P.check_one_process(got, ref, "pp_s2m2 step 2", i=1, grad_tol=1e-5)
    for k in ("loss", "grad_norm"):
        assert abs(got["metrics"][1][k] - jax_runs["pp_s2m2"][0][1][k]) <= 1e-3 * abs(
            jax_runs["pp_s2m2"][0][1][k]), k
    assert got["metrics"][1]["loss"] != got["metrics"][0]["loss"]


def _blocks(depth=2, **kw):
    model = factory.build_pretrain_model(model_name="pretrain_multimae_tiny", input_size=64,
                                         decoder_dim=64, decoder_num_heads=4, device="cpu",
                                         depth=depth, **kw)
    return model.encoder


def _pipe(stage=2, micro=2, data=1):
    return SimpleNamespace(n_stage=stage, n_micro=micro, n_data=data)


def test_pp_checks_and_their_messages():
    blocks = _blocks()
    pp.check(blocks, 4, _pipe(), train=True)  # a valid configuration passes
    with pytest.raises(ValueError, match=r"^encoder depth 2 not divisible by 4 pipeline "
                                         r"stages$"):
        pp.check(blocks, 4, _pipe(stage=4), train=True)
    with pytest.raises(ValueError, match=r"^global batch 6 not divisible by data axis 2 x 2 "
                                         r"microbatches$"):
        pp.check(blocks, 3, _pipe(data=2), train=True)
    with pytest.raises(ValueError, match=r"^pipeline microbatch count must be >= 1, got 0 "
                                         r"\(--pipeline_microbatches\)$"):
        pp.Pipeline(None, 0)
    dropped = _blocks(drop_path=0.1)
    with pytest.raises(ValueError, match=r"^pipeline parallelism requires drop/attn_drop/"
                                         r"drop_path == 0 during training \(got a nonzero "
                                         r"rate\)$"):
        pp.check(dropped, 4, _pipe(), train=True)
    pp.check(dropped, 4, _pipe(), train=False)  # eval: drop_path is a no-op
    mixed = _blocks()
    mixed[1].qkv_bias = False
    with pytest.raises(ValueError, match=r"^pipeline parallelism requires homogeneous "
                                         r"encoder blocks; block 1\.qkv_bias=False != "
                                         r"block 0\.qkv_bias=True$"):
        pp.check(mixed, 4, _pipe(), train=False)
    mixed[1].qkv_bias, mixed[1].dtype = True, torch.bfloat16
    with pytest.raises(ValueError, match=r"block 1\.dtype=torch\.bfloat16 != block 0\.dtype="
                                         r"torch\.float32$"):
        pp.check(mixed, 4, _pipe(), train=False)
