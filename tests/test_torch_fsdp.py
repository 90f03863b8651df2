"""FSDP2 in the port (multimae_tpu_torch/parallel/fsdp.py) with real gloo
processes on the CPU (worker: tests/_torch_parallel_worker.py), against the
JAX package's jit_fsdp on dcn 2 x data 2 (HSDP) and
against the port's one-process step (case, bars: tests/_torch_parallel.py).

* FSDP over 2 ranks: each rank holds about half the parameter and AdamW
  moment bytes (printed).
* HSDP: dcn 2 x data 2, replicated over dcn, sharded over data.
* dcn 2 x model 2 with FSDP (TP inside a host, FSDP over its data axis of
  one, the gradient mean over dcn).
* --pipeline_parallel 2 --fsdp on data 2 x stage 2 against the
  one-process step; each rank gathers only its own stage's block.
"""

import pytest

import _torch_parallel as P


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("fsdp")
    jc = P.JaxCase()
    case = jc.case(out / "case.pt")
    four = P.start(4, MODE="layouts", LAYOUTS="hsdp,fsdp_dcn2m2,pp_s2m2_fsdp", CASE=case,
                   OUT=out)
    two = P.start(2, MODE="layouts", LAYOUTS="fsdp2", CASE=case, OUT=out)
    jax_runs = P.run_jax({"hsdp": (jc, "hsdp", 4, 0, 1)})
    ref = P.one_process(case)
    P.finish(four)
    P.finish(two)
    return out, jax_runs, ref


@pytest.mark.parametrize("layout", ["fsdp2", "hsdp", "fsdp_dcn2m2"])
def test_fsdp_step_matches_jax_and_one_process(runs, layout):
    out, jax_runs, ref = runs
    got = P.load(out, layout)
    P.check_one_process(got, ref, layout, grad_tol=1e-5 if "m2" in layout else 1e-6)
    P.check_jax(got, jax_runs["hsdp"], ref, layout)


def test_pipeline_with_fsdp_matches_one_process(runs):
    out, _, ref = runs
    P.check_one_process(P.load(out, "pp_s2m2_fsdp"), ref, "pp_s2m2_fsdp", grad_tol=1e-5)


def test_pipeline_with_fsdp_gathers_only_its_stage(runs):
    """Data 2 x stage 2 over the 2 blocks: rank r runs stage r % 2, and
    while its block runs the other stage's block stays sharded (the slice
    jit_pp(fsdp=True) gathers)."""
    got = P.load(runs[0], "pp_s2m2_fsdp")["gathered"]
    assert got == [[r % 2] for r in range(4)], got


def test_fsdp_ranks_hold_half_the_bytes(runs):
    """Parameters and AdamW moments: each of 2 ranks holds half of what
    the one process holds, give or take FSDP's padding of dim 0 to an even
    split and the balancer's 4 replicated log-variances."""
    out, _, ref = runs
    held, whole = P.load(out, "fsdp2")["held_bytes"], ref[4]
    print(f"FSDP over 2 ranks: bytes of parameters + moments per rank {held}, "
          f"one process {whole}")
    for b in held:
        assert 0.49 * whole <= b <= 0.51 * whole, (b, whole)
