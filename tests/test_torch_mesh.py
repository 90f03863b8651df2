"""The port's meshes (multimae_tpu_torch/parallel/mesh.py) against the JAX
package's (multimae_tpu/parallel/mesh.py, parallel/pp.py): the grouping by
host, its checks and every mesh check's message, in one process. The
meshes seen from four real processes are in tests/test_torch_parallel_cli.py.
"""

import jax
import numpy as np
import pytest

import multimae_tpu.parallel.mesh as jmesh
from multimae_tpu.parallel import pp as jpp
from multimae_tpu_torch.parallel import mesh as tmesh


@pytest.mark.parametrize("env,rank,key", [
    ({"GROUP_RANK": "3", "LOCAL_WORLD_SIZE": "2", "RANK": "1"}, None, 3),
    ({"LOCAL_WORLD_SIZE": "4", "RANK": "9"}, None, 2),
    ({"LOCAL_WORLD_SIZE": "4"}, 5, 1),
    ({}, None, 0),
])
def test_host_key_under_launcher_variables(monkeypatch, env, rank, key):
    for k in ("GROUP_RANK", "LOCAL_WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    import os

    assert tmesh.host_key(os.environ, rank) == key


class _FakeTpu:
    platform = "tpu"

    def __init__(self, slice_index, i):
        self.slice_index, self.id = slice_index, i


def _jax_order(keys, dcn, monkeypatch):
    """The JAX package's device order for devices on the given slices."""
    captured = {}

    def fake_mesh(arr, names):
        captured["arr"] = arr
        return "mesh"

    monkeypatch.setattr(jmesh, "Mesh", fake_mesh)
    jmesh.create_hybrid_mesh(dcn=dcn, devices=[_FakeTpu(k, i) for i, k in enumerate(keys)])
    return [d.id for d in np.asarray(captured["arr"]).ravel()]


@pytest.mark.parametrize("keys,dcn", [
    ([0, 1, 0, 1, 0, 1, 0, 1], 2), ([1, 1, 0, 0], None), ([2, 0, 1, 2, 0, 1], 3),
    ([0, 0, 0, 0], 2),
])
def test_grouping_by_host_matches_jax(monkeypatch, keys, dcn):
    order, got_dcn = tmesh.order_by_host(keys, dcn)
    assert order == _jax_order(keys, dcn, monkeypatch)
    assert got_dcn == (dcn if dcn is not None else len(set(keys)))


def _jax_message(fn):
    with pytest.raises(AssertionError) as e:
        fn()
    return str(e.value)


def test_grouping_checks_and_their_messages(monkeypatch):
    with pytest.raises(ValueError) as e:
        tmesh.order_by_host([0, 1, 0, 1], 4)
    assert str(e.value) == _jax_message(lambda: _jax_order([0, 1, 0, 1], 4, monkeypatch))
    assert "slice topology wins" in str(e.value)
    with pytest.raises(ValueError) as e:
        tmesh.order_by_host([0, 0, 1], None)
    assert str(e.value) == _jax_message(lambda: _jax_order([0, 0, 1], None, monkeypatch))


def test_mesh_checks_and_their_messages():
    """One process: every shape that does not fill the world is refused
    with the JAX package's message for one device."""
    one = jax.devices()[:1]
    cases = [
        (lambda: tmesh.create_mesh(data=2, model=2, device="cpu"),
         lambda: jmesh.create_mesh(data=2, model=2, devices=one)),
        (lambda: tmesh.create_mesh(model=2, device="cpu"),
         lambda: jmesh.create_mesh(model=2, devices=one)),
        (lambda: tmesh.create_pp_mesh(stage=2, device="cpu"),
         lambda: jpp.create_pp_mesh(stage=2, devices=one)),
        (lambda: tmesh.create_hybrid_mesh(dcn=2, device="cpu"),
         lambda: jmesh.create_hybrid_mesh(dcn=2, devices=one)),
        (lambda: tmesh.create_hybrid_mesh(dcn=1, data=2, device="cpu"),
         lambda: jmesh.create_hybrid_mesh(dcn=1, data=2, devices=one)),
    ]
    for port, ref in cases:
        with pytest.raises(ValueError) as e:
            port()
        assert str(e.value) == _jax_message(ref)


def test_batch_axes():
    class M:
        mesh_dim_names = ("dcn", "data", "model")

    assert tmesh.batch_axes(M()) == ("dcn", "data")
    M.mesh_dim_names = ("data", "stage")
    assert tmesh.batch_axes(M()) == ("data",)
    assert tmesh.batch_axes(None) == ("data",)
    assert tmesh.batch_layout(None) == (None, 0, 1)  # one process: the world's
    assert tmesh.mesh_for_flags() is None


def test_pipeline_excludes_model_and_dcn():
    from multimae_tpu_torch.cli import run_pretraining_multimae as cli

    for extra in (["--model_parallel", "2"], ["--dcn_data_parallel", "2"]):
        args = cli.get_args(["--device", "cpu", "--synthetic_data", "--pipeline_parallel", "2"]
                            + extra)
        with pytest.raises(SystemExit, match="^--pipeline_parallel is exclusive with "
                                             "--model_parallel/--dcn_data_parallel$"):
            cli.main(args)
