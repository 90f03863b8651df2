"""The JAX package's orbax checkpoints in the port (multimae_tpu_torch/utils/
ocdbt.py, orbax_ckpt.py, train/checkpoint.py), against the JAX package,
orbax and tensorstore on the CPU at tiny sizes.

* JAX saves, the port reads: the JAX package's save_checkpoint(backend=
  "orbax") of the tiny pretraining state (AdamW, uncertainty balancer) and
  of the cls state (optax.MultiSteps with a device or a host EMA): the
  port's read_orbax equals the JAX `_orbax_restore_payload` on every leaf,
  byte for byte (bf16 included), and tests/test_torch_jax_resume.py's
  checks run on it as they run on a .msgpack: the mapped state bit for bit
  and the next steps against the JAX package's, at that file's tolerances.
* An 8-device sharded save (a subprocess with 8 CPU devices), its kernel
  one chunk per shard in indirect values, reads bit-equal.
* The port saves, JAX reads: the port's orbax save of a stepped state is
  restored by the JAX package's load_checkpoint with no leaf left at its
  template value, and both packages' next steps match;
  tensorstore.ocdbt.dump parses its manifests and nodes and tensorstore's
  OCDBT driver reads every key the port wrote.
* The OCDBT reader against tensorstore's own writes: a B+tree of height 2,
  a version tree (tensorstore.ocdbt.dump is the oracle), zarr v2 arrays of
  every dtype with edge chunks and a missing chunk of a fill value, and
  the whole-frame Zstandard entry's refusals.
* Damage (a missing _METADATA, a truncated node, a flipped CRC byte, a
  deleted data file, a missing chunk with a null fill value, a leaf of
  another shape than the live state's) raises ValueError naming the file
  or the leaf, and auto-resume falls back one epoch; an
  in-progress `*.orbax-checkpoint-tmp-*` directory is never a candidate.
* The committed JAX-written fixtures (tests/fixtures/orbax, one process
  and two processes) read to the SHA-256 of every leaf of the JAX restore,
  inside their size budget.
* Each CLI saves with --ckpt_backend orbax and resumes from it, and
  auto-resumes a JAX-written orbax state.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import tensorstore as ts
import torch

import test_torch_jax_resume as jr
import test_torch_jax_resume_cli as jrc
from multimae_tpu.train import checkpoint as jckpt
from multimae_tpu_torch import native
from multimae_tpu_torch.train import checkpoint as ckpt
from multimae_tpu_torch.utils import ocdbt, orbax_ckpt
from multimae_tpu_torch.utils.flax_msgpack import _NAMES
from test_torch_jax_resume import jax_pretrain  # noqa: F401 (a fixture)

REPO = Path(__file__).resolve().parents[1]
one_torch_thread = jrc.one_torch_thread  # (an autouse fixture: one intra-op thread)
FIXTURES = REPO / "tests" / "fixtures" / "orbax"
SIZE_BUDGET = 150_000


def flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, path + (key,)).items()}
    return {path: tree}


def leaf_bytes(x):
    if torch.is_tensor(x):
        return (list(x.shape), _NAMES[x.dtype],
                x.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.asarray(x)
    return list(a.shape), str(a.dtype), a.tobytes()


def assert_payloads_equal(got, ref):
    """The port's read_orbax against the JAX `_orbax_restore_payload`: every
    leaf's shape, dtype and bytes; the epoch; the extras."""
    got, ref = dict(got), dict(ref)
    assert got.pop("epoch") == ref.pop("epoch")
    extras_got, extras_ref = got.pop("extras", None), ref.pop("extras", None)
    assert (extras_got is None) == (extras_ref is None)
    g, r = flat(got), flat(ref)
    assert set(g) == set(r), sorted(set(g) ^ set(r))[:5]
    for k, v in r.items():
        assert leaf_bytes(g[k]) == leaf_bytes(v), k
    if extras_ref is not None:
        eg, er = flat(extras_got), flat(extras_ref)
        assert set(eg) == set(er)
        for k, v in er.items():
            if isinstance(v, (bytes, str, int, float)):
                assert eg[k] == v, k
            else:
                assert leaf_bytes(eg[k]) == leaf_bytes(v), k


def orbax_save(save):
    """jckpt.save_checkpoint with backend="orbax", whose every save the
    port reads equal to the JAX restore."""

    def wrapped(output_dir, epoch, state, extras=None, args=None, tag=None, backend=None):
        path = save(output_dir, epoch, state, extras=extras, args=args, tag=tag, backend="orbax")
        assert_payloads_equal(orbax_ckpt.read_orbax(path), jckpt._orbax_restore_payload(path))
        return path

    return wrapped


def read_as_jax_payload(path):
    """What read_msgpack gives of a .msgpack, of an orbax save: the pruned
    tree, `step` an int as flax writes it."""
    payload = orbax_ckpt.read_orbax(path)
    payload["step"] = int(payload["step"])
    return payload


# ------------------------------------------------------ JAX saves, port reads --

def test_jax_orbax_pretrain_state_maps_and_the_next_step_matches(jax_pretrain, tmp_path,
                                                                  monkeypatch):
    monkeypatch.setattr(jckpt, "save_checkpoint", orbax_save(jckpt.save_checkpoint))
    monkeypatch.setattr(jr, "read_msgpack", read_as_jax_payload)
    jr.test_optimizer_state_maps_and_the_next_step_matches_jax(jax_pretrain, "adamw", tmp_path)
    assert os.path.isdir(tmp_path / "checkpoint-3.orbax")


@pytest.mark.parametrize("where", ["device", "host"])
def test_jax_orbax_cls_multisteps_state_with_ema_resumes(where, tmp_path, monkeypatch):
    monkeypatch.setattr(jckpt, "save_checkpoint", orbax_save(jckpt.save_checkpoint))
    jr.test_cls_multisteps_state_with_ema_resumes(where, tmp_path)
    meta = json.loads((tmp_path / "checkpoint-0.orbax" / "_METADATA").read_text())
    assert not any("skip_state" in k for k in meta["tree_metadata"])  # pruned by the JAX save
    assert (tmp_path / "checkpoint-0.orbax.extras.msgpack").exists() == (where == "host")


SHARDED = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp, numpy as np, optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from multimae_tpu.train.checkpoint import save_checkpoint
from multimae_tpu.train.train_state import TrainState

assert jax.device_count() == 8
mesh = Mesh(np.asarray(jax.devices()), ("fsdp",))
rng = np.random.default_rng(0)
params = {"w": jax.device_put(rng.standard_normal((64, 1024)).astype(np.float32),
                              NamedSharding(mesh, P("fsdp", None))),
          "h": jax.device_put(jnp.asarray(rng.standard_normal((32, 512)), jnp.bfloat16),
                              NamedSharding(mesh, P(None, "fsdp")))}
state = TrainState.create(params=params, tx=optax.adamw(1e-3))
state = state.apply_gradients(jax.tree.map(lambda p: jnp.full_like(p, 0.25), params))
save_checkpoint(sys.argv[1], 1, state, extras={"data_iter_state": b"pos"}, backend="orbax")
"""


def test_an_8_device_sharded_save_reads_bit_equal(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = str(REPO)
    subprocess.run([sys.executable, "-c", SHARDED, str(tmp_path)], env=env, check=True,
                   timeout=240, capture_output=True)
    path = str(tmp_path / "checkpoint-1.orbax")
    got = orbax_ckpt.read_orbax(path)
    assert_payloads_equal(got, jckpt._orbax_restore_payload(path))
    assert got["params"]["h"].dtype == torch.bfloat16 and int(got["step"]) == 1
    assert got["extras"] == {"data_iter_state": b"pos"}
    store = ocdbt.Store(path)
    chunks = [k for k in store.keys() if k.startswith(b"params.w/") and not k.endswith(b"y")]
    assert chunks == [f"params.w/{i}.0".encode() for i in range(8)]
    assert all(store.entries[k].location.file[0] == "ocdbt.process_0/" for k in chunks)
    assert [k for k in store.keys() if k.startswith(b"params.h/") and b".z" not in k] == [
        f"params.h/0.{i}".encode() for i in range(8)]


# ------------------------------------------------------ port saves, JAX reads --

def test_port_orbax_resumes_in_jax_and_the_next_steps_match(jax_pretrain, tmp_path):
    params0, jstep = jax_pretrain
    state, step = jr.port_pretrain("adamw")
    sds = {"model": jr.jax_params_to_state_dict(params0["model"], jr.PROJ_SHAPES),
           "balancer": {"log_vars": jr.LOG_VARS}}
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in sds["model"].items()})
    state.balancer.load_state_dict({"log_vars": torch.from_numpy(jr.LOG_VARS)})
    jr.port_step(state, step)
    path = ckpt.save_checkpoint(str(tmp_path), 4, state, backend="orbax",
                                data_iter_state={"seed": 0, "epoch": 5, "batch": 0})
    assert path == str(tmp_path / "checkpoint-4.orbax")
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint-4.orbax", "checkpoint-4.orbax.extras.msgpack", "checkpoint-4.orbax.meta.json"]

    sentinel = 7
    template = jr.JTrainState.create(params=jax.tree.map(jr.jnp.asarray, params0),
                                     tx=jr.jax_tx(params0, "adamw"))
    template = jax.tree.map(lambda a: jr.jnp.full_like(a, sentinel), template)
    jstate, epoch, extras = jckpt.load_checkpoint(path, template, with_extras=True)
    assert epoch == 4 and int(jstate.step) == 1
    assert {k: int(v) for k, v in extras["port_loader_state"].items()} == {
        "seed": 0, "epoch": 5, "batch": 0}
    leaves = jax.tree_util.tree_leaves_with_path((jstate.params, jstate.opt_state))
    assert len(leaves) > 100
    left = [jax.tree_util.keystr(p) for p, v in leaves if np.all(np.asarray(v) == sentinel)]
    assert not left, left[:5]
    # what the JAX restore reads is the port's payload, byte for byte
    assert_payloads_equal(orbax_ckpt.read_orbax(path), jckpt._orbax_restore_payload(path))

    init = {k: v.numpy().copy() for k, v in state.model.state_dict().items()}
    jstate, jm = jstep(jstate)
    tm = jr.port_step(state, step)
    jr.assert_metrics_match(tm, jm)
    jr.assert_params_match(state.model.state_dict(),
                           jr.jax_params_to_state_dict(jr.numpy_tree(jstate.params["model"]),
                                                       jr.PROJ_SHAPES), init)


def ts_keys(root):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def test_tensorstore_reads_what_the_port_writes(tmp_path):
    state, _ = jr.port_pretrain("adamw")
    path = ckpt.save_checkpoint(str(tmp_path), 0, state, backend="orbax")
    for root in (path, os.path.join(path, "ocdbt.process_0")):
        base = ts.KvStore.open(f"file://{root}/").result()
        dump = ts.ocdbt.dump(base).result()
        assert dump["config"]["compression"] == {"id": "zstd"}
        (version,) = dump["versions"]
        node = ts.ocdbt.dump(base, version["root"]["location"]).result()
        store = ocdbt.Store(root)
        assert [e["key"] for e in node["entries"]] == list(store.keys())
        assert version["root"]["statistics"]["num_keys"] == len(store.keys()) > 400
        assert ts_keys(root) == {k: store.get(k) for k in store.keys()}
    # each array as tensorstore's zarr driver (libzstd) reads it
    store = ocdbt.Store(path)
    names = [k[:-len(b"/.zarray")].decode() for k in store.keys() if k.endswith(b"/.zarray")]
    context = ts.Context()
    opened = [ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{path}/"},
                       "path": name}, context=context) for name in names]
    reads = [f.result().read() for f in opened]
    for name, ref in zip(names, reads):
        got = orbax_ckpt.read_array(store, name)
        assert leaf_bytes(got)[2] == np.asarray(ref.result()).tobytes(), name


# ----------------------------------------------- OCDBT and zarr vs tensorstore --

def test_crc32c_check_value():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283


def test_a_tensorstore_btree_of_height_2_and_its_versions(tmp_path):
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 2048, "max_inline_value_bytes": 100}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(0)
    values = {f"key{i:05d}/{'x' * (i % 7)}".encode(): rng.bytes(int(rng.integers(0, 300)))
              for i in range(600)}
    for start in range(0, 600, 20):  # 30 commits: the versions spill into a version tree
        with ts.Transaction() as txn:
            for k in list(values)[start:start + 20]:
                kv.with_transaction(txn)[k] = values[k]
    base = ts.KvStore.open(f"file://{tmp_path}/").result()
    dump = ts.ocdbt.dump(base).result()
    newest = dump["versions"][-1]
    assert newest["root_height"] >= 2 and dump["version_tree_nodes"]
    store = ocdbt.Store(str(tmp_path))
    assert {k: store.get(k) for k in store.keys()} == values
    config = ocdbt.read_manifest(str(tmp_path)).config
    assert (config.uuid.hex(), config.max_inline_value_bytes, config.max_decoded_node_bytes,
            config.version_tree_arity_log2, config.compression[0]) == (
        dump["config"]["uuid"], 100, 2048, dump["config"]["version_tree_arity_log2"],
        dump["config"]["compression"]["id"])
    versions = ocdbt.all_versions(str(tmp_path))
    assert [v.generation for v in versions] == list(range(1, newest["generation_number"] + 1))
    last = versions[-1]
    assert (last.root_height, last.num_keys, last.num_tree_bytes, last.num_indirect_value_bytes,
            last.commit_time) == (newest["root_height"], *(
                newest["root"]["statistics"][k] for k in
                ("num_keys", "num_tree_bytes", "num_indirect_value_bytes")),
                newest["commit_time"])
    assert f"btreenode::{last.root.path()}:{last.root.offset}:{last.root.length}" == \
        newest["root"]["location"]


ZARR_CASES = {
    "<f4": np.float32, "bfloat16": None, "<i4": np.int32, "<i8": np.int64, "<u4": np.uint32,
    "|u1": np.uint8, "|b1": np.bool_,
}


@pytest.mark.parametrize("dtype", sorted(ZARR_CASES))
@pytest.mark.parametrize("compressor", ["zstd", "none"])
def test_zarr_edge_chunks_and_fill_values_match_tensorstore(dtype, compressor, tmp_path):
    """A (10, 7) array in (4, 3) chunks (edge chunks past both ends), its
    last column of chunks never written: those take the fill value."""
    rng = np.random.default_rng(1)
    raw = rng.standard_normal((10, 7)) * 1000
    fill = True if dtype == "|b1" else 3
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/"},
            "path": "a.b", "metadata": {
                "shape": [10, 7], "chunks": [4, 3], "dtype": dtype, "fill_value": fill,
                "compressor": {"id": "zstd", "level": 3} if compressor == "zstd" else None},
            "create": True}
    arr = ts.open(spec).result()
    data = (raw > 0) if dtype == "|b1" else raw.astype(ZARR_CASES[dtype] or np.float32)
    if dtype == "bfloat16":
        data = jax.numpy.asarray(data, jax.numpy.bfloat16)
    arr[:, :6].write(np.asarray(data)[:, :6]).result()
    ref = np.asarray(arr.read().result())
    got = orbax_ckpt.read_array(ocdbt.Store(str(tmp_path)), "a.b")
    assert list(got.shape) == [10, 7]
    assert leaf_bytes(got)[2] == ref.tobytes()
    assert b"a.b/0.2" not in ocdbt.Store(str(tmp_path)).keys()


def ts_frame(root, data, level):
    """The Zstandard frame tensorstore's zarr driver (its libzstd) writes of
    `data`, one uint8 chunk compressed at `level`."""
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}/"},
            "path": "v", "create": True, "metadata": {
                "shape": [max(len(data), 1)], "chunks": [max(len(data), 1)], "dtype": "|u1",
                "compressor": {"id": "zstd", "level": level}, "fill_value": None}}
    ts.open(spec).result().write(np.frombuffer(data or b"\0", np.uint8)).result()
    return ocdbt.Store(str(root)).get(b"v/0")


def checksummed(data, checksum):
    """A frame of raw blocks whose header asks for a content checksum, with
    `checksum` (4 bytes) after its last block."""
    raw = ocdbt.RawFrame(data).encoded()
    return raw[:4] + bytes([raw[4] | 4]) + raw[5:] + checksum


REFUSALS = {  # (frame of tensorstore's 12,000 bytes -> (data, size), words)
    "trailing bytes": (lambda f, n: (f + b"\0", n), "bytes after the frame"),
    "second frame": (lambda f, n: (f + f, n), "a second frame"),
    "cut short": (lambda f, n: (f[:-9], n), "the data ends inside the frame"),
    "other size": (lambda f, n: (f, n - 4), "content of another size"),
    "bad checksum": (lambda f, n: (checksummed(b"abc", b"\0\0\0\0"), 3), "checksum"),
    "window past 128 MiB": (lambda f, n: (b"\x28\xb5\x2f\xfd\x00\x90" + b"\0" * 8, 4),
                            "window past libzstd's 128 MiB"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_whole_frame_refusals_name_the_key(case, tmp_path):
    data = np.arange(3000, dtype=np.uint32).tobytes()
    make, words = REFUSALS[case]
    frame, size = make(ts_frame(tmp_path, data, 3), len(data))
    with pytest.raises(ValueError, match=f"f/d: key 'k'.*{words}"):
        native.zstd_frame(frame, size, "f/d: key 'k'")


def test_whole_frames_decode_as_libzstd_writes_them(tmp_path):
    """tensorstore's frames (libzstd's streaming form: no content size) at
    levels 1 and 19, and the port's raw-block frames, which tensorstore
    reads back through its zarr driver (test_tensorstore_reads_what_the_
    port_writes)."""
    rng = np.random.default_rng(2)
    for i, data in enumerate((rng.bytes(5), np.repeat(rng.bytes(400), 700).tobytes(),
                              np.arange(40000, dtype=np.float32).tobytes())):
        for level in (1, 19):
            frame = ts_frame(tmp_path / f"{i}-{level}", data, level)
            assert native.zstd_frame(frame, len(data), "x").tobytes() == data
            assert native.zstd_frame(frame, None, "x", len(data)).tobytes() == data
        frame = ocdbt.RawFrame(data).encoded()
        assert native.zstd_frame(frame, None, "x", len(data)).tobytes() == data
    assert native.zstd_frame(ocdbt.RawFrame(b"").encoded(), 0, "x").size == 0


# ----------------------------------------------------------------- damage --

def _damaged(out, case):
    path = os.path.join(out, "checkpoint-1.orbax")
    proc = os.path.join(path, "ocdbt.process_0")
    if case == "no_metadata":
        os.remove(os.path.join(path, "_METADATA"))
        return "_METADATA"
    if case == "truncated_node":
        (node,) = os.listdir(os.path.join(path, "d"))
        node = os.path.join(path, "d", node)
        with open(node, "r+b") as f:
            f.truncate(os.path.getsize(node) - 100)
        return node
    if case == "flipped_crc":
        manifest = os.path.join(path, "manifest.ocdbt")
        data = bytearray(Path(manifest).read_bytes())
        data[-2] ^= 0x40
        Path(manifest).write_bytes(bytes(data))
        return manifest
    if case == "deleted_data_file":
        (data,) = [n for n in os.listdir(os.path.join(proc, "d"))]
        os.remove(os.path.join(proc, "d", data))
        return data
    raise AssertionError(case)


DAMAGE = ["no_metadata", "truncated_node", "flipped_crc", "deleted_data_file", "missing_chunk",
          "other_shape"]


@pytest.mark.parametrize("case", DAMAGE)
def test_damaged_orbax_save_raises_and_costs_one_epoch(case, tmp_path, monkeypatch, capsys):
    state, step = jr.port_pretrain("adamw", seed=0)
    out = str(tmp_path)
    ckpt.save_checkpoint(out, 0, state, backend="orbax")
    at0 = {k: v.clone() for k, v in state.model.state_dict().items()}
    jr.port_step(state, step)
    if case == "missing_chunk":  # written without one chunk key: fill_value null
        items = orbax_ckpt._items
        gone = b"params.model.encoder_0.mlp.fc1.kernel/0.0"

        def without(tree):
            keys = list(items(tree))
            assert gone in {k for k, _ in keys}
            return iter([(k, v) for k, v in keys if k != gone])

        monkeypatch.setattr(orbax_ckpt, "_items", without)
        ckpt.save_checkpoint(out, 1, state, backend="orbax")
        monkeypatch.undo()
        named = gone.decode()
    elif case == "other_shape":  # whole, but one kernel is not the live state's
        payload = jr.port_state_to_jax(state, 1)
        payload["params"]["model"]["encoder_0"]["mlp"]["fc1"]["kernel"] = torch.zeros(3, 5)
        orbax_ckpt.write_orbax(os.path.join(out, "checkpoint-1.orbax"), payload)
        named = "params/model/encoder_0/mlp/fc1/kernel"
    else:
        ckpt.save_checkpoint(out, 1, state, backend="orbax")
        named = _damaged(out, case)
    fresh, _ = jr.port_pretrain("adamw", seed=9)
    with pytest.raises(ValueError, match=os.path.basename(named)):
        ckpt.read_checkpoint(os.path.join(out, "checkpoint-1.orbax"), fresh)
    start, payload = ckpt.auto_load_checkpoint(out, fresh)
    assert start == 1 and payload["path"] == os.path.join(out, "checkpoint-0.orbax")
    assert all(torch.equal(v, at0[k]) for k, v in fresh.model.state_dict().items())
    assert "checkpoint-1.orbax failed to load (ValueError" in capsys.readouterr().out


def test_an_in_progress_orbax_directory_is_never_a_candidate(tmp_path):
    state, _ = jr.port_pretrain("adamw", seed=0)
    out = str(tmp_path)
    ckpt.save_checkpoint(out, 0, state, backend="orbax")
    shutil.copytree(os.path.join(out, "checkpoint-0.orbax"),
                    os.path.join(out, "checkpoint-1.orbax.orbax-checkpoint-tmp-1792372362"))
    assert ckpt.checkpoint_candidates(out) == [os.path.join(out, "checkpoint-0.orbax")]
    assert jckpt.checkpoint_candidates(out) == [os.path.join(out, "checkpoint-0.orbax")]
    assert ckpt.auto_load_checkpoint(out, jr.port_pretrain("adamw")[0])[0] == 1


@pytest.mark.parametrize("files,want", [
    ({"checkpoint-0.pth": 1, "checkpoint-1.orbax": 2}, "checkpoint-1.orbax"),
    ({"checkpoint-1.orbax": 1, "checkpoint-1.msgpack": 2, "checkpoint-1.pth": 3},
     "checkpoint-1.pth"),
    ({"checkpoint-1.orbax": 1, "checkpoint-1.msgpack": 2}, "checkpoint-1.msgpack"),
], ids=["orbax_newest", "pth_first_at_one_epoch", "msgpack_before_orbax"])
def test_auto_resume_over_orbax_saves(files, want, tmp_path):
    out, at = jr.saves(tmp_path, files)
    state, _ = jr.port_pretrain("adamw", seed=9)
    start, payload = ckpt.auto_load_checkpoint(out, state)
    assert payload["path"] == os.path.join(out, want)
    assert start == int(want.split("-")[1].split(".")[0]) + 1
    assert (state.step, state.updates) == (files[want],) * 2
    assert all(torch.equal(v, at[want][k]) for k, v in state.model.state_dict().items())


# --------------------------------------------------------------- fixtures --

def test_fixtures_stay_inside_their_size_budget():
    size = sum(p.stat().st_size for p in FIXTURES.rglob("*") if p.is_file()
               and "__pycache__" not in p.parts)
    assert size <= SIZE_BUDGET, size


EXPECTED = json.loads((FIXTURES / "expected.json").read_text())


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_committed_jax_fixture_reads_to_its_digests(name):
    want = EXPECTED[name]
    payload = orbax_ckpt.read_orbax(str(FIXTURES / name))
    assert payload.pop("epoch") == want["epoch"]
    extras = payload.pop("extras")
    assert {k: v.decode() for k, v in extras.items()} == want["extras"]
    got = {"/".join(k): leaf_bytes(v) for k, v in flat(payload).items()}
    assert set(got) == set(want["leaves"])
    for k, (shape, dtype, digest) in want["leaves"].items():
        assert got[k][:2] == (shape, dtype), k
        assert hashlib.sha256(got[k][2]).hexdigest() == digest, k


def test_two_process_fixture_spans_two_process_trees():
    path = FIXTURES / "two_process" / "checkpoint-5.orbax"
    store = ocdbt.Store(str(path))
    bases = {v.location.file[0] for v in store.entries.values() if v.location is not None}
    assert bases == {"ocdbt.process_0/", "ocdbt.process_1/"}
    assert orbax_ckpt.read_orbax(str(path), rank=1)["extras"] == {"data_iter_state":
                                                                  b"grain-rank1"}


# -------------------------------------------------------------------- CLIs --

@pytest.mark.parametrize("kind", ["pretrain", "cls", "semseg", "taskonomy", "depth"])
def test_cli_saves_orbax_and_resumes_it(kind, tmp_path):
    """--ckpt_backend orbax writes checkpoint-0.orbax/ and its sidecars; a
    relaunch auto-resumes epoch 1 from it (the pretraining CLI also by
    --resume), its parameters bit-equal to the save's."""
    _, tcli = jrc.CLIS[kind]
    argv = jrc.ARGV[kind] + ["--synthetic_data", "--synthetic_steps_per_epoch", "1",
                             "--num_workers", "0", "--output_dir", str(tmp_path), "--device",
                             "cpu", "--save_ckpt_freq", "1"]
    if kind == "cls":  # one update an epoch under its --update_freq 2
        argv[argv.index("--synthetic_steps_per_epoch") + 1] = "2"
    first = tcli.main(tcli.get_args(argv + ["--epochs", "1", "--ckpt_backend", "orbax"]))
    assert len(first["steps"]) in (1, 2)
    names = set(os.listdir(tmp_path))
    assert {"checkpoint-0.orbax", "checkpoint-0.orbax.meta.json"} <= names
    assert not any(n.endswith(".pth") for n in names)
    relaunch = argv + ["--epochs", "2"]
    if kind == "pretrain":
        relaunch += ["--resume", str(tmp_path / "checkpoint-0.orbax")]
    again = tcli.main(tcli.get_args(relaunch))
    assert again["start_epoch"] == 1 and again["resume_bit_equal"]
    assert again["resumed_from"] == str(tmp_path / "checkpoint-0.orbax")
    assert [r["epoch"] for r in again["steps"]] == [1] * len(first["steps"])


@pytest.mark.parametrize("kind", ["pretrain", "cls"])
def test_cli_resumes_a_jax_written_orbax_state(kind, tmp_path, capsys):
    """tests/test_torch_jax_resume_cli.py's JAX-written state (one update of
    small fixed gradients) saved as checkpoint-2.orbax: the CLI
    auto-resumes epoch 3 from it and takes finite steps. (pretrain: the
    parameter-free balancer's subtrees pruned; cls: MultiSteps's pruned
    skip_state and the host EMA in .extras.msgpack. The dense fine-tunes
    share the loop of the port-written case below.)"""
    jcli, tcli = jrc.CLIS[kind]
    argv = jrc.ARGV[kind] + ["--epochs", "4", "--synthetic_data", "--synthetic_steps_per_epoch",
                             "2", "--num_workers", "0", "--output_dir", str(tmp_path)]
    state, host = jrc.jax_state(kind, jcli.get_args(argv))
    grads = jax.tree.map(lambda p: jax.numpy.full_like(p, 1e-2), state.params)
    state = state.apply_gradients(grads, ema_decay=0.9 if state.ema_params is not None else None)
    extras = None
    if host is not None:
        host.update(state.params)
        extras = {"ema_params": host.params}
    jckpt.save_checkpoint(str(tmp_path), 2, state, extras=extras, backend="orbax")

    run = tcli.main(tcli.get_args(argv + ["--device", "cpu"]))
    out = capsys.readouterr().out
    assert run["start_epoch"] == 3 and run["resumed_from"] == str(tmp_path / "checkpoint-2.orbax")
    assert "checkpoint-2.orbax holds no data position the port reads" in out
    assert [r["epoch"] for r in run["steps"]] == [3, 3]
    assert all(np.isfinite(list(r["metrics"].values())).all() for r in run["steps"])
    assert ("a .orbax keeps no best" in out) == (kind != "pretrain")
