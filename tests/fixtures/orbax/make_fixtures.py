"""Orbax checkpoints written by the JAX package's own save_checkpoint
(backend="orbax", multimae_tpu/train/checkpoint.py `_save_orbax`), for the
port's reader (multimae_tpu_torch/utils/orbax_ckpt.py) to hold against on a
machine without JAX, orbax or tensorstore.

    python tests/fixtures/orbax/make_fixtures.py   # needs JAX, optax, orbax

* one_process/checkpoint-3.orbax (+ .meta.json, .extras.msgpack): one
  process of 8 CPU devices, 64 bit types on. Its TrainState (optax.adam)
  holds a (64, 48) float32 kernel sharded over the 8 devices (8 chunks of
  1.5 KiB, past OCDBT's 1 KiB of inline bytes: indirect values), a bf16
  and a float32 bias, and batch_stats of bool, uint8, uint32 and int64.
* two_process/checkpoint-5.orbax (+ .meta.json, .proc0/.proc1.msgpack): two
  jax.distributed processes of 4 devices each, a (32, 96) float32 kernel
  sharded over all 8, so that each process writes its own
  ocdbt.process_<k>/ tree under one root manifest; each rank's extras go
  to its own sidecar.

expected.json holds, for each, the epoch and every leaf's shape, dtype and
the SHA-256 of its bytes as the JAX package's own restore
(`_orbax_restore_payload`) gives them, and the extras of rank 0 (the
`.proc0` sidecar where there is one, as the JAX load prefers it).
The directory stays under SIZE_BUDGET bytes (tests/test_torch_orbax.py).
"""

import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
SIZE_BUDGET = 150_000
SAVES = {"one_process/checkpoint-3.orbax": 3, "two_process/checkpoint-5.orbax": 5}


def _jax(devices, x64=False):
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    sys.path.insert(0, REPO)
    import jax

    jax.config.update("jax_platforms", "cpu")
    if x64:
        jax.config.update("jax_enable_x64", True)
    return jax


def one_process():
    jax = _jax(8, x64=True)
    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from multimae_tpu.train.checkpoint import save_checkpoint
    from multimae_tpu.train.train_state import TrainState

    mesh = Mesh(np.asarray(jax.devices()), ("data",))
    rng = np.random.default_rng(3)
    params = {
        "kernel": jax.device_put(rng.standard_normal((64, 48)).astype(np.float32),
                                 NamedSharding(mesh, P("data", None))),
        "bias": jnp.asarray(rng.standard_normal(48).astype(np.float32)),
        "scale": jnp.asarray(rng.standard_normal(5), jnp.bfloat16)}
    state = TrainState.create(params=params, tx=optax.adam(1e-2))
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.5), params)
    state = state.apply_gradients(grads)
    state = state.replace(batch_stats={
        "mask": np.arange(7) % 3 == 0, "hist": np.arange(9, dtype=np.uint8) * 20,
        "ids": np.arange(4, dtype=np.uint32) * 2**30, "total": np.asarray(2**40 + 7, np.int64)})
    save_checkpoint(os.path.join(HERE, "one_process"), 3, state,
                    extras={"data_iter_state": b"grain-one"}, backend="orbax")


def two_process(rank):
    jax = _jax(4)
    from multimae_tpu.parallel import mesh as mesh_lib

    mesh_lib.initialize_distributed()
    import numpy as np
    import optax
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from multimae_tpu.train.checkpoint import save_checkpoint
    from multimae_tpu.train.train_state import TrainState

    assert jax.process_count() == 2 and jax.device_count() == 8
    mesh = mesh_lib.create_mesh()
    full = np.random.default_rng(5).standard_normal((32, 96)).astype(np.float32)
    w = jax.make_array_from_callback(full.shape, NamedSharding(mesh, P("data", None)),
                                     lambda idx: full[idx])
    assert not w.is_fully_addressable
    state = TrainState.create(params={"w": w}, tx=optax.sgd(0.1, momentum=0.9))
    save_checkpoint(os.path.join(HERE, "two_process"), 5, state,
                    extras={"data_iter_state": f"grain-rank{rank}".encode()}, backend="orbax")
    multihost_utils.sync_global_devices("orbax fixture written")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SLURM_", "OMPI_", "JAX_")) and k not in ("XLA_FLAGS",)}
    env["PYTHONPATH"] = REPO
    return env


def expected():
    """{save: {"epoch", "leaves": {"a/b": [shape, dtype, sha256]}, "extras"}} from
    the JAX package's restore."""
    _jax(1)
    import numpy as np

    from multimae_tpu.train.checkpoint import _orbax_restore_payload

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, path + (k,))
        else:
            yield "/".join(path), tree

    out = {}
    for name, epoch in SAVES.items():
        path = os.path.join(HERE, name)
        payload = _orbax_restore_payload(path)
        assert payload.pop("epoch") == epoch
        extras = payload.pop("extras", None)
        proc0 = path[:-len(".orbax")] + ".proc0.msgpack"
        if os.path.exists(proc0):
            import flax.serialization

            with open(proc0, "rb") as f:
                extras = flax.serialization.msgpack_restore(f.read())
        leaves = {}
        for k, v in flat(payload):
            a = np.asarray(v)
            leaves[k] = [list(a.shape), str(a.dtype), hashlib.sha256(a.tobytes()).hexdigest()]
        out[name] = {"epoch": epoch, "leaves": leaves,
                     "extras": {k: v.decode() for k, v in extras.items()}}
    return out


def main():
    if len(sys.argv) > 1:
        {"one": lambda: one_process(), "two": lambda: two_process(int(sys.argv[2]))}[
            sys.argv[1]]()
        return
    for d in ("one_process", "two_process"):
        shutil.rmtree(os.path.join(HERE, d), ignore_errors=True)
    subprocess.run([sys.executable, __file__, "one"], env=_env(), check=True)
    port, procs = _port(), []
    for rank in range(2):
        env = _env()
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES="2",
                   JAX_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen([sys.executable, __file__, "two", str(rank)], env=env))
    if any(p.wait(timeout=300) for p in procs):
        raise SystemExit("the two-process save failed")
    # the sidecar args.json is the CLIs' and holds nothing here
    for d in ("one_process", "two_process"):
        args = os.path.join(HERE, d, "args.json")
        if os.path.exists(args):
            os.remove(args)
    with open(os.path.join(HERE, "expected.json"), "w") as f:
        json.dump(expected(), f, indent=1, sort_keys=True)
        f.write("\n")
    size = sum(os.path.getsize(os.path.join(r, n)) for r, _, ns in os.walk(HERE) for n in ns)
    print(f"tests/fixtures/orbax: {size} bytes (budget {SIZE_BUDGET})")
    if size > SIZE_BUDGET:
        raise SystemExit("over the size budget")


if __name__ == "__main__":
    main()
