"""The JAX package's orbax checkpoint, `checkpoint-{epoch}.orbax/`, read
and written without orbax, tensorstore or zarr (counterpart of
multimae_tpu/train/checkpoint.py `_save_orbax` and `_orbax_restore_payload`).

orbax's StandardCheckpointer (0.11) writes a directory:

    _METADATA                JSON: "tree_metadata" maps each leaf's key path
                             ("('params', 'w')") to its "key_metadata" (the
                             keys, key_type 2 for a dict key) and
                             "value_metadata"; "use_ocdbt": true,
                             "use_zarr3": false
    _CHECKPOINT_METADATA     JSON: the handler and the commit's timestamps
    manifest.ocdbt, d/       the OCDBT database (utils/ocdbt.py) that holds
    ocdbt.process_<k>/       the arrays; each process writes its own and the
                             root one points into theirs
    _sharding, array_metadatas/
                             each jax.Array's sharding (not read: a restore
                             here is topology-free, as the JAX one is)

and `_save_orbax` adds `{path}.meta.json` ({"epoch": N}) and
`{path}.extras.msgpack` beside it, and, under several processes, each rank's
extras in `checkpoint-{epoch}.proc{k}.msgpack`.

Each leaf is a zarr v2 array under the key of its dotted name
("params.w/.zarray", the JSON metadata, and "params.w/0.0", its chunks,
C order, indices joined by "."; a scalar's one chunk is "step/0"). A save
of an array sharded over devices holds one chunk per shard; zarr stores an
edge chunk whole, past the array's end. The chunks are Zstandard frames
("compressor": {"id": "zstd"}) or raw bytes ("compressor": null); a missing
chunk takes "fill_value", and where that is null it is damage. The dtypes
are numpy's ("<f4", "<i4", "|u1", "|b1", ...) and "bfloat16", read as
torch.bfloat16 bit for bit.

`read_orbax` returns the payload `_orbax_restore_payload` returns: the
tree as the JAX package saved it (empty subtrees pruned, `_prune_empty`),
its leaves torch tensors on the CPU, with `epoch` and `extras`.
`write_orbax` writes a payload of `utils/jax_state.port_state_to_jax` as
one process's save (utils/ocdbt.write_database), in a temporary directory
(`{path}.orbax-checkpoint-tmp-<ns>`, orbax's form of the name) renamed into
place, then the two sidecars as `_save_orbax` writes them. Anything this
reader does not take (zarr v3, a tree not stored in OCDBT, a list in the
tree, an unknown dtype, compressor or filter) raises ValueError naming the
file and the key.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from multimae_tpu_torch import native
from multimae_tpu_torch.utils import ocdbt
from multimae_tpu_torch.utils.flax_msgpack import msgpack_serialize, read_msgpack

HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
TMP_MARK = ".orbax-checkpoint-tmp-"
_DICT_KEY = 2  # orbax's KeyType.DICT

# zarr v2 dtype -> torch dtype: those of the JAX package's training states
ZARR_DTYPES = {
    "<f4": torch.float32, "bfloat16": torch.bfloat16, "<i4": torch.int32, "<i8": torch.int64,
    "<u4": torch.uint32, "|u1": torch.uint8, "|b1": torch.bool,
}
_ZARR_NAMES = {v: k for k, v in ZARR_DTYPES.items()}


# ----------------------------------------------------------------- zarr v2 --

def _fill(value: Any, dtype: torch.dtype, what: str) -> Any:
    if isinstance(value, str):
        special = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}
        if value not in special or not dtype.is_floating_point:
            raise ValueError(f"{what}: fill_value {value!r}")
        return special[value]
    if isinstance(value, (bool, int, float)):
        return value
    raise ValueError(f"{what}: fill_value {value!r}")


def read_array(store: ocdbt.Store, name: str) -> torch.Tensor:
    """The zarr v2 array `name` of an OCDBT store, as a CPU tensor."""
    what = f"{store.root}: {name}"
    try:
        meta = json.loads(store.get(f"{name}/.zarray".encode()))
    except json.JSONDecodeError as e:
        raise ValueError(f"{what}/.zarray: not JSON ({e})") from e
    if not isinstance(meta, dict) or meta.get("zarr_format") != 2:
        raise ValueError(f"{what}/.zarray: not zarr v2 metadata")
    dtype = ZARR_DTYPES.get(meta.get("dtype"))
    if dtype is None:
        raise ValueError(f"{what}/.zarray: dtype {meta.get('dtype')!r} is not read")
    shape, chunks = meta.get("shape"), meta.get("chunks")
    if (not isinstance(shape, list) or not isinstance(chunks, list) or len(shape) != len(chunks)
            or not all(type(s) is int and s >= 0 for s in shape)
            or not all(type(c) is int and c > 0 for c in chunks)):
        raise ValueError(f"{what}/.zarray: shape {shape} and chunks {chunks}")
    if meta.get("order", "C") != "C" or meta.get("filters") is not None:
        raise ValueError(f"{what}/.zarray: order {meta.get('order')!r} and filters "
                         f"{meta.get('filters')!r} (C order and no filters are read)")
    compressor = meta.get("compressor")
    if compressor is not None and (not isinstance(compressor, dict)
                                   or compressor.get("id") != "zstd"):
        raise ValueError(f"{what}/.zarray: compressor {compressor!r} (zstd or none are read)")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"{what}/.zarray: dimension_separator "
                         f"{meta['dimension_separator']!r} ('.' is read)")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    out: Optional[torch.Tensor] = None
    for index in np.ndindex(*grid):
        key = f"{name}/{'.'.join(map(str, index)) if index else '0'}".encode()
        where = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        if key not in store:
            if meta.get("fill_value") is None:
                raise ValueError(f"{store.root}: chunk {key.decode()} is missing and "
                                 "fill_value is null")
            if out is None:
                out = torch.empty(shape, dtype=dtype)
            out[where] = _fill(meta["fill_value"], dtype, f"{what}/.zarray")
            continue
        data = store.get(key)
        chunk_what = f"{store.root}: chunk {key.decode()}"
        if compressor is None:
            if len(data) != chunk_bytes:
                raise ValueError(f"{chunk_what}: {len(data)} bytes, {chunk_bytes} wanted")
            raw = np.frombuffer(bytearray(data), np.uint8)
        else:
            raw = native.zstd_frame(data, chunk_bytes, chunk_what)
        chunk = torch.from_numpy(raw).view(dtype).reshape(chunks)
        if grid == [1] * len(shape) and list(chunks) == list(shape):
            return chunk
        if out is None:
            out = torch.empty(shape, dtype=dtype)
        out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    return out if out is not None else torch.empty(shape, dtype=dtype)


def zarray(t: torch.Tensor) -> bytes:
    """The .zarray tensorstore writes for `t` in one chunk."""
    shape = list(t.shape)
    meta = {"chunks": [max(s, 1) for s in shape], "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": _ZARR_NAMES[t.dtype], "fill_value": None,
            "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


# ------------------------------------------------------------------- trees --

def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def prune_empty(tree: Any) -> Any:
    """`_prune_empty` of the JAX package: empty dict subtrees dropped."""
    if isinstance(tree, dict):
        out = {k: prune_empty(v) for k, v in tree.items()}
        return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}
    return tree


def orbax_tree(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The tree `_save_orbax` stores for a JAX payload: params, opt_state,
    step (an int32 scalar), ema_params and batch_stats where present, empty
    subtrees pruned; the epoch and extras go to the sidecars."""
    tree = {"params": payload["params"], "opt_state": payload["opt_state"],
            "step": torch.tensor(int(payload["step"]), dtype=torch.int32)}
    for k in ("ema_params", "batch_stats"):
        if payload.get(k) is not None:
            tree[k] = payload[k]
    return prune_empty(tree)


def _put(tree: Dict[str, Any], path: List[str], leaf: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _sidecar_epoch(path: str) -> int:
    meta = path + ".meta.json"
    if os.path.exists(meta):
        try:
            with open(meta) as f:
                return int(json.load(f)["epoch"])
        except (ValueError, KeyError, TypeError) as e:
            raise ValueError(f"{meta}: no epoch ({e})") from e
    m = re.search(r"checkpoint-(\d+)\.orbax$", path)
    return int(m.group(1)) if m else 0


def read_orbax(path: str, rank: int = 0) -> Dict[str, Any]:
    """The payload of the orbax checkpoint directory `path`, as the JAX
    `_orbax_restore_payload` gives it, leaves as CPU tensors; `extras` from
    rank `rank`'s `.proc{rank}.msgpack` where there is one."""
    path = os.path.abspath(path).rstrip(os.sep)
    meta_path = os.path.join(path, "_METADATA")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except OSError as e:
        raise ValueError(f"{meta_path}: {e.strerror or e} (not a committed orbax "
                         "checkpoint)") from e
    except json.JSONDecodeError as e:
        raise ValueError(f"{meta_path}: not JSON ({e})") from e
    if not isinstance(meta, dict) or not isinstance(meta.get("tree_metadata"), dict):
        raise ValueError(f"{meta_path}: no tree_metadata")
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", False):
        raise ValueError(f"{meta_path}: use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 "
                         f"{meta.get('use_zarr3')} (OCDBT with zarr v2 is read)")
    store = ocdbt.Store(path)
    payload: Dict[str, Any] = {}
    for entry, item in meta["tree_metadata"].items():
        value = item.get("value_metadata") or {}
        if value.get("skip_deserialize"):
            continue
        keys = item.get("key_metadata")
        if not keys or any(not isinstance(k, dict) or k.get("key_type") != _DICT_KEY
                           or not isinstance(k.get("key"), str) for k in keys):
            raise ValueError(f"{meta_path}: {entry}: {keys!r} (dict keys alone are read)")
        names = [k["key"] for k in keys]
        _put(payload, names, read_array(store, ".".join(names)))
    payload["epoch"] = _sidecar_epoch(path)
    extras = path + ".extras.msgpack"
    if os.path.exists(extras):
        payload["extras"] = read_msgpack(extras)
    stem = path[:-len(".orbax")] if path.endswith(".orbax") else path
    own = f"{stem}.proc{rank}.msgpack"
    if os.path.exists(own):
        payload["extras"] = read_msgpack(own)
    return payload


def _items(tree: Dict[str, Any]) -> Iterator[Tuple[bytes, Any]]:
    """The OCDBT items of a tree's leaves, in key order."""
    keys = []
    for path, leaf in _leaves(tree):
        if not torch.is_tensor(leaf):
            raise ValueError(f"{'/'.join(path)}: {type(leaf).__name__}, not a tensor")
        if leaf.dtype not in _ZARR_NAMES:
            raise ValueError(f"{'/'.join(path)}: dtype {leaf.dtype} has no zarr name")
        name = ".".join(path)
        keys.append((f"{name}/.zarray".encode(), leaf, None))
        if leaf.numel():
            keys.append((f"{name}/{'.'.join('0' * leaf.dim()) or '0'}".encode(), leaf, True))
    keys.sort(key=lambda k: k[0])
    for key, leaf, chunk in keys:
        if chunk is None:
            yield key, zarray(leaf)
        else:
            data = leaf.detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy()
            yield key, ocdbt.RawFrame(data)


def _tree_metadata(tree: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for path, _ in _leaves(tree):
        out[repr(tuple(path))] = {
            "key_metadata": [{"key": k, "key_type": _DICT_KEY} for k in path],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
    return out


def _write_json(path: str, obj: Any) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def write_orbax(path: str, payload: Dict[str, Any]) -> str:
    """Write `payload` (a JAX training payload: params, opt_state, step,
    epoch, and ema_params, batch_stats and extras where present) as the
    orbax checkpoint directory `path` with its sidecars; returns `path`."""
    path = os.path.abspath(path).rstrip(os.sep)
    tree = orbax_tree(payload)
    started = time.time_ns()
    tmp = f"{path}{TMP_MARK}{started}"
    os.makedirs(tmp)
    try:
        ocdbt.write_database(tmp, _items(tree))
        _write_json(os.path.join(tmp, "_METADATA"), {
            "tree_metadata": _tree_metadata(tree), "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
        _write_json(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
            "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}})
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _write_json(path + ".meta.json", {"epoch": int(payload["epoch"])})
    extras = path + ".extras.msgpack"
    if payload.get("extras"):
        with open(extras + ".tmp", "wb") as f:
            f.write(msgpack_serialize(payload["extras"]))
        os.replace(extras + ".tmp", extras)
    elif os.path.exists(extras):  # an earlier save's under this name
        os.remove(extras)
    return path
