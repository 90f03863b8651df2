"""flax's msgpack checkpoint format, in pure Python (counterpart of
`flax.serialization.msgpack_restore` / `msgpack_serialize`, flax 0.12;
the JAX package saves `checkpoint-{epoch}.msgpack` with them,
multimae_tpu/train/checkpoint.py).

The card machine has neither `msgpack` nor `flax` nor `ml_dtypes`, so the
subset of msgpack that flax writes is read and written here:
  * maps, arrays, str, bin, ints (up to uint64 and int64), float32/64,
    bool and nil;
  * ext 1, an ndarray: the msgpack array (shape, dtype name, raw C-order
    bytes), read as a tensor that shares the file's buffer
    (`torch.frombuffer`): no leaf is copied, and no byte is looped over in
    Python, which matters for a ViT-B pretraining checkpoint with its
    optimizer state (over 1 GB);
  * ext 2, a Python complex: the msgpack array (real, imag);
  * ext 3, a numpy scalar: an ndarray of shape (), read as a 0-d tensor;
  * flax's chunked arrays: a leaf past `MAX_CHUNK_SIZE` bytes is written as
    {"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
    {"0": flat array, ...}} and comes back whole (that leaf is copied once).

`msgpack_serialize(tree)` writes what flax writes for the same tree, byte
for byte: dicts (keys sorted, as flax's copy of the tree sorts them), lists, str, bytes, int, float, bool,
None, complex, torch tensors and numpy arrays (ext 1) and numpy scalars
(ext 3). Tuples are refused, as flax's packer (strict types) refuses them.
Dtype names are numpy's ("float32", "bfloat16", "int64", "bool", ...); a
name the reader does not know raises ValueError naming it. Arrays are in
the machine's byte order, as flax writes them.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: leaves above it are written in chunks.
MAX_CHUNK_SIZE = 2**30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

_DTYPES = {
    "float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float64": torch.float64, "complex64": torch.complex64, "complex128": torch.complex128,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint8": torch.uint8, "uint16": torch.uint16, "uint32": torch.uint32,
    "uint64": torch.uint64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> int:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError(f"msgpack data truncated at byte {start} (wants {n} more)")
        return start

    def unpack(self, fmt: str):
        return struct.unpack_from(fmt, self.buf, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        start = self.take(n)
        return str(self.buf[start:start + n], "utf-8")

    def read(self) -> Any:
        b = self.buf[self.take(1)]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array_(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            start = self.take(n)
            return bytes(self.buf[start:start + n])
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        fmt = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}.get(b)
        if fmt:
            return self.unpack(fmt)
        if b in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self.array_(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02X} at {self.pos - 1} is not one flax writes")

    def map_(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def array_(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def ext(self, code: int, n: int) -> Any:
        start = self.take(n)
        end = self.pos
        if code == _EXT_COMPLEX:
            self.pos = start
            real, imag = self.read()
            self.pos = end
            return complex(real, imag)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not one flax writes")
        self.pos = start
        # flax packs (shape, dtype name, buffer) with use_bin_type: an array
        # of 3, the name as str, the bytes as bin.
        head = self.buf[self.take(1)]
        if head != 0x93:
            raise ValueError(f"an ndarray ext at {start} does not hold (shape, dtype, bytes)")
        shape = self.read()
        name = self.read()
        b = self.buf[self.take(1)]
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError(f"an ndarray ext at {start} holds no bytes")
        nbytes = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
        offset = self.take(nbytes)
        if self.pos != end:
            raise ValueError(f"an ndarray ext at {start} is {n} bytes, its parts "
                             f"{self.pos - start}")
        dtype = _DTYPES.get(name)
        if dtype is None:
            raise ValueError(f"ndarray dtype {name!r} is not one the port reads "
                             f"({', '.join(sorted(_DTYPES))})")
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        item = torch.empty((), dtype=dtype).element_size()
        if count * item != nbytes:
            raise ValueError(f"an ndarray of shape {shape} and dtype {name} in {nbytes} bytes")
        if count == 0:
            arr = torch.empty(shape, dtype=dtype)
        else:
            arr = torch.frombuffer(self.buf, dtype=dtype, count=count,
                                   offset=offset).reshape(shape)
        return arr.reshape(()) if code == _EXT_NPSCALAR else arr


def _unchunk(tree: Any) -> Any:
    """flax's `_unchunk_array_leaves_in_place`: a chunked leaf at the top
    or as a dict value comes back as one tensor."""
    def whole(d):
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)

    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return whole(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                tree[k] = whole(v) if _CHUNKED in v else _unchunk(v)
    return tree


def msgpack_restore(data) -> Any:
    """bytes, bytearray or memoryview of a flax msgpack file -> the tree,
    with ndarray leaves as tensors on the CPU that share `data`'s memory
    (a read-only buffer is copied once, whole, so that they can)."""
    buf = memoryview(data)
    if buf.readonly:
        buf = memoryview(bytearray(buf))
    buf = buf.cast("B")
    reader = _Reader(buf)
    tree = reader.read()
    if reader.pos != len(buf):
        raise ValueError(f"{len(buf) - reader.pos} bytes after the msgpack object")
    return _unchunk(tree)


def read_msgpack(path: str) -> Any:
    """`msgpack_restore` of a file, read once into a writable buffer."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        buf = bytearray(f.tell())
        f.seek(0)
        f.readinto(buf)
    return msgpack_restore(buf)


# --- writing -------------------------------------------------------------------


def _pack_len(out: List[bytes], n: int, fix: int, fix_max: int, codes) -> None:
    if fix is not None and n <= fix_max:
        out.append(bytes([fix | n]))
    elif n < 1 << 8 and codes[0] is not None:
        out.append(bytes([codes[0], n]))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", codes[1], n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"a msgpack object of {n} entries or bytes")


def _pack_int(out: List[bytes], v: int) -> None:
    if 0 <= v < 0x80:
        out.append(bytes([v]))
    elif -32 <= v < 0:
        out.append(bytes([v & 0xFF]))
    elif 0x80 <= v <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, v))
    elif -0x80 <= v < 0:
        out.append(struct.pack(">Bb", 0xD0, v))
    elif 0xFF < v <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, v))
    elif -0x8000 <= v < -0x80:
        out.append(struct.pack(">Bh", 0xD1, v))
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, v))
    elif -0x80000000 <= v < -0x8000:
        out.append(struct.pack(">Bi", 0xD2, v))
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, v))
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _pack_bin(out: List[bytes], b) -> None:
    _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
    out.append(b)


def _pack_str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    out.append(b)


def _array_parts(x) -> tuple:
    """(shape, dtype name, raw bytes) of a tensor or numpy array."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor dtype {t.dtype} has no numpy name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        return tuple(t.shape), _NAMES[t.dtype], raw
    a = np.asarray(x)
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes have no msgpack form")
    return a.shape, a.dtype.name, a.tobytes("C")


def _pack_ext(out: List[bytes], code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fixed:
        out.append(struct.pack(">Bb", fixed, code))
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
    out.append(payload)


def _ndarray_payload(x) -> bytes:
    shape, name, raw = _array_parts(x)
    inner: List[bytes] = [b"\x93"]
    _pack_len(inner, len(shape), 0x90, 15, (None, 0xDC, 0xDD))
    for d in shape:
        _pack_int(inner, int(d))
    _pack_str(inner, name)
    _pack_bin(inner, raw)
    return b"".join(inner)


def _pack(out: List[bytes], x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is str:
        _pack_str(out, x)
    elif type(x) in (bytes, bytearray, memoryview):
        _pack_bin(out, bytes(x))
    elif type(x) is dict:
        _pack_len(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif type(x) is list:
        _pack_len(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(np.asarray(x)))
    elif type(x) is complex:
        inner: List[bytes] = [b"\x92"]
        _pack(inner, x.real)
        _pack(inner, x.imag)
        _pack_ext(out, _EXT_COMPLEX, b"".join(inner))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__} (flax's packer refuses it too)")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> Dict[str, Any]:
    """flax's `_chunk`: a flat array in pieces of MAX_CHUNK_SIZE bytes."""
    item = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / item))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _chunk_leaves(tree: Any) -> Any:
    """flax's `_chunk_array_leaves_in_place`, on a copy of the dicts: the
    top and dict values only, as flax does."""
    def big(v):
        return isinstance(v, (torch.Tensor, np.ndarray)) and _nbytes(v) > MAX_CHUNK_SIZE

    if isinstance(tree, dict):
        return {k: (_chunk(v) if big(v) else _chunk_leaves(v) if isinstance(v, dict) else v)
                for k, v in tree.items()}
    return _chunk(tree) if big(tree) else tree


def _sorted(tree: Any) -> Any:
    """The copy flax's `jax.tree_util.tree_map` makes: every dict's keys in
    sorted order."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """The tree as flax's `msgpack_serialize` writes it, byte for byte
    (dict keys sorted, as flax's copy of the tree sorts them)."""
    out: List[bytes] = []
    _pack(out, _chunk_leaves(_sorted(tree)))
    return b"".join(out)
