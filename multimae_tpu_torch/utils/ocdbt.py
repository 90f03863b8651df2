"""tensorstore's OCDBT key-value store, in Python: the storage
under an orbax checkpoint (utils/orbax_ckpt.py), read and written without
tensorstore.

An OCDBT database is a directory. `manifest.ocdbt` names the versions of
one B+tree; the tree's nodes and its large values live in data files under
`d/` (or, for a tree orbax merged from its processes' trees, under
`ocdbt.process_<k>/d/`, which the root tree's nodes name). Every manifest
and node is an encoded file:

    magic            uint32, big-endian: 0x0cdb3a2a manifest, 0x0cdb20de
                     B+tree node, 0x0cdb1234 version tree node
    length           uint64, little-endian: the whole encoding's bytes
    version          varint, 0
    compression      varint: 0 none, 1 Zstandard (one frame)
    body             (compressed)
    crc32c           uint32, little-endian: CRC-32C of everything before

Varints are LEB128 (7 bits a byte, low first). Lists are stored as arrays
of fields, one field of every element before the next field. A data file
table (`_files`) opens every body past the manifest's config: the paths,
each as (shared prefix with the path before, suffix, length of its base
path), so that a path is base path + relative path, both under the
database's directory.

    manifest body    config: uuid[16], manifest_kind varint (0, the one
                     file), max_inline_value_bytes, max_decoded_node_bytes
                     varints, version_tree_arity_log2 byte, compression
                     varint (1: zstd, then its level, int32 little-endian);
                     a data file table; the newest versions (a version
                     tree leaf's arrays); the version tree nodes that hold
                     the older ones: generation, data file, offset, length,
                     number of generations, commit time (uint64), height
    version          generation, root height (byte), root node's data file,
                     offset and length (an empty tree: data file 0, offset
                     and length 2**64 - 1), its statistics (number of keys,
                     bytes of tree nodes, bytes of indirect values), commit
                     time (uint64 ns)
    B+tree node      height (byte), a data file table, the number of
                     entries, each key's prefix shared with the key before
                     (from the second), each suffix's length, at a height
                     above 0 each child's subtree-common-prefix length, the
                     suffixes. A leaf then has each value's length, its kind
                     (byte: 0 inline, 1 indirect), the indirect values' data
                     files and offsets, and the inline values' bytes; an
                     interior node each child's data file, offset and length
                     and its statistics. A child's keys are stored without
                     the subtree-common prefix of the entry that points at
                     it, which is a prefix of the entry's key.
    version node     version_tree_arity_log2 (byte), height (byte), a data
                     file table, the number of entries, then versions (at
                     height 0) or the manifest's version tree node fields
                     less the height (above it).

The reader checks every header, length and CRC, that keys are increasing
and that the statistics agree with what the tree holds; anything else,
a missing data file, a value past its file's end, raises ValueError naming
the file and the key. The writer writes what orbax 0.11 writes for one
process: a tree of one leaf node under `ocdbt.process_0/`, its large values
(past max_inline_value_bytes) in one data file there, and the root
database's leaf in `d/` with the same keys, whose large values point into
`ocdbt.process_0/d/`. Its Zstandard frames are raw blocks, which every
Zstandard decoder reads, so nothing is compressed and no compressor is
needed.
"""

from __future__ import annotations

import io
import os
import struct
import time
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, Iterable, List, Optional, Tuple, Union

from multimae_tpu_torch import native

MANIFEST_MAGIC, BTREE_MAGIC, VERSION_MAGIC = 0x0CDB3A2A, 0x0CDB20DE, 0x0CDB1234
_HEADER = 14  # magic, length, and the one-byte version and compression varints
MISSING = 2**64 - 1  # offset and length of an empty tree's root
MAX_INLINE_VALUE_BYTES = 1024  # orbax 0.11's settings
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
RAW_BLOCK = 128 * 1024  # Zstandard's largest block

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C (Castagnoli, reflected, as RFC 3720 and tensorstore use it)."""
    table = _CRC_TABLE
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ------------------------------------------------------------------ reading --

class _Cursor:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError(f"{self.what}: the body ends {self.pos + n - len(self.buf)} bytes "
                             "short")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            if shift > 63:
                raise ValueError(f"{self.what}: a varint past 64 bits")
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack_from(f"<{n}Q", self.take(8 * n)))

    def done(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError(f"{self.what}: {len(self.buf) - self.pos} bytes after the body")


@dataclass
class Config:
    uuid: bytes
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: Optional[Tuple[str, int]]  # ("zstd", level) or None


@dataclass(frozen=True)
class Location:
    file: Tuple[str, str]  # (base path, relative path) under the database
    offset: int
    length: int

    def path(self) -> str:
        return self.file[0] + self.file[1]


@dataclass
class Version:
    generation: int
    root_height: int
    root: Optional[Location]  # None: the empty tree
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int


@dataclass
class VersionNodeRef:
    generation: int
    location: Location
    num_generations: int
    commit_time: int
    height: int


@dataclass
class Manifest:
    config: Config
    versions: List[Version]
    version_nodes: List[VersionNodeRef] = field(default_factory=list)


def decode(data: bytes, magic: int, what: str, limit: int = MAX_DECODED_NODE_BYTES) -> bytes:
    """The body of one encoded manifest or node, its header and CRC checked."""
    if len(data) < _HEADER + 4:
        raise ValueError(f"{what}: {len(data)} bytes, too short for an OCDBT file")
    got = struct.unpack_from(">I", data)[0]
    if got != magic:
        raise ValueError(f"{what}: magic {got:#010x}, not {magic:#010x}")
    length = struct.unpack_from("<Q", data, 4)[0]
    if length != len(data):
        raise ValueError(f"{what}: says {length} bytes, holds {len(data)}")
    want = struct.unpack_from("<I", data, len(data) - 4)[0]
    if crc32c(data[:-4]) != want:
        raise ValueError(f"{what}: CRC-32C does not match")
    version, compression = data[12], data[13]
    if version != 0 or compression > 1:
        raise ValueError(f"{what}: format version {version}, compression {compression}")
    body = data[_HEADER:-4]
    if compression == 0:
        return body
    return native.zstd_frame(body, None, what, limit).tobytes()


def _files(cur: _Cursor) -> List[Tuple[str, str]]:
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix, base = cur.varints(n), cur.varints(n)
    out, before = [], b""
    for i in range(n):
        if prefix[i] > len(before):
            raise ValueError(f"{cur.what}: data file {i} shares more than the path before")
        path = before[:prefix[i]] + cur.take(suffix[i])
        if base[i] > len(path):
            raise ValueError(f"{cur.what}: data file {i}'s base path is past its path")
        before = path
        text = path.decode()
        if text.startswith("/") or ".." in text.split("/"):
            raise ValueError(f"{cur.what}: data file {text!r} is outside the database")
        out.append((text[:base[i]], text[base[i]:]))
    return out


def _locations(cur: _Cursor, n: int, files) -> List[Location]:
    ids, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
    for i in ids:
        if i >= len(files):
            raise ValueError(f"{cur.what}: data file {i} of {len(files)}")
    return [Location(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _versions(cur: _Cursor, files) -> List[Version]:
    n = cur.varint()
    generations = cur.varints(n)
    heights = [cur.byte() for _ in range(n)]
    locations = _locations(cur, n, files)
    keys, tree_bytes, indirect = cur.varints(n), cur.varints(n), cur.varints(n)
    times = cur.u64s(n)
    return [Version(g, h, None if loc.offset == MISSING else loc, k, t, i, c)
            for g, h, loc, k, t, i, c in zip(generations, heights, locations, keys, tree_bytes,
                                             indirect, times)]


def _node_refs(cur: _Cursor, files, height: Optional[int]) -> List[VersionNodeRef]:
    n = cur.varint()
    generations = cur.varints(n)
    locations = _locations(cur, n, files)
    counts, times = cur.varints(n), cur.u64s(n)
    heights = [cur.byte() for _ in range(n)] if height is None else [height] * n
    return [VersionNodeRef(*r) for r in zip(generations, locations, counts, times, heights)]


def read_manifest(root: str) -> Manifest:
    """The manifest of the database in directory `root`."""
    path = os.path.join(root, "manifest.ocdbt")
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ValueError(f"{path}: {e.strerror or e}") from e
    cur = _Cursor(decode(data, MANIFEST_MAGIC, path), path)
    uuid = cur.take(16)
    kind = cur.varint()
    if kind != 0:
        raise ValueError(f"{path}: manifest kind {kind} (numbered manifests are not read)")
    inline, node_bytes = cur.varint(), cur.varint()
    arity = cur.byte()
    method = cur.varint()
    if method > 1:
        raise ValueError(f"{path}: compression method {method}")
    compression = ("zstd", struct.unpack("<i", cur.take(4))[0]) if method == 1 else None
    config = Config(uuid, inline, node_bytes, arity, compression)
    files = _files(cur)
    versions = _versions(cur, files)
    nodes = _node_refs(cur, files, None)
    cur.done()
    if not versions:
        raise ValueError(f"{path}: no version")
    return Manifest(config, versions, nodes)


def _read_at(root: str, loc: Location, what: str) -> bytes:
    path = os.path.join(root, loc.path())
    try:
        with open(path, "rb") as f:
            f.seek(loc.offset)
            data = f.read(loc.length)
    except OSError as e:
        raise ValueError(f"{what}: data file {loc.path()}: {e.strerror or e}") from e
    if len(data) != loc.length:
        raise ValueError(f"{what}: data file {loc.path()} ends before byte "
                         f"{loc.offset + loc.length} (it has {loc.offset + len(data)})")
    return data


def all_versions(root: str, manifest: Optional[Manifest] = None) -> List[Version]:
    """Every version the manifest and its version tree hold, oldest first."""
    manifest = manifest or read_manifest(root)
    out: List[Version] = []

    def walk(ref: VersionNodeRef):
        what = f"{os.path.join(root, ref.location.path())} at {ref.location.offset}"
        cur = _Cursor(decode(_read_at(root, ref.location, what), VERSION_MAGIC, what,
                             manifest.config.max_decoded_node_bytes), what)
        cur.byte()  # arity
        height = cur.byte()
        if height != ref.height:
            raise ValueError(f"{what}: a version node of height {height}, {ref.height} wanted")
        files = _files(cur)
        if height == 0:
            out.extend(_versions(cur, files))
        else:
            for child in _node_refs(cur, files, height - 1):
                walk(child)
        cur.done()

    for ref in manifest.version_nodes:
        walk(ref)
    out.extend(manifest.versions)
    return out


@dataclass(frozen=True)
class Value:
    """A leaf's value: its bytes (inline) or where they are (indirect)."""
    inline: Optional[bytes]
    location: Optional[Location] = None


def _keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else []
    keys, before = [], b""
    for i in range(n):
        if prefix[i] > len(before):
            raise ValueError(f"{cur.what}: key {i} shares more than the key before")
        key = before[:prefix[i]] + cur.take(suffix[i])
        keys.append(key)
        before = key
    for i, c in enumerate(common):
        if c > len(keys[i]):
            raise ValueError(f"{cur.what}: entry {i}'s common prefix is past its key")
    return keys, common


def read_tree(root: str, version: Optional[Version] = None) -> Dict[bytes, Value]:
    """{key: Value} of the newest version (or `version`) of the database in
    `root`, in key order."""
    manifest = read_manifest(root)
    version = version or max(manifest.versions, key=lambda v: v.generation)
    limit = manifest.config.max_decoded_node_bytes
    out: Dict[bytes, Value] = {}
    stats = [0, 0]  # tree bytes, indirect value bytes

    def walk(loc: Location, height: int, prefix: bytes):
        what = f"{os.path.join(root, loc.path())} at {loc.offset}"
        data = _read_at(root, loc, what)
        stats[0] += len(data)
        cur = _Cursor(decode(data, BTREE_MAGIC, what, limit), what)
        got = cur.byte()
        if got != height:
            raise ValueError(f"{what}: a node of height {got}, {height} wanted")
        files = _files(cur)
        n = cur.varint()
        if n == 0:
            raise ValueError(f"{what}: an empty node")
        keys, common = _keys(cur, n, height > 0)
        if height > 0:
            children = _locations(cur, n, files)
            cur.varints(3 * n)  # the children's statistics, checked at the root's
            cur.done()
            for key, c, child in zip(keys, common, children):
                walk(child, height - 1, prefix + key[:c])
            return
        lengths = cur.varints(n)
        kinds = [cur.byte() for _ in range(n)]
        if any(k > 1 for k in kinds):
            raise ValueError(f"{what}: a value of kind {max(kinds)}")
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        ids, offsets = cur.varints(len(indirect)), cur.varints(len(indirect))
        where = {}
        for i, fid, off in zip(indirect, ids, offsets):
            if fid >= len(files):
                raise ValueError(f"{what}: key {keys[i]!r}: data file {fid} of {len(files)}")
            where[i] = Location(files[fid], off, lengths[i])
            stats[1] += lengths[i]
        for i, key in enumerate(keys):
            full = prefix + key
            if out and full <= next(reversed(out)):
                raise ValueError(f"{what}: key {full!r} out of order")
            out[full] = Value(None, where[i]) if i in where else Value(cur.take(lengths[i]))
        cur.done()

    if version.root is not None:
        walk(version.root, version.root_height, b"")
    got = (len(out), stats[0], stats[1])
    want = (version.num_keys, version.num_tree_bytes, version.num_indirect_value_bytes)
    if got != want:
        raise ValueError(f"{os.path.join(root, 'manifest.ocdbt')}: the tree holds "
                         f"(keys, tree bytes, indirect bytes) {got}, the manifest says {want}")
    return out


class Store:
    """The newest version of the database in `root`: `keys()`, `get(key)`."""

    def __init__(self, root: str):
        self.root = root
        self.entries = read_tree(root)

    def keys(self):
        return self.entries.keys()

    def __contains__(self, key: bytes) -> bool:
        return key in self.entries

    def get(self, key: bytes) -> bytes:
        value = self.entries.get(key)
        if value is None:
            raise ValueError(f"{self.root}: no key {key.decode(errors='replace')!r}")
        if value.inline is not None:
            return value.inline
        return _read_at(self.root, value.location,
                        f"{self.root}: key {key.decode(errors='replace')!r}")


# ------------------------------------------------------------------ writing --

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in values)


def frame_header(size: int) -> bytes:
    """A Zstandard frame header for `size` bytes of raw blocks: the content
    size in 8 bytes and a 128 KiB window (no single-segment form, so that
    no size runs into a decoder's window limit)."""
    return b"\x28\xb5\x2f\xfd" + bytes([0xC0, 0x38]) + struct.pack("<Q", size)


def frame_length(size: int) -> int:
    return 14 + 3 * max(1, -(-size // RAW_BLOCK)) + size


def write_frame(f: BinaryIO, data: memoryview) -> int:
    """Write `data` to `f` as one Zstandard frame of raw blocks; returns the
    bytes written."""
    f.write(frame_header(len(data)))
    at = 0
    while True:
        n = min(RAW_BLOCK, len(data) - at)
        last = at + n == len(data)
        f.write((n << 3 | int(last)).to_bytes(3, "little"))
        f.write(data[at:at + n])
        at += n
        if last:
            return frame_length(len(data))


class RawFrame:
    """A value to be stored as one Zstandard frame of raw blocks holding
    `data`, written straight into its data file when it is not inline."""

    def __init__(self, data: Union[bytes, memoryview]):
        self.data = memoryview(data).cast("B")

    def __len__(self) -> int:
        return frame_length(len(self.data))

    def encoded(self) -> bytes:
        buf = io.BytesIO()
        write_frame(buf, self.data)
        return buf.getvalue()


def encode(body: bytes, magic: int) -> bytes:
    """The encoded file of a body: header, one raw-block frame, CRC-32C."""
    payload = RawFrame(body).encoded()
    head = struct.pack(">I", magic) + struct.pack("<Q", _HEADER + len(payload) + 4) + b"\x00\x01"
    data = head + payload
    return data + struct.pack("<I", crc32c(data))


def _file_table(files: List[Tuple[str, str]]) -> bytes:
    paths = [(b + r).encode() for b, r in files]
    prefix = []
    for before, path in zip(paths, paths[1:]):
        n = 0
        while n < min(len(before), len(path)) and before[n] == path[n]:
            n += 1
        prefix.append(n)
    suffix = [len(p) - n for p, n in zip(paths, [0] + prefix)]
    return (_varint(len(paths)) + _varints(prefix) + _varints(suffix)
            + _varints(len(b.encode()) for b, _ in files)
            + b"".join(p[n:] for p, n in zip(paths, [0] + prefix)))


def leaf_body(entries: List[Tuple[bytes, Union[bytes, Tuple[int, int]]]],
              files: List[Tuple[str, str]]) -> bytes:
    """A leaf node's body: `entries` (key, inline bytes or (offset, length)
    in files[0]) in key order."""
    keys = [k for k, _ in entries]
    prefix = []
    for before, key in zip(keys, keys[1:]):
        if key <= before:
            raise ValueError(f"key {key!r} out of order")
        n = 0
        while n < min(len(before), len(key)) and before[n] == key[n]:
            n += 1
        prefix.append(n)
    starts = [0] + prefix
    indirect = [v for _, v in entries if not isinstance(v, bytes)]
    return (b"\x00" + _file_table(files) + _varint(len(entries)) + _varints(prefix)
            + _varints(len(k) - n for k, n in zip(keys, starts))
            + b"".join(k[n:] for k, n in zip(keys, starts))
            + _varints(len(v) if isinstance(v, bytes) else v[1] for _, v in entries)
            + bytes(0 if isinstance(v, bytes) else 1 for _, v in entries)
            + _varints(0 for _ in indirect) + _varints(off for off, _ in indirect)
            + b"".join(v for _, v in entries if isinstance(v, bytes)))


def manifest_body(uuid: bytes, files: List[Tuple[str, str]], root: Location, num_keys: int,
                  indirect_bytes: int) -> bytes:
    """A manifest of one version (generation 1, a leaf root at files[0])."""
    config = (uuid + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES) + bytes([VERSION_TREE_ARITY_LOG2])
              + _varint(1) + struct.pack("<i", 0))
    return (config + _file_table(files) + _varint(1) + _varint(1) + b"\x00"
            + _varints([0, root.offset, root.length, num_keys, root.length, indirect_bytes])
            + struct.pack("<Q", time.time_ns()) + _varint(0))


def _name() -> str:
    return os.urandom(16).hex()


def write_database(root: str, items: Iterable[Tuple[bytes, Union[bytes, RawFrame]]],
                   process: int = 0) -> None:
    """Write `items` ((key, bytes or RawFrame), keys increasing) as orbax writes one
    process's keys: root/ocdbt.process_<process>/ (its data file: the large
    values as they come, then its leaf) and root/ (a leaf with the same keys,
    pointing into it), each with its manifest. The directory `root` exists
    and holds nothing of OCDBT's yet."""
    base = f"ocdbt.process_{process}/"
    data_file = ("", f"d/{_name()}")
    os.makedirs(os.path.join(root, base, "d"))
    os.makedirs(os.path.join(root, "d"))
    entries: List[Tuple[bytes, Union[bytes, Tuple[int, int]]]] = []
    indirect_bytes = 0
    with open(os.path.join(root, base, data_file[1]), "wb") as f:
        for key, value in items:
            framed = isinstance(value, RawFrame)
            if len(value) <= MAX_INLINE_VALUE_BYTES:
                entries.append((key, value.encoded() if framed else bytes(value)))
                continue
            offset = f.tell()
            if framed:
                write_frame(f, value.data)
            else:
                f.write(value)
            entries.append((key, (offset, len(value))))
            indirect_bytes += len(value)
        node = encode(leaf_body(entries, [data_file]), BTREE_MAGIC)
        if len(node) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"{root}: a leaf of {len(node)} bytes, past max_decoded_node_bytes")
        node_at = Location(data_file, f.tell(), len(node))
        f.write(node)
    with open(os.path.join(root, base, "manifest.ocdbt"), "wb") as f:
        f.write(encode(manifest_body(os.urandom(16), [data_file], node_at, len(entries),
                                     indirect_bytes), MANIFEST_MAGIC))
    # The root database: the same keys, its large values in the process's file.
    node_file = ("", f"d/{_name()}")
    node = encode(leaf_body(entries, [(base, data_file[1])]), BTREE_MAGIC)
    with open(os.path.join(root, node_file[1]), "wb") as f:
        f.write(node)
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(encode(manifest_body(os.urandom(16), [node_file],
                                     Location(node_file, 0, len(node)), len(entries),
                                     indirect_bytes), MANIFEST_MAGIC))
