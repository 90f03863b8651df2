"""A read-only HDF5 reader in Python and numpy, for MATLAB v7.3 `.mat` files.

MATLAB saves a v7.3 MAT-file as HDF5 in the library's earliest file
format (HDF5 1.8, `libver="earliest"`) behind a 512-byte user block that
holds its header text. This module reads exactly that format:

  * the superblock, versions 0 and 1, found at offset 0, 512, 1024, 2048,
    ...; its address is the base of every address in the file;
  * version 1 object headers, with their continuation blocks;
  * groups stored as symbol tables: a version 1 B-tree of type 0, its
    SNOD nodes and the group's local heap;
  * the dataspace, datatype, fill value (old and new), layout (version 3:
    compact, contiguous, or chunked with a version 1 B-tree of type 1) and
    filter pipeline messages; attributes and other messages are skipped;
  * fixed-point and IEEE floating-point elements in either byte order;
  * the deflate (1, the standard library's zlib), shuffle (2) and
    fletcher32 (3) filters;
  * edge chunks clipped to the dataset's extent; a chunk that was never
    written reads as the fill value.

An object-reference dataset (MATLAB's cell arrays, such as NYUv2's `names`
and `scenes`, and the `#refs#` group they point into) is listed but never
read. Anything else raises ValueError naming what it met: a version 2 or 3
superblock, a version 2 object header, a group stored as links, a layout
of version 4 (its other chunk indexes), an unknown filter, a shared
message, another element class, and a file cut short.

    with File("nyu_depth_v2_labeled.mat") as f:
        images = f["images"]          # Dataset: .shape, .dtype
        frame = images[7]             # one index of the first axis
        depths = f["depths"].read()   # the whole array

Arrays come in HDF5's stored dimension order (MATLAB's reversed), C order,
in the element type's byte order: what h5py's `np.asarray(f[name])` and
`f[name][i]` give. `[i]` inflates only the chunks that hold index i of the
first axis and keeps them for the next call, so reading a file frame by
frame holds one frame and its chunks in memory.
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# Object header message types.
MSG_DATASPACE = 0x0001
MSG_LINK_INFO = 0x0002
MSG_DATATYPE = 0x0003
MSG_FILL_OLD = 0x0004
MSG_FILL = 0x0005
MSG_LINK = 0x0006
MSG_LAYOUT = 0x0008
MSG_GROUP_INFO = 0x000A
MSG_FILTERS = 0x000B
MSG_CONTINUATION = 0x0010
MSG_SYMBOL_TABLE = 0x0011

FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32 = 1, 2, 3

_CLASS_NAMES = {0: "fixed-point", 1: "floating-point", 2: "time", 3: "string",
                4: "bitfield", 5: "opaque", 6: "compound", 7: "reference", 8: "enumerated",
                9: "variable-length", 10: "array"}


class _Reader:
    """Bounds-checked reads of the file at addresses relative to the base."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._f = open(self.path, "rb")
        self.size = os.fstat(self._f.fileno()).st_size
        self.base = 0
        self.offset_size = 8
        self.length_size = 8

    def close(self) -> None:
        self._f.close()

    def raw(self, pos: int, n: int) -> bytes:
        """n bytes at the absolute position pos."""
        if pos < 0 or pos + n > self.size:
            raise ValueError(f"{self.path}: truncated file: {n} bytes at offset {pos} pass "
                             f"its end at {self.size}")
        self._f.seek(pos)
        data = self._f.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated file: short read at offset {pos}")
        return data

    def read(self, addr: int, n: int) -> bytes:
        return self.raw(self.base + addr, n)

    def undefined(self, addr: int) -> bool:
        return addr == (1 << (8 * self.offset_size)) - 1


class _Cursor:
    """Little-endian fields from a bytes object."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"a record ends {self.pos + n - len(self.data)} bytes early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")

    def skip(self, n: int) -> None:
        self.take(n)


def fletcher32(data: bytes) -> int:
    """H5_checksum_fletcher32: sums of big-endian 16-bit words (an odd last
    byte is the high byte of a word), folded to 16 bits every 360 words."""
    n = len(data) // 2
    words = np.frombuffer(data[:2 * n], ">u2").astype(np.int64)
    sum1 = sum2 = 0
    for start in range(0, n, 360):
        block = words[start:start + 360]
        # sum2 adds sum1 after each word: len(block) * sum1 + the running sums.
        sum2 += len(block) * sum1 + int(np.cumsum(block).sum())
        sum1 += int(block.sum())
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    if len(data) % 2:
        sum1 += data[-1] << 8
        sum2 += sum1
        sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
        sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    sum1 = (sum1 & 0xFFFF) + (sum1 >> 16)
    sum2 = (sum2 & 0xFFFF) + (sum2 >> 16)
    return (sum2 << 16) | sum1


def unshuffle(data: bytes, element_size: int) -> bytes:
    """Undo the shuffle filter: byte j of every element was stored together."""
    n = len(data) // element_size
    if element_size <= 1 or n <= 1:
        return data
    body = np.frombuffer(data[:n * element_size], np.uint8).reshape(element_size, n)
    return body.T.tobytes() + data[n * element_size:]


class _Filter:
    def __init__(self, fid: int, client: Tuple[int, ...]):
        self.id, self.client = fid, client


def _parse_filters(body: bytes) -> List[_Filter]:
    c = _Cursor(body)
    version, count = c.uint(1), c.uint(1)
    if version not in (1, 2):
        raise ValueError(f"filter pipeline message version {version}")
    if version == 1:
        c.skip(6)
    filters = []
    for _ in range(count):
        fid = c.uint(2)
        name_len = c.uint(2) if version == 1 or fid >= 256 else 0
        c.skip(2)  # flags: whether the filter is optional; the chunk's mask says if it ran
        n_client = c.uint(2)
        if name_len:
            c.skip((name_len + 7) // 8 * 8 if version == 1 else name_len)
        client = tuple(c.uint(4) for _ in range(n_client))
        if version == 1 and n_client % 2:
            c.skip(4)
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32):
            raise ValueError(f"unknown filter id {fid} (this reader takes deflate 1, "
                             "shuffle 2 and fletcher32 3)")
        filters.append(_Filter(fid, client))
    return filters


def _parse_datatype(body: bytes) -> Tuple[Optional[np.dtype], str]:
    """(numpy dtype or None, description). None: a class this reader lists
    but does not read."""
    c = _Cursor(body)
    class_version = c.uint(1)
    cls, version = class_version & 0x0F, class_version >> 4
    bits = c.uint(3)
    size = c.uint(4)
    name = _CLASS_NAMES.get(cls, f"class {cls}")
    if version not in (1, 2, 3):
        raise ValueError(f"datatype message version {version}")
    order = ">" if bits & 1 else "<"
    if cls == 0:
        if size not in (1, 2, 4, 8):
            return None, f"{size}-byte {name}"
        offset, precision = c.uint(2), c.uint(2)
        if offset != 0 or precision != 8 * size:
            return None, f"{name} of {precision} bits at bit {offset}"
        kind = "i" if bits & 0x08 else "u"
        return np.dtype(f"{order}{kind}{size}"), f"{name} {order}{kind}{size}"
    if cls == 1:
        layouts = {4: (0, 32, 23, 8, 0, 23, 127), 8: (0, 64, 52, 11, 0, 52, 1023)}
        if bits & 0x40 or size not in layouts:
            return None, f"{size}-byte {name}" + (" (VAX order)" if bits & 0x40 else "")
        fields = (c.uint(2), c.uint(2), c.uint(1), c.uint(1), c.uint(1), c.uint(1), c.uint(4))
        if fields != layouts[size]:
            return None, f"non-IEEE {size}-byte {name} {fields}"
        return np.dtype(f"{order}f{size}"), f"{name} {order}f{size}"
    return None, f"{size}-byte {name}"


class _ObjectHeader:
    """A version 1 object header's messages, as (type, flags, body)."""

    def __init__(self, reader: _Reader, addr: int, name: str):
        self.name = name
        head = reader.read(addr, 16)
        if head[:4] == b"OHDR":
            raise ValueError(f"{name}: version 2 object header (written with "
                             "libver='latest'); this reader takes version 1")
        version, count = head[0], int.from_bytes(head[2:4], "little")
        if version != 1:
            raise ValueError(f"{name}: object header version {version}")
        size = int.from_bytes(head[8:12], "little")
        self.messages: List[Tuple[int, int, bytes]] = []
        blocks = [(addr + 16, size)]
        while blocks and len(self.messages) < count:
            start, length = blocks.pop(0)
            block = reader.read(start, length)
            c = _Cursor(block)
            while c.pos + 8 <= len(block) and len(self.messages) < count:
                mtype, msize, mflags = c.uint(2), c.uint(2), c.uint(1)
                c.skip(3)
                body = c.take(msize)
                if mtype == MSG_CONTINUATION:
                    bc = _Cursor(body)
                    blocks.append((bc.uint(reader.offset_size), bc.uint(reader.length_size)))
                self.messages.append((mtype, mflags, body))

    def find(self, mtype: int) -> Optional[bytes]:
        for t, flags, body in self.messages:
            if t == mtype:
                if flags & 0x02:
                    raise ValueError(f"{self.name}: shared message of type {mtype}")
                return body
        return None

    def has(self, mtype: int) -> bool:
        return any(t == mtype for t, _, _ in self.messages)


class Dataset:
    """One dataset: `.shape`, `.dtype` (None for a class that is listed but
    not read, such as object references), `.read()` and `[i]`."""

    def __init__(self, reader: _Reader, header: _ObjectHeader, name: str):
        self._reader = reader
        self.name = name
        space = header.find(MSG_DATASPACE)
        dtype_body = header.find(MSG_DATATYPE)
        layout = header.find(MSG_LAYOUT)
        if space is None or dtype_body is None or layout is None:
            raise ValueError(f"{name}: a dataset without dataspace, datatype or layout")
        self.shape = self._parse_space(space)
        self.dtype, self.type_name = _parse_datatype(dtype_body)
        self._layout = layout
        filters = header.find(MSG_FILTERS)
        self._filters = _parse_filters(filters) if filters is not None else []
        self._fill_body = header.find(MSG_FILL)
        self._fill_old = header.find(MSG_FILL_OLD)
        self._chunks: Optional[Dict[Tuple[int, ...], Tuple[int, int, int]]] = None
        self._kept: Dict[Tuple[int, ...], np.ndarray] = {}

    def __repr__(self) -> str:
        return f"<Dataset {self.name} {self.shape} {self.type_name}>"

    def _parse_space(self, body: bytes) -> Tuple[int, ...]:
        c = _Cursor(body)
        version, rank, flags = c.uint(1), c.uint(1), c.uint(1)
        if version == 1:
            c.skip(5)
        elif version == 2:
            kind = c.uint(1)
            if kind == 2:
                return (0,)
        else:
            raise ValueError(f"{self.name}: dataspace message version {version}")
        del flags  # the maximum dimensions that may follow are not needed
        return tuple(c.uint(self._reader.length_size) for _ in range(rank))

    # -- layout ----------------------------------------------------------

    def _require_readable(self) -> np.dtype:
        if self.dtype is None:
            raise ValueError(f"{self.name}: {self.type_name} elements are listed, not read "
                             "(this reader takes fixed-point and IEEE floating-point)")
        return self.dtype

    def _layout_kind(self) -> Tuple[int, _Cursor]:
        c = _Cursor(self._layout)
        version = c.uint(1)
        if version != 3:
            raise ValueError(f"{self.name}: data layout message version {version} (this "
                             "reader takes version 3; version 4 chunk indexes other than "
                             "the version 1 B-tree come from libver='latest')")
        return c.uint(1), c

    def _fill_bytes(self) -> bytes:
        """One element of the fill value (zeros where none is defined)."""
        size = self._require_readable().itemsize
        value = b""
        if self._fill_body is not None:
            c = _Cursor(self._fill_body)
            version = c.uint(1)
            if version in (1, 2):
                c.skip(2)
                defined = c.uint(1)
                if version == 1 or defined:
                    value = c.take(c.uint(4))
            elif version == 3:
                flags = c.uint(1)
                if flags & 0x20:
                    value = c.take(c.uint(4))
            else:
                raise ValueError(f"{self.name}: fill value message version {version}")
        elif self._fill_old is not None:
            c = _Cursor(self._fill_old)
            value = c.take(c.uint(4))
        return value if len(value) == size else bytes(size)

    def _filled(self, shape) -> np.ndarray:
        fill = np.frombuffer(self._fill_bytes(), self.dtype)[0]
        return np.full(shape, fill, self.dtype)

    def _decode(self, data: bytes, mask: int) -> bytes:
        """Undo the filter pipeline, last filter first, skipping the ones
        the chunk's filter mask marks."""
        for i in range(len(self._filters) - 1, -1, -1):
            if mask & (1 << i):
                continue
            f = self._filters[i]
            if f.id == FILTER_DEFLATE:
                try:
                    data = zlib.decompress(data)
                except zlib.error as e:
                    raise ValueError(f"{self.name}: deflate: {e}") from None
            elif f.id == FILTER_SHUFFLE:
                data = unshuffle(data, f.client[0] if f.client else self.dtype.itemsize)
            else:
                if len(data) < 4:
                    raise ValueError(f"{self.name}: fletcher32: a chunk of {len(data)} bytes")
                body, stored = data[:-4], int.from_bytes(data[-4:], "little")
                got = fletcher32(body)
                # HDF5 before 1.6.3 stored the checksum with its bytes swapped.
                swapped = int.from_bytes(got.to_bytes(4, "big"), "little")
                if stored not in (got, swapped):
                    raise ValueError(f"{self.name}: fletcher32 checksum mismatch "
                                     f"({stored:#010x} stored, {got:#010x} computed)")
                data = body
        return data

    def _chunk_dims(self) -> Tuple[int, Tuple[int, ...]]:
        kind, c = self._layout_kind()
        rank = c.uint(1)
        addr = c.uint(self._reader.offset_size)
        dims = tuple(c.uint(4) for _ in range(rank))
        if len(dims) != len(self.shape) + 1:
            raise ValueError(f"{self.name}: chunk of rank {len(dims) - 1} in a dataset of "
                             f"rank {len(self.shape)}")
        return addr, dims[:-1]

    def _index_chunks(self) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
        """{chunk offset: (address, stored size, filter mask)} from the
        version 1 B-tree of type 1."""
        if self._chunks is None:
            addr, dims = self._chunk_dims()
            chunks: Dict[Tuple[int, ...], Tuple[int, int, int]] = {}
            if not self._reader.undefined(addr):
                self._walk_chunk_tree(addr, len(dims) + 1, chunks)
            self._chunks = chunks
        return self._chunks

    def _walk_chunk_tree(self, addr: int, ndims: int, out) -> None:
        r = self._reader
        head = _Cursor(r.read(addr, 8 + 2 * r.offset_size))
        if head.take(4) != b"TREE":
            raise ValueError(f"{self.name}: no B-tree node at address {addr}")
        node_type, level, entries = head.uint(1), head.uint(1), head.uint(2)
        if node_type != 1:
            raise ValueError(f"{self.name}: B-tree node of type {node_type} under a chunked "
                             "layout")
        key_size = 8 + 8 * ndims
        body = _Cursor(r.read(addr + 8 + 2 * r.offset_size,
                              entries * (key_size + r.offset_size) + key_size))
        for _ in range(entries):
            size, mask = body.uint(4), body.uint(4)
            offset = tuple(body.uint(8) for _ in range(ndims))[:-1]
            child = body.uint(r.offset_size)
            if level == 0:
                out[offset] = (child, size, mask)
            else:
                self._walk_chunk_tree(child, ndims, out)

    def _chunk(self, offset: Tuple[int, ...], dims: Tuple[int, ...]) -> np.ndarray:
        """The decoded chunk at `offset` (whole, unclipped), or the fill
        value where it was never written."""
        entry = self._index_chunks().get(offset)
        if entry is None:
            return self._filled(dims)
        addr, size, mask = entry
        data = self._decode(self._reader.read(addr, size), mask)
        n = int(np.prod(dims)) * self.dtype.itemsize
        if len(data) < n:
            raise ValueError(f"{self.name}: chunk at {offset} holds {len(data)} bytes, "
                             f"needs {n}")
        return np.frombuffer(data[:n], self.dtype).reshape(dims)

    # -- reads -----------------------------------------------------------

    def read(self) -> np.ndarray:
        """The whole array."""
        dtype = self._require_readable()
        kind, c = self._layout_kind()
        count = int(np.prod(self.shape))
        nbytes = count * dtype.itemsize
        if kind == 0:
            size = c.uint(2)
            return np.frombuffer(c.take(size)[:nbytes], dtype).reshape(self.shape).copy()
        if kind == 1:
            addr = c.uint(self._reader.offset_size)
            if self._reader.undefined(addr):
                return self._filled(self.shape)
            return np.frombuffer(self._reader.read(addr, nbytes), dtype).reshape(self.shape)
        if kind == 2:
            _, dims = self._chunk_dims()
            out = self._filled(self.shape)
            for offset in self._index_chunks():
                self._place(out, offset, self._chunk(offset, dims), (0,) * len(dims))
            return out
        raise ValueError(f"{self.name}: layout class {kind}")

    @staticmethod
    def _place(out: np.ndarray, offset, chunk: np.ndarray, origin) -> None:
        """Copy the part of `chunk` (at `offset` in the dataset) that lies in
        `out` (the dataset's region starting at `origin`), clipping edges."""
        dst, src = [], []
        for o, c, n, g in zip(offset, chunk.shape, out.shape, origin):
            lo, hi = max(o, g), min(o + c, g + n)
            if hi <= lo:
                return
            dst.append(slice(lo - g, hi - g))
            src.append(slice(lo - o, hi - o))
        out[tuple(dst)] = chunk[tuple(src)]

    def __getitem__(self, index) -> np.ndarray:
        """Index `index` of the first axis (an int; negative counts from
        the end)."""
        if not isinstance(index, (int, np.integer)):
            raise TypeError(f"{self.name}: index with an int, not {type(index).__name__}")
        dtype = self._require_readable()
        if not self.shape:
            raise ValueError(f"{self.name}: a scalar dataset has no first axis")
        n = self.shape[0]
        i = int(index) + n if index < 0 else int(index)
        if not 0 <= i < n:
            raise IndexError(f"{self.name}: index {index} out of range for {n}")
        frame_shape = self.shape[1:]
        frame_bytes = int(np.prod(frame_shape)) * dtype.itemsize
        kind, c = self._layout_kind()
        if kind == 0:
            return self.read()[i]
        if kind == 1:
            addr = c.uint(self._reader.offset_size)
            if self._reader.undefined(addr):
                return self._filled(frame_shape)
            data = self._reader.read(addr + i * frame_bytes, frame_bytes)
            return np.frombuffer(data, dtype).reshape(frame_shape)
        if kind != 2:
            raise ValueError(f"{self.name}: layout class {kind}")
        _, dims = self._chunk_dims()
        out = self._filled((1,) + frame_shape)
        start = i // dims[0] * dims[0]
        kept: Dict[Tuple[int, ...], np.ndarray] = {}
        grid = [range(0, s, d) for s, d in zip(self.shape[1:], dims[1:])]
        for rest in np.ndindex(*[len(g) for g in grid]):
            offset = (start,) + tuple(g[k] for g, k in zip(grid, rest))
            chunk = self._kept.get(offset)
            if chunk is None:
                chunk = self._chunk(offset, dims)
            kept[offset] = chunk
            self._place(out, offset, chunk, (i,) + (0,) * len(frame_shape))
        self._kept = kept
        return out[0]


class Group:
    """A group stored as a symbol table: `keys()`, `[name]` (a path with
    '/' reaches into subgroups) and `walk()`."""

    def __init__(self, reader: _Reader, header: _ObjectHeader, name: str):
        self._reader = reader
        self.name = name
        table = header.find(MSG_SYMBOL_TABLE)
        if table is None:
            raise ValueError(f"{name}: a group stored as links (link info or link "
                             "messages, written with libver='latest'); this reader takes "
                             "symbol-table groups")
        c = _Cursor(table)
        btree, heap = c.uint(reader.offset_size), c.uint(reader.offset_size)
        self._heap = self._read_heap(heap)
        self._entries: Dict[str, int] = {}
        self._walk_group_tree(btree)

    def __repr__(self) -> str:
        return f"<Group {self.name} ({len(self._entries)} members)>"

    def _read_heap(self, addr: int) -> bytes:
        r = self._reader
        c = _Cursor(r.read(addr, 8 + 2 * r.length_size + r.offset_size))
        if c.take(4) != b"HEAP":
            raise ValueError(f"{self.name}: no local heap at address {addr}")
        c.skip(4)
        size = c.uint(r.length_size)
        c.skip(r.length_size)
        return r.read(c.uint(r.offset_size), size)

    def _name_at(self, offset: int) -> str:
        end = self._heap.find(b"\0", offset)
        if end < 0:
            raise ValueError(f"{self.name}: a link name past the local heap's end")
        return self._heap[offset:end].decode("utf-8")

    def _walk_group_tree(self, addr: int) -> None:
        r = self._reader
        head = _Cursor(r.read(addr, 8 + 2 * r.offset_size))
        if head.take(4) != b"TREE":
            raise ValueError(f"{self.name}: no B-tree node at address {addr}")
        node_type, level, entries = head.uint(1), head.uint(1), head.uint(2)
        if node_type != 0:
            raise ValueError(f"{self.name}: B-tree node of type {node_type} under a group")
        body = _Cursor(r.read(addr + 8 + 2 * r.offset_size,
                              entries * (r.length_size + r.offset_size) + r.length_size))
        for _ in range(entries):
            body.skip(r.length_size)
            child = body.uint(r.offset_size)
            if level == 0:
                self._read_symbol_node(child)
            else:
                self._walk_group_tree(child)

    def _read_symbol_node(self, addr: int) -> None:
        r = self._reader
        head = r.read(addr, 8)
        if head[:4] != b"SNOD":
            raise ValueError(f"{self.name}: no symbol table node at address {addr}")
        count = int.from_bytes(head[6:8], "little")
        entry_size = 2 * r.offset_size + 24
        c = _Cursor(r.read(addr + 8, count * entry_size))
        for _ in range(count):
            name_off, header_addr = c.uint(r.offset_size), c.uint(r.offset_size)
            cache_type = c.uint(4)
            c.skip(20)
            name = self._name_at(name_off)
            if cache_type == 2:
                raise ValueError(f"{self.name}/{name}: a soft link")
            self._entries[name] = header_addr

    def keys(self) -> List[str]:
        return list(self._entries)

    def __contains__(self, name: str) -> bool:
        try:
            self[name]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._entries:
                raise KeyError(f"{path!r} is not in {self.name}")
            node = _open(self._reader, node._entries[part],
                         f"{node.name.rstrip('/')}/{part}")
        return node

    def walk(self) -> Iterator[Tuple[str, object]]:
        """(path, Group or Dataset) of every member, depth first."""
        for name in self._entries:
            obj = self[name]
            yield obj.name, obj
            if isinstance(obj, Group):
                yield from obj.walk()


def _open(reader: _Reader, addr: int, name: str):
    header = _ObjectHeader(reader, addr, name)
    if header.has(MSG_SYMBOL_TABLE) or header.has(MSG_LINK_INFO) or header.has(
            MSG_LINK) or header.has(MSG_GROUP_INFO):
        return Group(reader, header, name)
    return Dataset(reader, header, name)


class File(Group):
    """An HDF5 file in the earliest format, opened read-only."""

    def __init__(self, path):
        reader = _Reader(path)
        try:
            root = self._superblock(reader)
            Group.__init__(self, reader, _ObjectHeader(reader, root, "/"), "/")
        except BaseException:
            reader.close()
            raise

    @staticmethod
    def _superblock(r: _Reader) -> int:
        """Find and read the superblock; returns the root group's object
        header address."""
        pos = 0
        while True:
            if pos + 8 > r.size:
                raise ValueError(f"{r.path}: no HDF5 signature at offset 0 or any power "
                                 "of two from 512 (not an HDF5 file, or truncated)")
            if r.raw(pos, 8) == SIGNATURE:
                break
            pos = 512 if pos == 0 else 2 * pos
        version = r.raw(pos + 8, 1)[0]
        if version not in (0, 1):
            raise ValueError(f"{r.path}: superblock version {version} (written with "
                             "libver='latest' or a later default); this reader takes "
                             "versions 0 and 1")
        head = r.raw(pos + 8, 16)
        r.offset_size, r.length_size = head[5], head[6]
        if r.offset_size not in (2, 4, 8) or r.length_size not in (2, 4, 8):
            raise ValueError(f"{r.path}: offsets of {r.offset_size} and lengths of "
                             f"{r.length_size} bytes")
        at = pos + 24 + (4 if version == 1 else 0)
        o = r.offset_size
        c = _Cursor(r.raw(at, 4 * o + 2 * o + 24))
        stored_base = c.uint(o)
        c.skip(o)  # free-space info
        # The end-of-file address counts from the file's start as written;
        # a superblock found elsewhere (a user block added later) moves it.
        eof = c.uint(o) - stored_base + pos
        c.skip(o)  # the address of the file layer's information block
        r.base = pos
        if eof > r.size:
            raise ValueError(f"{r.path}: truncated file: the superblock gives "
                             f"{eof} bytes, the file has {r.size}")
        c.skip(o)  # the root entry's link name offset
        return c.uint(o)

    def close(self) -> None:
        self._reader.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def user_block(self) -> bytes:
        """The bytes in front of the superblock (MATLAB's header text)."""
        return self._reader.raw(0, self._reader.base)
