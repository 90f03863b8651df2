"""The port's HDF5 reader (multimae_tpu_torch/utils/hdf5.py) against h5py.

Every file here is written by h5py in the earliest format MATLAB v7.3
uses (`libver="earliest"`); the reader's arrays, whole and frame by
frame, must equal h5py's bit for bit, in the same shape and dtype:
contiguous, compact and chunked layouts with edge chunks; deflate at
several levels, shuffle with deflate, fletcher32; chunks never written
(the fill value); nested groups; user blocks of 0, 512 and 1024 bytes;
uint8, uint16, int16, float32 and float64 in both byte orders. An
object-reference dataset is listed and refused on read. A file written
with `libver="latest"`, a file cut short and a damaged checksum raise
ValueError naming the cause.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from multimae_tpu_torch.utils import hdf5  # noqa: E402

DTYPES = ["<u1", "<u2", ">u2", "<i2", ">i2", "<f4", ">f4", "<f8", ">f8"]


def sample(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        return (rng.standard_normal(shape) * 100).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, int(info.max) + 1, shape).astype(dt)


def write(path, datasets, userblock=0, libver="earliest"):
    """datasets: {name: (array, create_dataset kwargs)}; names may nest."""
    kw = {"userblock_size": userblock} if userblock else {}
    with h5py.File(path, "w", libver=libver, **kw) as f:
        for name, (arr, opts) in datasets.items():
            opts = dict(opts)
            if opts.pop("compact", False):
                dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
                dcpl.set_layout(h5py.h5d.COMPACT)
                opts["dcpl"] = dcpl
            f.create_dataset(name, data=arr, **opts)


def assert_same(path, names):
    with h5py.File(path, "r") as ref, hdf5.File(path) as got:
        for name in names:
            want = np.asarray(ref[name])
            ds = got[name]
            assert ds.shape == want.shape and ds.dtype == want.dtype, name
            arr = ds.read()
            assert arr.dtype == want.dtype and arr.shape == want.shape
            assert arr.tobytes() == want.tobytes(), name
            if want.ndim:
                for i in list(range(want.shape[0])) + [-1]:
                    frame = ds[i]
                    assert frame.dtype == want.dtype and frame.shape == want.shape[1:]
                    assert frame.tobytes() == ref[name][i].tobytes(), (name, i)


LAYOUTS = {
    "contiguous": {},
    "compact": {"compact": True},
    "chunked": {"chunks": (2, 3, 4)},
    "edge": {"chunks": (2, 4, 5)},          # 5 x 7 x 9 leaves partial chunks
    "one_frame_chunks": {"chunks": (1, 7, 9)},
    "deflate1": {"chunks": (2, 4, 5), "compression": "gzip", "compression_opts": 1},
    "deflate4": {"chunks": (3, 7, 4), "compression": "gzip", "compression_opts": 4},
    "deflate9": {"chunks": (5, 2, 9), "compression": "gzip", "compression_opts": 9},
    "shuffle": {"chunks": (2, 4, 5), "shuffle": True, "compression": "gzip"},
    "fletcher32": {"chunks": (2, 4, 5), "fletcher32": True},
    "all_filters": {"chunks": (2, 3, 4), "shuffle": True, "compression": "gzip",
                    "fletcher32": True},
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_layouts_and_types_equal_h5py(tmp_path, layout, dtype):
    opts = dict(LAYOUTS[layout])
    shape = (5, 7, 9)
    if layout == "compact":
        shape = (3, 4, 5)  # compact data lives in the 64 KiB object header
    arr = sample(shape, dtype, seed=len(layout))
    path = tmp_path / "a.h5"
    write(path, {"x": (arr, opts)})
    assert_same(path, ["x"])


@pytest.mark.parametrize("userblock", [0, 512, 1024])
def test_user_blocks_and_nested_groups(tmp_path, userblock):
    path = tmp_path / "nested.mat"
    data = {"top": (sample((4, 6), "<f4"), {}),
            "g/a": (sample((3, 5), "<u2"), {"chunks": (2, 2), "compression": "gzip"}),
            "g/h/b": (sample((2, 3, 3), ">f8"), {"chunks": (1, 3, 3)}),
            "g/h/i/c": (sample((6,), "<i2"), {})}
    write(path, data, userblock=userblock)
    if userblock:
        with open(path, "r+b") as f:
            f.write(b"MATLAB 7.3 MAT-file, Platform: GLNXA64".ljust(116, b" "))
    assert_same(path, list(data))
    with hdf5.File(path) as f:
        assert sorted(f.keys()) == ["g", "top"]
        assert isinstance(f["g"], hdf5.Group) and sorted(f["g"].keys()) == ["a", "h"]
        assert sorted(p for p, _ in f.walk()) == [
            "/g", "/g/a", "/g/h", "/g/h/b", "/g/h/i", "/g/h/i/c", "/top"]
        assert len(f.user_block()) == userblock
        if userblock:
            assert f.user_block().startswith(b"MATLAB 7.3 MAT-file")
        assert "g/h/b" in f and "g/nope" not in f


def test_many_members_split_the_group_tree(tmp_path):
    """Enough members for several symbol table nodes and B-tree levels."""
    path = tmp_path / "many.h5"
    data = {f"d{i:03d}": (np.full((2,), i, "<u2"), {}) for i in range(150)}
    write(path, data)
    with hdf5.File(path) as f:
        assert sorted(f.keys()) == sorted(data)
    assert_same(path, ["d000", "d077", "d149"])


@pytest.mark.parametrize("fill", [None, 7, -3.5])
def test_unwritten_chunks_read_as_the_fill_value(tmp_path, fill):
    path = tmp_path / "sparse.h5"
    dtype = "<f4" if isinstance(fill, float) else "<i2"
    with h5py.File(path, "w", libver="earliest") as f:
        kw = {} if fill is None else {"fillvalue": fill}
        ds = f.create_dataset("x", shape=(6, 5, 4), dtype=dtype, chunks=(2, 2, 3),
                              compression="gzip", **kw)
        ds[2:4, 1:3] = sample((2, 2, 4), dtype, seed=3)  # four of the chunks
        f.create_dataset("empty", shape=(3, 4), dtype=dtype, chunks=(2, 2), **kw)
        f.create_dataset("flat", shape=(3, 4), dtype=dtype, **kw)  # never allocated
    assert_same(path, ["x", "empty", "flat"])


def test_matlab_like_file_with_references(tmp_path):
    """A v7.3-like layout: a user block, chunked deflate images, a
    contiguous dataset beside them, a `#refs#` group and an object
    reference dataset `names`, which is listed but not read."""
    path = tmp_path / "nyu.mat"
    images = sample((3, 3, 8, 6), "<u1")
    depths = sample((3, 8, 6), "<f4")
    with h5py.File(path, "w", libver="earliest", userblock_size=512) as f:
        f.create_dataset("images", data=images, chunks=(1, 3, 8, 6), compression="gzip",
                         compression_opts=3)
        f.create_dataset("depths", data=depths)
        refs = f.create_group("#refs#")
        words = [refs.create_dataset(k, data=np.frombuffer(v.encode("utf-16-le"), "<u2"))
                 for k, v in (("a", "wall"), ("b", "floor"))]
        names = f.create_dataset("names", (1, 2), dtype=h5py.ref_dtype)
        names[0, 0], names[0, 1] = words[0].ref, words[1].ref
    assert_same(path, ["images", "depths", "#refs#/a", "#refs#/b"])
    with hdf5.File(path) as f:
        assert sorted(f.keys()) == ["#refs#", "depths", "images", "names"]
        names = f["names"]
        assert names.shape == (1, 2) and names.dtype is None
        assert "reference" in names.type_name
        with pytest.raises(ValueError, match="reference elements are listed, not read"):
            names.read()
        with pytest.raises(ValueError, match="reference"):
            names[0]


def test_frame_reads_inflate_only_their_chunks(tmp_path, monkeypatch):
    """[i] decodes the chunks that hold frame i and keeps them: frames that
    share a chunk inflate it once."""
    path = tmp_path / "frames.h5"
    arr = sample((6, 10, 8), "<u2")
    write(path, {"x": (arr, {"chunks": (3, 5, 8), "compression": "gzip"})})
    calls = []
    real = hdf5.zlib.decompress
    monkeypatch.setattr(hdf5.zlib, "decompress", lambda b: calls.append(1) or real(b))
    with hdf5.File(path) as f:
        ds = f["x"]
        for i in range(6):
            np.testing.assert_array_equal(ds[i], arr[i])
        assert len(calls) == 4  # two chunks for frames 0-2, two for 3-5
        ds.read()
        assert len(calls) == 8


def test_latest_format_raises(tmp_path):
    path = tmp_path / "latest.h5"
    write(path, {"x": (sample((4, 4), "<f4"), {"chunks": (2, 2)})}, libver="latest")
    with pytest.raises(ValueError, match="superblock version 3"):
        hdf5.File(path)


def test_truncated_file_raises(tmp_path):
    path = tmp_path / "full.h5"
    write(path, {"x": (sample((16, 64), "<f4"), {})}, userblock=512)
    data = path.read_bytes()
    cut = tmp_path / "cut.h5"
    cut.write_bytes(data[:len(data) - 100])
    with pytest.raises(ValueError, match="truncated file"):
        hdf5.File(cut)
    cut.write_bytes(data[:300])
    with pytest.raises(ValueError, match="no HDF5 signature"):
        hdf5.File(cut)


def test_damaged_chunk_raises(tmp_path):
    path = tmp_path / "damaged.h5"
    arr = np.arange(64, dtype="<u2").reshape(8, 8)
    write(path, {"x": (arr, {"chunks": (8, 8), "fletcher32": True})})
    data = bytearray(path.read_bytes())
    at = bytes(data).find(arr.tobytes()[:16])
    data[at] ^= 0xFF
    path.write_bytes(bytes(data))
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match="fletcher32 checksum mismatch"):
            f["x"].read()


def test_unknown_filter_raises(tmp_path):
    """h5py's LZF filter has the registered id 32000."""
    path = tmp_path / "lzf.h5"
    write(path, {"x": (sample((8, 8), "<u1"), {"chunks": (4, 4), "compression": "lzf"})})
    with hdf5.File(path) as f:
        with pytest.raises(ValueError, match="unknown filter id 32000"):
            f["x"]


def test_fletcher32_matches_the_hdf5_definition():
    """Odd lengths and long runs (several 360-word folds)."""
    def reference(data):
        s1 = s2 = 0
        words = [data[i] << 8 | data[i + 1] for i in range(0, len(data) - 1, 2)]
        for k in range(0, len(words), 360):
            for w in words[k:k + 360]:
                s1 += w
                s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        if len(data) % 2:
            s1 += data[-1] << 8
            s2 += s1
            s1 = (s1 & 0xFFFF) + (s1 >> 16)
            s2 = (s2 & 0xFFFF) + (s2 >> 16)
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
        return s2 << 16 | s1

    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 3, 719, 720, 721, 5000):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        assert hdf5.fletcher32(data) == reference(data), n
    assert hdf5.fletcher32(b"\xff" * 2000) == reference(b"\xff" * 2000)
