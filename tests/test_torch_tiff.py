"""The port's TIFF reader (multimae_tpu_torch/data/image_io.py `read_tiff`,
native/tiff_decode.cpp) against PIL 12.1 with libtiff 4.7, and the JAX
package's data pipeline over TIFF trees.

* (a) Every TIFF fixture of tests/fixtures/images but the JPEG-compressed
  and YCbCr ones, which tests/test_torch_tiff_jpeg.py holds (make_fixtures.py: PIL's
  writer and libtiff for what PIL writes, a hand writer for BigTIFF, tiles,
  planar files, FillOrder 2, big-endian compressed files, predictor 3,
  old-style LZW, MinIsWhite, 2- and 4-bit gray and palettes, associated
  alpha, 16-bit RGB, Orientation): convert("RGB") and the raw form
  bit-equal to PIL's committed digests, through the native decoders and
  through the Python twins; damaged files raise ValueError.
* (b) Files at random small sizes across compression x mode x predictor x
  byte order, in strips and tiles, written by the hand writer and by PIL,
  bit-equal to PIL in both forms.
* (c) The native LZW and PackBits decoders against their twins on random
  streams; flipped and cut bytes of whole files: every case raises
  ValueError (or UnsupportedImage) or decodes as PIL does, and none
  crashes.
* (d) The JAX package's MultiTaskImageFolder listing and pretraining
  transform against the port's on a tree whose rgb, depth (little- and
  big-endian) and semseg files are TIFF: the listing and raw samples
  equal, depth and semseg bit-equal, rgb within 1e-5. A big-endian depth
  map is held against the JAX transform fed its values as "I;16": Pillow
  12.1 resamples an "I;16B" image's bytes as little-endian samples
  (Resample.c reads "I;16B" as "I;16" on a little-endian host), and the
  port takes the samples' values.
* (e) The cls ImageFolder over TIFF files against the JAX package's.
* (f) Each compression and photometric the port refused until items 11g
  and 11h ported them (old-style and new-style JPEG, LZW YCbCr, CCITT RLE,
  Group 3, Group 4 and RLEW, ThunderScan, LZMA, ZSTD, CIELab) reads as PIL
  reads it, in a tree too, and so do the committed files once refused.
  SGILog and WebP-in-TIFF, which PIL refuses, raise ValueError naming the
  file, and the port's MultiTaskImageFolder resamples past them as the JAX
  package's does.
* (g) `write_tiff` output read back by PIL.
"""

import hashlib
import importlib.util
import io
import json
import random
import re
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from multimae_tpu_torch import native
from multimae_tpu_torch.data import image_io
from multimae_tpu_torch.data.image_io import UnsupportedImage

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
sys.path.insert(0, str(FIXTURES))
import make_fixtures as mf  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "tiff_codecs_make_fixtures", FIXTURES.parent / "tiff_codecs" / "make_fixtures.py")
mk = importlib.util.module_from_spec(_spec)  # the CCITT and ThunderScan writers
_spec.loader.exec_module(mk)

# The JPEG-compressed and YCbCr files (ROADMAP item 11g) are tests/test_torch_tiff_jpeg.py's.
TIFFS = sorted(n for n in EXPECTED if n.endswith(".tif") and not re.search(r"jpeg|ycbcr", n))
READ = [n for n in TIFFS if "sha256" in EXPECTED[n]]
REFUSED = [n for n in TIFFS if "error" in EXPECTED[n]]
UNPORTED = [n for n in TIFFS if "ported_in" in EXPECTED[n]]  # refused until 11h


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pil_forms(data: bytes):
    """PIL's convert("RGB") and raw form (make_fixtures.pil_digests's: "1"
    as 0 / 255, LA and PA their first band, alpha dropped, CMYK whole,
    native byte order) of a file, or the exception PIL raises."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        img = Image.open(io.BytesIO(data))
        rgb = np.asarray(img.convert("RGB"))
        raw = np.asarray(img)
    if raw.dtype == bool:
        raw = raw.astype(np.uint8) * 255
    if img.mode in ("LA", "PA"):
        raw = raw[..., 0]
    elif raw.ndim == 3 and img.mode != "CMYK":
        raw = raw[..., :3]
    return rgb, np.ascontiguousarray(raw.astype(raw.dtype.newbyteorder("=")))


def assert_matches_pil(data: bytes, what):
    """The port's two forms equal PIL's, through the native decoders and
    the twins; where PIL refuses the file, the port raises ValueError."""
    try:
        rgb, raw = pil_forms(data)
    except (OSError, ValueError, SyntaxError):
        for twin in (False, True):
            with pytest.raises(ValueError):
                image_io.read_tiff(data, twin)
        return False
    for twin in (False, True):
        img = image_io.read_tiff(data, twin)
        assert np.array_equal(img.rgb(), rgb), (what, twin, "rgb")
        got = img.raw()
        assert got.dtype == raw.dtype and np.array_equal(got, raw, equal_nan=True), (
            what, twin, "raw", img.mode)
    return True


# --- (a) the fixtures ------------------------------------------------------------


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("name", READ)
def test_tiff_fixture_matches_pil(name, twin):
    want = EXPECTED[name]
    rgb = image_io.load_image(str(FIXTURES / name), twin=twin)
    raw = image_io.load_image(str(FIXTURES / name), convert_rgb=False, twin=twin)
    assert list(rgb.shape) == want["shape"] and digest(rgb) == want["sha256"]
    assert list(raw.shape) == want["raw_shape"] and str(raw.dtype) == want["raw_dtype"]
    assert digest(raw) == want["raw_sha256"], want["mode"]


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("name", REFUSED)
def test_damaged_tiff_raises_value_error(name, twin):
    with pytest.raises(ValueError, match=rf"{name}: .*{EXPECTED[name]['error']}"):
        image_io.load_image(str(FIXTURES / name), twin=twin)


def test_tiff_fixtures_cover_the_modes():
    modes = {EXPECTED[n]["mode"] for n in READ}
    assert {"1", "L", "LA", "P", "PA", "I;16", "I;16B", "I", "F", "RGB", "RGBA",
            "CMYK"} <= modes
    trees = [n for n in READ if n.startswith("tree_")]
    assert len(trees) == 7 and {tuple(EXPECTED[n]["shape"]) for n in trees} == {(48, 64, 3)}
    assert not any(t(b"II*\x00....") for t, _, _ in image_io.UNPORTED_FORMATS)


# --- (b) files at random sizes ------------------------------------------------------


def _kind(name, rng, h, w):
    """(pixels, photometric, writer keywords) of a hand-written kind."""
    if name == "rgb8":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8), 2, {}
    if name in ("rgba_assoc", "rgba_unassoc", "rgbx"):
        extra = {"rgba_assoc": 1, "rgba_unassoc": 2, "rgbx": 0}[name]
        return rng.integers(0, 256, (h, w, 4), dtype=np.uint8), 2, {"extra": (extra,)}
    if name == "rgb16":
        return rng.integers(0, 65536, (h, w, 3)).astype(np.uint16), 2, {}
    if name == "cmyk":
        return rng.integers(0, 256, (h, w, 4), dtype=np.uint8), 5, {}
    if name == "la":
        return rng.integers(0, 256, (h, w, 2), dtype=np.uint8), 1, {"extra": (2,)}
    if name == "gray16":
        return rng.integers(0, 65536, (h, w)).astype(np.uint16), 1, {}
    if name == "gray16s":
        return rng.integers(-32768, 32768, (h, w)).astype(np.int16), 1, {}
    if name == "float32":
        return rng.normal(100, 150, (h, w)).astype(np.float32), 1, {}
    bits = int(name[-1])
    v = rng.integers(0, 1 << bits, (h, w), dtype=np.uint8)
    if name.startswith("pal"):
        return v, 3, {"bits": bits, "colormap": rng.integers(0, 65536, (1 << bits, 3))}
    return v, 0 if name.startswith("white") else 1, {"bits": bits}


KINDS = ["rgb8", "rgba_assoc", "rgba_unassoc", "rgbx", "rgb16", "cmyk", "la", "gray16",
         "gray16s", "float32", "gray1", "white2", "gray4", "pal1", "pal4", "pal8"]


@pytest.mark.parametrize("kind", KINDS)
def test_hand_written_tiffs_match_pil_at_random_sizes(kind):
    """Each compression (none, LZW, Deflate, PackBits) x predictor x byte
    order x strips or tiles x planar, at a random size each."""
    rng = np.random.default_rng(KINDS.index(kind))
    read = 0
    for case in range(12):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        px, photometric, kw = _kind(kind, rng, h, w)
        compression = (1, 5, 8, 32773)[case % 4]
        predictor = 1
        if compression in (5, 8) and case % 3:
            predictor = 3 if px.dtype == np.float32 else 2 if kw.get("bits", 8) >= 8 else 1
        tile = (16, 16 * int(rng.integers(1, 3))) if case % 2 else None
        data = mf.tiff(px, photometric, compression=compression, predictor=predictor,
                       order="<>"[case // 2 % 2], tile=tile, planar=1 + (case % 5 == 4),
                       rows_per_strip=0 if tile else int(rng.integers(1, h + 2)), **kw)
        read += assert_matches_pil(data, (kind, case, h, w, compression, predictor, tile))
    assert read >= 8, read  # Pillow refuses a few planar layouts: so does the port


PIL_MODES = ["1", "L", "LA", "P", "PA", "RGB", "RGBA", "RGBX", "CMYK", "I;16", "I;16B", "I",
             "F"]


@pytest.mark.parametrize("mode", PIL_MODES)
def test_pil_written_tiffs_match_pil(mode):
    """PIL's writer (uncompressed) and libtiff's (LZW, Deflate, PackBits;
    predictor 2 where libtiff takes it) at random sizes."""
    rng = np.random.default_rng(len(mode) * 7 + ord(mode[-1]))
    for case, compression in enumerate([None, "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                                        "packbits", "tiff_lzw", "tiff_adobe_deflate"]):
        h, w = (int(v) for v in rng.integers(1, 50, 2))
        src = Image.fromarray(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), "RGBA")
        if mode in ("P", "PA"):
            img = src.convert("RGB").quantize(int(rng.integers(2, 200))).convert(mode)
        elif mode in ("I;16", "I;16B"):
            img = Image.frombytes(mode, (w, h), rng.integers(0, 65536, (h, w)).astype(
                "<u2" if mode == "I;16" else ">u2").tobytes())
        elif mode == "I":
            img = Image.fromarray(rng.integers(-2**31, 2**31, (h, w)).astype(np.int32))
        elif mode == "F":
            img = Image.fromarray(rng.normal(100, 200, (h, w)).astype(np.float32))
        else:
            img = src.convert(mode)
        kw = {"compression": compression} if compression else {}
        if case >= 5 and mode not in ("1",):
            info = TiffImagePlugin.ImageFileDirectory_v2()
            info[317] = 2
            kw["tiffinfo"] = info
        buf = io.BytesIO()
        img.save(buf, "TIFF", **kw)
        assert_matches_pil(buf.getvalue(), (mode, compression, h, w))


@pytest.mark.parametrize("layout", ["orientation", "bigtiff", "lzw_compat", "fill_order",
                                    "rows_per_strip", "gray12"])
def test_tiff_layouts_match_pil(layout):
    rng = np.random.default_rng(len(layout))
    a = rng.integers(0, 256, (13, 22, 3), dtype=np.uint8)
    g16 = rng.integers(0, 65536, (9, 11)).astype(np.uint16)
    if layout == "orientation":
        files = [mf.tiff(a, 2, orientation=o, compression=c) for o in range(10) for c in (1, 5)]
    elif layout == "bigtiff":
        files = [mf.tiff(a, 2, bigtiff=True, compression=c, rows_per_strip=4)
                 for c in (1, 5, 8, 32773)]
    elif layout == "lzw_compat":
        files = [mf.tiff(px, ph, compression=5, lzw_compat=True, predictor=p)
                 for px, ph in ((a, 2), (g16, 1)) for p in (1, 2)]
        files.append(mf.tiff(rng.integers(0, 256, (120, 200), dtype=np.uint8), 1,
                             compression=5, lzw_compat=True))  # the table fills and widens
    elif layout == "fill_order":
        files = [mf.tiff(g16, 1, compression=c, fillorder=2, order=o, rows_per_strip=4)
                 for c in (1, 5, 8) for o in "<>"]
        files += [mf.tiff(a, 2, compression=c, fillorder=2) for c in (1, 5, 32773)]
    elif layout == "gray12":  # Pillow's "I;16" from 12-bit samples, little-endian files only
        g12 = rng.integers(0, 4096, (9, 11)).astype(np.uint16)
        files = [mf.tiff(g12, 1, bits=12, compression=c, rows_per_strip=4) for c in (1, 5, 8)]
    else:
        files = [mf.tiff(a, 2, rows_per_strip=r, compression=c)
                 for r in (1, 13, 14, 40, 0xFFFFFFFF) for c in (1, 5, 8)]
    for i, data in enumerate(files):
        assert_matches_pil(data, (layout, i))
    # A big-endian BigTIFF: PIL 12.1 reads its header as a classic one and fails.
    if layout == "bigtiff":
        data = mf.tiff(a, 2, bigtiff=True, order=">")
        with pytest.raises(OSError):
            pil_forms(data)
        with pytest.raises(ValueError):
            image_io.read_tiff(data)


# --- (c) the native decoders, and damaged files ----------------------------------------


def test_lzw_and_packbits_match_their_twins_on_random_streams():
    rng = np.random.default_rng(5)
    agreed = refused = 0
    for case in range(1500):
        if case % 4 == 0:
            data = rng.integers(0, 256, int(rng.integers(1, 300)), dtype=np.uint8).tobytes()
        elif case % 4 == 1:
            src = rng.integers(0, 4, int(rng.integers(1, 3000)), dtype=np.uint8).tobytes()
            data = bytearray(mf.lzw_encode(src, compat=case % 8 == 1))
            for _ in range(int(rng.integers(0, 3))):
                data[int(rng.integers(0, len(data)))] ^= 1 << int(rng.integers(0, 8))
            data = bytes(data[:int(rng.integers(1, len(data) + 1))])
        elif case % 4 == 2:
            data = bytes(rng.choice([0, 1, 3, 127, 128, 129, 200, 255], int(rng.integers(1, 300)))
                         .astype(np.uint8))
        else:
            src = rng.integers(0, 3, int(rng.integers(1, 3000)), dtype=np.uint8).tobytes()
            data = bytearray(mf.packbits_encode(src))
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
            data = bytes(data)
        size = int(rng.integers(1, 4000))
        for pair in ((native.tiff_lzw, image_io.lzw_twin),
                     (native.tiff_packbits, image_io.packbits_twin)):
            results = []
            for fn in pair:
                try:
                    results.append(fn(data, size))
                except ValueError as e:
                    results.append(str(e))
            if isinstance(results[0], str) or isinstance(results[1], str):
                assert results[0] == results[1], case
                refused += 1
            else:
                assert np.array_equal(results[0], results[1]), case
                agreed += 1
    assert agreed > 200 and refused > 1000, (agreed, refused)
    src = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    for compat in (False, True):  # past 4094 codes: Clear codes and 12-bit codes
        assert native.tiff_lzw(mf.lzw_encode(src, compat), len(src)).tobytes() == src
    assert native.tiff_packbits(mf.packbits_encode(src), len(src)).tobytes() == src


def test_damaged_tiffs_refuse_or_decode_as_pil_does():
    """Flipped bits, a replaced byte or a cut end, anywhere in LZW (with
    predictor 2, and the old coding), PackBits (tiled), Deflate (planar),
    uncompressed, big-endian 16-bit and palette files."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
    bases = [mf.tiff(a, 2, compression=5, predictor=2, rows_per_strip=7),
             mf.tiff(a, 2, compression=32773, tile=(16, 16)),
             mf.tiff(a, 2, compression=8, planar=2, rows_per_strip=6),
             mf.tiff(a, 2, compression=1, rows_per_strip=5),
             mf.tiff(rng.integers(0, 65536, (20, 30)).astype(np.uint16), 1, compression=5,
                     order=">", predictor=2),
             mf.tiff(rng.integers(0, 16, (20, 30), dtype=np.uint8), 3, bits=4,
                     compression=32773, colormap=rng.integers(0, 65536, (16, 3))),
             mf.tiff(a, 2, compression=5, lzw_compat=True)]
    decoded = refused = 0
    for case in range(700):
        data = bytearray(bases[case % len(bases)])
        if case % 3 == 0:
            for _ in range(int(rng.integers(1, 4))):
                data[int(rng.integers(0, len(data)))] ^= 1 << int(rng.integers(0, 8))
        elif case % 3 == 1:
            data = data[:int(rng.integers(8, len(data)))]
        else:
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        data = bytes(data)
        for twin in (False, True):
            try:
                img = image_io.read_tiff(data, twin)
            except (ValueError, UnsupportedImage):
                refused += 1
                continue
            rgb, raw = pil_forms(data)  # the port decoded it: PIL must, to the bit
            assert np.array_equal(img.rgb(), rgb) and np.array_equal(img.raw(), raw), case
            decoded += 1
    assert decoded > 300 and refused > 300, (decoded, refused)


# --- (d), (e) the JAX package's pipeline over TIFF trees --------------------------------


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    from _torch_jnative import bind_private_jax_fastimage

    with pytest.MonkeyPatch.context() as mp:
        try:
            yield bind_private_jax_fastimage(mp, tmp_path_factory.mktemp("jax_fastimage"))
        except RuntimeError as e:
            yield e


@pytest.fixture(scope="module")
def tiff_tree(tmp_path_factory):
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    root = tmp_path_factory.mktemp("tiff_tree")
    write_random_tree(str(root), 8, (40, 56), smooth=True, fmt="tiff")
    return str(root)


TASKS = ["depth", "rgb", "semseg"]


def test_tiff_tree_listing_and_raw_samples_match_jax(tiff_tree):
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu_torch.data import dataset_folder as tdf

    j, t = jdf.MultiTaskImageFolder(tiff_tree, TASKS), tdf.MultiTaskImageFolder(tiff_tree, TASKS)
    assert t.samples == j.samples and len(t) == len(j) == 8
    orders = set()
    for i in range(len(t)):
        js, jt = j.load_raw(i)
        ts, tt = t.load_raw(i)
        assert jt == tt
        orders.add(js["depth"].mode)
        for k in TASKS:
            ref = np.asarray(js[k])
            ref = ref.astype(ref.dtype.newbyteorder("="))
            assert ts[k].dtype == ref.dtype and np.array_equal(ts[k], ref), (i, k)
    assert orders == {"I;16", "I;16B"}


@pytest.mark.parametrize("size", [32, 64])
def test_tiff_tree_transform_matches_jax(tiff_tree, jax_native, size):
    """rgb within 1e-5 (normalised units), depth and semseg bit-equal; a
    big-endian depth map against the JAX transform of its values as
    "I;16" (the module docstring says why)."""
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu.data.pretrain_transforms import DataAugmentationForMultiMAE as JAug
    from multimae_tpu_torch.data import dataset_folder as tdf
    from multimae_tpu_torch.data.pretrain_transforms import DataAugmentationForMultiMAE as TAug

    assert not isinstance(jax_native, RuntimeError), jax_native
    j, t = jdf.MultiTaskImageFolder(tiff_tree, TASKS), tdf.MultiTaskImageFolder(tiff_tree, TASKS)
    ja, ta = JAug(input_size=size), TAug(input_size=size)
    worst = 0.0
    for idx in range(len(t)):
        sample = j.load_raw(idx)[0]
        if sample["depth"].mode == "I;16B":
            sample["depth"] = Image.fromarray(np.asarray(sample["depth"]).astype(np.uint16))
        for seed in range(2):
            jo = ja(dict(sample), rng=random.Random(seed))
            to = ta(t.load_raw(idx)[0], rng=random.Random(seed))
            assert set(jo) == set(to)
            for k in jo:
                assert to[k].shape == jo[k].shape and to[k].dtype == jo[k].dtype, k
            assert np.array_equal(to["depth"], jo["depth"]), idx
            assert np.array_equal(to["semseg"], jo["semseg"]), idx
            worst = max(worst, float(np.abs(to["rgb"] - jo["rgb"]).max()))
    assert worst <= 1e-5, worst


def test_cls_image_folder_over_tiffs_matches_jax(tmp_path):
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu_torch.data import dataset_folder as tdf

    names = [n for n in READ if EXPECTED[n]["mode"] in ("RGB", "RGBA", "P", "L", "CMYK", "1")]
    for i, name in enumerate(names):
        (tmp_path / f"c{i % 3}").mkdir(exist_ok=True)
        (tmp_path / f"c{i % 3}" / f"{i:03d}_{name}").write_bytes((FIXTURES / name).read_bytes())
    j, t = jdf.ImageFolder(str(tmp_path)), tdf.ImageFolder(str(tmp_path))
    assert t.samples == j.samples and len(t) == len(names)
    for i in range(len(t)):
        (img, target), (ref, ref_target) = t[i], j[i]
        assert target == ref_target and np.array_equal(img, np.asarray(ref)), t.samples[i]


# --- (f) refusals -------------------------------------------------------------------


# Refused until items 11g (6, 7, "ycbcr_lzw") and 11h (the rest) ported them.
REFUSALS = [2, 3, 4, 6, 7, 32771, 32809, 34925, 50000, "ycbcr_lzw", "cielab"]


@pytest.mark.parametrize("what", REFUSALS, ids=str)
def test_refused_tiff_names_file_and_item(what, tmp_path):
    """A file of each compression or photometric the port once refused
    (items 11g and 11h) reads as PIL reads it, alone and in a tree."""
    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder, write_random_tree

    rng = np.random.default_rng(3)
    px = mf.photo((16, 24), 3)
    doc = mk.bilevel((16, 24), 3)
    kinds = {2: "rle", 3: "g3", 4: "g4", 32771: "rlew"}
    if what in (6, 7, "ycbcr_lzw"):
        data = (mf.ojpeg_tiff(px) if what == 6 else mf.jpeg_tiff(px) if what == 7
                else mf.ycbcr_tiff(px, 2, 2, compression=5))
    elif what in kinds:
        data = mk.ccitt_tiff(doc, kinds[what], k=2 if what == 3 else 1, white=what == 4)
    elif what == 32809:
        data = mk.thunder_tiff(mk.gray4((16, 24), 3))
    elif what in (34925, 50000):
        data = mk.pil_save(Image.fromarray(px), compression="lzma" if what == 34925 else "zstd")
    else:
        data = mf.tiff(rng.integers(0, 256, (16, 24, 3), dtype=np.uint8), 8)
    assert image_io._TiffFile(data).scalar(259) == (1 if what == "cielab" else 5 if
                                                    what == "ycbcr_lzw" else what)
    write_random_tree(str(tmp_path), 4, (16, 24), classes=1)
    rgb = tmp_path / "rgb" / "c0"
    (rgb / "i0002.png").unlink()
    (rgb / "i0002.tif").write_bytes(data)
    want = pil_forms(data)
    assert np.array_equal(image_io.load_image(str(rgb / "i0002.tif")), want[0])
    assert np.array_equal(image_io.load_image(str(rgb / "i0002.tif"), False), want[1])
    sample = MultiTaskImageFolder(str(tmp_path), ["rgb"]).load_raw(2)[0]
    assert np.array_equal(sample["rgb"], want[0])


@pytest.mark.parametrize("code", sorted(image_io.TIFF_PIL_REFUSED))
def test_tiff_pil_refuses_is_resampled_by_both_loaders(code, tmp_path, capsys):
    """SGILog, SGILog24 and WebP-in-TIFF: PIL 12.1 opens such a file and
    fails to decode it, the port raises ValueError naming the file, and
    both MultiTaskImageFolders resample past it, to the same sample."""
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder, write_random_tree

    px = np.random.default_rng(code).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    data = mf.set_tiff_tag(mf.tiff(px, 2), 259, code)
    with pytest.raises(OSError):
        pil_forms(data)
    write_random_tree(str(tmp_path), 4, (16, 24), classes=1)
    rgb = tmp_path / "rgb" / "c0"
    (rgb / "i0002.png").unlink()
    (rgb / "i0002.tif").write_bytes(data)
    with pytest.raises(ValueError, match=rf"i0002\.tif: .*\({code}\), which PIL refuses"):
        image_io.load_image(str(rgb / "i0002.tif"))
    random.seed(code)
    ref = jdf.MultiTaskImageFolder(str(tmp_path), ["rgb"])[2][0]["rgb"]
    random.seed(code)
    got = MultiTaskImageFolder(str(tmp_path), ["rgb"])[2][0]["rgb"]
    assert np.array_equal(got, np.asarray(ref))
    out = capsys.readouterr().out  # each retry prints what it caught
    assert "decoder error" in out and "i0002.tif: a TIFF with" in out


@pytest.mark.parametrize("name", UNPORTED)
def test_refused_tiff_fixtures_pil_reads(name):
    """The committed TIFFs refused until item 11h: PIL reads each, and the
    port reads it to PIL's pixels, natively and through the twins."""
    rgb, raw = pil_forms((FIXTURES / name).read_bytes())
    assert EXPECTED[name]["ported_in"] == "11h"
    for twin in (False, True):
        assert np.array_equal(image_io.load_image(str(FIXTURES / name), twin=twin), rgb)
        assert np.array_equal(image_io.load_image(str(FIXTURES / name), False, twin), raw)


# --- (g) write_tiff -------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb", "palette"])
def test_write_tiff_reads_back_through_pil(kind, tmp_path):
    rng = np.random.default_rng(len(kind))
    path = tmp_path / "t.tif"
    for case in range(10):
        h, w = (int(v) for v in rng.integers(1, 45, 2))
        palette = None
        if kind == "gray8":
            px = rng.integers(0, 256, (h, w), dtype=np.uint8)
        elif kind == "gray16":
            px = rng.integers(0, 65536, (h, w)).astype(np.uint16)
        elif kind == "rgb":
            px = np.repeat(rng.integers(0, 256, (h, w // 3 + 1, 3), dtype=np.uint8), 3, 1)[:, :w]
        else:
            px = rng.integers(0, 200, (h, w), dtype=np.uint8)
            palette = rng.integers(0, 256, (200, 3), dtype=np.uint8)
        compression = ("none", "packbits", "deflate")[case % 3]
        image_io.write_tiff(path, px, palette, compression, 2 if case % 3 == 2 and case % 2 else 1,
                            "<>"[case % 2], (16, 32) if case % 4 == 3 else None)
        img = Image.open(path)
        got = np.asarray(img)
        if palette is not None:
            assert img.mode == "P" and np.array_equal(np.asarray(img.convert("RGB")), palette[px])
        got = got.astype(got.dtype.newbyteorder("="))
        assert np.array_equal(got, px), (kind, case)
        assert np.array_equal(image_io.load_image(str(path), convert_rgb=False), px)
    with pytest.raises(ValueError, match="predictor 2 goes with Deflate"):
        image_io.write_tiff(path, px, palette, "packbits", 2)


def test_the_port_imports_no_pil_or_libtiff():
    source = Path(image_io.__file__).read_text() + native.TIFF_SOURCE.read_text()
    assert not re.search(r"^\s*(import|from)\s+(PIL|tifffile|libtiff)", source, re.M)
    assert "#include <tiff" not in source


def test_tiff_without_the_native_library_raises_naming_the_file(tmp_path, monkeypatch):
    """The native library does not build (here from a broken copy of
    tiff_decode.cpp alone): an LZW file raises RuntimeError with g++'s
    message and the file's name, which no corrupt-file retry takes for a
    damaged file; the twins still decode it."""
    broken = tmp_path / "tiff_decode.cpp"
    broken.write_text(native.TIFF_SOURCE.read_text() + "\nint broken(\n")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "SOURCES", (broken,))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    path = tmp_path / "lzw.tif"
    path.write_bytes(mf.tiff(np.zeros((4, 5, 3), np.uint8), 2, compression=5))
    with pytest.raises(RuntimeError, match=r"(?s)lzw\.tif: g\+\+ .* failed:\n.*tiff_decode\.cpp"):
        image_io.load_image(str(path))
    assert image_io.load_image(str(path), twin=True).shape == (4, 5, 3)
