"""The port's JPEG-compressed and YCbCr TIFF reading (ROADMAP item 11g:
multimae_tpu_torch/data/image_io.py `read_tiff`, native/jpeg_decode.cpp
`mm_decode_jpeg_tiff`) against PIL 12.1 with libtiff 4.7 and
libjpeg-turbo 3.1, and the JAX package's data pipeline over a JPEG-TIFF
tree.

* (a) Every JPEG-compressed and YCbCr fixture of tests/fixtures/images
  (make_fixtures.py: `jpeg_tiff`, `ojpeg_tiff`, `ycbcr_tiff` and PIL's
  writer): convert("RGB") and the raw form bit-equal to PIL's committed
  digests, through the native decoders and the twins; the damaged ones
  raise ValueError naming what libtiff refuses.
* (b) Files at random small sizes: new-style JPEG (compression 7) as
  YCbCr at 4:4:4, 4:2:2 and 4:2:0, RGB, gray, MinIsWhite and CMYK, in
  strips and tiles, chunky and planar, with JPEGTables or whole streams,
  and as PIL writes it (with alpha too);
  old-style JPEG (compression 6) in its three forms, gray too; LZW,
  Deflate and PackBits YCbCr at each subsampling of libtiff's RGBA reader,
  in strips and tiles, with a predictor: each bit-equal to PIL.
* (c) Tables-only streams and abbreviated ones: each bit-equal to the same
  data as one whole stream; the JPEG files of tests/fixtures/jpeg keep
  their digests through the old entry point.
* (d) Flipped and cut bytes of whole files: each raises ValueError or
  decodes as PIL does, and none crashes.
* (e) The JAX package's MultiTaskImageFolder listing and pretraining
  transform against the port's on a tree whose rgb images are the
  JPEG-TIFF tree fixtures: listing and raw samples equal, depth and semseg
  bit-equal, rgb within 1e-5.

PIL's TIFF writer is never asked for a subsampled JPEG-compressed file:
its encoder fails on tag 530 under JPEG and the process aborts.
"""

import hashlib
import io
import json
import random
import re
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from multimae_tpu_torch import native
from multimae_tpu_torch.data import image_io
from multimae_tpu_torch.data.image_io import UnsupportedImage

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
JPEG_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
sys.path.insert(0, str(FIXTURES))
import make_fixtures as mf  # noqa: E402

FAMILY = re.compile(r"(jpeg|ycbcr)")
NAMES = sorted(n for n in EXPECTED if n.endswith(".tif") and FAMILY.search(n))
READ = [n for n in NAMES if "sha256" in EXPECTED[n]]
REFUSED = [n for n in NAMES if "error" in EXPECTED[n]]


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pil_forms(data: bytes):
    """PIL's convert("RGB") and raw form (LA its first band, alpha
    dropped, CMYK whole)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        img = Image.open(io.BytesIO(data))
        rgb = np.asarray(img.convert("RGB"))
        raw = np.asarray(img)
    if img.mode == "LA":
        raw = raw[..., 0]
    elif raw.ndim == 3 and img.mode != "CMYK":
        raw = raw[..., :3]
    return rgb, np.ascontiguousarray(raw)


def assert_matches_pil(data: bytes, what, twins=(False, True)):
    """The port's two forms equal PIL's through the native decoders and the
    twins; where PIL refuses the file, the port raises ValueError. Returns
    whether PIL read it."""
    try:
        rgb, raw = pil_forms(data)
    except (OSError, ValueError, SyntaxError):
        for twin in twins:
            with pytest.raises(ValueError):
                image_io.read_tiff(data, twin)
        return False
    for twin in twins:
        img = image_io.read_tiff(data, twin)
        assert np.array_equal(img.rgb(), rgb), (what, twin, "rgb")
        got = img.raw()
        assert got.dtype == raw.dtype and np.array_equal(got, raw), (what, twin, "raw", img.mode)
    return True


# --- (a) the fixtures ------------------------------------------------------------


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("name", READ)
def test_jpeg_tiff_fixture_matches_pil(name, twin):
    want = EXPECTED[name]
    rgb = image_io.load_image(str(FIXTURES / name), twin=twin)
    raw = image_io.load_image(str(FIXTURES / name), convert_rgb=False, twin=twin)
    assert list(rgb.shape) == want["shape"] and digest(rgb) == want["sha256"]
    assert list(raw.shape) == want["raw_shape"] and str(raw.dtype) == want["raw_dtype"]
    assert digest(raw) == want["raw_sha256"], want["mode"]


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("name", REFUSED)
def test_damaged_jpeg_tiff_raises_value_error(name, twin):
    with pytest.raises(ValueError, match=rf"{name}: .*{EXPECTED[name]['error']}"):
        image_io.load_image(str(FIXTURES / name), twin=twin)


def test_jpeg_tiff_fixtures_cover_the_layouts():
    """Compression 6 and 7, every subsampling of the RGBA reader, the four
    tree images of chip_smoke.py's TIFF epoch at the tree's size, and no
    refused compression left (the old-style JPEG tiles side by side with
    tables in tags, 11g's last corner, among the files read)."""
    tags = {n: image_io._TiffFile((FIXTURES / n).read_bytes()) for n in READ}
    compressions = {f.scalar(259) for f in tags.values()}
    assert {5, 6, 7, 8, 32773} <= compressions
    sampling = {tuple(f.tags[530]) for n, f in tags.items() if "ycbcr" in n and 530 in f.tags}
    assert set(image_io._YCBCR_PUTS) <= sampling
    trees = [n for n in READ if n.startswith("tree_")]
    assert len(trees) == 4 and {tuple(EXPECTED[n]["shape"]) for n in trees} == {(48, 64, 3)}
    assert not hasattr(image_io, "TIFF_REFUSED")
    assert "unported_ojpeg_tiles_tables.tif" in READ


# --- (b) files at random sizes --------------------------------------------------------

NEW_STYLE = ["ycbcr444", "ycbcr422", "ycbcr420", "ycbcr_planar", "rgb", "rgb_planar", "gray",
             "white", "cmyk"]


@pytest.mark.parametrize("kind", NEW_STYLE)
def test_new_style_jpeg_tiffs_match_pil_at_random_sizes(kind):
    """Strips (rows a multiple of the MCU's or not, the last one short) or
    tiles (edge tiles padded), JPEGTables or whole streams, both byte
    orders."""
    rng = np.random.default_rng(NEW_STYLE.index(kind))
    read = 0
    for case in range(6):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        px = mf.photo((h, w), case + 10 * NEW_STYLE.index(kind), noise=4)
        photometric, sub, planar = 6, 2, 1
        if kind.startswith("ycbcr4"):
            sub = {"ycbcr444": 0, "ycbcr422": 1, "ycbcr420": 2}[kind]
        elif kind == "ycbcr_planar":
            sub, planar = 0, 2
        elif kind.startswith("rgb"):
            photometric, planar = 2, 1 + (kind == "rgb_planar")
        elif kind in ("gray", "white"):
            photometric, px = (1 if kind == "gray" else 0), px[..., 1]
        else:
            photometric, px = 5, np.concatenate([px, px[..., :1]], -1)
        tile = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3))) if case % 2 else None
        rows = 0 if tile else int(rng.integers(1, 5)) * 8 * (2 if sub == 2 else 1)
        data = mf.jpeg_tiff(px, photometric, subsampling=sub, rows_per_strip=rows, tile=tile,
                            tables=case % 3 != 2, planar=planar, order="<>"[case % 2],
                            quality=int(rng.integers(30, 96)))
        read += assert_matches_pil(data, (kind, case, h, w, tile, rows))
    assert read == 6


PIL_MODES = ["RGB", "RGBA", "RGBX", "LA", "L", "CMYK", "YCbCr"]


@pytest.mark.parametrize("mode", PIL_MODES)
def test_pil_written_jpeg_tiffs_match_pil(mode):
    """libtiff's JPEG writer as PIL drives it (4:4:4 only; 2, 3 and 4
    components, YCbCr as photometric 6) at random sizes and qualities."""
    rng = np.random.default_rng(PIL_MODES.index(mode))
    for case in range(3):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        src = np.concatenate([mf.photo((h, w), case, noise=4),
                              rng.integers(0, 256, (h, w, 1), dtype=np.uint8)], -1)
        buf = io.BytesIO()
        Image.fromarray(src, "RGBA").convert(mode).save(
            buf, "TIFF", compression="jpeg", quality=int(rng.integers(20, 96)))
        assert assert_matches_pil(buf.getvalue(), (mode, case, h, w))


@pytest.mark.parametrize("form", ["tables", "jif", "jif_header", "gray"])
def test_old_style_jpeg_tiffs_match_pil_at_random_sizes(form):
    """Each subsampling in each form, in strips of whole MCU rows or in
    tiles (side by side where the stream's frame holds them all, one
    column in the tables form); the gray files in the tables form."""
    rng = np.random.default_rng(len(form))
    for case in range(8):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        px = mf.photo((h, w), 50 + case, noise=4)
        sub = case % 3
        vs = mf.SUBSAMPLING[sub][1]
        rows = 8 * vs * int(rng.integers(1, 4))
        tile = None
        if case >= 6:
            tw = 16 * int(rng.integers(1, 5))
            tile = (16 * vs, -(-w // 16) * 16 if form in ("tables", "gray") else tw)
        if form == "gray":
            data = mf.ojpeg_tiff(px[..., 0], rows_per_strip=rows, tile=tile)
        else:
            data = mf.ojpeg_tiff(px, subsampling=sub, rows_per_strip=rows, form=form, tile=tile,
                                 sampling_tag=form == "tables" or case % 2 == 0)
        assert assert_matches_pil(data, (form, case, h, w, sub, rows, tile))


@pytest.mark.parametrize("sampling", image_io._YCBCR_PUTS, ids=str)
def test_compressed_ycbcr_tiffs_match_pil_at_random_sizes(sampling):
    """LZW, Deflate and PackBits data units in strips (rows a multiple of
    the unit's or not) and tiles, with the horizontal predictor in some,
    through libtiff's RGBA reader."""
    hs, vs = sampling
    rng = np.random.default_rng(hs * 10 + vs)
    for case in range(6):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        px = mf.photo((h, w), 60 + case, noise=6)
        compression = (5, 8, 32773)[case % 3]
        tile = (16, 16 * int(rng.integers(1, 3))) if case % 2 else None
        predictor = 2 if case in (0, 1, 3, 4) else 1  # LZW and Deflate, strips and tiles
        data = mf.ycbcr_tiff(px, hs, vs, compression=compression, tile=tile,
                             rows_per_strip=0 if tile else int(rng.integers(1, 12)),
                             predictor=predictor)
        assert assert_matches_pil(data, (sampling, case, h, w, compression, tile, predictor))


def test_ycbcr_coefficients_and_reference_black_white_match_pil():
    """YCbCrCoefficients (529) and ReferenceBlackWhite (532) as rationals,
    libtiff's float tables, on chunky and planar files."""
    rng = np.random.default_rng(4)
    for case in range(8):
        luma = [(0.299, 0.587, 0.114), (0.2126, 0.7152, 0.0722), (0.3, 0.59, 0.11)][case % 3]
        refbw = [(0, 255, 128, 255, 128, 255), (16, 235, 128, 240, 128, 240),
                 (15.5, 234.25, 127, 241, 100, 230), (0, 255, 0, 255, 0, 255)][case % 4]
        tags = [(529, 5, [v for c in luma for v in (int(round(c * 10000)), 10000)]),
                (532, 5, [v for c in refbw for v in (int(round(c * 4)), 4)])]
        px = mf.photo(tuple(int(v) for v in rng.integers(1, 40, 2)), 70 + case, noise=6)
        hs, vs = [(1, 1), (2, 2), (2, 1), (4, 2)][case % 4]
        assert assert_matches_pil(mf.ycbcr_tiff(px, hs, vs, rows_per_strip=8, tags=tags), case)
    planar = mf.tiff(rng.integers(0, 256, (9, 13, 3), dtype=np.uint8), 6, compression=5,
                     planar=2, rows_per_strip=4, tags=[(530, 3, [1, 1])] + tags)
    assert assert_matches_pil(planar, "planar")


def test_jpeg_tiff_edge_streams_match_pil():
    """What libtiff's JPEG codec lets through: no YCbCrSubsampling tag (the
    first stream's frame header read), JFIF and Adobe markers in the
    streams (the colour handling stays forced), streams without EOI,
    JPEGTables without EOI, a last stream taller than its strip, streams
    shorter or narrower than their strip or tile (Pillow's buffer keeps the
    strip before's samples), progressive streams, an Orientation, and
    old-style files that say RGB or lack the subsampling tag."""
    px = mf.photo((40, 37), 1, noise=4)
    ab = [mf.split_jpeg(mf.jpeg_stream(px[y:y + 16], 2)) for y in range(0, 40, 16)]
    full = [mf.jpeg_stream(px[y:y + 16], 2) for y in range(0, 40, 16)]
    files = [mf.jpeg_tiff(px, 6, subsampling=s, rows_per_strip=16, sampling_tag=False)
             for s in (0, 1, 2)]
    files += [mf.jpeg_tiff(px, 6, subsampling=1, rows_per_strip=16, keep_app=True),
              mf.jpeg_tiff(px, 2, rows_per_strip=16, keep_app=True)]
    files += [mf.jpeg_tiff(px, 6, rows_per_strip=8, tags=[(274, 3, [o])]) for o in (3, 5, 8)]
    base = dict(compression=7, rows_per_strip=16, tags=[(530, 3, [2, 2])])
    files += [mf.tiff(px, 6, chunks=[s[:-2] for s in full], **base),
              mf.tiff(px, 6, chunks=[a for _, a in ab], **dict(base, tags=base["tags"] + [
                  (347, 7, ab[0][0][:-2])])),
              mf.tiff(px[:30], 6, chunks=full[:2], **base),
              mf.tiff(px[:32], 6, chunks=[full[0], mf.jpeg_stream(px[16:24], 2)], **base),
              mf.tiff(px[:32], 6, chunks=[full[0], mf.jpeg_stream(px[16:32, :20], 2)], **base),
              mf.tiff(px[:32, :32], 6, compression=7, tile=(16, 16), tags=[(530, 3, [2, 2])],
                      chunks=[mf.jpeg_stream(p, 2) for p in (px[:16, :16], px[:8, 16:32],
                                                             px[16:32, :16], px[16:32, 16:32])])]
    for ph in (2, 6):
        files.append(mf.ojpeg_tiff(px, rows_per_strip=16, form="jif_header", photometric=ph))
    for ph in (0, 1):
        files.append(mf.set_tiff_tag(mf.ojpeg_tiff(px[..., 0], rows_per_strip=16, form="jif"),
                                     262, ph))
    files.append(mf.ojpeg_tiff(px, subsampling=0, rows_per_strip=40, form="jif",
                               sampling_tag=False))
    for i, data in enumerate(files):
        assert assert_matches_pil(data, i), i


def test_jpeg_tiffs_pil_refuses_raise_value_error():
    """libtiff's refusals: JPEGTables of no tables, sampling factors
    against tag 530, a stream of other than 8-bit samples, a planar YCbCr file subsampled,
    old-style strips of no whole MCU rows, old-style files of three
    MinIsBlack samples or one YCbCr sample."""
    px = mf.photo((40, 37), 2, noise=4)
    full = [mf.jpeg_stream(px[y:y + 16], 2) for y in range(0, 40, 16)]
    base = dict(compression=7, rows_per_strip=16)
    tables, abbreviated = mf.split_jpeg(full[0])
    files = [mf.tiff(px[:16], 6, chunks=[abbreviated], tags=[(530, 3, [2, 2]), (347, 7, b"x")],
                     **base),
             mf.tiff(px[:16], 6, chunks=[abbreviated], tags=[(530, 3, [1, 1]), (347, 7, tables)],
                     **base),
             mf.tiff(px[:16], 6, chunks=[full[0]], tags=[(530, 3, [2, 2])], bits=12, **base),
             mf.jpeg_tiff(px, 6, subsampling=2, rows_per_strip=16, planar=2,
                          tags=[(530, 3, [2, 2])], sampling_tag=False),
             mf.set_tiff_tag(mf.ojpeg_tiff(px, subsampling=2, rows_per_strip=16), 278, 24),
             mf.ojpeg_tiff(px, rows_per_strip=16, form="jif_header", photometric=1),
             mf.set_tiff_tag(mf.ojpeg_tiff(px[..., 0], rows_per_strip=16), 262, 6)]
    for i, data in enumerate(files):
        assert not assert_matches_pil(data, i), i
    # A first stream shorter than its strip: PIL shows what Pillow's new
    # buffer held, which no reader reproduces; the port refuses it.
    short = mf.tiff(px[:32], 6, chunks=[mf.jpeg_stream(px[:8], 2), full[1]],
                    tags=[(530, 3, [2, 2])], **base)
    with pytest.raises(ValueError, match="rest of Pillow's buffer"):
        image_io.read_tiff(short)


# --- (c) tables and abbreviated streams --------------------------------------------------


def test_abbreviated_streams_equal_whole_streams():
    """Each PIL-encoded stream (gray, YCbCr at every subsampling, restart
    markers, progressive, optimised tables) split into a tables-only
    stream and an abbreviated one decodes bit-equal to the whole stream,
    in every colour handling; the tables come first, so the image stream
    may redefine them."""
    rng = np.random.default_rng(6)
    for case in range(24):
        h, w = (int(v) for v in rng.integers(1, 80, 2))
        px = mf.photo((h, w), 80 + case, noise=8)
        px = px[..., 0] if case % 4 == 3 else px
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "JPEG", quality=int(rng.integers(20, 96)),
                                 subsampling=case % 3, progressive=case % 5 == 1,
                                 optimize=case % 7 == 2,
                                 restart_marker_blocks=int(rng.integers(1, 9)) * (case % 2))
        whole = buf.getvalue()
        tables, image = mf.split_jpeg(whole)
        assert len(tables) > 4 and b"\xff\xdb" not in image.split(b"\xff\xda")[0]
        for color in ("none", "planes") + (("rgb",) if px.ndim == 3 else ()):
            a = native.decode_jpeg_tiff(image, tables, color)
            b = native.decode_jpeg_tiff(whole, None, color)
            assert (a.height, a.width, a.sampling) == (b.height, b.width, b.sampling), case
            for x, y in zip(a.pixels if color == "planes" else [a.pixels],
                            b.pixels if color == "planes" else [b.pixels]):
                assert np.array_equal(x, y), (case, color)
        ref = native.decode_jpeg(whole)  # JFIF: the old entry point's YCbCr to RGB
        got = native.decode_jpeg_tiff(image, tables, "rgb" if px.ndim == 3 else "none").pixels
        assert np.array_equal(got if px.ndim == 3 else np.repeat(got, 3, 2), ref), case
        # The tables stream's own DRI is reset by the image's SOI, as libjpeg resets it.
        again = native.decode_jpeg_tiff(image, tables[:-2] + b"\xff\xdd\x00\x04\x00\x05\xff\xd9",
                                        "none")
        assert np.array_equal(again.pixels, native.decode_jpeg_tiff(whole, None, "none").pixels)


def test_jpeg_fixtures_unchanged_through_the_old_entry_point():
    want = json.loads((JPEG_FIXTURES / "expected.json").read_text())
    checked = 0
    for name, entry in sorted(want.items()):
        if "sha256" not in entry:
            continue
        out = native.decode_jpeg((JPEG_FIXTURES / name).read_bytes())
        assert list(out.shape) == entry["shape"] and digest(out) == entry["sha256"], name
        checked += 1
    assert checked >= 20, checked


def test_tables_stream_refusals():
    px = mf.photo((16, 16), 3)
    whole = mf.jpeg_stream(px, 2)
    tables, image = mf.split_jpeg(whole)
    for bad, words in ((b"", "no quantisation table"), (tables[2:], "not a JPEG stream"),
                       (whole, "holds a frame"),
                       (tables[:-2] + whole[whole.index(b"\xff\xda"):], "holds a scan"),
                       (tables[:-2] + b"\xff\xd8\xff\xd9", "second SOI")):
        with pytest.raises(ValueError, match=words):
            native.decode_jpeg_tiff(image, bad or None, "rgb")
    with pytest.raises(ValueError, match="YCbCr to RGB of a stream of 1 components"):
        native.decode_jpeg_tiff(mf.jpeg_stream(px[..., 0], 0), None, "rgb")
    # A tables stream that ends where a marker is due ends as if it held EOI.
    assert np.array_equal(native.decode_jpeg_tiff(image, tables[:-2], "rgb").pixels,
                          native.decode_jpeg(whole))


# --- (d) damaged files --------------------------------------------------------------------


def test_damaged_jpeg_tiffs_refuse_or_decode_as_pil_does():
    """Flipped bits, a replaced byte or a cut end, anywhere in new-style
    JPEG (tables, strips and tiles), old-style JPEG (tables and JIF) and
    LZW YCbCr files."""
    rng = np.random.default_rng(8)
    px = mf.photo((24, 30), 9, noise=4)
    bases = [mf.jpeg_tiff(px, 6, rows_per_strip=16), mf.jpeg_tiff(px, 6, tile=(16, 16)),
             mf.ojpeg_tiff(px, rows_per_strip=16), mf.ojpeg_tiff(px, rows_per_strip=16,
                                                                 form="jif"),
             mf.ycbcr_tiff(px, 2, 2, rows_per_strip=8)]
    decoded = refused = 0
    for case in range(400):
        data = bytearray(bases[case % len(bases)])
        if case % 3 == 0:
            for _ in range(int(rng.integers(1, 4))):
                data[int(rng.integers(0, len(data)))] ^= 1 << int(rng.integers(0, 8))
        elif case % 3 == 1:
            data = data[:int(rng.integers(8, len(data)))]
        else:
            data[int(rng.integers(0, len(data)))] = int(rng.integers(0, 256))
        data = bytes(data)
        try:
            img = image_io.read_tiff(data)
        except (ValueError, UnsupportedImage):
            refused += 1
            continue
        rgb, raw = pil_forms(data)  # the port decoded it: PIL must, to the bit
        assert np.array_equal(img.rgb(), rgb) and np.array_equal(img.raw(), raw), case
        decoded += 1
    assert decoded > 100 and refused > 100, (decoded, refused)


# --- (e) the JAX package's pipeline over a JPEG-TIFF tree --------------------------------


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    from _torch_jnative import bind_private_jax_fastimage

    with pytest.MonkeyPatch.context() as mp:
        try:
            yield bind_private_jax_fastimage(mp, tmp_path_factory.mktemp("jax_fastimage"))
        except RuntimeError as e:
            yield e


@pytest.fixture(scope="module")
def jpeg_tiff_tree(tmp_path_factory):
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    root = tmp_path_factory.mktemp("jpeg_tiff_tree")
    rgb = [str(FIXTURES / n) for n in READ if n.startswith("tree_")]
    write_random_tree(str(root), 8, (48, 64), smooth=True, rgb_files=rgb, fmt="tiff")
    return str(root)


TASKS = ["depth", "rgb", "semseg"]


def test_jpeg_tiff_tree_listing_and_raw_samples_match_jax(jpeg_tiff_tree):
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu_torch.data import dataset_folder as tdf

    j = jdf.MultiTaskImageFolder(jpeg_tiff_tree, TASKS)
    t = tdf.MultiTaskImageFolder(jpeg_tiff_tree, TASKS)
    assert t.samples == j.samples and len(t) == len(j) == 8
    for i in range(len(t)):
        js, jt = j.load_raw(i)
        ts, tt = t.load_raw(i)
        assert jt == tt
        for k in TASKS:
            ref = np.asarray(js[k])
            ref = ref.astype(ref.dtype.newbyteorder("="))
            assert ts[k].dtype == ref.dtype and np.array_equal(ts[k], ref), (i, k)


@pytest.mark.parametrize("size", [32, 48])
def test_jpeg_tiff_tree_transform_matches_jax(jpeg_tiff_tree, jax_native, size):
    """rgb within 1e-5 (normalised units), depth and semseg bit-equal; a
    big-endian depth map against the JAX transform of its values as
    "I;16", as tests/test_torch_tiff.py (d) explains."""
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu.data.pretrain_transforms import DataAugmentationForMultiMAE as JAug
    from multimae_tpu_torch.data import dataset_folder as tdf
    from multimae_tpu_torch.data.pretrain_transforms import DataAugmentationForMultiMAE as TAug

    assert not isinstance(jax_native, RuntimeError), jax_native
    j = jdf.MultiTaskImageFolder(jpeg_tiff_tree, TASKS)
    t = tdf.MultiTaskImageFolder(jpeg_tiff_tree, TASKS)
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


def test_the_port_imports_no_libjpeg_or_libtiff():
    source = Path(image_io.__file__).read_text() + native.JPEG_SOURCE.read_text()
    assert not re.search(r"^\s*(import|from)\s+(PIL|tifffile|libtiff)", source, re.M)
    assert not re.search(r"#include\s*<(tiff|jpeglib|turbojpeg)", source)
