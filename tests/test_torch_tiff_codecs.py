"""The port's TIFF reading of the last codecs PIL reads through libtiff
(ROADMAP item 11h: CCITT RLE, Group 3, Group 4 and RLEW, LZMA, ZSTD,
ThunderScan), of CIELab and of the one-band planar file, against PIL 12.1
with libtiff 4.7.1 and LittleCMS 2.17 (multimae_tpu_torch/data/image_io.py
`read_tiff`; native/ccitt_decode.cpp, zstd_decode.cpp, cielab.cpp and
tiff_decode.cpp `mm_tiff_thunderscan`).

* (a) Every fixture of tests/fixtures/tiff_codecs (its make_fixtures.py:
  PIL's writer where it writes the codec, hand-written CCITT, RLEW,
  ThunderScan and Zstandard frames where it does not): convert("RGB") and
  the raw form bit-equal to PIL's committed digests, natively and through
  the twins (`ccitt_twin`, `thunderscan_twin`, `lab_to_rgb_twin`); the
  damaged ones raise ValueError naming what libtiff fails on. The
  Zstandard fixtures hold every block, literals and table kind.
* (b) PIL-written CCITT ("1"), LZMA and ZSTD ("L", "RGB", "LAB") files at
  random sizes and strip heights, strips past 128 KiB of smooth, noisy
  and constant pixels among them, and hand-written CCITT and ThunderScan
  files in strips and tiles: bit-equal to PIL.
* (c) All 2^24 CIELab triples, as one 4096 x 4096 image, natively and
  through the twin: PIL's convert("RGB"), every pixel.
* (d) The native CCITT and ThunderScan decoders against their twins on
  random and damaged streams; PIL's Zstandard frames changed by hand to
  probe libzstd's rules (checksum, content size, single segment,
  skippable frames, dictionary ID, reserved bits) read or refused as PIL
  does.
* (e) Flipped bits, a replaced byte or a cut end in CCITT (each of the
  four, PIL's own RLEW output among them), LZMA, ZSTD, ThunderScan and
  old-style JPEG tiles with tables in tags: each file decodes bit-equal
  to PIL or raises ValueError; at least 300 of each.
* (f) A tree whose rgb files are the new codecs through the JAX package's
  and the port's pretraining pipelines: the same samples.
"""

import hashlib
import importlib.util
import io
import json
import random
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from multimae_tpu_torch import native
from multimae_tpu_torch.data import image_io

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "tiff_codecs"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
READ = sorted(n for n, e in EXPECTED.items() if "sha256" in e)
REFUSED = sorted(n for n, e in EXPECTED.items() if "error" in e)
_spec = importlib.util.spec_from_file_location("tiff_codecs_make_fixtures",
                                               FIXTURES / "make_fixtures.py")
mk = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mk)
mf = mk.mf  # tests/fixtures/images/make_fixtures.py: the TIFF writer


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def pil_forms(data: bytes):
    """PIL's convert("RGB") and raw form ("1" as 0 / 255, alpha dropped,
    native byte order), or the exception PIL raises."""
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


def port_forms(data: bytes, twin: bool):
    img = image_io.read_tiff(data, twin)
    return img.rgb(), img.raw()


def assert_matches_pil(data: bytes, what) -> bool:
    """The port's two forms equal PIL's natively and through the twins;
    where PIL refuses the file, the port raises ValueError. Returns whether
    PIL read it."""
    try:
        want = pil_forms(data)
    except (OSError, ValueError, SyntaxError):
        for twin in (False, True):
            with pytest.raises(ValueError):
                image_io.read_tiff(data, twin)
        return False
    for twin in (False, True):
        got = port_forms(data, twin)
        assert got[1].dtype == want[1].dtype, (what, twin)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), (what, twin)
    return True


def pil_save(img, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


# --- (a) the fixtures -------------------------------------------------------------


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("name", READ)
def test_codec_fixture_matches_pil(name, twin):
    want = EXPECTED[name]
    rgb = image_io.load_image(str(FIXTURES / name), twin=twin)
    raw = image_io.load_image(str(FIXTURES / name), convert_rgb=False, twin=twin)
    assert list(rgb.shape) == want["shape"] and digest(rgb) == want["sha256"]
    assert list(raw.shape) == want["raw_shape"] and str(raw.dtype) == want["raw_dtype"]
    assert digest(raw) == want["raw_sha256"], want["mode"]


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("name", REFUSED)
def test_damaged_codec_fixture_raises_value_error(name, twin):
    with pytest.raises(ValueError, match=rf"{name}: .*{EXPECTED[name]['error']}"):
        image_io.load_image(str(FIXTURES / name), twin=twin)


def test_codec_fixtures_cover_the_codecs():
    """Every codec and layout of item 11h, the tree files at one size, all
    within the directory's budget."""
    tags = {n: image_io._TiffFile((FIXTURES / n).read_bytes()) for n in EXPECTED}
    assert {f.scalar(259) for f in tags.values()} >= {1, 2, 3, 4, 5, 8, 32771, 32809, 34925,
                                                      50000}
    assert {EXPECTED[n]["codec"] for n in READ} == {"ccitt", "lzma", "zstd", "thunderscan",
                                                    "cielab", "planar"}
    assert {EXPECTED[n]["mode"] for n in READ} >= {"1", "L", "RGB", "LAB", "I;16", "P"}
    g3 = [f for f in tags.values() if f.scalar(259) == 3]
    assert {f.scalar(292, 0) for f in g3} >= {0, 1, 5}
    assert {f.scalar(266, 1) for n, f in tags.items() if "ccitt" in n} == {1, 2}
    assert any(324 in f.tags for n, f in tags.items() if "ccitt" in n)  # tiles
    trees = [n for n in READ if n.startswith("tree_")]
    assert len(trees) == 6 and {tuple(EXPECTED[n]["shape"]) for n in trees} == {
        mk.TREE_HW + (3,)}
    assert sum((FIXTURES / n).stat().st_size for n in EXPECTED) <= mk.SIZE_BUDGET


def test_zstd_fixtures_hold_every_kind():
    """The Zstandard fixtures and PIL-written strips past 128 KiB (smooth,
    noisy, constant, and word-like text whose second block reuses the
    first one's Huffman tree) hold every block, literals and table kind
    the decoder counts, and repeat offsets, checksums and single-segment
    frames."""
    files = [(FIXTURES / n).read_bytes() for n in READ if "zstd" in n]
    rng = np.random.default_rng(50)
    smooth = (np.add.outer(np.arange(300), np.arange(400))[..., None] // 3 % 256
              * np.array([1, 2, 3])).astype(np.uint8)
    noisy = rng.integers(0, 256, (150, 400, 3), dtype=np.uint8)
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[278] = 300
    for a in (smooth, noisy, np.full((150, 400, 3), 9, np.uint8)):
        files.append(pil_save(Image.fromarray(a), compression="zstd", tiffinfo=info))
    words = b" ".join(bytes(rng.choice(list(b"etaoinshr"), int(rng.integers(2, 8))))
                      for _ in range(40000))
    for tail in (4000, 150000):  # treeless literals, one stream and four
        text = np.frombuffer(words[:131072 + tail], np.uint8).reshape(-1, 8)
        info[278] = len(text)
        files.append(pil_save(Image.fromarray(text), compression="zstd", tiffinfo=info))
    native.ZSTD_COUNTS = np.zeros(len(native.ZSTD_KINDS), np.int64)
    try:
        for data in files:
            image_io.read_tiff(data)
        counts = dict(zip(native.ZSTD_KINDS, native.ZSTD_COUNTS.tolist()))
    finally:
        native.ZSTD_COUNTS = None
    assert all(counts.values()), [k for k, v in counts.items() if not v]


# --- (b) files at random sizes -------------------------------------------------------


@pytest.mark.parametrize("compression", ["tiff_ccitt", "group3", "group4", "tiff_raw_16"])
def test_pil_written_ccitt_matches_pil(compression):
    """PIL's CCITT writer at random sizes and strip heights, 2-D Group 3
    and fill bits among them (PIL's RLEW rows are no 16-bit words: libtiff
    decodes bad code words, which the port follows)."""
    rng = np.random.default_rng(len(compression))
    for case in range(10):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        px = mk.bilevel((h, w), case) if case % 3 else rng.integers(0, 2, (h, w))
        img = Image.fromarray((1 - px).astype(np.uint8) * 255).convert("1")
        info = TiffImagePlugin.ImageFileDirectory_v2()
        info[278] = int(rng.integers(1, h + 1))
        if compression == "group3":
            info[292] = (0, 1, 4, 5)[case % 4]
        if case % 4 == 3:
            info[266] = 2
        assert_matches_pil(pil_save(img, compression=compression, tiffinfo=info),
                           (compression, case, h, w))


@pytest.mark.parametrize("mode", ["L", "RGB", "LAB", "I;16"])
def test_pil_written_lzma_and_zstd_match_pil(mode):
    """PIL's LZMA and ZSTD writers at random sizes and strip heights, with
    and without the horizontal predictor."""
    rng = np.random.default_rng(ord(mode[0]) + len(mode))
    for case in range(8):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        kind = case % 3
        a = (rng.integers(0, 256, (h, w, 3), dtype=np.uint8) if kind == 0 else
             np.full((h, w, 3), int(rng.integers(0, 256)), np.uint8) if kind == 1 else
             (np.add.outer(np.arange(h), np.arange(w))[..., None] * np.array([1, 2, 3]) % 256)
             .astype(np.uint8))
        if mode == "LAB":
            img = Image.frombytes("LAB", (w, h), a.tobytes())
        elif mode == "I;16":
            img = Image.fromarray(a[..., 0].astype(np.uint16) * 257)
        else:
            img = Image.fromarray(a).convert(mode)
        info = TiffImagePlugin.ImageFileDirectory_v2()
        info[278] = int(rng.integers(1, h + 1))
        if case % 2 and mode != "LAB":
            info[317] = 2
        for compression in ("lzma", "zstd"):
            assert_matches_pil(pil_save(img, compression=compression, tiffinfo=info),
                               (mode, compression, case, h, w))


def _fill_order_2(data: bytes, px: np.ndarray, photometric: int, **kw) -> bytes:
    """A file's strips with every byte's bits reversed, under FillOrder 2."""
    f = image_io._TiffFile(data)
    f.setup()
    chunks = [mf.REVERSE_BITS[np.frombuffer(data[o:o + c], np.uint8)].tobytes()
              for o, c in zip(f.offsets, f.counts)]
    return mf.tiff(px, photometric, compression=f.compression, rows_per_strip=f.chunk_h,
                   fillorder=2, chunks=chunks, **kw)


@pytest.mark.parametrize("layout", ["ccitt_strips", "ccitt_tiles", "thunderscan",
                                    "fill_order_2", "codec_tiles"])
def test_hand_written_codecs_match_pil(layout):
    """CCITT of every kind in strips and in tiles (MinIsWhite and
    MinIsBlack, FillOrder 1 and 2, 2-D Group 3 at K 2-4, fill bits, the
    Group 4 end-of-facsimile block), ThunderScan, LZMA, ZSTD and
    ThunderScan strips under FillOrder 2, and LZMA and ZSTD tiles of gray,
    RGB and CIELab (ZSTD from PIL's writer, a content checksum put into
    some), at random sizes."""
    import lzma

    rng = np.random.default_rng(len(layout))
    kinds = ["rle", "rlew", "g3", "g4"]
    encoders = [lambda r: lzma.compress(r, format=lzma.FORMAT_XZ), mk.zstd_frames,
                lambda r: mk.zstd_frames(r, checksum=True)]
    for case in range(12):
        h, w = (int(v) for v in rng.integers(1, 50, 2))
        if layout == "codec_tiles":
            px = mf.photo((h, w), case)
            photometric = (1, 2, 8)[case % 3]
            px = px[..., 0] if photometric == 1 else px
            tile = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
            data = mk.codec_tiff(px, photometric, (34925, 50000, 50000)[case % len(encoders)],
                                 encoders[case % len(encoders)], tile=tile,
                                 predictor=1 + (case % 4 == 1 and photometric != 8))
        elif layout == "fill_order_2":
            info = TiffImagePlugin.ImageFileDirectory_v2()
            info[278] = int(rng.integers(1, h + 1))
            if case % 3 < 2:
                px = mf.photo((h, w), case)
                if case % 2:
                    info[317] = 2
                data = pil_save(Image.fromarray(px), compression=("lzma", "zstd")[case % 3],
                                tiffinfo=info)
                data = _fill_order_2(data, px, 2, predictor=1 + case % 2)
            else:
                g = mk.gray4((h, w), case)
                data = _fill_order_2(mk.thunder_tiff(g, rows_per_strip=info[278]), g, 1, bits=4)
        elif layout == "thunderscan":
            data = mk.thunder_tiff(mk.gray4((h, w), case), white=case % 2 == 1,
                                   rows_per_strip=int(rng.integers(1, h + 1)))
        else:
            kind = kinds[case % 4]
            tile = (16 * int(rng.integers(1, 3)), 16 * int(rng.integers(1, 3)))
            data = mk.ccitt_tiff(mk.bilevel((h, w), case), kind, white=case % 2 == 0,
                                 fillorder=1 + (case % 3 == 2),
                                 k=1 + case % 4 if kind == "g3" else 1,
                                 fill=kind == "g3" and case % 2 == 1, eofb=case % 5 == 0,
                                 **({"tile": tile} if layout == "ccitt_tiles" and kind != "rlew"
                                    else {"rows_per_strip": int(rng.integers(1, h + 1))}))
        assert assert_matches_pil(data, (layout, case, h, w))


# --- (c) CIELab ------------------------------------------------------------------------


def test_every_cielab_triple_matches_pil():
    """All 2^24 Lab triples, one 4096 x 4096 image in Pillow's "LAB"
    storage: LittleCMS's convert("RGB") through the native transform and
    its twin, every pixel."""
    idx = np.arange(1 << 24, dtype=np.int64)
    lab = np.stack([idx >> 16, (idx >> 8) & 255, idx & 255], -1).astype(np.uint8)
    lab = lab.reshape(4096, 4096, 3)
    bands = [Image.frombytes("L", (4096, 4096), np.ascontiguousarray(lab[..., c]).tobytes())
             for c in range(3)]
    want = np.asarray(Image.merge("LAB", bands).convert("RGB"))
    assert np.array_equal(native.lab_to_rgb(lab), want)
    assert np.array_equal(image_io.lab_to_rgb_twin(lab), want)


# --- (d) the native decoders and Zstandard's rules ------------------------------------


def test_ccitt_and_thunderscan_match_their_twins_on_random_streams():
    rng = np.random.default_rng(11)
    agreed = failed = 0
    for case in range(400):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        kind = ("rle", "rlew", "g3", "g3_2d", "g4")[case % 5]
        if case % 2:
            data = rng.integers(0, 256, int(rng.integers(1, 200)), dtype=np.uint8).tobytes()
        else:
            data = bytearray(mk.ccitt(mk.bilevel((h, w), case), kind.split("_")[0],
                                      k=3 if kind == "g3_2d" else 1))
            for _ in range(int(rng.integers(0, 3))):
                data[int(rng.integers(0, len(data)))] ^= 1 << int(rng.integers(0, 8))
            data = bytes(data[:int(rng.integers(1, len(data) + 1))])
        rowbytes = (w + 7) // 8 + int(rng.integers(0, 2))
        a = native.ccitt_decode(data, kind, w, rowbytes, h, bool(case % 3 == 0))
        b = image_io.ccitt_twin(data, kind, w, rowbytes, h, bool(case % 3 == 0))
        assert (a.status, a.errors, a.extensions, a.lines) == (b.status, b.errors, b.extensions,
                                                               b.lines), case
        assert np.array_equal(a.rows, b.rows), case
        agreed += a.status == 0
        failed += a.status != 0
        line = (w * 4 + 7) // 8
        stream = (mk.thunderscan(mk.gray4((h, w), case)) if case % 2 else
                  rng.integers(0, 256, int(rng.integers(1, 100)), dtype=np.uint8).tobytes())
        results = []
        for fn in (native.tiff_thunderscan, image_io.thunderscan_twin):
            try:
                results.append(fn(stream, h * line, line, w))
            except ValueError as e:
                results.append(str(e))
        assert type(results[0]) is type(results[1]), case
        assert (results[0] == results[1] if isinstance(results[0], str)
                else np.array_equal(results[0], results[1])), case
    assert agreed > 100 and failed > 50, (agreed, failed)


def _zstd_variant(frame: bytes, kind: str) -> bytes:
    """A Zstandard frame changed as `kind` says."""
    if kind == "skippable_before":
        return (0x184D2A50).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"abc" + frame
    if kind == "skippable_after":
        return frame + (0x184D2A5F).to_bytes(4, "little") + (2).to_bytes(4, "little") + b"ab"
    if kind == "reserved_bit":
        return frame[:4] + bytes([frame[4] | 8]) + frame[5:]
    if kind == "bad_checksum":
        return frame[:-1] + bytes([frame[-1] ^ 1])
    if kind == "second_frame":
        return frame + frame
    if kind == "cut":
        return frame[:len(frame) * 2 // 3]
    return frame


@pytest.mark.parametrize("kind", ["plain", "skippable_before", "skippable_after",
                                  "reserved_bit", "bad_checksum", "second_frame", "cut",
                                  "dictionary", "content_size", "longer"])
def test_zstd_frames_read_or_refused_as_pil(kind):
    """PIL's Zstandard frames with the checksum, content size or
    single-segment form libtiff's writer leaves out (written in by hand),
    changed one way each: a skippable frame before or after, a reserved
    bit, a bad checksum, a second frame, a cut end, a dictionary ID, a
    wrong content size, or more content than the strip holds. The port
    reads each as PIL does or refuses it where PIL does."""
    rng = np.random.default_rng(len(kind))
    px = mf.photo((30, 40), 12)
    px[::3] = rng.integers(0, 256, px[::3].shape, dtype=np.uint8)
    read = 0
    for case in range(6):
        rows = int(rng.integers(4, 31))
        params = {"checksum": case % 2 == 0, "size": case % 3 != 2, "single": case % 3 == 1,
                  "dict_id": int(rng.integers(1, 1 << 32)) if kind == "dictionary" else 0}

        def encode(raw, _p=params):
            if kind == "content_size":
                frame = mk.zstd_frames(raw, **{**_p, "size": True, "single": False})
                return frame[:6] + bytes([frame[6] ^ 2]) + frame[7:]  # content size off by 2
            if kind == "longer":
                return mk.zstd_frames(raw + b"\x01\x02", **_p)
            return _zstd_variant(mk.zstd_frames(raw, **_p), kind)

        data = mk.codec_tiff(px, 2, 50000, encode, rows_per_strip=rows)
        read += assert_matches_pil(data, (kind, case))
    expect_read = {"plain": 6, "skippable_after": 6, "second_frame": 6, "skippable_before": 0,
                   "reserved_bit": 0, "dictionary": 0}
    if kind in expect_read:
        assert read == expect_read[kind], read


# --- (e) damaged files ----------------------------------------------------------------


def _damaged_bases():
    doc = mk.bilevel((28, 45), 21)
    one = Image.fromarray((1 - doc) * 255).convert("1")
    info = TiffImagePlugin.ImageFileDirectory_v2()
    info[278] = 10
    photo = mf.photo((20, 30), 22)
    zinfo = TiffImagePlugin.ImageFileDirectory_v2()
    zinfo[278] = 7
    zinfo[317] = 2
    return [mk.ccitt_tiff(doc, "rle", rows_per_strip=9),
            mk.ccitt_tiff(doc, "g3", rows_per_strip=12, white=True),
            mk.ccitt_tiff(doc, "g3", k=3, fill=True, rows_per_strip=15),
            mk.ccitt_tiff(doc, "g4", tile=(16, 32)),
            mk.ccitt_tiff(doc, "rlew", rows_per_strip=11),
            pil_save(one, compression="tiff_raw_16", tiffinfo=info),
            pil_save(one, compression="group4", tiffinfo=info),
            pil_save(Image.fromarray(photo), compression="lzma", tiffinfo=zinfo),
            pil_save(Image.fromarray(photo), compression="zstd", tiffinfo=zinfo),
            mk.thunder_tiff(mk.gray4((20, 33), 23), rows_per_strip=7),
            mf.ojpeg_tiff(mf.photo((29, 37), 24, noise=4), tile=(16, 16))]


def test_damaged_codec_tiffs_refuse_or_decode_as_pil_does():
    """Flipped bits, a replaced byte or a cut end, anywhere in CCITT RLE,
    Group 3 (1-D, 2-D with fill bits), Group 4 (tiled, and PIL's), RLEW
    (word-aligned, and PIL's own output), LZMA, ZSTD, ThunderScan and
    old-style JPEG tiles with tables in tags: the port raises ValueError or
    decodes bit-equal to PIL, natively and through the twins."""
    rng = np.random.default_rng(25)
    bases = _damaged_bases()
    decoded = refused = 0
    for case in range(1000):
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
                got = port_forms(data, twin)
            except ValueError:
                refused += 1
                continue
            want = pil_forms(data)  # the port decoded it: PIL must, to the bit
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]), case
            decoded += 1
    assert decoded >= 300 and refused >= 300, (decoded, refused)


def test_uncompressed_mode_is_refused():
    """T.4's uncompressed mode (an extension code in the data), which
    libtiff reports and does not decode: ValueError. The T4Options bit
    alone changes nothing."""
    doc = mk.bilevel((8, 20), 30)
    bits = mk.mh_row(doc[0])
    data = mk._pack_bits(mk.EOL + "1" + bits + mk.EOL + "0" + "0000001111" + "0" * 30)
    tiff = mf.tiff(np.zeros((2, 20), np.uint8), 0, bits=1, compression=3, chunks=[data],
                   tags=[(292, 4, [3])])
    with pytest.raises(ValueError, match="uncompressed mode"):
        image_io.read_tiff(tiff)
    plain = mk.ccitt_tiff(doc, "g3", k=2, tags=[(292, 4, [3])])
    assert assert_matches_pil(plain, "T4Options 3")


def test_the_new_codecs_import_no_codec_library():
    """No zstd, liblzma C, lcms2 or libtiff header in the native sources,
    and no PIL, zstandard or imagecodecs import in the port's reader."""
    source = "".join(p.read_text() for p in (native.CCITT_SOURCE, native.ZSTD_SOURCE,
                                             native.CIELAB_SOURCE, native.TIFF_SOURCE))
    assert not re.search(r"#include\s*<(zstd|lzma|lcms2|tiff)", source)
    py = Path(image_io.__file__).read_text() + Path(native.__file__).read_text()
    assert not re.search(r"^\s*(import|from)\s+(PIL|zstandard|imagecodecs|tifffile)", py, re.M)
    assert not hasattr(image_io, "TIFF_REFUSED")


# --- (f) a tree of the new codecs through the JAX package's pipeline ------------------


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    from _torch_jnative import bind_private_jax_fastimage

    with pytest.MonkeyPatch.context() as mp:
        try:
            yield bind_private_jax_fastimage(mp, tmp_path_factory.mktemp("jax_fastimage"))
        except RuntimeError as e:
            yield e


@pytest.fixture(scope="module")
def codec_tree(tmp_path_factory):
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    root = tmp_path_factory.mktemp("codec_tree")
    rgb = [str(FIXTURES / n) for n in READ if n.startswith("tree_")]
    write_random_tree(str(root), 6, mk.TREE_HW, smooth=True, rgb_files=rgb, fmt="tiff")
    return str(root)


TASKS = ["depth", "rgb", "semseg"]


def test_codec_tree_transform_matches_jax(codec_tree, jax_native):
    """The listing and the raw rgb samples equal; the pretraining
    transform's depth and semseg bit-equal, rgb within 1e-5 (normalised
    units), big-endian depth maps fed to the JAX transform as "I;16" (see
    tests/test_torch_tiff.py)."""
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu.data.pretrain_transforms import DataAugmentationForMultiMAE as JAug
    from multimae_tpu_torch.data import dataset_folder as tdf
    from multimae_tpu_torch.data.pretrain_transforms import DataAugmentationForMultiMAE as TAug

    assert not isinstance(jax_native, RuntimeError), jax_native
    j, t = jdf.MultiTaskImageFolder(codec_tree, TASKS), tdf.MultiTaskImageFolder(codec_tree, TASKS)
    assert t.samples == j.samples and len(t) == 6
    ja, ta = JAug(input_size=32), TAug(input_size=32)
    worst = 0.0
    for idx in range(len(t)):
        sample = j.load_raw(idx)[0]
        assert np.array_equal(t.load_raw(idx)[0]["rgb"], np.asarray(sample["rgb"])), idx
        if sample["depth"].mode == "I;16B":
            sample["depth"] = Image.fromarray(np.asarray(sample["depth"]).astype(np.uint16))
        jo = ja(dict(sample), rng=random.Random(idx))
        to = ta(t.load_raw(idx)[0], rng=random.Random(idx))
        assert set(jo) == set(to)
        assert np.array_equal(to["depth"], jo["depth"]), idx
        assert np.array_equal(to["semseg"], jo["semseg"]), idx
        worst = max(worst, float(np.abs(to["rgb"] - jo["rgb"]).max()))
    assert worst <= 1e-5, worst
