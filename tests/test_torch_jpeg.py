"""The port's JPEG decoder (multimae_tpu_torch/native/jpeg_decode.cpp)
against PIL's Image.open(f).convert("RGB") and the JAX package's loader,
multimae_tpu.data.dataset_folder.pil_loader, bit for bit.

* Files PIL encodes here from seeded numpy images, noise and photo-like:
  4:4:4, 4:2:2 and 4:2:0 at qualities 50, 75, 90, 95 and 100, baseline,
  optimised, progressive and with restart markers every 3 blocks or every
  row, at 1x1 up to 257x193; gray and CMYK.
* The committed fixtures (tests/fixtures/jpeg/, written by its
  make_fixtures.py, with 4:4:0, 4:1:1, YCCK, SOF1 with 16-bit tables and
  non-interleaved scans from the system libjpeg) against expected.json
  and against PIL, so chip_smoke.py's check on the card compares the same
  thing.
* Damage: seeded truncations and byte flips decode to an array of the
  header's shape or raise ValueError; a truncated file raises naming it.
* Arithmetic coding (SOF9, SOF10, DAC conditioning other than the
  defaults), block smoothing (progressive files that leave coefficients
  unrefined, DC interpolation, a zero quantiser), lossless SOF3 (the seven
  predictors, a point transform, restart markers) and a vertical sampling
  ratio of 3: the committed fixtures, and a progressive file cut after its
  first scans, bit-equal to PIL.
* Refused, as PIL refuses them: hierarchical and lossless arithmetic
  frames, 12-bit precision, a DNL-given height, a lossless frame with a
  sequential scan; each raises ValueError naming the feature.
"""

import hashlib
import io
import json
import os
import struct
import time
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from multimae_tpu.data.dataset_folder import pil_loader
from multimae_tpu_torch import native
from multimae_tpu_torch.data import image_io

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
SIZES = [(1, 1), (2, 3), (7, 9), (17, 33), (31, 64), (257, 193)]
QUALITIES = [50, 75, 90, 95, 100]
OPTIONS = {"baseline": {}, "optimize": {"optimize": True}, "progressive": {"progressive": True},
           "restart_blocks": {"restart_marker_blocks": 3},
           "restart_rows": {"restart_marker_rows": 1}}


def image(hw, mode, seed, smooth):
    rng = np.random.default_rng(seed)
    channels = {"RGB": 3, "L": 1, "CMYK": 4}[mode]
    h, w = hw
    if smooth:
        yy, xx = np.mgrid[0:h, 0:w]
        a = np.stack([128 + 100 * np.sin(xx / (3 + 5 * c) + yy / (4 + 3 * c) + c)
                      for c in range(channels)], -1)
        a = np.clip(a + rng.normal(0, 6, a.shape), 0, 255).astype(np.uint8)
    else:
        a = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    return Image.fromarray(a[..., 0] if channels == 1 else a, mode)


@pytest.fixture(autouse=True)
def large_pil_buffer(monkeypatch):
    """Optimised and progressive noise at high quality outgrows the buffer
    PIL sizes for a whole-image write."""
    monkeypatch.setattr(ImageFile, "MAXBLOCK", 1 << 22)


def encode(img, **options):
    buf = io.BytesIO()
    img.save(buf, "JPEG", **options)
    return buf.getvalue()


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# Files that libjpeg-turbo smooths. The JAX package's loader decodes a JPEG
# through its native helper, which links the system libjpeg (2.1 here),
# whose smoothing differs from that of PIL's own libjpeg-turbo (3.1): for
# these, PIL alone is the reference.
SMOOTHED = {"progressive_dc_only.jpg", "smooth_ac_approx.jpg", "smooth_ac_low.jpg",
            "smooth_gray_dc_only.jpg", "smooth_arith.jpg", "smooth_narrow.jpg",
            "tree_smooth.jpg", "big_smooth_640.jpg"}


def assert_bit_equal(data, tmp_path, what, jax_loader=True):
    """The port's decode equals PIL's convert("RGB") and (unless the file
    is smoothed, see SMOOTHED) the JAX package's loader on the same file."""
    got = image_io.load_image(_write(tmp_path, data))
    ref = pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == ref.shape, what
    if not np.array_equal(got, ref):
        diff = np.abs(got.astype(int) - ref.astype(int))
        raise AssertionError(f"{what}: {int((diff > 0).sum())} samples differ from PIL, "
                             f"max {int(diff.max())}")
    if jax_loader:
        assert np.array_equal(got, np.asarray(pil_loader(_write(tmp_path, data)))), what


def _write(tmp_path, data, name="x.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


# --- files PIL writes here -----------------------------------------------------------


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_rgb_matches_pil_and_jax_loader(tmp_path, subsampling, option):
    for seed, (hw, quality, smooth) in enumerate(
            (hw, q, s) for hw in SIZES for q in QUALITIES for s in (False, True)):
        if hw == (257, 193) and quality in (50, 75):
            continue  # the large size at the qualities that matter most
        data = encode(image(hw, "RGB", seed, smooth), quality=quality, subsampling=subsampling,
                      **OPTIONS[option])
        assert_bit_equal(data, tmp_path, f"{hw} q{quality} {'smooth' if smooth else 'noise'}")


@pytest.mark.parametrize("option", list(OPTIONS))
@pytest.mark.parametrize("mode", ["L", "CMYK"])
def test_gray_and_cmyk_match_pil_and_jax_loader(tmp_path, mode, option):
    for seed, (hw, quality) in enumerate((hw, q) for hw in SIZES for q in (50, 90, 100)):
        data = encode(image(hw, mode, seed, seed % 2 == 0), quality=quality, **OPTIONS[option])
        assert_bit_equal(data, tmp_path, f"{mode} {hw} q{quality}")


JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


@pytest.mark.parametrize("variant", ["adobe_rgb", "ids_rgb", "jfif_over_adobe"])
def test_colour_space_markers_match_pil(tmp_path, variant):
    """libjpeg-turbo's default_decompress_parms: Adobe transform 0 means RGB;
    without markers, component ids R, G, B mean RGB; a JFIF marker means
    YCbCr whatever the Adobe marker says."""
    data = encode(image((31, 64), "RGB", 4, True), quality=90, keep_rgb=True)
    at = data.index(b"\xff\xee")
    if variant == "ids_rgb":
        data = data[:at] + data[at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]:]
    elif variant == "jfif_over_adobe":
        data = data[:2] + JFIF + data[2:]
    assert_bit_equal(data, tmp_path, variant)


def test_file_without_huffman_tables_takes_the_standard_ones(tmp_path):
    """A motion-JPEG frame has no DHT: libjpeg takes the tables of the
    standard's Annex K.3, which PIL writes when it does not optimise."""
    data = encode(image((31, 64), "RGB", 5, True), quality=90)
    at = data.index(b"\xff\xc4")
    while data[at:at + 2] == b"\xff\xc4":  # PIL writes the four tables in a row
        data = data[:at] + data[at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]:]
    assert b"\xff\xc4" not in data[:data.index(b"\xff\xda")]
    assert_bit_equal(data, tmp_path, "no DHT")


@pytest.fixture(scope="module")
def libjpeg_encoder(tmp_path_factory):
    """make_fixtures.py's encoder on the system libjpeg, for sampling
    factors PIL cannot write."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_fixtures", FIXTURES / "make_fixtures.py")
    mf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mf)
    tmp = str(tmp_path_factory.mktemp("libjpeg"))
    exe, why = mf.libjpeg_encoder(tmp)
    if exe is None:
        pytest.skip(f"the system libjpeg is not usable here: {why}")
    return lambda case, seed: mf.libjpeg_file(exe, tmp, case, seed)


def _blocks(sampling):
    return sum(int(f[0]) * int(f[2]) for f in sampling.split(","))


@pytest.mark.parametrize("sampling,scans", [
    (sampling, scans)
    for sampling in ("1x4,1x1,1x1", "4x2,1x1,1x1", "3x1,1x1,1x1", "1x3,1x1,1x1", "2x1,1x2,1x1",
                     "1x2,2x1,1x1",
                     "2x2,2x2,2x2", "4x4,2x2,1x1", "2x2,1x1,1x1,2x2")
    for scans in ("default", "progressive", "noninterleaved")
    if scans == "noninterleaved" or _blocks(sampling) <= 10])  # libjpeg's MCU limit
def test_libjpeg_sampling_factors_match_pil(tmp_path, libjpeg_encoder, sampling, scans):
    """Integral ratios of 1 to 4, interleaved and not."""
    cmyk = sampling.count(",") == 3
    for seed, hw in enumerate([(1, 1), (7, 9), (33, 47), (65, 31)]):
        case = (hw, "cmyk" if cmyk else "rgb", "ycck" if cmyk else "ycc", 75 + seed * 5,
                sampling, scans, seed % 2)
        assert_bit_equal(libjpeg_encoder(case, seed), tmp_path, f"{sampling} {scans} {hw}")


# --- the committed fixtures --------------------------------------------------------


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_fixture_matches_expected(tmp_path, name):
    data = (FIXTURES / name).read_bytes()
    want = EXPECTED[name]
    if "error" in want:
        with pytest.raises(ValueError, match=want["error"]):
            image_io.load_image(str(FIXTURES / name))
        return
    got = image_io.load_image(str(FIXTURES / name))
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"]
    assert_bit_equal(data, tmp_path, name, jax_loader=name not in SMOOTHED)


def test_fixtures_cover_the_sampling_factors():
    """4:4:0, 4:1:1 and 1x3 (which PIL cannot write), YCCK, arithmetic
    coding, smoothing and lossless frames are committed."""
    assert {"s440.jpg", "s411.jpg", "s1x3.jpg", "ycck.jpg", "sof1_16bit_tables.jpg",
            "noninterleaved.jpg", "arith_dac.jpg", "arith_progressive_dac.jpg",
            "smooth_ac_approx.jpg", "smooth_zero_quant.jpg", "lossless_rgb_p6_restart.jpg",
            "refused_dnl_height.jpg"} <= set(EXPECTED)
    assert sum(os.path.getsize(FIXTURES / n) for n in EXPECTED) < 600_000


# --- damage ------------------------------------------------------------------------


def _frame_shape(data):
    """(H, W, 3) from the first SOF0/1/2/3/9/10 segment, as the header says."""
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            i += 1
            continue
        marker = data[i + 1]
        if marker in (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA) and i + 9 <= len(data):
            h, w = struct.unpack(">HH", data[i + 5:i + 9])
            return (h, w, 3)
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7 or marker == 0xFF:
            i += 2 if marker != 0xFF else 1
            continue
        i += 2 + struct.unpack(">H", data[i + 2:i + 4])[0]
    return None


def test_fuzzed_files_decode_or_raise_value_error():
    rng = np.random.default_rng(10)
    sources = [(FIXTURES / n).read_bytes() for n in
               ("s420.jpg", "progressive.jpg", "restart_blocks.jpg", "cmyk.jpg", "s440.jpg",
                "gray_progressive.jpg", "arith_444_restart.jpg", "arith_progressive_dac.jpg",
                "smooth_ac_approx.jpg", "lossless_rgb_p6_restart.jpg")]
    decoded = refused = 0
    t0 = time.perf_counter()
    for case in range(1000):
        data = bytearray(sources[case % len(sources)])
        if case % 3 == 0:
            data = data[:int(rng.integers(1, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 6))):
                at = int(rng.integers(0, len(data)))
                data[at] = (int(rng.integers(0, 256)) if case % 3 == 1
                            else data[at] ^ (1 << int(rng.integers(0, 8))))
        data = bytes(data)
        try:
            out = native.decode_jpeg(data)
        except ValueError:
            refused += 1
            continue
        decoded += 1
        assert out.dtype == np.uint8 and out.shape == _frame_shape(data), case
    assert decoded > 80 and refused > 300, (decoded, refused)
    assert time.perf_counter() - t0 < 30


@pytest.mark.parametrize("cut", [0.3, 0.6, 0.95])
def test_truncated_file_raises_naming_it(tmp_path, cut):
    data = (FIXTURES / "s420.jpg").read_bytes()
    path = _write(tmp_path, data[:int(len(data) * cut)], "cut.jpg")
    with pytest.raises(ValueError, match=r"cut\.jpg: JPEG: .*(truncated|ends early)"):
        image_io.load_image(path)
    with pytest.raises(OSError, match="(?i)truncated"):  # as PIL refuses it
        Image.open(path).convert("RGB")


def test_header_larger_than_the_file_is_refused_before_allocating():
    data = bytearray((FIXTURES / "s420.jpg").read_bytes())
    i = data.index(b"\xff\xc0")
    data[i + 5:i + 9] = struct.pack(">HH", 65535, 65535)
    with pytest.raises(ValueError, match="needs more data"):
        native.decode_jpeg(bytes(data))


# --- refused frames ----------------------------------------------------------------


@pytest.mark.parametrize("marker,words", [
    (0xC3, "lossless"), (0xC5, "hierarchical"), (0xC6, "hierarchical"), (0xC7, "hierarchical"),
    (0xCB, "arithmetic"), (0xCD, "arithmetic"), (0xCE, "arithmetic"), (0xCF, "arithmetic")])
def test_unsupported_frame_raises_naming_it(tmp_path, marker, words):
    """PIL refuses these too (a baseline scan under a lossless frame, which
    libjpeg-turbo's scan checks refuse, for SOF3)."""
    data = bytearray((FIXTURES / "s420.jpg").read_bytes())
    i = data.index(b"\xff\xc0")
    data[i + 1] = marker
    path = _write(tmp_path, bytes(data), "frame.jpg")
    with pytest.raises(ValueError, match=rf"frame\.jpg: JPEG: .*{words}.*SOF{marker - 0xC0}"):
        image_io.load_image(path)


def test_twelve_bit_precision_raises_naming_it():
    data = bytearray((FIXTURES / "s420.jpg").read_bytes())
    i = data.index(b"\xff\xc0")
    data[i + 4] = 12
    with pytest.raises(ValueError, match="12-bit precision"):
        native.decode_jpeg(bytes(data))


def _scans(data):
    """Offsets of the SOS markers of a file."""
    return [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]


@pytest.mark.parametrize("kept", [1, 2, 3, 4, 5])
def test_unrefined_progressive_file_is_smoothed_as_pil(tmp_path, kept):
    """A progressive file cut after its first scans (EOI put back): PIL
    smooths the blocks whose coefficients stay unrefined (DC interpolation
    while no AC coefficient is in)."""
    data = encode(image((31, 64), "RGB", 3, True), quality=90, progressive=True)
    scans = _scans(data)
    assert len(scans) > 5
    assert_bit_equal(data[:scans[kept]] + b"\xff\xd9", tmp_path, f"{kept} scans",
                     jax_loader=False)


@pytest.mark.parametrize("arith", [False, True], ids=["huffman", "arithmetic"])
@pytest.mark.parametrize("scans", ["progressive", "ac_approx", "ac_low", "dconly"])
def test_libjpeg_progressions_match_pil(tmp_path, libjpeg_encoder, scans, arith):
    """Smoothed and unsmoothed progressions, Huffman and arithmetic-coded,
    at sizes from one block up, each sampling of its own."""
    for seed, (hw, sampling) in enumerate([((1, 1), "1x1,1x1,1x1"), ((9, 7), "2x2,1x1,1x1"),
                                           ((47, 33), "1x3,1x1,1x1"), ((40, 66), "2x1,1x2,1x1"),
                                           ((17, 9), "3x1,1x1,1x1")]):
        case = (hw, "rgb", "ycc", 60 + seed * 9, sampling, scans, seed % 2) + (
            (f"{seed % 3},{seed % 3 + seed},{1 + 7 * seed}",) if arith else ())
        assert_bit_equal(libjpeg_encoder(case, seed), tmp_path, f"{sampling} {hw}",
                         jax_loader=scans == "progressive")


# --- the pipeline ------------------------------------------------------------------


def test_decoder_releases_the_gil():
    """A CDLL (not a PyDLL) call drops the GIL: loader threads decode in
    parallel."""
    import ctypes

    lib = native.lib()
    assert isinstance(lib, ctypes.CDLL) and not isinstance(lib, ctypes.PyDLL)


def test_tree_with_jpeg_rgb_loads_the_fixtures(tmp_path):
    """chip_smoke.py's JPEG tree at a small size: rgb copied from the photo
    fixtures, depth and semseg written beside them, aligned by index."""
    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder, write_random_tree

    photos = sorted(str(p) for p in FIXTURES.glob("photo_*.jpg"))
    write_random_tree(str(tmp_path), 6, (375, 500), rgb_files=photos)
    ds = MultiTaskImageFolder(str(tmp_path), ["depth", "rgb", "semseg"])
    assert [os.path.basename(p) for p, _ in ds.samples["rgb"]] == \
        [f"i{i:04d}.jpg" for i in (0, 2, 4, 1, 3, 5)]
    for i in range(len(ds)):
        sample, _ = ds.load_raw(i)
        name = os.path.basename(ds.samples["rgb"][i][0])
        src = photos[int(name[1:5]) % len(photos)]
        assert np.array_equal(sample["rgb"], pil_rgb(Path(src).read_bytes()))
        assert sample["depth"].shape == (375, 500) and sample["semseg"].shape == (375, 500)


def test_decoder_needs_no_libjpeg():
    """The sources include only the C++ standard library's headers, and the
    build links nothing."""
    import re

    for src in native.SOURCES:
        headers = re.findall(r'#include\s*[<"]([^>"]+)[>"]', src.read_text())
        assert all("." not in h for h in headers), (src.name, headers)
    assert not any(f.startswith("-l") for f in native.CXX_FLAGS)
