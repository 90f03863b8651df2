"""The port's JPEG 2000 reader (multimae_tpu_torch/native/jpeg2000_decode.cpp,
data/image_io.py `read_jpeg2000`) against the JAX package's loader, which
opens a JP2 or J2K file with PIL 12.1 (OpenJPEG 2.5.4).

* (a) Every fixture of tests/fixtures/jpeg2000 (its make_fixtures.py: PIL's
  files over its writer's options; hand-written codestreams with each
  code-block style, SOP/EPH, PPM, PPT, POC, tile-parts, COC/QCC, ROI,
  sub-sampled, signed and 1- to 16-bit components; JP2 boxes sYCC, CMYK,
  ICC, pclr/cmap, cdef and res): PIL's mode, and convert("RGB") and the raw
  form bit-equal to the committed digests and to the JAX `pil_loader`,
  through the native decoder and through the twins; the files PIL refuses
  raise ValueError naming the file.
* (b) PIL-written files at random sizes and options (fixed seeds).
* (c) A bounded fuzz of flipped bytes and cut files: PIL's pixels where PIL
  decodes, ValueError naming the file where it raises, never
  UnsupportedImage (the bytes of the image size are left alone: a flip
  there makes PIL allocate a canvas of up to 2 * MAX_IMAGE_PIXELS).
* (d) The inverse wavelet and colour twins against the native stages on
  random coefficients and planes, 1 x 1 and odd origins among them.
* (e) A tree whose rgb images are the tree_*.jpx fixtures and two of whose
  depth maps are 16-bit .jpx files, through the port's
  MultiTaskImageFolder and pretraining transform and the JAX ones.
* (f) A codestream with high-throughput code-blocks that claims Part 15
  raises UnsupportedImage naming item 11f-b; the style bit alone is damage.
"""

import hashlib
import importlib.util
import io
import json
import random
import re
from pathlib import Path

import numpy as np
import pytest

from multimae_tpu_torch import native
from multimae_tpu_torch.data import image_io
from multimae_tpu_torch.data.image_io import UnsupportedImage

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jpeg2000"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
# Loaded from its path under a name of its own: other fixture folders hold
# modules named make_fixtures too.
_SPEC = importlib.util.spec_from_file_location("jpeg2000_make_fixtures",
                                               FIXTURES / "make_fixtures.py")
mf = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(mf)

READ = sorted(n for n, e in EXPECTED.items() if "sha256" in e)
REFUSED = sorted(n for n, e in EXPECTED.items() if "error" in e)


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def jax_forms(path):
    """The JAX pil_loader's mode, convert("RGB") pixels and raw pixels in the
    port's raw form."""
    from multimae_tpu.data.dataset_folder import pil_loader

    rgb = np.asarray(pil_loader(str(path)))
    img = pil_loader(str(path), False)
    return img.mode, rgb, mf.port_raw(img)


def assert_reads_as_jax(path):
    mode, rgb, raw = jax_forms(path)
    for twin in (False, True):
        assert np.array_equal(image_io.load_image(str(path), twin=twin), rgb), (path, twin)
        got = image_io.load_image(str(path), False, twin=twin)
        assert got.dtype == raw.dtype and np.array_equal(got, raw), (path, twin)
    assert image_io.read_jpeg2000(Path(path).read_bytes()).mode == mode


# --- (a) the fixtures ----------------------------------------------------------------


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("name", READ)
def test_fixture_matches_pil(name, twin):
    want, path = EXPECTED[name], FIXTURES / name
    rgb = image_io.load_image(str(path), twin=twin)
    raw = image_io.load_image(str(path), convert_rgb=False, twin=twin)
    assert list(rgb.shape) == want["shape"] and rgb.dtype == np.uint8
    assert digest(rgb) == want["sha256"]
    assert list(raw.shape) == want["raw_shape"] and str(raw.dtype) == want["raw_dtype"]
    assert digest(raw) == want["raw_sha256"]
    assert image_io.read_jpeg2000(path.read_bytes(), twin).mode == want["mode"]
    mode, jax_rgb, jax_raw = jax_forms(path)
    assert mode == want["mode"] and np.array_equal(rgb, jax_rgb) and np.array_equal(raw, jax_raw)


@pytest.mark.parametrize("name", REFUSED)
def test_file_pil_refuses_raises_value_error(name):
    from multimae_tpu.data.dataset_folder import pil_loader

    with pytest.raises(Exception):  # noqa: B017 - the JAX loader's retry catches any
        pil_loader(str(FIXTURES / name))
    for twin in (False, True):
        with pytest.raises(ValueError, match=rf"{re.escape(name)}: .*{EXPECTED[name]['error']}"):
            image_io.load_image(str(FIXTURES / name), twin=twin)


def test_fixtures_cover_the_modes_and_kinds_within_their_budget():
    modes = {EXPECTED[n]["mode"] for n in READ}
    assert modes == {"L", "LA", "RGB", "RGBA", "I;16", "P", "PA", "CMYK"}
    assert {n for n in READ if n.startswith("style_")} == {
        f"style_{k}.j2k" for k in ("bypass", "reset", "termall", "vsc", "pterm", "segsym",
                                  "bypass_termall", "bypass_reset_vsc", "all")}
    for kind in ("sop_eph", "ppm", "ppt_sop", "poc", "roi_at_background", "sub_420_sycc",
                 "jp2_pclr", "jp2_sycc", "pil_rgb_irreversible", "pil_i16", "pil_1x1"):
        assert any(n.startswith(kind) for n in READ), kind
    assert sum((FIXTURES / n).stat().st_size for n in EXPECTED) <= mf.SIZE_BUDGET
    assert len(list(FIXTURES.glob("tree_*.jpx"))) == 4


def test_image_past_twice_max_image_pixels_is_refused_as_pil_refuses_it(tmp_path):
    """A SIZ of 20000 x 20000 (past 2 * Image.MAX_IMAGE_PIXELS): PIL's
    DecompressionBombError at open, the port's ValueError before a byte of
    it is decoded."""
    from multimae_tpu.data.dataset_folder import pil_loader

    cs = bytearray((FIXTURES / "style_bypass.j2k").read_bytes())
    cs[8:16] = (20000).to_bytes(4, "big") * 2  # Xsiz, Ysiz
    path = tmp_path / "huge.j2k"
    path.write_bytes(bytes(cs))
    with pytest.raises(Exception):  # noqa: B017 - the JAX loader's retry catches any
        pil_loader(str(path))
    with pytest.raises(ValueError, match="huge.j2k: image of 20000 x 20000 pixels"):
        image_io.load_image(str(path))


def test_hand_written_lossless_files_decode_to_their_samples():
    """The encoder of make_fixtures.py round-trips through the port as it
    does through PIL (make_fixtures.py checks PIL)."""
    rgb = mf.photo((18, 22), 30)
    for name in ("style_all.j2k", "sop_eph.j2k", "poc.j2k", "coc_qcc.j2k", "mct_rct.j2k"):
        assert np.array_equal(image_io.load_image(str(FIXTURES / name), False), rgb), name


# --- (b) PIL-written files ---------------------------------------------------------


def pil_written(rng):
    """A PIL-written JP2 or J2K file drawn from `rng`, within the options
    PIL's writer survives (the irreversible transform wants two samples at
    every level it takes, so no tiles and levels within the size there)."""
    mode = ["L", "LA", "RGB", "RGBA", "I;16"][int(rng.integers(5))]
    h, w = (int(v) for v in rng.integers(1, 60, 2))
    seed = int(rng.integers(1 << 30))
    if mode == "I;16":
        px = mf.photo((h, w), seed, 1)[..., 0].astype(np.uint16) * int(rng.integers(1, 257))
    else:
        px = mf.photo((h, w), seed, {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode])
        px = px[..., 0] if mode == "L" else px
    opts = {}
    irreversible = bool(rng.integers(2))
    fit = 1
    while fit < 7 and (min(h, w) >> fit) >= 2:
        fit += 1
    if irreversible:
        opts["irreversible"] = True
        opts["num_resolutions"] = int(rng.integers(1, fit + 1))
    else:
        opts["num_resolutions"] = int(rng.integers(1, max(fit, 2) + 1))
        if rng.integers(2):
            opts["tile_size"] = (int(rng.integers(max(w // 3, 1), w + 1)) + 4,
                                 int(rng.integers(max(h // 3, 1), h + 1)) + 4)
    if rng.integers(2):
        opts["progression"] = ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"][int(rng.integers(5))]
    if rng.integers(2):
        opts["quality_layers"] = sorted((float(v) for v in rng.choice([2, 5, 10, 20, 40, 80],
                                                                      int(rng.integers(1, 4)),
                                                                      replace=False)),
                                        reverse=True)
    if rng.integers(3) == 0:
        opts["codeblock_size"] = tuple(int(v) for v in rng.choice([4, 8, 16, 32, 64], 2))
    if rng.integers(4) == 0:
        opts["signed"] = True
    if rng.integers(4) == 0 and mode in ("RGB", "RGBA"):
        opts["mct"] = 1
    if rng.integers(3) == 0:
        opts["no_jp2"] = True
    return mf.pil_j2k(px, mode if mode in ("LA", "RGBA") else None, **opts)


@pytest.mark.parametrize("seed", range(4))
def test_pil_written_files_match_pil(seed, tmp_path):
    rng = np.random.default_rng(seed + 60)
    for i in range(8):
        path = tmp_path / f"{i}.jp2"
        path.write_bytes(pil_written(rng))
        assert_reads_as_jax(path)


# --- (c) damaged files -----------------------------------------------------------------

FUZZ_BASES = {"lossless": "pil_rgb_default.jp2",
              "irreversible": "pil_layers_rates_irreversible.jp2",
              "styles": "style_all.j2k", "ppm": "ppm.j2k", "sop_eph": "sop_eph.j2k",
              "pclr": "jp2_pclr.jp2", "sycc_420": "sub_420_sycc.jp2",
              "tiles": "pil_tiles_offsets.jp2"}


def size_fields(data: bytes):
    """The byte offsets of the image size: SIZ's Xsiz, Ysiz, XOsiz, YOsiz
    and a JP2 ihdr's height and width."""
    out = set()
    at = data.find(b"\xff\x4f\xff\x51")
    if at >= 0:
        out |= set(range(at + 8, at + 24))
    at = data.find(b"ihdr")
    if at >= 0:
        out |= set(range(at + 4, at + 12))
    return out


@pytest.mark.parametrize("kind", sorted(FUZZ_BASES))
def test_flipped_and_cut_files_decode_as_pil_or_raise_value_error(kind, tmp_path):
    base = (FIXTURES / FUZZ_BASES[kind]).read_bytes()
    keep = size_fields(base)
    rng = np.random.default_rng(sorted(FUZZ_BASES).index(kind) + 70)
    decoded = refused = 0
    for i in range(90):
        data = bytearray(base)
        if i % 3 == 0:
            data = data[:int(rng.integers(1, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(4, len(data)))
                if at in keep:
                    continue
                data[at] = int(rng.integers(256)) if i % 3 == 1 else data[at] ^ (1 << int(
                    rng.integers(8)))
        path = tmp_path / f"f{i}.jp2"
        path.write_bytes(bytes(data))
        try:
            jax_forms(path)
        except Exception:  # noqa: BLE001 - PIL refuses it: so must the port
            for twin in (False, True):
                with pytest.raises(ValueError, match=re.escape(path.name)):
                    image_io.load_image(str(path), twin=twin)
            refused += 1
            continue
        try:
            assert_reads_as_jax(path)
            decoded += 1
        except ValueError as e:  # the port may refuse damage PIL reads past
            assert path.name in str(e)
            refused += 1
    assert decoded > 5 and refused > 5, (decoded, refused)


# --- (d) the twins -------------------------------------------------------------------------


def random_rects(rng, levels):
    """A tile-component's resolution rectangles: a random rectangle on the
    grid and its halvings, odd origins and sizes of 1 among them."""
    x0, y0 = (int(v) for v in rng.integers(0, 9, 2))
    w, h = (int(v) for v in rng.integers(1, 23, 2))
    rects = []
    for r in range(levels + 1):
        lev = levels - r
        f = 1 << lev
        rects.append((-(-x0 // f), -(-y0 // f), -(-(x0 + w) // f), -(-(y0 + h) // f)))
    return np.array(rects, np.int32), h, w


@pytest.mark.parametrize("qmfbid", [1, 0], ids=["5/3", "9/7"])
def test_idwt_twin_matches_native(qmfbid):
    rng = np.random.default_rng(qmfbid + 80)
    for case in range(60):
        rects, h, w = random_rects(rng, int(rng.integers(0, 5)))
        if qmfbid == 1:
            coef = rng.integers(-3000, 3000, (h, w)).astype(np.int32)
        else:
            coef = (rng.standard_normal((h, w)) * 40).astype(np.float32)
        got = image_io.jpeg2000_idwt_twin(coef, rects, qmfbid)
        want = native.jpeg2000_idwt(coef, rects, qmfbid)
        assert got.dtype == want.dtype and np.array_equal(got, want), (case, rects.tolist())
    for x0 in (0, 1):  # a single sample: kept at an even origin, halved toward 0 at an odd one
        rects = np.array([[(x0 + 1) // 2, 0, (x0 + 2) // 2, 1], [x0, 0, x0 + 1, 1]], np.int32)
        for v in (5, -5, -(2 ** 31)):
            one = np.array([[v]], np.int32)
            want = [[v] if x0 == 0 else [int(v / 2)]]
            assert image_io.jpeg2000_idwt_twin(one, rects, 1).tolist() == want
            assert native.jpeg2000_idwt(one, rects, 1).tolist() == want


# (mode, unpacker, components as (dx, dy, prec, sgnd)), as jpeg2000_decode.cpp's table pairs them
COLOUR_CASES = [
    ("L", 0, [(1, 1, 8, 0)]), ("L", 0, [(1, 1, 12, 1)]), ("L", 0, [(1, 1, 3, 0)]),
    ("I;16", 1, [(1, 1, 16, 0)]), ("I;16", 1, [(1, 1, 12, 1)]), ("I;16", 1, [(1, 1, 20, 0)]),
    ("LA", 2, [(1, 1, 8, 0), (1, 1, 5, 0)]), ("RGB", 3, [(1, 1, 8, 0)]),
    ("RGB", 4, [(1, 1, 8, 0)] * 3), ("RGB", 4, [(1, 1, 10, 1)] * 3),
    ("RGB", 5, [(1, 1, 8, 0), (2, 2, 8, 0), (2, 2, 8, 0)]), ("RGB", 5, [(1, 1, 8, 0)] * 3),
    ("RGBA", 6, [(1, 1, 8, 0)] * 4), ("RGBA", 7, [(1, 1, 8, 0)] * 4),
    ("RGBA", 4, [(1, 1, 8, 0), (2, 1, 8, 0), (1, 2, 8, 0)]), ("P", 0, [(1, 1, 8, 0)]),
    ("PA", 2, [(1, 1, 8, 0)] * 2), ("CMYK", 6, [(1, 1, 8, 0)] * 4),
]


@pytest.mark.parametrize("case", range(len(COLOUR_CASES)))
def test_colour_twin_matches_native(case):
    mode, unpacker, comps = COLOUR_CASES[case]
    rng = np.random.default_rng(case + 90)
    for trial in range(8):
        ox, oy = (int(v) for v in rng.integers(0, 4, 2))
        x0, y0 = ox + int(rng.integers(0, 3)), oy + int(rng.integers(0, 3))
        w, h = (int(v) for v in rng.integers(1, 12, 2))
        rect = (x0, y0, x0 + w, y0 + h)
        size_hw = (y0 + h - oy + int(rng.integers(0, 3)), x0 + w - ox + int(rng.integers(0, 3)))
        qmf = int(rng.integers(2)) if len(comps) < 3 or comps[1][0] == 1 else 1
        mct = int(rng.integers(2)) if len(comps) >= 3 and all(c[:2] == (1, 1) for c in comps[:3]) \
            else 0
        planes, qmfbid = [], []
        for dx, dy, prec, sgnd in comps:
            shape = (-(-(y0 + h) // dy) + (y0 // -dy), -(-(x0 + w) // dx) + (x0 // -dx))
            span = 1 << (prec - 1)
            if qmf == 1:
                planes.append(rng.integers(-span - 9, span + 9, shape).astype(np.int32))
            else:
                planes.append((rng.standard_normal(shape) * span).astype(np.float32))
            qmfbid.append(qmf)
        comps_a = np.array(comps, np.int32)
        shape, dtype = native.jpeg2000_shape(mode, size_hw)
        twin = np.zeros(shape, dtype)
        image_io.jpeg2000_colour_twin(twin, planes, qmfbid, comps_a, mct, mode, unpacker,
                                      (ox, oy), rect)
        want = native.jpeg2000_colour(planes, qmfbid, comps_a, mct, mode, unpacker, (ox, oy),
                                      rect, size_hw)
        assert np.array_equal(twin, want), (case, trial)


# --- (e) trees ---------------------------------------------------------------------------------

TASKS = ["depth", "rgb", "semseg"]


@pytest.fixture(scope="module")
def jpx_tree(tmp_path_factory):
    from PIL import Image

    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    root = tmp_path_factory.mktemp("jpx_tree")
    write_random_tree(str(root), 8, mf.TREE_HW, smooth=True,
                      rgb_files=sorted(str(p) for p in FIXTURES.glob("tree_*.jpx")))
    for png in sorted((root / "depth").rglob("*.png"))[:2]:  # 16-bit depth maps as .jpx
        depth = image_io.load_image(str(png), convert_rgb=False)
        buf = io.BytesIO()
        Image.fromarray(depth).save(buf, "JPEG2000")
        png.with_suffix(".jpx").write_bytes(buf.getvalue())
        png.unlink()
    return str(root)


def test_jpx_tree_listing_and_raw_samples_match_jax(jpx_tree):
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu_torch.data import dataset_folder as tdf

    j, t = jdf.MultiTaskImageFolder(jpx_tree, TASKS), tdf.MultiTaskImageFolder(jpx_tree, TASKS)
    assert t.samples == j.samples and len(t) == len(j) == 8
    assert {Path(p).suffix for p, _ in t.samples["rgb"]} == {".jpx"}
    assert sum(Path(p).suffix == ".jpx" for p, _ in t.samples["depth"]) == 2
    for i in range(len(t)):
        (js, jt), (ts, tt) = j.load_raw(i), t.load_raw(i)
        assert jt == tt
        for k in TASKS:
            assert np.array_equal(ts[k], np.asarray(js[k])), (i, k)
            assert ts[k].dtype == np.asarray(js[k]).dtype, (i, k)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    from _torch_jnative import bind_private_jax_fastimage

    with pytest.MonkeyPatch.context() as mp:
        try:
            yield bind_private_jax_fastimage(mp, tmp_path_factory.mktemp("jax_fastimage"))
        except RuntimeError as e:
            yield e


def test_jpx_tree_transform_matches_jax(jpx_tree, jax_native):
    """The pretraining transform over the tree: rgb within 1e-5
    (normalised units), depth and semseg bit-equal."""
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu.data.pretrain_transforms import DataAugmentationForMultiMAE as JAug
    from multimae_tpu_torch.data import dataset_folder as tdf
    from multimae_tpu_torch.data.pretrain_transforms import DataAugmentationForMultiMAE as TAug

    assert not isinstance(jax_native, RuntimeError), jax_native
    j, t = jdf.MultiTaskImageFolder(jpx_tree, TASKS), tdf.MultiTaskImageFolder(jpx_tree, TASKS)
    ja, ta = JAug(input_size=32), TAug(input_size=32)
    worst = 0.0
    for idx in range(len(t)):
        jo = ja(j.load_raw(idx)[0], rng=random.Random(idx))
        to = ta(t.load_raw(idx)[0], rng=random.Random(idx))
        assert set(jo) == set(to)
        assert np.array_equal(to["depth"], jo["depth"]) and np.array_equal(to["semseg"],
                                                                           jo["semseg"]), idx
        worst = max(worst, float(np.abs(to["rgb"] - jo["rgb"]).max()))
    assert worst <= 1e-5, worst


# --- (f) what the port does not decode -------------------------------------------------------


def high_throughput(capabilities: bool) -> bytes:
    """A codestream whose COD sets the high-throughput code-block style,
    with Rsiz's Part 15 bit and a CAP marker where `capabilities`."""
    planes = [mf.photo((8, 9), 41)[..., c].astype(np.int64) for c in range(3)]
    cs = bytearray(mf.encode(planes, [8] * 3, levels=1))
    cs[cs.index(b"\xff\x52") + 12] |= 0x40  # COD's code-block style
    if capabilities:
        cs[6] |= 0x40  # Rsiz
        siz_end = 4 + int.from_bytes(cs[4:6], "big")
        cs[siz_end:siz_end] = b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00"  # CAP
    return bytes(cs)


@pytest.mark.parametrize("container", ["j2k", "jp2"])
def test_high_throughput_codestream_names_item_11f_b(container, tmp_path):
    """High-throughput (Part 15) code-blocks in a codestream that claims
    Part 15 (Rsiz and CAP) stop the loader naming the file and item 11f-b,
    whatever their data hold: telling a sound HT code-block from a damaged
    one takes the HT decoder. The same style bit in a Part 1 codestream is
    damage, which PIL refuses too."""
    from multimae_tpu.data.dataset_folder import pil_loader

    for capabilities in (True, False):
        cs = high_throughput(capabilities)
        path = tmp_path / f"ht{int(capabilities)}.{container}"
        path.write_bytes(cs if container == "j2k" else mf.jp2(cs, enumcs=16))
        for twin in (False, True):
            if capabilities:
                with pytest.raises(UnsupportedImage, match=rf"{path.name}: .*item 11f-b"):
                    image_io.load_image(str(path), twin=twin)
            else:
                with pytest.raises(ValueError, match=rf"{path.name}: .*Part 15"):
                    image_io.load_image(str(path), twin=twin)
        if not capabilities:
            with pytest.raises(Exception):  # noqa: B017 - the JAX loader's retry catches any
                pil_loader(str(path))
