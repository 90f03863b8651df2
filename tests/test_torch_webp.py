"""The port's WebP reader (multimae_tpu_torch/native/webp_decode.cpp,
data/image_io.py `read_webp`) against the JAX package's loader, which opens
a WebP file with PIL 12.1 (libwebp 1.6).

* (a) Every fixture of tests/fixtures/webp (its make_fixtures.py: PIL's
  lossy, alpha, lossless, palette and animated files; hand-written VP8
  frames with the simple filter, token partitions, loop-filter deltas,
  sharpness, segments with and without a map and coefficients past 16
  bits; raw ALPH under each filter; VP8L with simple codes, a colour cache
  and backward references): PIL's mode, and convert("RGB") and the raw form
  bit-equal to the committed digests and to the JAX `pil_loader`, through
  the native decoder and through the twins; the files PIL refuses raise
  ValueError naming the file.
* (b) PIL-written files at random sizes and options (fixed seeds).
* (c) A bounded fuzz of flipped bytes and cut files: PIL's pixels where PIL
  decodes, ValueError naming the file where it raises, never
  UnsupportedImage.
* (d) The colour and alpha twins against the native stages on random
  planes, widths and heights of 1 and 2 among them.
* (e) A tree whose rgb images are the tree_*.webp fixtures through the
  port's MultiTaskImageFolder and the JAX one: the same listing, samples
  and augmented batches; a .webp segmentation map stops the loader with
  UnsupportedImage, as an RGB PNG map does.
"""

import hashlib
import importlib.util
import json
import random
import re
from pathlib import Path

import numpy as np
import pytest

from multimae_tpu_torch import native
from multimae_tpu_torch.data import image_io
from multimae_tpu_torch.data.image_io import UnsupportedImage

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "webp"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
# Loaded from its path under a name of its own: tests/fixtures/images and
# tests/fixtures/jpeg hold modules named make_fixtures too.
_SPEC = importlib.util.spec_from_file_location("webp_make_fixtures", FIXTURES / "make_fixtures.py")
mf = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(mf)

READ = sorted(n for n, e in EXPECTED.items() if "sha256" in e)
REFUSED = sorted(n for n, e in EXPECTED.items() if "error" in e)


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def jax_forms(path):
    """The JAX pil_loader's mode, convert("RGB") pixels and raw pixels with
    alpha dropped (the port's raw form)."""
    from multimae_tpu.data.dataset_folder import pil_loader

    rgb = np.asarray(pil_loader(str(path)))
    img = pil_loader(str(path), False)
    return img.mode, rgb, np.ascontiguousarray(np.asarray(img)[..., :3])


def assert_reads_as_jax(path):
    mode, rgb, raw = jax_forms(path)
    for twin in (False, True):
        assert np.array_equal(image_io.load_image(str(path), twin=twin), rgb), (path, twin)
        assert np.array_equal(image_io.load_image(str(path), False, twin=twin), raw), (path, twin)
    assert image_io.read_webp(Path(path).read_bytes()).mode == mode


# --- (a) the fixtures ----------------------------------------------------------------


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("name", READ)
def test_fixture_matches_pil(name, twin):
    want, path = EXPECTED[name], FIXTURES / name
    rgb = image_io.load_image(str(path), twin=twin)
    raw = image_io.load_image(str(path), convert_rgb=False, twin=twin)
    assert list(rgb.shape) == want["shape"] and rgb.dtype == np.uint8
    assert digest(rgb) == want["sha256"]
    assert list(raw.shape) == want["raw_shape"] and digest(raw) == want["raw_sha256"]
    assert image_io.read_webp(path.read_bytes(), twin).mode == want["mode"]
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


def test_fixtures_cover_the_kinds_within_their_budget():
    chunks = {n: [t for t, _ in mf.chunks_of((FIXTURES / n).read_bytes())] for n in READ}
    assert {EXPECTED[n]["mode"] for n in READ} == {"RGB", "RGBA"}
    assert any(b"VP8 " in c and b"VP8X" not in c for c in chunks.values())
    assert any(b"VP8L" in c and b"VP8X" not in c for c in chunks.values())
    assert any(b"ALPH" in c for c in chunks.values())
    assert sum(b"ANMF" in c for c in chunks.values()) >= 4
    assert sum((FIXTURES / n).stat().st_size for n in EXPECTED) <= mf.SIZE_BUDGET
    assert len(list(FIXTURES.glob("tree_*.webp"))) == 4


def test_no_webp_file_is_unsupported():
    assert not any(test(b"RIFF\0\0\0\0WEBPVP8 ") for test, _, _ in image_io.UNPORTED_FORMATS)


# --- (b) PIL-written files ---------------------------------------------------------


def pil_written(kind, rng):
    h, w = (int(v) for v in rng.integers(1, 80, 2))
    seed = int(rng.integers(1 << 30))
    q, m = int(rng.integers(0, 101)), int(rng.integers(0, 7))
    if kind == "lossy":
        return mf.pil_webp(mf.photo((h, w), seed), quality=q, method=m)
    if kind == "alpha":
        rgba = mf.photo((h, w), seed, channels=4)
        rgba[rng.random((h, w)) < 0.2, 3] = 0
        return mf.pil_webp(rgba, "RGBA", quality=q, method=m,
                           alpha_quality=int(rng.integers(0, 101)))
    if kind == "lossless":
        return mf.pil_webp(mf.photo((h, w), seed, channels=4), "RGBA", lossless=True, method=m,
                           exact=bool(rng.integers(0, 2)), quality=q)
    if kind == "palette":
        from PIL import Image

        im = Image.fromarray(mf.photo((h, w), seed)).quantize(int(rng.integers(2, 257)))
        return mf.pil_webp(np.asarray(im.convert("RGB")), lossless=True, method=m)
    frames = [mf.photo((h, w), seed + k, channels=4) for k in range(3)]
    frames[0][: h // 2] = 0
    return mf.pil_animation(frames, lossless=bool(rng.integers(0, 2)), quality=q,
                            allow_mixed=bool(rng.integers(0, 2)), background=(0, 0, 0, 0))


KINDS = ["lossy", "alpha", "lossless", "palette", "animation"]


@pytest.mark.parametrize("kind", KINDS)
def test_pil_written_files_match_pil(kind, tmp_path):
    rng = np.random.default_rng(KINDS.index(kind) + 20)
    for i in range(6):
        path = tmp_path / f"{i}.webp"
        path.write_bytes(pil_written(kind, rng))
        assert_reads_as_jax(path)


# --- (c) damaged files -----------------------------------------------------------------

FUZZ_BASES = {"lossy": "lossy_31x45_q25_m1.webp", "alpha": "alpha_40x33_aq50_m4.webp",
              "lossless": "lossless_m3_exact.webp", "palette": "palette_16.webp",
              "animation": "anim_offset_lossy.webp", "raw_alpha": "alph_raw_gradient.webp",
              "partitions": "vp8_4_partitions_skip.webp", "vp8l_cache": "vp8l_cache_backrefs.webp"}


@pytest.mark.parametrize("kind", sorted(FUZZ_BASES))
def test_flipped_and_cut_files_decode_as_pil_or_raise_value_error(kind, tmp_path):
    base = (FIXTURES / FUZZ_BASES[kind]).read_bytes()
    rng = np.random.default_rng(sorted(FUZZ_BASES).index(kind) + 40)
    decoded = refused = 0
    for i in range(240):
        data = bytearray(base)
        if i % 3 == 0:
            data = data[:int(rng.integers(1, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                at = int(rng.integers(12, len(data)))
                if kind == "animation" and 24 <= at < 30:
                    continue  # the canvas size, which PIL would allocate
                data[at] = int(rng.integers(256)) if i % 3 == 1 else data[at] ^ (1 << int(
                    rng.integers(8)))
        path = tmp_path / f"f{i}.webp"
        path.write_bytes(bytes(data))
        try:
            jax_forms(path)
        except Exception:  # noqa: BLE001 - PIL refuses it: so must the port
            for twin in (False, True):
                with pytest.raises(ValueError, match=re.escape(path.name)):
                    image_io.load_image(str(path), twin=twin)
            refused += 1
            continue
        assert_reads_as_jax(path)
        decoded += 1
    assert decoded > 20 and refused > 20, (decoded, refused)


# --- (d) the twins -------------------------------------------------------------------------

SHAPES = [(1, 1), (1, 2), (2, 1), (2, 2), (1, 9), (9, 1), (2, 7), (3, 5), (17, 33), (40, 2)]


@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_colour_twin_matches_native(hw):
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    h, w = hw
    uv = ((h + 1) // 2, (w + 1) // 2)
    planes = [(rng.integers(0, 256, (h, w)), rng.integers(0, 256, uv), rng.integers(0, 256, uv))
              for _ in range(3)]
    planes += [(np.full((h, w), y), np.full(uv, u), np.full(uv, v))
               for y, u, v in ((0, 0, 255), (255, 255, 0), (16, 128, 128), (235, 0, 0))]
    for y, u, v in planes:
        y, u, v = (a.astype(np.uint8) for a in (y, u, v))
        assert np.array_equal(image_io.webp_colour_twin(y, u, v), native.webp_colour(y, u, v))


@pytest.mark.parametrize("alpha_filter", [0, 1, 2, 3], ids=["none", "horizontal", "vertical",
                                                          "gradient"])
def test_alpha_unfilter_twin_matches_native(alpha_filter):
    rng = np.random.default_rng(alpha_filter)
    for h, w in SHAPES:
        for samples in (rng.integers(0, 256, (h, w)), rng.integers(0, 3, (h, w)) * 127):
            samples = samples.astype(np.uint8)
            assert np.array_equal(image_io.alpha_unfilter_twin(samples, alpha_filter),
                                  native.webp_unfilter(samples, alpha_filter)), (h, w)


# --- (e) trees ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def webp_tree(tmp_path_factory):
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    root = tmp_path_factory.mktemp("webp_tree")
    write_random_tree(str(root), 8, mf.TREE_HW, smooth=True,
                      rgb_files=sorted(str(p) for p in FIXTURES.glob("tree_*.webp")))
    return str(root)


TASKS = ["depth", "rgb", "semseg"]


def test_webp_tree_listing_and_raw_samples_match_jax(webp_tree):
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu_torch.data import dataset_folder as tdf

    j, t = jdf.MultiTaskImageFolder(webp_tree, TASKS), tdf.MultiTaskImageFolder(webp_tree, TASKS)
    assert t.samples == j.samples and len(t) == len(j) == 8
    assert {Path(p).suffix for p, _ in t.samples["rgb"]} == {".webp"}
    for i in range(len(t)):
        (js, jt), (ts, tt) = j.load_raw(i), t.load_raw(i)
        assert jt == tt
        for k in TASKS:
            assert np.array_equal(ts[k], np.asarray(js[k])), (i, k)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    from _torch_jnative import bind_private_jax_fastimage

    with pytest.MonkeyPatch.context() as mp:
        try:
            yield bind_private_jax_fastimage(mp, tmp_path_factory.mktemp("jax_fastimage"))
        except RuntimeError as e:
            yield e


def test_webp_tree_transform_matches_jax(webp_tree, jax_native):
    """The pretraining transform over the tree: rgb within 1e-5
    (normalised units), depth and semseg bit-equal."""
    from multimae_tpu.data import dataset_folder as jdf
    from multimae_tpu.data.pretrain_transforms import DataAugmentationForMultiMAE as JAug
    from multimae_tpu_torch.data import dataset_folder as tdf
    from multimae_tpu_torch.data.pretrain_transforms import DataAugmentationForMultiMAE as TAug

    assert not isinstance(jax_native, RuntimeError), jax_native
    j, t = jdf.MultiTaskImageFolder(webp_tree, TASKS), tdf.MultiTaskImageFolder(webp_tree, TASKS)
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


def test_webp_semseg_map_stops_the_loader(tmp_path):
    """A .webp segmentation map is PIL's "RGB" (or "RGBA"): the port takes
    palette and gray maps only, so the loader stops naming the file, as for
    an RGB PNG map, and resamples nothing."""
    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder, write_random_tree
    from multimae_tpu_torch.data.loader import Loader

    write_random_tree(str(tmp_path), 4, (16, 24), classes=1)
    semseg = tmp_path / "semseg" / "c0"
    (semseg / "i0003.png").unlink()
    (semseg / "i0003.webp").write_bytes((FIXTURES / "lossless_m0.webp").read_bytes())
    multi = MultiTaskImageFolder(str(tmp_path), ["rgb", "semseg"])
    with pytest.raises(UnsupportedImage, match="i0003.webp: a segmentation map of 3 channels"):
        next(Loader(multi, None, global_batch_size=4, seed=0))
