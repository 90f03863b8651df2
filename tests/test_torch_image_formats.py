"""The port's readers of the formats the datasets' IMG_EXTENSIONS promise
beside PNG and JPEG (multimae_tpu_torch/data/image_io.py) against PIL, and
`UnsupportedImage` against the corrupt-file retries.

* The committed fixtures (tests/fixtures/images/, written by its
  make_fixtures.py): Adam7-interlaced PNG at every colour type and depth,
  BMP (core to V5 headers, palettes read as "P", "1" and "L", 16-, 24- and
  32-bit pixels with bitfields, BI_RLE8 and BI_RLE4 with every escape,
  bottom-up and top-down) and netpbm (P1-P6, plain and raw, maxvals PIL
  scales, 16-bit gray as "I"): convert("RGB") and the raw form bit-equal
  to PIL's committed digests, through the native library and the numpy
  twins; files PIL refuses raise ValueError.
* The same kinds written here at random sizes: Adam7 PNG from numpy,
  BMP and netpbm by PIL; and seeded random RLE streams through the native
  decoder and its twin, which agree on pixels and on refusals.
* The four files the port refused with UnsupportedImage until ROADMAP
  items 11g and 11h ported them (CCITT, LZMA and ZSTD TIFF, old-style JPEG
  tiles side by side with tables in tags) read bit-equal to PIL, alone and
  through `ImageFolder`, `MultiTaskImageFolder` and the loader; an RGB
  semseg map or an 8-bit depth map in a tree stops them with
  UnsupportedImage naming the file; a truncated file is still resampled.
"""

import hashlib
import io
import json
import shutil
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from multimae_tpu_torch import native
from multimae_tpu_torch.data import image_io
from multimae_tpu_torch.data.dataset_folder import (IMG_EXTENSIONS, ImageFolder,
                                                    MultiTaskImageFolder, write_random_tree)
from multimae_tpu_torch.data.image_io import UnsupportedImage

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "images"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())
sys.path.insert(0, str(FIXTURES))
import make_fixtures as mf  # noqa: E402

# TIFF files are read and refused in tests/test_torch_tiff.py and
# tests/test_torch_tiff_jpeg.py; the files once unported (their expected.json
# entries name the ROADMAP item that ported them) through the loaders here.
READ = sorted(n for n, e in EXPECTED.items() if "sha256" in e and not n.endswith(".tif"))
REFUSED = sorted(n for n, e in EXPECTED.items() if "error" in e and not n.endswith(".tif"))
UNPORTED = sorted(n for n, e in EXPECTED.items() if e.get("ported_in"))


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("name", READ)
def test_fixture_matches_pil(name, twin):
    want = EXPECTED[name]
    rgb = image_io.load_image(str(FIXTURES / name), twin=twin)
    raw = image_io.load_image(str(FIXTURES / name), convert_rgb=False, twin=twin)
    assert list(rgb.shape) == want["shape"] and rgb.dtype == np.uint8
    assert digest(rgb) == want["sha256"]
    assert list(raw.shape) == want["raw_shape"] and str(raw.dtype) == want["raw_dtype"]
    assert digest(raw) == want["raw_sha256"], want["mode"]


@pytest.mark.parametrize("name", REFUSED)
def test_file_pil_refuses_raises_value_error(name):
    with pytest.raises(ValueError, match=rf"{name}: .*{EXPECTED[name]['error']}"):
        image_io.load_image(str(FIXTURES / name))


def test_fixtures_cover_the_kinds():
    modes = {EXPECTED[n]["mode"] for n in READ}
    assert {"1", "L", "P", "I", "RGB", "RGBA", "LA", "I;16"} <= modes
    assert {n.split("_")[0] for n in READ} >= {"adam7", "bmp", "pbm", "pgm", "ppm", "tree"}
    assert sum((FIXTURES / n).stat().st_size for n in EXPECTED) < 200_000


PNG_KINDS = [(0, 1), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 2), (3, 8), (4, 8), (4, 16),
             (6, 8), (6, 16)]


@pytest.mark.parametrize("kind", PNG_KINDS, ids=lambda k: f"type{k[0]}_{k[1]}bit")
def test_adam7_png_matches_pil_at_random_sizes(kind, tmp_path):
    ct, depth = kind
    rng = np.random.default_rng(ct * 17 + depth)
    for i in range(6):
        hw = tuple(int(v) for v in rng.integers(1, 40, 2))
        c = mf.CHANNELS[ct]
        px = rng.integers(0, 1 << depth, hw + ((c,) if c > 1 else ()))
        pal = rng.integers(0, 256, (1 << depth, 3)) if ct == 3 else None
        data = mf.png_adam7(px, depth, ct, pal, seed=i)
        path = tmp_path / f"{i}.png"
        path.write_bytes(data)
        pil = Image.open(io.BytesIO(data))
        ref = np.asarray(pil)
        ref = ref.astype(np.uint8) * 255 if ref.dtype == bool else ref
        ref = ref[..., 0] if pil.mode == "LA" else ref[..., :3] if ref.ndim == 3 else ref
        for twin in (False, True):
            assert np.array_equal(image_io.load_image(str(path), twin=twin),
                                  np.asarray(pil.convert("RGB"))), (hw, twin)
            assert np.array_equal(image_io.load_image(str(path), False, twin=twin), ref), hw


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pil_written_bmp_and_netpbm_match_pil(mode, tmp_path):
    rng = np.random.default_rng(len(mode))
    for i in range(4):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        img = Image.fromarray(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), "RGBA")
        img = img.quantize(int(rng.integers(2, 200))) if mode == "P" else img.convert(mode)
        for fmt in (("BMP", "PPM") if mode in ("1", "L", "RGB") else ("BMP",)):
            buf = io.BytesIO()
            img.save(buf, fmt)
            path = tmp_path / f"{i}.{fmt.lower()}"
            path.write_bytes(buf.getvalue())
            pil = Image.open(path)
            ref = np.asarray(pil)
            ref = ref.astype(np.uint8) * 255 if ref.dtype == bool else ref
            ref = ref[..., :3] if ref.ndim == 3 else ref
            assert np.array_equal(image_io.load_image(str(path)), np.asarray(pil.convert("RGB")))
            assert np.array_equal(image_io.load_image(str(path), convert_rgb=False), ref), fmt


def test_rle_decoder_and_twin_agree_on_random_streams():
    """Seeded random RLE streams, most of them nonsense: the native decoder
    and its twin give the same pixels or the same refusal, and PIL agrees
    on a sample of them."""
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (256, 3))
    agreed = refused = 0
    for case in range(300):
        rle4 = bool(case % 2)
        w, h = (int(v) for v in rng.integers(1, 12, 2))
        n = int(rng.integers(2, 80))
        body = bytes(rng.choice([0, 1, 2, 3, 4, 5, 7, 15, 200], n).astype(np.uint8)
                     if case % 3 else rng.integers(0, 256, n, dtype=np.uint8))
        data = mf.bmp(body, w, h, 4 if rle4 else 8, compression=2 if rle4 else 1,
                      palette=pal[:16] if rle4 else pal)
        offset = struct.unpack_from("<I", data, 10)[0]
        results = []
        for fn in (native.bmp_rle, image_io.bmp_rle_twin):
            try:
                results.append(fn(data, offset, offset, rle4, w, h))
            except ValueError as e:
                results.append(str(e))
        if isinstance(results[0], str):
            assert results[0] == results[1], case
            refused += 1
        else:
            assert np.array_equal(results[0], results[1]), case
            agreed += 1
        if case % 10 == 0:
            try:
                ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            except (OSError, ValueError):
                ref = None
            got = None if isinstance(results[0], str) else image_io.read_bmp(data).rgb()
            assert (ref is None) == (got is None) and (got is None or np.array_equal(got, ref))
    assert agreed > 50 and refused > 50, (agreed, refused)


# --- UnsupportedImage and the retries ------------------------------------------------


def test_unsupported_image_is_no_value_or_os_error():
    assert not issubclass(UnsupportedImage, (ValueError, OSError))
    assert {".tif", ".tiff", ".webp", ".jpx", ".bmp", ".ppm", ".pgm"} <= set(IMG_EXTENSIONS)


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_format_raises_naming_file_and_item(name):
    """A file item 11g or 11h ported reads as PIL reads it, in both forms,
    through the native decoders and the twins."""
    want = EXPECTED[name]
    assert want["ported_in"] in ("11g", "11h")
    for twin in (False, True):
        rgb = image_io.load_image(str(FIXTURES / name), twin=twin)
        raw = image_io.load_image(str(FIXTURES / name), convert_rgb=False, twin=twin)
        assert digest(rgb) == want["sha256"] and digest(raw) == want["raw_sha256"], twin


@pytest.fixture
def tree(tmp_path):
    write_random_tree(str(tmp_path), 4, (16, 24), classes=1)
    return tmp_path


@pytest.mark.parametrize("name", UNPORTED)
def test_unported_file_stops_both_loaders(tree, name):
    """A file item 11g or 11h ported no longer stops the loaders: each reads
    it as PIL does, and the loader's batch holds it."""
    from multimae_tpu_torch.data.loader import Loader

    rgb = tree / "rgb" / "c0"
    victim = rgb / ("i0002" + Path(name).suffix)
    (rgb / "i0002.png").unlink()
    shutil.copyfile(FIXTURES / name, victim)
    want = EXPECTED[name]["sha256"]
    single = ImageFolder(str(tree / "rgb"))
    assert [digest(single[i][0]) for i in range(len(single))].count(want) == 1
    multi = MultiTaskImageFolder(str(tree), ["rgb"])
    assert digest(multi.load_raw(2)[0]["rgb"]) == want
    batch = next(Loader(multi, _corner, global_batch_size=4, seed=0))
    assert batch["rgb"].shape == (4, 16, 16, 3)


def _corner(sample, rng=None):
    """Each image's top-left 16 x 16 pixels, so that the batch stacks."""
    return {k: v[:16, :16] for k, v in sample.items()}


def test_truncated_file_is_still_resampled(tree, capsys):
    from multimae_tpu_torch.data.loader import Loader

    path = tree / "rgb" / "c0" / "i0001.png"
    path.write_bytes(path.read_bytes()[:60])
    multi = MultiTaskImageFolder(str(tree), ["rgb"])
    batch = next(Loader(multi, None, global_batch_size=4, seed=0))
    assert batch["rgb"].shape[0] == 4
    assert "i0001.png" in capsys.readouterr().out


def test_mode_checks_stop_the_run_naming_the_file(tree):
    """An RGB semseg map and an 8-bit depth map: PIL reads both, the port's
    pipeline does not take them, and neither is resampled."""
    from multimae_tpu_torch.data.loader import Loader
    from multimae_tpu_torch.data.pretrain_transforms import DataAugmentationForMultiMAE

    semseg = tree / "semseg" / "c0" / "i0003.png"
    image_io.write_png(str(semseg), np.zeros((16, 24, 3), np.uint8))
    multi = MultiTaskImageFolder(str(tree), ["rgb", "semseg"])
    with pytest.raises(UnsupportedImage, match="i0003.png: a segmentation map of 3 channels"):
        next(Loader(multi, None, global_batch_size=4, seed=0))
    depth = tree / "depth" / "c0" / "i0000.png"
    image_io.write_png(str(depth), np.zeros((16, 24), np.uint8))
    multi = MultiTaskImageFolder(str(tree), ["depth", "rgb"])
    loader = Loader(multi, DataAugmentationForMultiMAE(16), global_batch_size=4, seed=0)
    with pytest.raises(UnsupportedImage, match=r"i0000\.png.*depth map of uint8"):
        next(loader)
