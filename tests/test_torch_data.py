"""The port's data pipeline (multimae_tpu_torch/data/) against the JAX
package's and against PIL.

Trees are written with PIL here, as tests/test_cli_end_to_end.py does.

* Listings: make_dataset / MultiTaskImageFolder samples, classes and
  labels identical to the JAX package's, with `max_images` and `prefixes`.
* PNG: the port's reader bit-equal to PIL on PIL-written files (gray,
  gray + alpha, RGB, RGBA, 16-bit gray, palette at 8 and 2 bits, 1-bit
  gray) and on files written with each of the five row filters; files
  the port writes read back bit-equal through PIL.
* JPEG: bit-equal to the JAX package's native decoder (libjpeg).
* Crop parameters equal under the same random.Random seed.
* The transform against the JAX package's DataAugmentationForMultiMAE
  (its native rgb path here): depth and semseg bit-equal; rgb within 1e-5
  absolute in normalised units (measured: 3e-7; the sums run in another
  order than fastimage.cpp's compiled loops).
* The loader: each record once per epoch across 2 simulated ranks, the
  same batches for 0 and 2 worker processes, get_state / set_state
  resuming the same sequence, a deterministic corrupt-file retry.
"""

import io
import os
import random
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from multimae_tpu import native as jnative
from multimae_tpu.data import dataset_folder as jdf
from multimae_tpu.data.pretrain_transforms import (
    DataAugmentationForMultiMAE as JAug,
    random_resized_crop_params as jcrop,
)
from multimae_tpu_torch.data import dataset_folder as tdf
from multimae_tpu_torch.data import image_io
from multimae_tpu_torch.data.loader import Loader, epoch_shard
from multimae_tpu_torch.data.pretrain_transforms import (
    DataAugmentationForMultiMAE as TAug,
    random_resized_crop_params as tcrop,
)

H, W = 96, 128
TASKS = ["depth", "rgb", "semseg"]


def smooth(i, scale=1.0):
    yy, xx = np.mgrid[0:H, 0:W]
    return np.sin(xx / (7.0 * scale) + i) * np.cos(yy / (5.0 * scale))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """10 aligned samples in 2 classes: PNG rgb (smooth + noise channels),
    16-bit depth, 'P' semseg; plus a pseudo-label semseg tree under a
    prefix, and an rgb JPEG copy."""
    root = str(tmp_path_factory.mktemp("torch_data"))
    rng = np.random.default_rng(0)
    for i in range(10):
        cls = f"c{i % 2}"
        for t in ("rgb", "depth", "semseg", "pseudo_semseg", "rgb_jpg"):
            os.makedirs(f"{root}/{t}/{cls}", exist_ok=True)
        s = (128 + 100 * smooth(i)).astype(np.uint8)
        rgb = np.stack([s, rng.integers(0, 255, (H, W), dtype=np.uint8), s[::-1]], -1)
        Image.fromarray(rgb, "RGB").save(f"{root}/rgb/{cls}/i{i:02d}.png")
        Image.fromarray(rgb, "RGB").save(f"{root}/rgb_jpg/{cls}/i{i:02d}.jpg", quality=90)
        Image.fromarray((30000 + 25000 * smooth(i, 1.5)).astype(np.uint16)).save(
            f"{root}/depth/{cls}/i{i:02d}.png")
        for t in ("semseg", "pseudo_semseg"):
            Image.fromarray(rng.integers(0, 10, (H, W), dtype=np.uint8), "L").convert(
                "P").save(f"{root}/{t}/{cls}/i{i:02d}.png")
    return root


@pytest.mark.parametrize("kw", [{}, {"max_images": 7}, {"prefixes": {"semseg": "pseudo_"}},
                                {"max_images": 3, "prefixes": {"semseg": "pseudo_"}}])
def test_listing_matches_jax(tree, kw):
    j, t = jdf.MultiTaskImageFolder(tree, TASKS, **kw), tdf.MultiTaskImageFolder(tree, TASKS, **kw)
    assert (t.classes, t.class_to_idx) == (j.classes, j.class_to_idx)
    assert t.samples == j.samples and len(t) == len(j)
    _, idx = jdf.find_classes(f"{tree}/rgb")
    assert tdf.make_dataset(f"{tree}/rgb", idx) == jdf.make_dataset(f"{tree}/rgb", idx)


def test_image_folder_matches_jax(tree):
    j, t = jdf.ImageFolder(f"{tree}/rgb"), tdf.ImageFolder(f"{tree}/rgb")
    assert t.samples == j.samples
    img, target = t[3]
    assert target == j[3][1] and np.array_equal(img, np.asarray(j[3][0]))


def test_load_raw_matches_jax(tree):
    """rgb as RGB, semseg as palette indices, depth as uint16."""
    j, t = jdf.MultiTaskImageFolder(tree, TASKS), tdf.MultiTaskImageFolder(tree, TASKS)
    for i in (0, 5):
        js, jt = j.load_raw(i)
        ts, tt = t.load_raw(i)
        assert jt == tt
        for k in TASKS:
            ref = np.asarray(js[k])
            assert ts[k].dtype == ref.dtype and np.array_equal(ts[k], ref), k


def pil_images():
    rng = np.random.default_rng(1)
    noise = rng.integers(0, 255, (61, 83, 3), dtype=np.uint8)
    s = (np.add.outer(np.arange(61), np.arange(83)) * 3 % 256).astype(np.uint8)
    pal = Image.fromarray(rng.integers(0, 3, (61, 83), dtype=np.uint8), "P")
    pal.putpalette([255, 0, 0, 0, 255, 0, 0, 0, 255])
    return {
        "rgb_noise": (Image.fromarray(noise, "RGB"), {}),
        "rgb_smooth": (Image.fromarray(np.stack([s, s[::-1], s], -1), "RGB"), {}),
        "gray": (Image.fromarray(s, "L"), {}),
        "gray_alpha": (Image.fromarray(s, "L").convert("LA"), {}),
        "rgba": (Image.fromarray(np.concatenate([noise, s[..., None]], -1), "RGBA"), {}),
        "palette8": (Image.fromarray(s % 40, "L").convert("P"), {}),
        "palette2": (Image.fromarray(rng.integers(0, 4, (61, 83), dtype=np.uint8),
                                     "L").convert("P"), {"bits": 2}),
        "palette_rgb": (pal, {}),
        "gray16_noise": (Image.fromarray(rng.integers(0, 65535, (61, 83), dtype=np.uint16)), {}),
        "gray16_smooth": (Image.fromarray(s.astype(np.uint16) * 250), {}),
        "bilevel": (Image.fromarray(s > 128).convert("1"), {}),
    }


@pytest.mark.parametrize("name", sorted(pil_images()))
def test_png_reader_matches_pil(name):
    img, kw = pil_images()[name]
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    data = buf.getvalue()
    ref = Image.open(io.BytesIO(data))
    dec = image_io.read_png(data)
    raw = np.asarray(ref)
    if ref.mode in ("RGBA", "LA"):
        raw = raw[..., :3] if ref.mode == "RGBA" else raw[..., 0]
    if ref.mode == "1":  # PIL gives bools; the port gray levels 0 and 255
        raw = raw.astype(np.uint8) * 255
    got = image_io.png_raw(dec)
    assert got.dtype == raw.dtype and np.array_equal(got, raw)
    if ref.mode != "I;16":
        assert np.array_equal(image_io.png_to_rgb(dec), np.asarray(ref.convert("RGB")))


def _filtered_png(pixels, filter_type):
    """A PNG whose every row uses `filter_type` (PNG spec 9.2)."""
    h, w = pixels.shape[:2]
    c = 1 if pixels.ndim == 2 else pixels.shape[2]
    big = pixels.dtype == np.uint16
    rows = (pixels.astype(">u2") if big else pixels).tobytes()
    stride, bpp = w * c * (2 if big else 1), c * (2 if big else 1)
    raw = np.frombuffer(rows, np.uint8).reshape(h, stride).astype(np.int32)
    out = []
    for y in range(h):
        x, up = raw[y], raw[y - 1] if y else np.zeros(stride, np.int32)
        a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        cc = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
        if filter_type == 0:
            f = x
        elif filter_type == 1:
            f = x - a
        elif filter_type == 2:
            f = x - up
        elif filter_type == 3:
            f = x - (a + up) // 2
        else:
            p = a + up - cc
            pa, pb, pc = abs(p - a), abs(p - up), abs(p - cc)
            f = x - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, cc))
        out.append(bytes([filter_type]) + (f & 0xFF).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    color = {1: 0, 3: 2, 4: 6}[c]
    return (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16 if big else 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray16"])
def test_png_filters_match_pil(filter_type, kind):
    rng = np.random.default_rng(filter_type)
    pixels = {"rgb": rng.integers(0, 256, (23, 37, 3), dtype=np.uint8),
              "rgba": rng.integers(0, 256, (23, 37, 4), dtype=np.uint8),
              "gray16": rng.integers(0, 65536, (23, 37), dtype=np.uint16)}[kind]
    data = _filtered_png(pixels, filter_type)
    ref = np.asarray(Image.open(io.BytesIO(data)))
    assert np.array_equal(ref, pixels)
    assert np.array_equal(image_io.read_png(data).pixels, pixels)


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb", "rgba", "palette"])
def test_png_writer_reads_back_through_pil(tmp_path, kind):
    rng = np.random.default_rng(2)
    pixels = {"gray8": rng.integers(0, 256, (19, 31), dtype=np.uint8),
              "gray16": rng.integers(0, 65536, (19, 31), dtype=np.uint16),
              "rgb": rng.integers(0, 256, (19, 31, 3), dtype=np.uint8),
              "rgba": rng.integers(0, 256, (19, 31, 4), dtype=np.uint8),
              "palette": rng.integers(0, 133, (19, 31), dtype=np.uint8)}[kind]
    palette = rng.integers(0, 256, (133, 3), dtype=np.uint8) if kind == "palette" else None
    path = str(tmp_path / "x.png")
    image_io.write_png(path, pixels, palette=palette)
    img = Image.open(path)
    assert np.array_equal(np.asarray(img), pixels)
    raw = pixels[..., :3] if kind == "rgba" else pixels  # alpha is dropped
    assert np.array_equal(image_io.load_image(path, convert_rgb=False), raw)
    if palette is not None:
        assert img.mode == "P"
        assert np.array_equal(image_io.load_image(path), np.asarray(img.convert("RGB")))


def test_jpeg_matches_jax_native(tree):
    if not jnative.available():
        pytest.skip("the JAX package's native decoder did not build here")
    for name in sorted(os.listdir(f"{tree}/rgb_jpg/c0"))[:3]:
        path = f"{tree}/rgb_jpg/c0/{name}"
        with open(path, "rb") as f:
            data = f.read()
        assert np.array_equal(image_io.load_image(path), jnative.decode_jpeg(data))


def test_jpeg_without_decoder_raises_naming_file(tree, monkeypatch):
    """A machine without g++ or libjpeg: the error names the file and the
    library, and the corrupt-file retry does not swallow it."""
    monkeypatch.setattr(image_io, "_JPEG_LIB", None)
    monkeypatch.setattr(image_io, "_JPEG_ERROR", "the JPEG decoder needs g++ and libjpeg")
    ds = tdf.MultiTaskImageFolder(tree, ["rgb_jpg"])
    with pytest.raises(RuntimeError, match=r"i00\.jpg: the JPEG decoder needs g\+\+ and libjpeg"):
        ds[0]


def test_damaged_png_raises_value_error(tmp_path):
    path = tmp_path / "bad.png"
    image_io.write_png(str(path), np.zeros((8, 8), np.uint8))
    path.write_bytes(path.read_bytes()[:40])
    with pytest.raises(ValueError, match="bad.png"):
        image_io.load_image(str(path))


@pytest.mark.parametrize("hw", [(96, 128), (480, 640), (100, 30), (30, 400)])
def test_crop_params_match_jax(hw):
    for seed in range(20):
        assert tcrop(*hw, rng=random.Random(seed)) == jcrop(*hw, rng=random.Random(seed))


@pytest.mark.parametrize("size", [64, 224])
def test_transform_matches_jax(tree, size):
    """rgb within 1e-5 (normalised units), depth and semseg bit-equal."""
    assert jnative.available(), "the JAX transform's rgb path here is the native one"
    j, t = jdf.MultiTaskImageFolder(tree, TASKS), tdf.MultiTaskImageFolder(tree, TASKS)
    ja, ta = JAug(input_size=size), TAug(input_size=size)
    worst = 0.0
    for idx in (0, 3, 8):
        for seed in range(4):
            jo = ja(j.load_raw(idx)[0], rng=random.Random(seed))
            to = ta(t.load_raw(idx)[0], rng=random.Random(seed))
            assert set(jo) == set(to)
            for k in jo:
                assert to[k].shape == jo[k].shape and to[k].dtype == jo[k].dtype, k
            assert np.array_equal(to["depth"], jo["depth"])
            assert np.array_equal(to["semseg"], jo["semseg"])
            worst = max(worst, float(np.abs(to["rgb"] - jo["rgb"]).max()))
    assert worst <= 1e-5, worst


class IndexDataset:
    """load_raw(i) -> ({"x": [i]}, i); indices in `bad` raise ValueError."""

    def __init__(self, n, bad=()):
        self.n, self.bad = n, set(bad)

    def __len__(self):
        return self.n

    def load_raw(self, i):
        if i in self.bad:
            raise ValueError(f"record {i} is damaged")
        return {"x": np.asarray([i], np.int64)}, i


def test_shards_cover_each_record_once():
    n, batch = 23, 4
    seen = []
    for rank in range(2):
        loader = Loader(IndexDataset(n), None, global_batch_size=batch, seed=5,
                        shard_index=rank, shard_count=2)
        epoch = [int(v) for _ in range(loader.steps_per_epoch) for v in next(loader)["label"]]
        assert epoch == list(epoch_shard(n, 0, seed=5, shard_index=rank, shard_count=2)[
            :loader.steps_per_epoch * 2])
        seen.append(set(epoch))
        assert len(epoch) == len(set(epoch)) == (n // batch) * 2
    assert not seen[0] & seen[1]
    shards = [set(epoch_shard(n, 3, seed=5, shard_index=r, shard_count=2)) for r in range(2)]
    assert not shards[0] & shards[1] and len(shards[0] | shards[1]) == n - n % 2


def test_batches_equal_for_0_and_2_workers(tree):
    ds = tdf.MultiTaskImageFolder(tree, TASKS)
    runs = []
    for workers in (0, 2):
        loader = Loader(ds, TAug(input_size=64), global_batch_size=4, seed=1,
                        num_workers=workers)
        runs.append([next(loader) for _ in range(3)])  # crosses an epoch (2 steps)
        loader.close()
    for a, b in zip(*runs):
        assert set(a) == set(b) == set(TASKS) | {"label"}
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert runs[0][0]["semseg"].dtype == torch.int64 and runs[0][0]["rgb"].shape == (4, 64, 64, 3)


def test_state_resumes_the_same_sequence():
    ds = IndexDataset(20)
    a = Loader(ds, None, global_batch_size=3, seed=2)
    first = [next(a)["label"] for _ in range(4)]
    state = a.get_state()
    rest = [next(a)["label"] for _ in range(9)]  # past the epoch of 6 batches
    b = Loader(ds, None, global_batch_size=3, seed=2)
    b.set_state(state)
    assert state == {"seed": 2, "epoch": 0, "batch": 4}
    assert all(torch.equal(x, next(b)["label"]) for x in rest)
    assert not torch.equal(first[0], rest[2])
    with pytest.raises(ValueError, match="seed"):
        Loader(ds, None, global_batch_size=3, seed=3).set_state(state)


def test_corrupt_file_retry_is_deterministic(capsys):
    ds = IndexDataset(16, bad={1, 2, 3, 7, 11})
    runs = []
    for _ in range(2):
        loader = Loader(ds, None, global_batch_size=4, seed=0)
        runs.append([next(loader)["x"] for _ in range(8)])
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    got = torch.cat(runs[0]).flatten().tolist()
    assert not set(got) & ds.bad and len(got) == 32
    assert "resampling" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="20 consecutive corrupt samples"):
        next(Loader(IndexDataset(8, bad=range(8)), None, global_batch_size=2, seed=0))
