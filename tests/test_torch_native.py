"""The port's native image library (multimae_tpu_torch/native/) against its
numpy twins, PIL, and the JAX package's fastimage and cv2 transforms.

* Every native function is bit-equal to its numpy twin (the *_twin
  functions of data/): PIL's resampling (rgb crop + resize + normalise and
  its uint8 form, bicubic and bilinear; "I;16" depth; NEAREST) over up- and
  down-scaling and crops touching each border; cv2's linear resize (uint8,
  float32) and nearest resize (uint8, uint16, float32) at odd widths and
  1 and 3 channels; RGB2GRAY and RGB2HSV on random colours; HSV2RGB on
  every H < 180, S and V, and at widths below, at and past multiples of 32
  (the scalar tail).
* PNG: every filter type at every bit depth and colour type decodes to the
  numpy reader's arrays (all samples, alpha dropped, RGB), and to PIL's
  where PIL keeps the samples; a 640x480 RGB file of Paeth and Average
  rows decodes in under 50 ms and at least 6x faster than the numpy
  reader; the adaptive writer reads back through PIL.
* Against the JAX package on the CPU: `crop_resize_normalize` and
  `crop_resize_u8` are bit-equal to fastimage.cpp's, built from the JAX
  package's source with the port's flags (no fused multiply-adds), and
  within 1e-5 of `multimae_tpu.native` as that package builds it; the
  semseg training transform is bit-equal to the JAX one (cv2), colour
  jitter on and at its default rate, on photo-like NYU-shaped samples.
* The build: a second process loads the cached library without building;
  a broken source raises with g++'s message and the transforms raise
  rather than fall back.
* The loader: workers stopped with batches in flight exit cleanly.
"""

import io
import os
import random
import shutil
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import pytest

from multimae_tpu_torch import native
from multimae_tpu_torch.data import image_io
from multimae_tpu_torch.data import pretrain_transforms as T
from multimae_tpu_torch.data import semseg_transforms as S
from multimae_tpu_torch.data.dataset_folder import _smooth_sample, write_random_tree

REPO = Path(__file__).resolve().parents[1]
MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
STD = np.asarray([0.229, 0.224, 0.225], np.float32)


# --- PIL's resampling -------------------------------------------------------------


def crops(h, w):
    """(name, crop) cases: random, and crops touching each border."""
    rng = random.Random(h * 1000 + w)
    out = [("random", T.random_resized_crop_params(h, w, rng=rng))]
    ch, cw = max(1, h // 2), max(1, w // 3)
    out += [("top", (0, w // 4, ch, cw)), ("bottom", (h - ch, w // 4, ch, cw)),
            ("left", (h // 4, 0, ch, cw)), ("right", (h // 4, w - cw, ch, cw)),
            ("whole", (0, 0, h, w))]
    return out


RESAMPLE = [(97, 131, 224), (256, 320, 224), (40, 50, 224), (480, 640, 64), (33, 35, 7)]


@pytest.mark.parametrize("h,w,size", RESAMPLE, ids=lambda v: str(v))
@pytest.mark.parametrize("channels", [1, 3])
def test_crop_resize_normalize_is_twin(h, w, size, channels):
    img = np.random.default_rng(h).integers(0, 256, (h, w, channels), dtype=np.uint8)
    for name, crop in crops(h, w):
        for bicubic in (True, False):
            for flip in (False, True):
                got = native.crop_resize_normalize(img, crop, (size, size), MEAN[:channels],
                                                   STD[:channels], bicubic=bicubic, hflip=flip)
                ref = T.crop_resize_normalize_twin(img, crop, size, MEAN[:channels],
                                                   STD[:channels], flip, bicubic=bicubic)
                assert got.dtype == ref.dtype and np.array_equal(got, ref), (name, bicubic, flip)
                got = native.crop_resize_u8(img, crop, (size, size), bicubic=bicubic, hflip=flip)
                ref = T.crop_resize_u8_twin(img, crop, size, flip, bicubic=bicubic)
                assert np.array_equal(got, ref), (name, bicubic, flip)


@pytest.mark.parametrize("h,w,size", RESAMPLE, ids=lambda v: str(v))
def test_depth_and_nearest_are_twin(h, w, size):
    rng = np.random.default_rng(w)
    depth = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    labels = rng.integers(0, 133, (h, w), dtype=np.uint8)
    for name, (i, j, ch, cw) in crops(h, w):
        for flip in (False, True):
            ref = T.resize_u16_twin(depth[i:i + ch, j:j + cw], size)
            got = native.crop_resize_u16(depth, (i, j, ch, cw), (size, size), hflip=flip)
            assert np.array_equal(got, ref[:, ::-1] if flip else ref), (name, flip)
            ref = T.resize_nearest_twin(labels[i:i + ch, j:j + cw], size)
            got = native.pil_nearest(labels, (i, j, ch, cw), (size, size), hflip=flip)
            assert np.array_equal(got, ref[:, ::-1] if flip else ref), (name, flip)


def test_crop_outside_the_image_raises():
    img = np.zeros((10, 12, 3), np.uint8)
    with pytest.raises(ValueError, match="outside"):
        native.crop_resize_normalize(img, (5, 0, 6, 12), (4, 4), MEAN, STD)
    with pytest.raises(ValueError, match="uint16"):
        native.crop_resize_u16(img[..., 0], (0, 0, 10, 12), (4, 4))


def test_pretrain_transform_is_twin():
    """The whole DataAugmentationForMultiMAE, native against twins."""
    rgb, depth, labels = _smooth_sample(np.random.default_rng(3), 180, 240, 133)
    sample = {"rgb": rgb, "depth": depth, "semseg": labels}
    for seed in range(6):
        got = T.DataAugmentationForMultiMAE(96)(sample, rng=random.Random(seed))
        ref = T.DataAugmentationForMultiMAE(96, twin=True)(sample, rng=random.Random(seed))
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


# --- cv2 ---------------------------------------------------------------------------

# (h, w, dh, dw): down and up, odd widths, one-pixel sides, the LongestMaxSize
# of NYU and the large-scale jitter's extremes
CV_CASES = [(480, 640, 384, 512), (384, 512, 768, 1024), (384, 512, 38, 51), (1, 7, 3, 2),
            (5, 1, 2, 9), (37, 53, 71, 29), (97, 131, 128, 173), (64, 33, 64, 31)]


@pytest.mark.parametrize("case", CV_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("channels", [1, 3])
def test_cv_resizes_are_twin(case, channels):
    h, w, dh, dw = case
    rng = np.random.default_rng(h + w)
    shape = (h, w, channels) if channels > 1 else (h, w)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    assert np.array_equal(S.resize_linear(img, (dw, dh)), S.resize_linear_twin(img, (dw, dh)))
    f = (rng.random(shape) * 255).astype(np.float32)
    got, ref = S.resize_linear(f, (dw, dh)), S.resize_linear_twin(f, (dw, dh))
    assert got.dtype == np.float32 and np.array_equal(got, ref)
    for arr in (img, rng.integers(0, 65536, shape).astype(np.uint16), f):
        got, ref = S.resize_nearest(arr, (dw, dh)), S.resize_nearest_twin(arr, (dw, dh))
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_rgb_to_gray_and_hsv_are_twin():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (256, 257, 3), dtype=np.uint8)
    rgb[0, :8] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0], [0, 0, 255],
                  [7, 7, 7], [255, 255, 0], [1, 0, 1]]
    assert np.array_equal(S.rgb_to_gray(rgb), S.rgb_to_gray_twin(rgb))
    assert np.array_equal(S.rgb_to_hsv(rgb), S.rgb_to_hsv_twin(rgb))


def test_hsv_to_rgb_is_twin_on_every_hsv():
    """Every H < 180, S and V: the fused multiply-adds against the twin's
    float64 evaluation, rows of 1024 (all in the vector loop)."""
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"),
                   -1).reshape(180 * 64, 1024, 3).astype(np.uint8)
    assert np.array_equal(S.hsv_to_rgb(hsv), S.hsv_to_rgb_twin(hsv))


@pytest.mark.parametrize("width", [1, 31, 32, 33, 63, 64, 65, 97])
def test_hsv_to_rgb_tails_are_twin(width):
    rng = np.random.default_rng(width)
    hsv = np.stack([rng.integers(0, 180, (40, width)), rng.integers(0, 256, (40, width)),
                    rng.integers(0, 256, (40, width))], -1).astype(np.uint8)
    assert np.array_equal(S.hsv_to_rgb(hsv), S.hsv_to_rgb_twin(hsv))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_semseg_transform_is_twin(train):
    rgb, depth, labels = _smooth_sample(np.random.default_rng(5), 240, 320, 40)
    sample = {"rgb": rgb, "depth": depth, "semseg": labels,
              "mask_valid": (labels % 7 != 0).astype(np.uint8) * 255}
    for seed in range(6):
        outs = [S.DataAugmentationForSemSeg(S.SimpleTransform(train, 160, twin=twin,
                                                              color_jitter_p=1.0),
                                            seg_num_classes=40)(sample, rng=random.Random(seed))
                for twin in (False, True)]
        for k in outs[1]:
            assert np.array_equal(outs[0][k], outs[1][k]), k


# --- PNG ---------------------------------------------------------------------------

# (colour type, bit depth) pairs the PNG standard allows
KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


def filtered_png(samples: np.ndarray, depth: int, color_type: int, filter_type,
                 palette=None) -> bytes:
    """A PNG of (H, W, C) samples whose rows use `filter_type` (one type,
    or one per row)."""
    h, w, c = samples.shape
    if depth == 16:
        rows = samples.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        rows = samples.astype(np.uint8).reshape(h, -1)
    else:
        per = 8 // depth
        padded = np.zeros((h, -(-w // per) * per), np.uint8)
        padded[:, :w] = samples[..., 0]
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = (padded.reshape(h, -1, per) << shifts).sum(axis=2).astype(np.uint8)
    bpp = max(1, c * depth // 8)
    x = rows.astype(np.int32)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, bpp:] = x[:-1, :-bpp]
    p = a + b - cc
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
    pred = np.stack([np.zeros_like(x), a, b, (a + b) // 2,
                     np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))])
    types = np.broadcast_to(np.asarray(filter_type, np.uint8), (h,))
    body = ((x - pred[types, np.arange(h)]) & 0xFF).astype(np.uint8)
    raw = np.concatenate([types[:, None], body], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    out = image_io.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth,
                                                               color_type, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b"")


def kind_png(color_type, depth, filter_type, h=13, w=37, seed=0):
    rng = np.random.default_rng(seed)
    c = native.PNG_CHANNELS[color_type]
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (h, w, c)).astype(np.uint16 if depth == 16 else np.uint8)
    palette = (rng.integers(0, 256, (min(top + 1, 200), 3), dtype=np.uint8)
               if color_type == 3 else None)
    return filtered_png(samples, depth, color_type, filter_type, palette)


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("kind", KINDS, ids=lambda k: f"type{k[0]}_{k[1]}bit")
def test_png_decode_is_twin_and_pil(kind, filter_type):
    color_type, depth = kind
    data = kind_png(color_type, depth, filter_type, seed=filter_type)
    got, ref = image_io.read_png(data), image_io.read_png_twin(data)
    assert got.pixels.dtype == ref.pixels.dtype and np.array_equal(got.pixels, ref.pixels)
    assert np.array_equal(image_io.decode_png(data, False), image_io.png_raw(ref))
    if depth != 16:
        assert np.array_equal(image_io.decode_png(data, True), image_io.png_to_rgb(ref))
    Image = pytest.importorskip("PIL.Image")
    pil = Image.open(io.BytesIO(data))
    if depth == 16 and color_type != 0:
        return  # PIL keeps 8 bits of these
    raw = np.asarray(pil)
    if pil.mode == "1":
        raw = raw.astype(np.uint8) * 255
    if pil.mode in ("LA", "RGBA"):
        raw = raw[..., 0] if pil.mode == "LA" else raw[..., :3]
    assert np.array_equal(image_io.decode_png(data, False), raw)
    if depth != 16:
        assert np.array_equal(image_io.decode_png(data, True), np.asarray(pil.convert("RGB")))


def test_png_bad_filter_and_depth_raise():
    data = bytearray(image_io._PngFile(kind_png(2, 8, 0)).raw)
    data[5 * (37 * 3 + 1)] = 7
    with pytest.raises(ValueError, match="row 5 has unknown filter type 7"):
        native.png_decode(bytes(data), 37, 13, 8, 2, None, "samples")
    bad = filtered_png(np.zeros((2, 2, 3), np.uint8), 8, 2, 0)
    bad = bad[:24] + bytes([4]) + bad[25:]  # RGB at 4 bits: not in the standard
    with pytest.raises(ValueError, match="colour type 2 at bit depth 4"):
        image_io.read_png(bad)


def best_ms(fn, repeats=3):
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times)


def test_photo_png_decodes_fast():
    """640x480 RGB of Paeth rows: under 50 ms (the numpy reader took
    about 300 ms); Paeth and Average rows: at least 6x the numpy reader."""
    rgb, _, _ = _smooth_sample(np.random.default_rng(6), 480, 640, 40)
    paeth = filtered_png(rgb, 8, 2, 4)
    assert best_ms(lambda: image_io.decode_png(paeth, True)) < 50
    mixed = filtered_png(rgb, 8, 2, [3, 4] * 240)
    assert np.array_equal(image_io.decode_png(mixed, True), rgb)
    native_ms = best_ms(lambda: image_io.decode_png(mixed, True))
    twin_ms = best_ms(lambda: image_io.png_to_rgb(image_io.read_png_twin(mixed)), repeats=1)
    assert twin_ms >= 6 * native_ms, (native_ms, twin_ms)


def test_adaptive_writer_reads_back(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rgb, depth, labels = _smooth_sample(np.random.default_rng(7), 60, 90, 40)
    palette = np.random.default_rng(7).integers(0, 256, (40, 3), dtype=np.uint8)
    for name, pixels, kw in (("rgb", rgb, {}), ("depth", depth, {}),
                             ("gray", rgb[..., 0], {}), ("labels", labels, {"palette": palette})):
        path = str(tmp_path / f"{name}.png")
        counts = image_io.write_png(path, pixels, filters="adaptive", **kw)
        assert counts.sum() == pixels.shape[0]
        assert (counts[0] == pixels.shape[0]) == (name == "labels"), counts  # palette: filter 0
        assert np.array_equal(np.asarray(Image.open(path)), pixels)
        assert np.array_equal(image_io.load_image(path, convert_rgb=False), pixels)


def test_smooth_tree_uses_every_filter(tmp_path):
    counts = write_random_tree(str(tmp_path), 2, (48, 64), smooth=True, mask_valid=True)
    assert counts.sum() == 2 * 4 * 48 and (counts[1:] > 0).sum() >= 3, counts


# --- the JAX package ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_fastimage(tmp_path_factory):
    """The JAX package's fastimage.cpp built with the port's flags, bound
    with the JAX package's signatures; the JAX module itself bound to its
    source built with its own flags for this process alone
    (tests/_torch_jnative.py)."""
    from _torch_jnative import JAX_LIBS, JAX_SOURCE, bind_private_jax_fastimage

    with pytest.MonkeyPatch.context() as mp:
        try:
            jnative = bind_private_jax_fastimage(mp, tmp_path_factory.mktemp("jax_own_flags"))
            path = native.build(JAX_SOURCE, tmp_path_factory.mktemp("jax_fastimage"),
                                libs=JAX_LIBS, name="libfastimage.so")
        except RuntimeError as e:
            pytest.skip(f"the JAX package's source does not build here: {e}")
        lib = jnative._load()
        jax_lib = __import__("ctypes").CDLL(str(path))
        for name in ("mm_crop_resize_normalize", "mm_crop_resize_u8"):
            fn = getattr(jax_lib, name)
            fn.argtypes, fn.restype = getattr(lib, name).argtypes, getattr(lib, name).restype
        yield jnative, jax_lib


def test_crop_resize_matches_jax_fastimage(jax_fastimage, monkeypatch):
    jnative, jax_lib = jax_fastimage
    rng = np.random.default_rng(8)
    worst, differ, cases = 0.0, 0, 0
    for t in range(40):
        h, w = (int(v) for v in rng.integers(16, 360, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        crop = T.random_resized_crop_params(h, w, rng=random.Random(t))
        size, flip, bicubic = int(rng.integers(8, 240)), t % 2 == 0, t % 3 != 0
        got = native.crop_resize_normalize(img, crop, (size, size), MEAN, STD, bicubic, flip)
        got_u8 = native.crop_resize_u8(img, crop, (size, size), bicubic, flip)
        built = jnative.crop_resize_normalize(img, crop, (size, size), MEAN, STD, bicubic, flip)
        worst, differ, cases = (max(worst, float(np.abs(got - built).max())),
                                differ + (not np.array_equal(got, built)), cases + 1)
        with monkeypatch.context() as m:
            m.setattr(jnative, "_lib", jax_lib)
            assert np.array_equal(got, jnative.crop_resize_normalize(
                img, crop, (size, size), MEAN, STD, bicubic, flip))
            assert np.array_equal(got_u8, jnative.crop_resize_u8(img, crop, (size, size),
                                                                 bicubic, flip))
    # The JAX package builds with -march=native, where g++ fuses multiply-adds.
    print(f"against the JAX package's own build: {differ} of {cases} differ, max {worst:.3g}")
    assert worst <= 1e-5


@pytest.mark.parametrize("jitter", [1.0, 0.5], ids=["jitter", "default"])
def test_semseg_transform_matches_jax_cv2(jitter):
    J = pytest.importorskip("multimae_tpu.data.semseg_transforms")
    kw = dict(seg_num_classes=40)
    rng = np.random.default_rng(9)
    for seed in range(4):
        rgb, depth, labels = _smooth_sample(rng, 480, 640, 40)
        labels[:60, :80] = 255
        sample = {"rgb": rgb, "depth": depth, "semseg": labels,
                  "mask_valid": (labels % 5 != 0).astype(np.uint8) * 255}
        ref = J.DataAugmentationForSemSeg(J.SimpleTransform(True, 256, color_jitter_p=jitter),
                                          **kw)(sample, random.Random(seed))
        got = S.DataAugmentationForSemSeg(S.SimpleTransform(True, 256, color_jitter_p=jitter),
                                          **kw)(sample, random.Random(seed))
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k


# --- the build ---------------------------------------------------------------------


def test_build_hash_covers_both_sources(tmp_path):
    """The library holds fastimage.cpp and jpeg_decode.cpp; an edit to
    either gives a new build directory."""
    lib_dirs = set()
    for edited in (None, "fastimage.cpp", "jpeg_decode.cpp"):
        sources = []
        for src in native.SOURCES:
            copy = tmp_path / str(edited) / src.name
            copy.parent.mkdir(exist_ok=True)
            copy.write_bytes(src.read_bytes() + (b"\n// edited\n" if src.name == edited else b""))
            sources.append(copy)
        lib_dirs.add(native.build(sources, tmp_path / "build").parent.name)
    assert len(lib_dirs) == 3
    assert hasattr(native.lib(), "mm_decode_jpeg") and hasattr(native.lib(), "mm_png_decode")


def test_second_process_loads_without_building():
    path = native.build()
    mtime = path.stat().st_mtime_ns
    code = ("from multimae_tpu_torch import native; native.lib(); "
            "print(native.BUILD_SECONDS)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "None" and path.stat().st_mtime_ns == mtime


def test_broken_source_raises_without_fallback(tmp_path, monkeypatch):
    for broken_name in ("fastimage.cpp", "jpeg_decode.cpp"):
        sources = []
        for src in native.SOURCES:
            copy = tmp_path / broken_name / src.name
            copy.parent.mkdir(exist_ok=True)
            shutil.copy(src, copy)
            sources.append(copy)
        with open(tmp_path / broken_name / broken_name, "a") as f:
            f.write("\nint broken(\n")
        with pytest.raises(RuntimeError, match=rf"(?s)g\+\+ .* failed:\n.*{broken_name}.*error"):
            native.build(sources, tmp_path / "build")
    assert not list((tmp_path / "build").rglob("*.so"))

    def fail(*args, **kw):
        raise RuntimeError("g++ failed: fastimage.cpp:1: error")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "build", fail)
    rgb = np.zeros((32, 40, 3), np.uint8)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        S.SimpleTransform(True, 32)({"rgb": rgb}, rng=random.Random(0))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        T.DataAugmentationForMultiMAE(16)({"rgb": rgb}, rng=random.Random(0))


# --- the loader --------------------------------------------------------------------


class BigRecords:
    """Records of 0.75 MiB, which torch sends through shared memory."""

    def __len__(self):
        return 24

    def load_raw(self, i):
        return {"x": np.full((256, 256, 3), i, np.float32)}, i


def test_workers_stopped_with_batches_in_flight_exit_cleanly():
    from multimae_tpu_torch.data.loader import Loader

    loader = Loader(BigRecords(), None, global_batch_size=2, num_workers=2)
    first = [int(next(loader)["label"][0]) for _ in range(3)]
    workers = loader.loader._iterator._workers
    loader.close()
    assert [w.exitcode for w in workers] == [0, 0]
    again = Loader(BigRecords(), None, global_batch_size=2)
    assert first == [int(next(again)["label"][0]) for _ in range(3)]
