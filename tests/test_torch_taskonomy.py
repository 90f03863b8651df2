"""The port's Taskonomy data path against the JAX package's (PIL and cv2)
on the CPU (multimae_tpu_torch/data/taskonomy.py, the native 3x3
Gaussian blur):

* `task_transform` for rgb, depth_zbuffer, mask_valid, normal,
  edge_occlusion, principal_curvature and reshading, on 8-bit RGB, 8-bit
  gray and 16-bit gray PNGs written by the port's writer, at a shorter
  side of 32 from 40 x 52 and at the file's own size: bit-equal to the JAX
  function on the PIL image, native and numpy twin;
* `gaussian_blur_3x3`, native and twin, bit-equal to
  cv2.GaussianBlur(x, (3, 3), sigmaX=1.0) on float32 over random sizes
  (odd and even widths, one row, one column);
* `TaskonomyDataset` over a written tree and its CSV split: the same
  arrays as the JAX dataset, sample by sample, and `max_images`;
* a truncated PNG raises ValueError naming the file (the JAX loader reads
  it with PIL's LOAD_TRUNCATED_IMAGES).
"""

import os

import cv2
import numpy as np
import pytest
from PIL import Image

from multimae_tpu.data import taskonomy as jtk
from multimae_tpu_torch import native
from multimae_tpu_torch.data import taskonomy as tk
from multimae_tpu_torch.data.image_io import load_image

TASKS = ["rgb", "depth_zbuffer", "mask_valid", "normal", "edge_occlusion",
         "principal_curvature", "reshading"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("taskonomy"))
    tk.write_taskonomy_tree(root, TASKS, {"train": 3, "val": 2}, hw=(40, 52), seed=4)
    return root


def first_row(root, split="train"):
    with open(os.path.join(root, "splits", f"tiny_{split}.csv")) as f:
        return f.read().splitlines()[1].split(",")


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("size", [32, None], ids=["resized", "as_is"])
@pytest.mark.parametrize("task", TASKS)
def test_task_transform_bit_equal_to_jax(tree, task, size, twin):
    path = tk.task_path(tree, task, *first_row(tree))
    with Image.open(path) as img:
        img.load()
        want = jtk.task_transform(img, task, image_size=size)
    got = tk.task_transform(load_image(path, convert_rgb=False), task, size, twin=twin)
    assert got.dtype == want.dtype and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    if size is not None:
        assert got.shape[:2] == (32, 42)


@pytest.mark.parametrize("fn", [native.gaussian_blur_3x3, tk.gaussian_blur_3x3_twin],
                         ids=["native", "twin"])
def test_gaussian_blur_bit_equal_to_cv2(fn):
    rng = np.random.default_rng(0)
    sizes = [(1, 1), (1, 7), (9, 1), (2, 2), (384, 384), (33, 47), (64, 70)]
    sizes += [tuple(int(v) for v in rng.integers(1, 90, 2)) for _ in range(40)]
    for h, w in sizes:
        x = (rng.integers(0, 65536, (h, w)) / 65535.0).astype(np.float32)
        if (h * w) % 2:
            x = rng.standard_normal((h, w)).astype(np.float32) * np.float32(50.0)
        np.testing.assert_array_equal(fn(x), cv2.GaussianBlur(x, (3, 3), sigmaX=1.0),
                                      err_msg=str((h, w)))


def test_blur_taps_are_cv2s():
    k = cv2.getGaussianKernel(3, 1.0, ktype=cv2.CV_32F).ravel()
    assert (k[1], k[0], k[2]) == (np.float32(0.45186275), np.float32(0.27406862),
                                  np.float32(0.27406862))


@pytest.mark.parametrize("split", ["train", "val"])
def test_dataset_matches_jax(tree, split):
    tasks = ["depth_zbuffer", "rgb", "mask_valid"]
    ref = jtk.TaskonomyDataset(tree, tasks, split=split, image_size=32)
    got = tk.TaskonomyDataset(tree, tasks, split=split, image_size=32)
    assert len(got) == len(ref) == {"train": 3, "val": 2}[split]
    for i in range(len(ref)):
        (g, gl), (r, rl) = got.load_raw(i), ref.load_raw(i)
        assert set(g) == set(r) == set(tasks) and gl == rl == 0
        for k in tasks:
            np.testing.assert_array_equal(g[k], r[k], err_msg=f"{i} {k}")
        assert not g["mask_valid"].all() and g["mask_valid"].any()
    assert len(tk.TaskonomyDataset(tree, tasks, split=split, max_images=1)) == 1


def test_truncated_png_raises_naming_the_file(tree, tmp_path):
    src = tk.task_path(tree, "depth_zbuffer", *first_row(tree))
    bad = tmp_path / "point_0_view_0_domain_depth_zbuffer.png"
    data = open(src, "rb").read()
    bad.write_bytes(data[: len(data) * 2 // 3])
    with pytest.raises(ValueError, match=str(bad)):
        load_image(str(bad), convert_rgb=False)


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
def test_16_bit_nearest_resize_matches_pil(tmp_path, twin):
    """Pillow resizes "I;16" through its generic transform, whose pixel
    centres differ from the 8-bit modes' summed ones at some sizes."""
    from multimae_tpu_torch.data.image_io import write_png

    rng = np.random.default_rng(2)
    for i in range(25):
        h, w = (int(v) for v in rng.integers(5, 120, 2))
        dh, dw = (int(v) for v in rng.integers(3, 130, 2))
        px = rng.integers(0, 65536, (h, w), dtype=np.uint16)
        path = str(tmp_path / f"{i}.png")
        write_png(path, px)
        with Image.open(path) as img:
            assert img.mode == "I;16"
            want = np.asarray(img.resize((dw, dh), Image.NEAREST))
        np.testing.assert_array_equal(tk._resize(px, (dh, dw), False, twin), want,
                                      err_msg=str((h, w, dh, dw)))
