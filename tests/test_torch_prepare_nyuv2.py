"""The port's prepare_nyuv2 (multimae_tpu_torch/tools/prepare_nyuv2.py)
against the repository's JAX-side tools/prepare_nyuv2.py, run unchanged
through runpy (it reads the .mat with h5py and writes with PIL).

On the committed fixture (tests/fixtures/nyuv2: MATLAB v7.3's layout at
NYUv2's frame size, made by make_fixtures.py) and on a small .mat written
here, with and without --class_mapping_path and at a second --depth_scale,
PIL reads the two trees as equal: every file's mode, size, palette and
pixels. The fixture's datasets, read by the port's HDF5 reader, have the
SHA-256 of h5py's arrays in expected.json, and the port's trees the PNG
digests the JAX tool's trees gave. The port's tool runs with h5py and PIL
unimportable; the port's NYU semseg and depth loaders read its tree.
"""

import hashlib
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")
Image = pytest.importorskip("PIL.Image")

from multimae_tpu_torch.tools import prepare_nyuv2 as tool  # noqa: E402
from multimae_tpu_torch.utils import hdf5  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FIXTURE = REPO / "tests" / "fixtures" / "nyuv2"
JAX_TOOL = REPO / "tools" / "prepare_nyuv2.py"
EXPECTED = json.loads((FIXTURE / "expected.json").read_text())


def paths(root):
    return {"dataset_path": str(root / "nyu_depth_v2_labeled.mat"),
            "splits_path": str(root / "splits.mat"),
            "class_mapping_path": str(root / "classMapping40.mat")}


def argv(src, save, mapped, scale):
    out = ["--dataset_path", src["dataset_path"], "--splits_path", src["splits_path"],
           "--save_path", str(save), "--depth_scale", str(scale)]
    return out + (["--class_mapping_path", src["class_mapping_path"]] if mapped else [])


def run_jax_tool(args, monkeypatch):
    monkeypatch.setattr(sys, "argv", [str(JAX_TOOL)] + args)
    runpy.run_path(str(JAX_TOOL), run_name="__main__")


def pil_tree(root):
    """{relative path: (mode, size, palette, pixels)} as PIL reads them."""
    out = {}
    for p in sorted(Path(root).rglob("*.png")):
        with Image.open(p) as im:
            out[str(p.relative_to(root))] = (im.mode, im.size, im.getpalette(),
                                             np.asarray(im).copy())
    return out


def assert_same_trees(got_root, ref_root):
    got, ref = pil_tree(got_root), pil_tree(ref_root)
    assert sorted(got) == sorted(ref) and got
    for name, (mode, size, palette, px) in ref.items():
        g = got[name]
        assert (g[0], g[1], g[2]) == (mode, size, palette), name
        assert g[3].dtype == px.dtype and np.array_equal(g[3], px), name


@pytest.mark.parametrize("name", sorted(EXPECTED["datasets"]))
def test_fixture_datasets_have_their_digests(name):
    want = EXPECTED["datasets"][name]
    with hdf5.File(FIXTURE / "nyu_depth_v2_labeled.mat") as f, \
            h5py.File(FIXTURE / "nyu_depth_v2_labeled.mat", "r") as ref:
        arr = f[name].read()
        assert list(arr.shape) == want["shape"] and arr.dtype.str == want["dtype"]
        assert hashlib.sha256(arr.tobytes()).hexdigest() == want["sha256"]
        for i in range(arr.shape[0]):
            assert f[name][i].tobytes() == ref[name][i].tobytes()
        assert f.user_block().startswith(b"MATLAB 7.3 MAT-file")
        assert sorted(f.keys()) == ["#refs#", "accelData", "depths", "images", "labels",
                                    "names", "scenes"]
        assert f["names"].dtype is None and f["scenes"].dtype is None


@pytest.mark.parametrize("tree,mapped", [("class40", True), ("raw", False)])
def test_fixture_tree_has_the_jax_tools_digests(tmp_path, tree, mapped):
    summary = tool.main(argv(paths(FIXTURE), tmp_path, mapped, 1000.0))
    assert summary["frames"] == EXPECTED["splits"]
    assert tool.tree_digests(tmp_path) == EXPECTED["trees"][tree]


@pytest.mark.parametrize("mapped,scale", [(True, 1000.0), (False, 1000.0), (True, 7000.0)])
def test_fixture_tree_equals_the_jax_tools(tmp_path, monkeypatch, mapped, scale):
    src = paths(FIXTURE)
    run_jax_tool(argv(src, tmp_path / "jax", mapped, scale), monkeypatch)
    tool.main(argv(src, tmp_path / "port", mapped, scale))
    assert_same_trees(tmp_path / "port", tmp_path / "jax")


def write_small_mat(root, n=5, hw=(30, 40), seed=0):
    """A MATLAB-like .mat of n noise frames of hw (the frames' content
    changes every pixel), depths past 65.535 m and labels past 255."""
    from scipy.io import savemat

    rng = np.random.default_rng(seed)
    h, w = hw
    with h5py.File(root / "nyu_depth_v2_labeled.mat", "w", libver="earliest",
                   userblock_size=512) as f:
        f.create_dataset("images", data=rng.integers(0, 256, (n, 3, w, h), dtype=np.uint8),
                         chunks=(2, 3, 16, h), compression="gzip", shuffle=True)
        depth = rng.uniform(0, 80, (n, w, h)).astype(np.float32)
        depth[rng.random(depth.shape) < 0.2] = 0.0
        f.create_dataset("depths", data=depth, chunks=(1, 7, 11), compression="gzip",
                         compression_opts=9, fletcher32=True)
        f.create_dataset("labels", data=rng.integers(0, 895, (n, w, h), dtype=np.uint16))
    order = rng.permutation(n) + 1
    savemat(root / "splits.mat", {"trainNdxs": order[:3].astype(np.uint16)[:, None],
                                  "testNdxs": order[3:].astype(np.uint16)[:, None]})
    savemat(root / "classMapping40.mat",
            {"mapClass": rng.integers(1, 41, (1, 894)).astype(np.float64)})
    return paths(root)


@pytest.mark.parametrize("mapped,scale", [(True, 1000.0), (False, 1000.0), (False, 333.3)])
def test_written_mat_tree_equals_the_jax_tools(tmp_path, monkeypatch, mapped, scale):
    src = write_small_mat(tmp_path)
    run_jax_tool(argv(src, tmp_path / "jax", mapped, scale), monkeypatch)
    tool.main(argv(src, tmp_path / "port", mapped, scale))
    assert_same_trees(tmp_path / "port", tmp_path / "jax")


def test_one_frame_split(tmp_path, monkeypatch):
    """A split of one frame: the JAX tool iterates the 0-d array that
    `squeeze()` leaves and raises; the port writes the frame."""
    from scipy.io import savemat

    src = write_small_mat(tmp_path, n=3)
    savemat(src["splits_path"], {"trainNdxs": np.array([[3, 1]], np.uint16).T,
                                 "testNdxs": np.array([[2]], np.uint16)})
    with pytest.raises(TypeError, match="not iterable"):
        run_jax_tool(argv(src, tmp_path / "jax", True, 1000.0), monkeypatch)
    assert tool.main(argv(src, tmp_path / "port", True, 1000.0))["frames"] == {
        "train": 2, "test": 1}
    assert (tmp_path / "port" / "test" / "semseg" / "all" / "0001.png").exists()


def test_runs_without_h5py_or_pil(tmp_path):
    code = ("import sys; sys.modules['h5py'] = None; sys.modules['PIL'] = None\n"
            "from multimae_tpu_torch.tools import prepare_nyuv2 as t\n"
            f"t.main({argv(paths(FIXTURE), tmp_path, True, 1000.0)!r})\n"
            "assert 'h5py' not in sys.modules or sys.modules['h5py'] is None\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True)
    assert tool.tree_digests(tmp_path) == EXPECTED["trees"]["class40"]


def test_the_ports_loaders_read_the_tree(tmp_path):
    """The NYU semseg loader (MultiTaskImageFolder + the semseg training
    transform) and the NYU depth transform read the tree the tool wrote."""
    import random

    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder
    from multimae_tpu_torch.data.regression_transforms import NYUTransform
    from multimae_tpu_torch.data.semseg_transforms import (
        DataAugmentationForSemSeg, SimpleTransform)

    tool.main(argv(paths(FIXTURE), tmp_path, True, 1000.0))
    tasks = ["rgb", "depth", "semseg", "mask_valid"]
    data = MultiTaskImageFolder(str(tmp_path / "train"), tasks)
    assert len(data) == EXPECTED["splits"]["train"]
    sample, _ = data[0]
    assert sample["rgb"].shape == (480, 640, 3) and sample["rgb"].dtype == np.uint8
    assert sample["depth"].shape == (480, 640) and sample["depth"].dtype == np.uint16
    assert sample["semseg"].shape == (480, 640) and int(sample["semseg"].max()) <= 40
    np.testing.assert_array_equal(sample["mask_valid"] > 0, sample["depth"] > 0)
    semseg = DataAugmentationForSemSeg(SimpleTransform(True, 64), seg_num_classes=40)(
        dict(sample), rng=random.Random(0))
    assert semseg["rgb"].shape[:2] == (64, 64) and semseg["semseg"].shape == (64, 64)
    depth = NYUTransform(train=False, input_size=64)(dict(sample), rng=random.Random(0))
    assert depth["depth"].shape[:2] == (64, 64)


def test_semseg_loss_takes_the_trees_labels_as_jax_does(tmp_path):
    """The class-mapped tree's labels run over 0..40 (0 void) and the NYU
    recipe has 40 classes, so label 40 lies past them: the JAX loss counts
    such a pixel with an NLL of 0 (its one-hot row is empty), and so does
    the port's (a gather there would index past the classes)."""
    import jax.numpy as jnp
    import torch

    from multimae_tpu.cli.run_finetuning_semseg import seg_cross_entropy
    from multimae_tpu_torch.cli.run_finetuning_semseg import seg_cross_entropy_parts
    from multimae_tpu_torch.data.image_io import read_png

    tool.main(argv(paths(FIXTURE), tmp_path, True, 1000.0))
    labels = np.stack([read_png(p.read_bytes()).pixels
                       for p in sorted((tmp_path / "train" / "semseg" / "all").iterdir())])
    labels[:, :8, :8] = 255  # ignored
    assert labels.max() == 255 and 40 in labels
    logits = np.random.default_rng(0).standard_normal(labels.shape + (40,)).astype(np.float32)
    num, den = seg_cross_entropy_parts(torch.from_numpy(logits), torch.from_numpy(labels))
    ref = float(seg_cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    assert abs(float(num / den) - ref) <= 1e-6 * abs(ref)
