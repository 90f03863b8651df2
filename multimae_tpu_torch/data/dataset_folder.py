"""Multi-modal folder datasets (counterpart of
multimae_tpu/data/dataset_folder.py :1-175; reference
utils/dataset_folder.py).

* `make_dataset`: the sorted walk of root/<class>/..., same order.
* `ImageFolder`: one modality, (image, target).
* `CIFAR100`: the `cifar-100-python` pickles (JAX :180-238), read by an
  unpickler that builds numpy arrays and nothing else.
* `MultiTaskImageFolder`: aligned per-modality trees
  root/<prefix><task>/<class>/<name>.<ext>, the `max_images` subset drawn
  from np.random.RandomState(0), `load_raw`, and the corrupt-file retry.
  RGB comes back as (H, W, 3) uint8, semantic segmentation maps as palette
  indices (what PIL's convert("P") gives for palette and gray files),
  other modalities in their raw form (16-bit depth as uint16).

Images are numpy arrays from data/image_io.py, not PIL images: PNG, JPEG,
BMP, netpbm, TIFF, WebP and JPEG 2000 (a 16-bit depth map in either byte
order, or a 16-bit .jpx, comes back as native uint16). The corrupt-file
retry catches what a damaged or missing file raises (OSError, ValueError),
not the RuntimeError of a machine without the native library and not
`UnsupportedImage`, which a file that PIL reads and the port cannot raises
(a CCITT TIFF, a JPEG 2000 file with high-throughput code-blocks):
the JAX package trains on such a file, so the run stops naming it.
"""

from __future__ import annotations

import os
import pickle
import random
import shutil
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from multimae_tpu_torch.data.image_io import UnsupportedImage, load_image

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
    ".jpx",
)


def has_file_allowed_extension(filename: str, extensions: Tuple[str, ...]) -> bool:
    return filename.lower().endswith(extensions)


def find_classes(directory: str) -> Tuple[List[str], Dict[str, int]]:
    classes = sorted(d.name for d in os.scandir(directory) if d.is_dir())
    return classes, {c: i for i, c in enumerate(classes)}


def make_dataset(
    directory: str,
    class_to_idx: Dict[str, int],
    extensions: Tuple[str, ...] = IMG_EXTENSIONS,
) -> List[Tuple[str, int]]:
    instances = []
    for target_class in sorted(class_to_idx.keys()):
        class_index = class_to_idx[target_class]
        target_dir = os.path.join(directory, target_class)
        if not os.path.isdir(target_dir):
            continue
        for root, _, fnames in sorted(os.walk(target_dir, followlinks=True)):
            for fname in sorted(fnames):
                path = os.path.join(root, fname)
                if has_file_allowed_extension(path, extensions):
                    instances.append((path, class_index))
    return instances


class ImageFolder:
    """Single-modality class-folder dataset returning (RGB image, target)."""

    def __init__(
        self,
        root: str,
        transform: Optional[Callable] = None,
        extensions: Tuple[str, ...] = IMG_EXTENSIONS,
    ):
        self.root = root
        self.classes, self.class_to_idx = find_classes(root)
        self.samples = make_dataset(root, self.class_to_idx, extensions)
        if not self.samples:
            raise RuntimeError(f"Found 0 files in subfolders of: {root}")
        self.transform = transform

    def __len__(self) -> int:
        return len(self.samples)

    def load_raw(self, index: int) -> Tuple[np.ndarray, int]:
        path, target = self.samples[index]
        return load_image(path), target

    def __getitem__(self, index: int):
        while True:
            try:
                sample, target = self.load_raw(index)
                break
            except (OSError, ValueError) as e:  # corrupt-file retry
                print(e)
                index = random.randint(0, len(self.samples) - 1)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles dicts, lists, numbers, strings and numpy arrays only: a
    dataset file from outside the program must not run code."""

    ALLOWED = {("numpy.core.multiarray", "_reconstruct"),
               ("numpy._core.multiarray", "_reconstruct"), ("numpy", "ndarray"),
               ("numpy", "dtype"), ("_codecs", "encode")}

    def find_class(self, module: str, name: str):
        if (module, name) not in self.ALLOWED:
            raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a CIFAR pickle")
        return super().find_class(module, name)


class CIFAR100:
    """CIFAR-100 from `<root>/cifar-100-python/{train,test}` (the pickles
    with b'data', (N, 3072) uint8 rows in CHW order, and b'fine_labels'),
    as torchvision's CIFAR100 reads them for the reference's --data_set
    CIFAR; returns ((32, 32, 3) uint8, target) as ImageFolder does. No
    download: the files must be there."""

    base_folder = "cifar-100-python"

    def __init__(self, root: str, train: bool = True, transform: Optional[Callable] = None):
        path = os.path.join(root, self.base_folder, "train" if train else "test")
        if not os.path.exists(path):
            raise FileNotFoundError(f"CIFAR-100 pickle not found: {path} (no download; place "
                                    "cifar-100-python/ under the data path)")
        with open(path, "rb") as f:
            entry = _ArrayUnpickler(f, encoding="bytes").load()
        data = np.asarray(entry[b"data"], np.uint8)
        self.data = np.ascontiguousarray(data.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        self.targets = [int(t) for t in entry[b"fine_labels"]]
        if len(self.targets) != len(self.data):
            raise ValueError(f"{path}: {len(self.data)} images, {len(self.targets)} labels")
        self.transform = transform
        self.classes = [str(i) for i in range(100)]
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}

    def __len__(self) -> int:
        return len(self.targets)

    def load_raw(self, index: int) -> Tuple[np.ndarray, int]:
        return self.data[index], self.targets[index]

    def __getitem__(self, index: int):
        img, target = self.load_raw(index)
        if self.transform is not None:
            img = self.transform(img)
        return img, target


def write_cifar100(root: str, images: np.ndarray, labels: Sequence[int], train: bool = True
                   ) -> str:
    """Write (N, 32, 32, 3) uint8 `images` and their fine labels as
    `<root>/cifar-100-python/{train,test}` in the dataset's pickle layout,
    for tests; returns the file's path."""
    folder = os.path.join(root, CIFAR100.base_folder)
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "train" if train else "test")
    rows = np.ascontiguousarray(np.asarray(images, np.uint8).transpose(0, 3, 1, 2)).reshape(
        len(images), 3072)
    with open(path, "wb") as f:
        pickle.dump({b"data": rows, b"fine_labels": [int(v) for v in labels]}, f, protocol=2)
    return path


def write_imagenet_tree(root: str, files: Sequence[str], num_train: int, num_val: int,
                        classes: int, link: bool = True) -> Tuple[str, str]:
    """An ImageNet-layout tree of the given image files, taken in turn:
    `<root>/train/c<k>/i<n><ext>` (num_train samples) and `<root>/val/...`
    (num_val), sample n in class n % classes; symbolic links to the files,
    or copies with link=False. Returns the train and val folders."""
    out = []
    for split, count in (("train", num_train), ("val", num_val)):
        for i in range(count):
            src = os.path.abspath(files[i % len(files)])
            folder = os.path.join(root, split, f"c{i % classes}")
            os.makedirs(folder, exist_ok=True)
            dst = os.path.join(folder, f"i{i:05d}{os.path.splitext(src)[1]}")
            if link:
                os.symlink(src, dst)
            else:
                shutil.copyfile(src, dst)
        out.append(os.path.join(root, split))
    return out[0], out[1]


class MultiTaskImageFolder:
    """Aligned per-modality folder trees; __getitem__ -> ({task: array}, target)."""

    def __init__(
        self,
        root: str,
        tasks: Sequence[str],
        transform: Optional[Callable] = None,
        prefixes: Optional[Dict[str, str]] = None,
        max_images: Optional[int] = None,
        extensions: Tuple[str, ...] = IMG_EXTENSIONS,
        twin: bool = False,
    ):
        self.root = root
        self.tasks = list(tasks)
        self.twin = twin  # PNG files through the numpy reader, for comparisons; no CLI
        self.classes, self.class_to_idx = find_classes(
            os.path.join(root, self.tasks[0])
        )
        prefixes = dict(prefixes or {})
        prefixes.update({t: "" for t in self.tasks if t not in prefixes})
        self.samples = {
            t: make_dataset(
                os.path.join(root, f"{prefixes[t]}{t}"), self.class_to_idx, extensions
            )
            for t in self.tasks
        }
        for t, s in self.samples.items():
            if not s:
                raise RuntimeError(f"Found 0 files in subfolders of: {root}/{t}")
        if isinstance(max_images, int):
            total = len(next(iter(self.samples.values())))
            rng = np.random.RandomState(0)  # fixed-seed subset (reference :262)
            permutation = rng.permutation(total)
            for t in self.samples:
                self.samples[t] = [self.samples[t][i] for i in permutation][:max_images]
        self.transform = transform

    def __len__(self) -> int:
        return len(next(iter(self.samples.values())))

    def load_raw(self, index: int) -> Tuple[Dict[str, Any], int]:
        sample_dict = {}
        target = 0
        for t in self.tasks:
            path, target = self.samples[t][index]
            img = load_image(path, convert_rgb=(t == "rgb"), twin=self.twin)
            if "semseg" in t and img.ndim != 2:
                raise UnsupportedImage(f"{path}: a segmentation map of {img.shape[-1]} channels; "
                                       "the port reads palette and gray maps (PIL's modes "
                                       "'P' and 'L'), no ROADMAP item ports others")
            sample_dict[t] = img
        return sample_dict, target

    def __getitem__(self, index: int):
        while True:
            try:
                sample_dict, target = self.load_raw(index)
                break
            except (OSError, ValueError) as e:  # corrupt-file retry
                print(e)
                index = random.randint(0, len(self) - 1)
        if self.transform is not None:
            sample_dict = self.transform(sample_dict)
        return sample_dict, target


def _regions(rng: np.random.Generator, h: int, w: int, count: int) -> np.ndarray:
    """(h, w) int map of `count` Voronoi regions around random seeds."""
    seeds = rng.random((count, 2)) * (h, w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    best = np.full((h, w), np.inf, np.float32)
    out = np.zeros((h, w), np.int64)
    for k, (sy, sx) in enumerate(seeds):
        d = (yy - sy) ** 2 + (xx - sx) ** 2
        closer = d < best
        best[closer], out[closer] = d[closer], k
    return out


def _smooth_sample(rng: np.random.Generator, h: int, w: int, semseg_classes: int):
    """Photo-like rgb, depth and labels of one scene: regions (as objects)
    with their own colour, shading and depth plane, a smooth light field,
    and a little sensor noise."""
    regions = _regions(rng, h, w, 24)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    light = 0.75 + 0.25 * np.sin(2 * np.pi * (xx * rng.uniform(0.3, 1.5) + rng.random())) \
        * np.cos(2 * np.pi * (yy * rng.uniform(0.3, 1.5) + rng.random()))
    colour = rng.uniform(30, 230, (24, 3))
    tilt = rng.uniform(-40, 40, (24, 2))
    rgb = colour[regions] * light[..., None] + (tilt[regions, 0] * xx)[..., None] \
        + rng.normal(0, 2.0, (h, w, 3))
    plane = rng.uniform(-2000, 2000, (24, 2))
    depth = (rng.uniform(1000, 6000, 24)[regions] + plane[regions, 0] * xx
             + plane[regions, 1] * yy + rng.normal(0, 3.0, (h, w)))
    labels = rng.integers(0, semseg_classes, 24)[regions]
    return (np.clip(rgb, 0, 255).astype(np.uint8), np.clip(depth, 0, 65535).astype(np.uint16),
            labels.astype(np.uint8))


def write_random_tree(root: str, num_samples: int, hw: Tuple[int, int], seed: int = 0,
                      classes: int = 2, semseg_classes: int = 133,
                      ignore_patches: bool = False, mask_valid: bool = False,
                      smooth: bool = False, rgb_files: Sequence[str] = (),
                      fmt: str = "png") -> np.ndarray:
    """Write an aligned MultiTaskImageFolder tree of random PNGs drawn from
    `seed`: root/<task>/c<k>/i<n>.png with 8-bit RGB, 16-bit depth and
    palette semseg with labels in [0, semseg_classes) (133 by default, the
    pretraining recipe's), for tests and chip runs. The pixels are uniform
    noise written with filter 0, or with `smooth` photo-like scenes
    (regions with their own colour, shading and depth plane, and sensor
    noise) written with adaptive row filters, as PIL and libpng write real
    datasets. `ignore_patches` sets a random rectangle of each class map
    to the ignore label 255; `mask_valid` adds root/mask_valid/ maps of 0
    (invalid: a border and a random rectangle) and 255. NYUv2-shaped: hw
    (480, 640), semseg_classes 40, both on. `rgb_files` (JPEG files, say)
    are copied in turn as the rgb images, each under the sample's name with
    its own extension, in place of the RGB PNGs. `fmt` "tiff" writes every
    modality as TIFF instead (i<n>.tif; `image_io.write_tiff`): RGB in turn
    uncompressed, PackBits and Deflate with predictor 2 in 16 x 16 tiles,
    16-bit depth Deflate with predictor 2, little-endian for even samples
    and big-endian for odd ones, palette semseg and mask_valid Deflate.
    Returns the count of PNG rows written per filter type (5,)."""
    from multimae_tpu_torch.data.image_io import write_png, write_tiff

    if fmt not in ("png", "tiff"):
        raise ValueError(f"fmt must be 'png' or 'tiff', not {fmt!r}")
    ext = ".png" if fmt == "png" else ".tif"
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    h, w = hw
    tasks = ("rgb", "depth", "semseg") + (("mask_valid",) if mask_valid else ())
    filters = "adaptive" if smooth else "none"
    counts = np.zeros(5, np.int64)

    def rectangle():
        y, x = int(rng.integers(0, h)), int(rng.integers(0, w))
        return slice(y, y + int(rng.integers(1, h // 4 + 2))), slice(x, x + int(rng.integers(1, w // 4 + 2)))

    def write(task, name, pixels, palette=None):
        path = os.path.join(root, task, cls, name)
        if fmt == "png":
            counts[:] += write_png(path, pixels, palette=palette, filters=filters)
        elif task == "rgb":
            kinds = ({}, {"compression": "packbits"},
                     {"compression": "deflate", "predictor": 2, "tile": (16, 16)})
            write_tiff(path, pixels, **kinds[i % 3])
        else:
            write_tiff(path, pixels, palette, "deflate", 1 + (task == "depth"),
                       ">" if task == "depth" and i % 2 else "<")

    for i in range(num_samples):
        cls = f"c{i % classes}"
        for task in tasks:
            os.makedirs(os.path.join(root, task, cls), exist_ok=True)
        name = f"i{i:04d}{ext}"
        if smooth:
            rgb, depth, labels = _smooth_sample(rng, h, w, semseg_classes)
        else:
            rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            depth = rng.integers(0, 65536, (h, w), dtype=np.uint16)
            labels = None
        if rgb_files:
            src = rgb_files[i % len(rgb_files)]
            shutil.copyfile(src, os.path.join(root, "rgb", cls,
                                              f"i{i:04d}{os.path.splitext(src)[1]}"))
        else:
            write("rgb", name, rgb)
        write("depth", name, depth)
        if labels is None:
            labels = rng.integers(0, semseg_classes, (h, w), dtype=np.uint8)
        if ignore_patches:
            labels[rectangle()] = 255
        write("semseg", name, labels, palette=palette)
        if mask_valid:
            valid = np.zeros((h, w), np.uint8)
            valid[h // 40:h - h // 40, w // 40:w - w // 40] = 255
            valid[rectangle()] = 0
            write("mask_valid", name, valid)
    return counts
