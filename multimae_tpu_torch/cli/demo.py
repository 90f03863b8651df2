"""MultiMAE inpainting demo on the card (counterpart of the JAX package's
demo.py, the script version of the reference's MultiMAE_Demo.ipynb).

    python -m multimae_tpu_torch.cli.demo --checkpoint checkpoint-1599.pth \\
        --rgb my_image.jpg --depth my_depth.png --semseg my_semseg.png \\
        --num_encoded_tokens 98 --out_dir demo_out [--visible_rgb '0,0 1,0 7,7']

Loads a pretrained MultiMAE from a `.pth` (the reference's layout or the
port's own `checkpoint-*.pth`, through utils/torch_compat.load_pretrained)
or from a JAX `.msgpack` (the JAX demo's `from_state_dict`: every leaf of
the model's flax tree must be in `params/model`, utils/torch_compat.
load_flax_start with rule "strict"),
reads an RGB image (PNG or JPEG) and optionally a depth PNG and a semantic
segmentation PNG, masks the tokens at random (seeded by --seed) or keeps
only the RGB patches --visible_rgb names, and writes pred_<task>.png and
mask_<task>.png per task into --out_dir. The model computes in fp32, as
the JAX demo builds it: the encoder takes the module path (K4 is bf16
only) and each decoder one K1 forward launch. It runs on the card unless
--device names another; it raises where no card is visible.

The images are read as the JAX demo reads them through PIL (demo.py:61-76),
bit for bit, with the port's decoders (data/image_io.py) and the native
library's resizes of PIL's:
  * RGB: convert("RGB"), then a BICUBIC resize to s x s (`native.pil_resize`);
  * depth: Image.resize((s, s)), whose default is BICUBIC: for a 16-bit PNG
    (mode "I;16") Pillow's 16-bit resample with its rounding and clamping
    (`native.crop_resize_u16` over the whole image), for an 8-bit gray one
    ("L") `pil_resize`; then the truncated standardisation, by the
    reference's sort (the JAX demo calls its bisect default, which differs
    where values tie at the 10% and 90% cuts, as integer depth maps do);
  * semseg: convert("P"), then a NEAREST resize to s/4 x s/4
    (`native.pil_nearest`), for palette ("P") and 8-bit gray ("L") PNGs.
Any other mode raises ValueError naming it, where PIL would convert or
quantise. A checkpoint that is neither a `.pth` nor a `.msgpack` (an orbax
directory) raises ValueError, as the JAX demo, which open()s the file,
fails on one.
"""

from __future__ import annotations

import argparse
import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimae_tpu_torch import native
from multimae_tpu_torch.cli.factory import build_pretrain_model, entry_device
from multimae_tpu_torch.data.image_io import PNG_SIGNATURE, decode_png, load_image, write_png
from multimae_tpu_torch.ops.masking import make_mask
from multimae_tpu_torch.train.checkpoint import START_REFUSAL
from multimae_tpu_torch.train.pretrain_step import standardize_depth
from multimae_tpu_torch.utils.data_constants import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD
from multimae_tpu_torch.utils.torch_compat import load_flax_start, load_pretrained

MEAN = np.asarray(IMAGENET_DEFAULT_MEAN, np.float32)
STD = np.asarray(IMAGENET_DEFAULT_STD, np.float32)

# PNG (colour type, bit depth) -> the mode Pillow opens the file in.
_PIL_MODES = {(0, 1): "1", (0, 2): "L", (0, 4): "L", (0, 8): "L", (0, 16): "I;16",
              (2, 8): "RGB", (2, 16): "RGB", (3, 1): "P", (3, 2): "P", (3, 4): "P",
              (3, 8): "P", (4, 8): "LA", (4, 16): "LA", (6, 8): "RGBA", (6, 16): "RGBA"}


def get_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser("MultiMAE demo")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--rgb", required=True, help="RGB image path")
    p.add_argument("--depth", default=None, help="16-bit depth PNG (optional)")
    p.add_argument("--semseg", default=None, help="palette semseg PNG (optional)")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--num_encoded_tokens", type=int, default=98)
    p.add_argument("--alphas", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--visible_rgb", type=str, default=None,
                   help="space-separated x,y pairs of visible RGB patches, "
                        "e.g. '0,0 1,0 7,7' (switches to manual masking)")
    p.add_argument("--out_dir", default="demo_out")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def png_mode(path: str) -> Tuple[str, bytes]:
    """(the mode Pillow opens a PNG file in, its bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    depth, color_type = struct.unpack(">BB", data[24:26])
    return _PIL_MODES.get((color_type, depth), f"PNG colour type {color_type}"), data


def read_rgb(path: str, size: int) -> np.ndarray:
    """(size, size, 3) float32, normalised by the ImageNet mean and std."""
    rgb = native.pil_resize(load_image(path, convert_rgb=True), (size, size))
    return (np.asarray(rgb, np.float32) / 255.0 - MEAN) / STD


def read_depth(path: str, size: int) -> np.ndarray:
    """(size, size) float32 of the depth PNG resized as Image.resize does."""
    mode, data = png_mode(path)
    if mode == "I;16":
        img = decode_png(data, convert_rgb=False)
        out = native.crop_resize_u16(img, (0, 0) + img.shape, (size, size))
    elif mode == "L":
        out = native.pil_resize(decode_png(data, convert_rgb=False), (size, size))
    else:
        raise ValueError(f"{path}: a depth PNG of mode {mode!r}; the demo reads 'I;16' "
                         f"and 'L'")
    return np.asarray(out, np.float32)


def read_semseg(path: str, size: int) -> np.ndarray:
    """(size // 4, size // 4) int64 class ids: convert("P"), then NEAREST."""
    mode, data = png_mode(path)
    if mode not in ("P", "L"):
        raise ValueError(f"{path}: a semseg PNG of mode {mode!r}, which convert('P') would "
                         f"quantise; the demo reads 'P' and 'L'")
    ids = decode_png(data, convert_rgb=False)
    out = native.pil_nearest(ids, (0, 0) + ids.shape, (size // 4, size // 4))
    return out.astype(np.int64)


def load_inputs(args, device) -> Dict[str, torch.Tensor]:
    """The model's NHWC inputs (batch 1) on `device`, in rgb, depth, semseg order."""
    s = args.input_size
    inputs = {"rgb": torch.from_numpy(read_rgb(args.rgb, s)[None]).to(device)}
    if args.depth:
        depth = torch.from_numpy(read_depth(args.depth, s)[None, ..., None]).to(device)
        inputs["depth"] = standardize_depth(depth)
    if args.semseg:
        inputs["semseg"] = torch.from_numpy(read_semseg(args.semseg, s)[None]).to(device)
    return inputs


def load_checkpoint(model: torch.nn.Module, path: str) -> Dict[str, Any]:
    if path.endswith(".msgpack"):
        return load_flax_start(model, path, "strict")
    if not path.endswith(".pth"):
        raise ValueError(f"{path}: neither a .pth nor a JAX .msgpack file; {START_REFUSAL}")
    return load_pretrained(model, path)


def visible_masks(spec: str, n: int, domains: Sequence[str], device):
    """(task_masks, visible count) that keep only the RGB patches `spec` names."""
    coords = [tuple(map(int, c.split(","))) for c in spec.split()]
    masks = make_mask(n, n, {d: (coords if d == "rgb" else []) for d in domains})
    visible = int(sum(int((m == 0).sum()) for m in masks.values()))
    return {d: m.to(device) for d, m in masks.items()}, visible


def write_outputs(preds: Dict[str, torch.Tensor], masks: Dict[str, torch.Tensor],
                  out_dir: str, size: int) -> List[str]:
    """pred_<task>.png and mask_<task>.png, as the JAX demo writes them."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for task, pred in preds.items():
        arr = pred[0].float().cpu().numpy()
        if task == "rgb":
            arr = np.clip(arr * STD + MEAN, 0, 1)
            img = (arr * 255).astype(np.uint8)
        elif task == "depth":
            arr = arr[..., 0]
            arr = (arr - arr.min()) / max(arr.max() - arr.min(), 1e-6)
            img = (arr * 255).astype(np.uint8)
        else:
            img = arr.argmax(-1).astype(np.uint8)
        paths.append(os.path.join(out_dir, f"pred_{task}.png"))
        write_png(paths[-1], img)
        if task in masks:
            m = masks[task][0].cpu().numpy()
            n = int(np.sqrt(m.size))
            grid = (m.reshape(n, n) * 255).astype(np.uint8)
            paths.append(os.path.join(out_dir, f"mask_{task}.png"))
            write_png(paths[-1], native.pil_nearest(grid, (0, 0, n, n), (size, size)))
    return paths


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the demo; returns {"preds", "masks", "paths"} (preds and masks
    as the model gives them, on the device)."""
    args = get_args(argv)
    device = entry_device(args.device)
    inputs = load_inputs(args, device)
    domains = list(inputs)
    model = build_pretrain_model(in_domains=domains, out_domains=domains,
                                 extra_norm_pix_loss=False, input_size=args.input_size,
                                 device=device).eval()
    load_checkpoint(model, args.checkpoint)
    task_masks, visible = None, args.num_encoded_tokens
    if args.visible_rgb:
        task_masks, visible = visible_masks(args.visible_rgb, args.input_size // 16, domains,
                                            device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    with torch.inference_mode():
        preds, masks = model(inputs, mask_inputs=True, task_masks=task_masks,
                             num_encoded_tokens=visible, alphas=args.alphas,
                             generator=generator)
    paths = write_outputs(preds, masks, args.out_dir, args.input_size)
    print(f"Wrote predictions to {args.out_dir}/")
    return {"preds": preds, "masks": masks, "paths": paths}


if __name__ == "__main__":
    main()
