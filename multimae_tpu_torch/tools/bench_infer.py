"""Inference (serving) throughput on the card (counterpart of the JAX
package's tools/bench_infer.py).

    python -m multimae_tpu_torch.tools.bench_infer [--batch_cls 256] [--batch_seg 32] [--large]

Times back-to-back bf16 eval forwards of the two serving shapes, each
forward's output folded into the next one's input (x + 0 * f(out), as the
JAX tool's scan carries it) so that none can be skipped, ending in a host
read; a first run of the same length warms up. Weights are random, drawn
from a seeded CPU generator.
  * cls@224: MultiViT with the rgb input and the ImageNet head
    (LinearOutputAdapter, 1000 classes, mean pooling): 197 tokens, the
    encoder blocks on K4.
  * semseg@512: MultiViT with rgb + depth and the ConvNeXt head (150
    classes): 2049 tokens, K4 with its attention on the K2 forward, the
    head's ConvNeXt blocks on K3b at 16 sub-pixels of 384 channels per
    rgb token.
--large adds ViT-L (multivit_large: 24 blocks, dim 1024, 16 heads) at
the cls batch and half the semseg batch. Prints one JSON line per shape,
{"metric": ..., "value": images per second, "unit": "images/sec/chip"}.
Runs on the card unless --device names another.
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

from multimae_tpu_torch.cli.factory import entry_device
from multimae_tpu_torch.models import ConvNeXtAdapter, LinearOutputAdapter, PatchedInputAdapter
from multimae_tpu_torch.models.registry import create_model


def build_cls(arch: str = "multivit_base"):
    """The cls@224 serving model, weights unset (bf16)."""
    return create_model(
        arch,
        input_adapters={"rgb": functools.partial(
            PatchedInputAdapter, num_channels=3, stride_level=1, patch_size_full=16,
            image_size=224)},
        output_adapters={"cls": functools.partial(
            LinearOutputAdapter, num_classes=1000, use_mean_pooling=True)},
        dtype=torch.bfloat16)


def build_semseg(arch: str = "multivit_base"):
    """The semseg@512 serving model (rgb + depth, ConvNeXt head), weights unset (bf16)."""
    return create_model(
        arch,
        input_adapters={t: functools.partial(
            PatchedInputAdapter, num_channels=c, stride_level=1, patch_size_full=16,
            image_size=512) for t, c in (("rgb", 3), ("depth", 1))},
        output_adapters={"semseg": functools.partial(
            ConvNeXtAdapter, num_classes=150, preds_per_patch=16, depth=4, embed_dim=6144,
            patch_size=16, main_tasks=("rgb",))},
        dtype=torch.bfloat16)


def _ready(model, device, seed: int):
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def _normal(seed: int, shape, device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(device)


def chained_rate(forward, fold, x0: torch.Tensor, batch: int, steps: int) -> float:
    """Images per second over `steps` forwards, each on the last one's input
    plus 0 * fold(output), ending in a host read; one run of as many
    forwards warms up first."""
    def run():
        c, out = x0, None
        with torch.inference_mode():
            for _ in range(steps):
                out = forward(c)
                c = c + 0.0 * fold(out)
            return float(out.float().mean())

    run()
    if x0.is_cuda:
        torch.cuda.synchronize(x0.device)
    t0 = time.perf_counter()
    run()
    return batch * steps / (time.perf_counter() - t0)


def bench_cls(batch: int, steps: int = 20, arch: str = "multivit_base", device="cuda") -> float:
    device = entry_device(device)
    model = _ready(build_cls(arch), device, 1)
    x = _normal(0, (batch, 224, 224, 3), device)
    return chained_rate(lambda c: model({"rgb": c})["cls"],
                        lambda logits: logits.float().sum() / (batch * 1000), x, batch, steps)


def bench_semseg(batch: int, steps: int = 10, arch: str = "multivit_base",
                 device="cuda") -> float:
    device = entry_device(device)
    model = _ready(build_semseg(arch), device, 2)
    rgb = _normal(0, (batch, 512, 512, 3), device)
    depth = _normal(1, (batch, 512, 512, 1), device)
    return chained_rate(lambda c: model({"rgb": c, "depth": depth})["semseg"],
                        lambda pred: pred.float().mean(), rgb, batch, steps)


def metric_line(metric: str, value: float) -> str:
    return json.dumps({"metric": metric, "value": round(value, 1), "unit": "images/sec/chip"})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch_cls", type=int, default=256)
    ap.add_argument("--batch_seg", type=int, default=32)
    ap.add_argument("--large", action="store_true",
                    help="also measure ViT-L (cls@224 and semseg@512 at half the batch)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print(metric_line("infer_cls224_vitb", bench_cls(args.batch_cls, device=args.device)))
    print(metric_line("infer_semseg512_rgbd", bench_semseg(args.batch_seg, device=args.device)))
    if args.large:
        print(metric_line("infer_cls224_vitl", bench_cls(args.batch_cls, arch="multivit_large",
                                                         device=args.device)))
        print(metric_line("infer_semseg512_rgbd_vitl", bench_semseg(
            max(args.batch_seg // 2, 1), arch="multivit_large", device=args.device)))


if __name__ == "__main__":
    main()
