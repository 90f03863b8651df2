"""Where the serving forward's device time goes, by kernel.

    python -m multimae_tpu_torch.cli.profile_forward

Runs the flagship masked forward (MultiMAE ViT-B, 224 px, RGB + depth +
semseg, 98 visible tokens, bf16 with the fp32 semseg decoder, seeded
random weights, batch 32) under torch.profiler over 5 forwards and
prints per forward: the host wall time, the summed device kernel time,
the idle share (1 - kernel / wall) and the largest kernels. The
profiler's own host overhead inflates the wall time; chip_smoke.py gives
the forward time without it. Needs a CUDA card.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from multimae_tpu_torch.cli.factory import build_pretrain_model, make_synthetic_batch


BATCH, ITERS, TOP = 32, 5, 14


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    model = build_pretrain_model(dtype=torch.bfloat16, fp32_output_adapters=("semseg",),
                                 device=dev).eval()
    batch = make_synthetic_batch(BATCH, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    print(torch.cuda.get_device_name(0))
    with torch.inference_mode():
        for _ in range(3):
            model(batch, num_encoded_tokens=98, generator=gen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ITERS):
                model(batch, num_encoded_tokens=98, generator=gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / ITERS * 1e3
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / ITERS / 1e3)
    device_ms = sum(per_kernel.values())
    print(f"wall {wall_ms:.3f} ms/forward, device kernels {device_ms:.3f} ms/forward, "
          f"idle share {1 - device_ms / wall_ms:.3f}")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms:8.3f} ms  {name[:100]}")


if __name__ == "__main__":
    main()
