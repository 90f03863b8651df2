"""Where the serving forward's, the pretraining step's or the semantic
segmentation fine-tune step's device time goes, by kernel (the port's
counterpart of the JAX package's tools/profile_step.py).

    python -m multimae_tpu_torch.cli.profile_forward            # forward, batch 32
    python -m multimae_tpu_torch.cli.profile_forward --step     # train step, batch 128
    python -m multimae_tpu_torch.cli.profile_forward --semseg   # fine-tune step, batch 4
    python -m multimae_tpu_torch.cli.profile_forward --step --plain

Runs the flagship model (MultiMAE ViT-B, 224 px, RGB + depth + semseg, 98
visible tokens, bf16 with the fp32 semseg decoder, seeded random weights):
the masked forward over 5 calls, or with --step the pretraining step
(cli/factory.build_pretrain_trainer) over 3 steps on one synthetic batch;
or with --semseg the NYUv2 RGB + depth fine-tune step (MultiViT-B at
512 px with the ConvNeXt head, cli/factory.build_semseg_trainer) over 3
steps on one synthetic batch; under torch.profiler, and prints per call: the host wall time, the summed
device kernel time, the idle share (1 - kernel / wall), the time by kind
of kernel (CATEGORIES) and the largest kernels. --plain runs the kernels' plain twins instead. The profiler's
own host overhead inflates the wall time; chip_smoke.py gives the times
without it. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from multimae_tpu_torch.cli.factory import (
    build_pretrain_model,
    build_pretrain_trainer,
    build_semseg_trainer,
    make_synthetic_batch,
    make_synthetic_semseg_batch,
)
from multimae_tpu_torch.ops import fused_block, fused_decoder, fused_mlp, short_attention

TOP = 24

# Kernel-name substrings -> kind, first match wins. The common.cuh kernels
# serve K4, K1 fwd, K3b fwd and the backwards' recompute and dX GEMMs
# alike; the backward.cuh pieces serve K1 bwd and K3b bwd.
CATEGORIES = (
    ("K2 fwd + bwd (csrc/short_attention_*.cu)",
     ("short_attention_fwd_kernel", "dkdv_kernel", "dq_kernel")),
    ("K1 bwd attention (csrc/fused_decoder_bwd.cu)", ("attention_bwd_kernel",)),
    ("backward.cuh pieces (K1 bwd, K3b bwd: dW, db, LN backward)",
     ("tn_bf16_kernel", "tn_f32_kernel", "ln_bwd_kernel", "ln_grad_partial_kernel",
      "colsum_partial_kernel", "sum_slices_kernel", "transpose_kernel", "gelu_kernel")),
    ("common.cuh chains (K4, K1 fwd, K3b fwd, the backwards' GEMMs)",
     ("mm::gemm_", "mm::attention_kernel", "mm::layer_norm_kernel")),
    ("convolutions (cuDNN / torch: patch embedding, ConvNeXt depthwise, 1x1)",
     ("conv_depthwise", "convolve", "cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm")),
    ("cuBLAS/CUTLASS GEMMs (encoder, adapters, plain twins)",
     ("nvjet", "gemm", "cutlass", "xmma")),
    ("AdamW (foreach)", ("multi_tensor_apply",)),
    ("softmax, LayerNorm, reductions (torch)", ("softmax", "layer_norm", "reduce_kernel")),
)


def category(name: str) -> str:
    for kind, keys in CATEGORIES:
        if any(k in name for k in keys):
            return kind
    return "elementwise, copies, casts, other (torch)"


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--step", action="store_true", help="profile the training step")
    parser.add_argument("--semseg", action="store_true",
                        help="profile the semantic segmentation fine-tune step")
    parser.add_argument("--plain", action="store_true", help="run the plain twins")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.plain:
        for m in (fused_block, fused_decoder, fused_mlp, short_attention):
            m.set_force_mode("plain")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    if args.semseg:
        batch_size, iters = 4, 3
        state, step = build_semseg_trainer(batch_size=batch_size, device=dev)
        batch = make_synthetic_semseg_batch(batch_size, seed=0, device=dev)

        def run():
            step(state, batch, generator=gen)
    elif args.step:
        batch_size, iters = 128, 3
        state, step = build_pretrain_trainer(batch_size=batch_size, device=dev)
        batch = make_synthetic_batch(batch_size, seed=0, device=dev)

        def run():
            step(state, batch, generator=gen)
    else:
        batch_size, iters = 32, 5
        model = build_pretrain_model(dtype=torch.bfloat16, fp32_output_adapters=("semseg",),
                                     device=dev).eval()
        batch = make_synthetic_batch(batch_size, seed=0, device=dev)

        @torch.inference_mode()
        def run():
            model(batch, num_encoded_tokens=98, generator=gen)

    what = "step" if args.step or args.semseg else "forward"
    print(f"{torch.cuda.get_device_name(0)}; {what} at batch {batch_size}, "
          f"{'plain twins' if args.plain else 'kernels'}")
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    per_kernel = {}
    for e in prof.events():
        # user annotations (e.g. Optimizer.step) span kernels counted already
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / iters / 1e3)
    device_ms = sum(per_kernel.values())
    print(f"wall {wall_ms:.3f} ms/{what}, device kernels {device_ms:.3f} ms/{what}, "
          f"idle share {1 - device_ms / wall_ms:.3f}")
    kinds = {}
    for name, ms in per_kernel.items():
        kinds[category(name)] = kinds.get(category(name), 0.0) + ms
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms  {kind}")
    print("largest kernels:")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:TOP]:
        print(f"  {ms:8.3f} ms  {name[:100]}")


if __name__ == "__main__":
    main()
