"""Where the serving forward's, the pretraining step's or the semantic
segmentation fine-tune step's device time goes, by kernel (the port's
counterpart of the JAX package's tools/profile_step.py).

    python -m multimae_tpu_torch.cli.profile_forward            # forward, batch 32
    python -m multimae_tpu_torch.cli.profile_forward --step     # train step, batch 128
    python -m multimae_tpu_torch.cli.profile_forward --semseg   # fine-tune step, batch 4
    python -m multimae_tpu_torch.cli.profile_forward --step --plain
    python -m multimae_tpu_torch.cli.profile_forward --k1 [--batch 128]

Runs the flagship model (MultiMAE ViT-B, 224 px, RGB + depth + semseg, 98
visible tokens, bf16 with the fp32 semseg decoder, seeded random weights):
the masked forward over 5 calls, or with --step the pretraining step
(cli/factory.build_pretrain_trainer) over 3 steps on one synthetic batch;
or with --semseg the NYUv2 RGB + depth fine-tune step (MultiViT-B at
512 px with the ConvNeXt head, cli/factory.build_semseg_trainer) over 3
steps on one synthetic batch; or with --k1 one K1 forward and one K1
backward launch (fused_decoder_core at the decoders' shape: 196 queries,
99 context tokens, D=256, 8 heads, depth 2; --batch samples, bf16 and
fp32); under torch.profiler, and prints per call: the host wall time, the summed
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

# Kernel-name substrings -> kind, first match wins. The tiles of
# csrc/decoder_tc.cuh come first: their GEMM's name contains "gemm", which
# would otherwise land with cuBLAS; K1, K3a, K3b and K4 run their GEMMs and
# LayerNorms there, and K4 its attention at short key sets. K2's four
# kernels are told apart (its forward also runs inside K4 at long key
# sets). common.cuh's kernels are fallbacks: K1's fp32 attention and
# LayerNorm rows the vectorised kernel does not take.
CATEGORIES = (
    ("K1 GEMMs, bf16 wgmma (csrc/decoder_tc.cuh; K3 and K4 run them too)", ("tc_gemm_kernel",)),
    ("K1 GEMMs, fp32 FMA (csrc/decoder_tc.cuh)", ("f32_gemm_kernel",)),
    ("K1 attention fwd, bf16 mma.sync (csrc/decoder_tc.cuh; K4 runs it too)",
     ("attn_fwd_kernel",)),
    ("K1 attention bwd rows pass, bf16 (csrc/decoder_tc.cuh)", ("attn_bwd_rows_kernel",)),
    ("K1 attention bwd keys pass, bf16 (csrc/decoder_tc.cuh)", ("attn_bwd_keys_kernel",)),
    ("K1 attention, fp32 FMA (csrc/decoder_tc.cuh)",
     ("fa_fwd_kernel", "fa_bwd_rows_kernel", "fa_bwd_keys_kernel")),
    ("K1 LayerNorm and slice sums (csrc/decoder_tc.cuh; K3 and K4 run them too)",
     ("ln_fwd_kernel", "ln_bwd_row_kernel", "ln_bwd_kernel", "ln_param_partial_kernel",
      "sum_slices2_kernel")),
    ("K1 attention bwd, warp per row (fused_decoder_bwd.cu before decoder_tc.cuh)",
     ("attention_bwd_kernel",)),
    ("K2 fwd (csrc/short_attention_fwd.cu)", ("short_attention_fwd_kernel",)),
    ("K2 bwd dK/dV pass (csrc/short_attention_bwd.cu)", ("dkdv_kernel",)),
    ("K2 bwd dQ pass (csrc/short_attention_bwd.cu)", ("dq_kernel",)),
    ("K2 bwd delta and lse prep (csrc/short_attention_bwd.cu)", ("prep_kernel",)),
    ("common.cuh kernels (fp32 attention and LayerNorm fallbacks)",
     ("mm::attention_kernel", "mm::layer_norm_kernel")),
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


def device_kernels(prof, iters: int) -> dict:
    """{kernel name: device ms per call} of a torch.profiler run over `iters` calls."""
    per_kernel = {}
    for e in prof.events():
        # user annotations (e.g. Optimizer.step) span kernels counted already
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            per_kernel[e.name] = (per_kernel.get(e.name, 0.0)
                                  + e.time_range.elapsed_us() / iters / 1e3)
    return per_kernel


def print_kernels(per_kernel: dict, wall_ms: float, what: str, top: int = TOP) -> None:
    """The wall and device time per call, the idle share, the time by kind
    (CATEGORIES) and the `top` largest kernels."""
    device_ms = sum(per_kernel.values())
    print(f"wall {wall_ms:.3f} ms/{what}, device kernels {device_ms:.3f} ms/{what}, "
          f"idle share {1 - device_ms / wall_ms:.3f}")
    kinds = {}
    for name, ms in per_kernel.items():
        kinds[category(name)] = kinds.get(category(name), 0.0) + ms
    for kind, ms in sorted(kinds.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms  {kind}")
    print("largest kernels:")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {ms:8.3f} ms  {name[:100]}")


def profile_calls(run, iters: int, what: str, top: int = TOP) -> dict:
    """Profile `iters` calls of run() after two warm-up calls; print the
    wall and device time per call, the idle share, the time by kind and
    the `top` largest kernels; return {kernel name: device ms per call}."""
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / iters * 1e3
    per_kernel = device_kernels(prof, iters)
    print_kernels(per_kernel, wall_ms, what, top)
    return per_kernel


def event_ms(run, iters: int = 10, repeats: int = 5) -> float:
    """Milliseconds per call of run(): CUDA events around `iters` calls
    issued back to back, median over `repeats` windows."""
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return sorted(times)[len(times) // 2]


def decoder_inputs(batch_size: int, dtype, dev, nq=196, nc=99, d=256, depth=2, seed=0):
    """Seeded random K1 inputs at the decoders' shape: (q, c, g, weights)."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale, offset=0.0):
        return (torch.randn(shape, generator=gen) * scale + offset).to(dev)

    hidden = 4 * d

    def stack(*shape, scale, offset=0.0):
        return rnd(depth, *shape, scale=scale, offset=offset)

    w = fused_decoder.DecoderCoreWeights(
        rnd(d, scale=0.1, offset=1.0), rnd(d, scale=0.1), rnd(d, scale=0.1, offset=1.0),
        rnd(d, scale=0.1), rnd(d, scale=0.1, offset=1.0), rnd(d, scale=0.1),
        rnd(d, d, scale=d ** -0.5), rnd(d, scale=0.02),
        rnd(2 * d, d, scale=d ** -0.5), rnd(2 * d, scale=0.02),
        rnd(d, d, scale=d ** -0.5), rnd(d, scale=0.02),
        rnd(hidden, d, scale=d ** -0.5), rnd(hidden, scale=0.02),
        rnd(d, hidden, scale=hidden ** -0.5), rnd(d, scale=0.02),
        stack(d, scale=0.1, offset=1.0), stack(d, scale=0.1),
        stack(3 * d, d, scale=d ** -0.5), stack(3 * d, scale=0.02),
        stack(d, d, scale=d ** -0.5), stack(d, scale=0.02),
        stack(d, scale=0.1, offset=1.0), stack(d, scale=0.1),
        stack(hidden, d, scale=d ** -0.5), stack(hidden, scale=0.02),
        stack(d, hidden, scale=hidden ** -0.5), stack(d, scale=0.02))
    q = torch.randn((batch_size, nq, d), generator=gen).to(dev, dtype)
    c = torch.randn((batch_size, nc, d), generator=gen).to(dev, dtype)
    g = torch.randn((batch_size, nq, d), generator=gen).to(dev, dtype)
    return q, c, g, w


def profile_k1(batch_size: int, dev) -> None:
    """One K1 forward and one K1 backward launch per call, bf16 and fp32,
    every kernel listed."""
    heads, depth = 8, 2
    for dtype in (torch.bfloat16, torch.float32):
        q, c, g, w = decoder_inputs(batch_size, dtype, dev)

        @torch.inference_mode()
        def fwd():
            fused_decoder.fused_decoder_core(q, c, w, heads, depth)

        def bwd():
            fused_decoder.fused_decoder_core_bwd(q, c, w, g, heads, depth)

        for name, run in (("K1 fwd", fwd), ("K1 bwd", bwd)):
            print(f"{name} {dtype} at ({batch_size}, 196, 99, 256), 8 heads, depth 2: "
                  f"{event_ms(run):.4f} ms per launch (CUDA events, no profiler)")
            profile_calls(run, 3, "launch", top=64)
        del q, c, g, w
        torch.cuda.empty_cache()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--step", action="store_true", help="profile the training step")
    parser.add_argument("--semseg", action="store_true",
                        help="profile the semantic segmentation fine-tune step")
    parser.add_argument("--k1", action="store_true",
                        help="profile one K1 forward and backward launch, bf16 and fp32")
    parser.add_argument("--batch", type=int, default=128, help="samples for --k1")
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
    if args.k1:
        print(f"{torch.cuda.get_device_name(0)}; K1 launches at batch {args.batch}, "
              f"{'plain twins' if args.plain else 'kernels'}")
        profile_k1(args.batch, dev)
        return
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
    profile_calls(run, iters, what)


if __name__ == "__main__":
    main()
