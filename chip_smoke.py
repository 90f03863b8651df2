#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving forward once on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits
non-zero:
  1. environment: torch and CUDA versions, the card's name and power limit;
  2. kernel build: nvcc builds multimae_tpu_torch/csrc/*.cu (first use);
  3. K4 fused_block_infer against its plain twin at the encoder's shape
     (B=32, N=99, D=768, 12 heads, hidden 3072, bf16): errors and times;
  4. K1 fused_decoder_fwd against its plain twin at the decoders' shape
     (B=32, 196 queries, 99 context, D=256, 8 heads, depth 2), bf16 and fp32;
  5. the slice: MultiMAE ViT-B (224 px, RGB + depth + semseg, 98 visible
     tokens, four decoders, fp32 semseg decoder) with seeded random
     weights answers three requests of 32 samples; every pred and loss is
     finite, each forward launches K4 12 times and K1 4 times, and the
     preds match the same model run on the plain twins.
Then it prints the card line, a JSON line of the kernels and, last,
{"ok": true, "device": {...}}. A time is per call, from CUDA events
around back-to-back calls (median of 5 windows; kernel and plain twin
timed in turns).

Without a CUDA card, or without the multimae_tpu_torch package beside
it, the script exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Slice preds vs the same model on the plain twins, as relative RMS per
# pred: the kernels' bf16 rounding flips (ops/functional.TWIN_TOLERANCE)
# propagate through 12 encoder blocks and a decoder.
SLICE_TOLERANCE = 3e-2
BATCH = 32
REQUESTS = 3


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3, repeats=5):
    """Milliseconds per call of fn(): CUDA events around `iters` calls
    issued back to back, median over `repeats` such windows."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def ab_ms(torch, kernel_fn, plain_fn, **kw):
    """(kernel ms, plain ms), timed in the order kernel, plain, plain,
    kernel and averaged, so drift in the card's clocks hits both."""
    k1, p1 = cuda_ms(torch, kernel_fn, **kw), cuda_ms(torch, plain_fn, **kw)
    p2, k2 = cuda_ms(torch, plain_fn, **kw), cuda_ms(torch, kernel_fn, **kw)
    return (k1 + k2) / 2, (p1 + p2) / 2


def rand_block_weights(torch, fused_block, d, hidden, gen, device):
    def rnd(*shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    one = torch.ones(d, device=device)
    return fused_block.BlockWeights(
        one + rnd(d, scale=0.1), rnd(d, scale=0.1),
        rnd(3 * d, d, scale=d ** -0.5), rnd(3 * d, scale=0.02),
        rnd(d, d, scale=d ** -0.5), rnd(d, scale=0.02),
        one + rnd(d, scale=0.1), rnd(d, scale=0.1),
        rnd(hidden, d, scale=d ** -0.5), rnd(hidden, scale=0.02),
        rnd(d, hidden, scale=hidden ** -0.5), rnd(d, scale=0.02))


def main():
    if not os.path.isdir(os.path.join(HERE, "multimae_tpu_torch")):
        raise SystemExit("chip_smoke.py: the multimae_tpu_torch package is not "
                         "beside this script")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA card visible to torch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from multimae_tpu_torch.cli.factory import (
        build_pretrain_losses, build_pretrain_model, make_synthetic_batch)
    from multimae_tpu_torch.ops import _build, fused_block, fused_decoder
    from multimae_tpu_torch.ops.functional import assert_matches_twin

    # 1. environment
    card = card_line()
    log(1, f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
           f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    log(1, f"card: {card}")

    # 2. kernel build
    t0 = time.perf_counter()
    _build.load()
    build_log = _build.BUILD_LOG.read_text().splitlines()
    log(2, f"kernels ready in {time.perf_counter() - t0:.1f} s "
           f"({'built now' if _build.BUILD_SECONDS is not None else 'cached build'}; "
           f"{build_log[-1]})")
    for line in build_log:
        if "registers" in line or ("spill" in line and " 0 bytes spill" not in line):
            log(2, "ptxas: " + line.strip())

    gen = torch.Generator().manual_seed(0)
    kernels = []

    # 3. K4 against its twin
    b, n, d, heads, hidden = BATCH, 99, 768, 12, 3072
    w4 = rand_block_weights(torch, fused_block, d, hidden, gen, dev)
    x = torch.randn((b, n, d), generator=gen).to(dev, torch.bfloat16)
    with torch.inference_mode():
        out = fused_block.fused_block_infer(x, w4, heads)
        torch.cuda.synchronize()
        ref = fused_block.block_infer_ref(x, w4, heads)
        err, rel = assert_matches_twin(out, ref, "K4 fused_block_infer")
        ms, plain_ms = ab_ms(torch, lambda: fused_block.fused_block_infer(x, w4, heads),
                             lambda: fused_block.block_infer_ref(x, w4, heads))
    log(3, f"K4 bf16 ({b},{n},{d}) max abs {err:.3e}, rel RMS {rel:.3e}; "
           f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    kernels.append({
        "name": "fused_block_infer", "route": "cuda",
        "source": "multimae_tpu_torch/csrc/fused_block_infer.cu",
        "replaces": "multimae_tpu/ops/fused_block_pallas.py:253",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    # 4. K1 forward against its twin, bf16 and fp32
    nq, nc, dd, hh, depth = 196, 99, 256, 8, 2
    blocks = [rand_block_weights(torch, fused_block, dd, 4 * dd, gen, dev)
              for _ in range(depth + 1)]
    xattn = blocks[0]
    w1 = fused_decoder.DecoderCoreWeights(
        xattn.n1_g, xattn.n1_b, xattn.n2_g, xattn.n2_b, xattn.n1_g.flip(0), xattn.n1_b.flip(0),
        xattn.wp, xattn.bp, xattn.wqkv[: 2 * dd], xattn.bqkv[: 2 * dd],
        xattn.wqkv[2 * dd:], xattn.bqkv[2 * dd:], xattn.w1, xattn.b1, xattn.w2, xattn.b2,
        *[torch.stack([bw[i] for bw in blocks[1:]]) for i in range(12)])
    k1 = {"name": "fused_decoder_fwd", "route": "cuda",
          "source": "multimae_tpu_torch/csrc/fused_decoder_fwd.cu",
          "replaces": "multimae_tpu/ops/fused_decoder_pallas.py:737"}
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "fp32_")):
        q = torch.randn((b, nq, dd), generator=gen).to(dev, dtype)
        c = torch.randn((b, nc, dd), generator=gen).to(dev, dtype)
        with torch.inference_mode():
            out = fused_decoder.fused_decoder_core(q, c, w1, hh, depth)
            torch.cuda.synchronize()
            ref = fused_decoder.decoder_core_ref(q, c, w1, hh, depth)
            err, rel = assert_matches_twin(out, ref, f"K1 fused_decoder_fwd {dtype}")
            ms, plain_ms = ab_ms(
                torch, lambda: fused_decoder.fused_decoder_core(q, c, w1, hh, depth),
                lambda: fused_decoder.decoder_core_ref(q, c, w1, hh, depth))
        log(4, f"K1 {dtype} ({b},{nq},{nc},{dd}) max abs {err:.3e}, rel RMS {rel:.3e}; "
               f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        k1.update({f"{tag}max_abs_err": err, f"{tag}ms": ms, f"{tag}plain_ms": plain_ms})
    kernels.append(k1)

    # 5. the slice
    t0 = time.perf_counter()
    model = build_pretrain_model(dtype=torch.bfloat16, fp32_output_adapters=("semseg",),
                                 seed=0, device=dev).eval()
    losses = build_pretrain_losses(("rgb", "depth", "semseg"))
    batches = [make_synthetic_batch(BATCH, seed=i, device=dev) for i in range(REQUESTS)]
    mask_gen = torch.Generator(device=dev).manual_seed(1)
    log(5, f"MultiMAE ViT-B bf16 (fp32 semseg decoder) built in "
           f"{time.perf_counter() - t0:.1f} s")

    results = []
    fused_block.LAUNCHES = 0
    fused_decoder.LAUNCHES = 0
    with torch.inference_mode():
        for batch in batches:
            k4_before, k1_before = fused_block.LAUNCHES, fused_decoder.LAUNCHES
            preds, masks = model(batch, num_encoded_tokens=98, alphas=1.0,
                                 generator=mask_gen)
            task_losses = {
                t: float(losses[t](preds[t].float(), batch["rgb" if t == "norm_rgb" else t],
                                   mask=masks["rgb" if t == "norm_rgb" else t]))
                for t in preds}
            if (fused_block.LAUNCHES - k4_before, fused_decoder.LAUNCHES - k1_before) != (12, 4):
                raise AssertionError(
                    f"launches per forward: K4 {fused_block.LAUNCHES - k4_before}, "
                    f"K1 {fused_decoder.LAUNCHES - k1_before}; expected 12 and 4")
            results.append((preds, masks, task_losses))
    launches = {"fused_block_infer": fused_block.LAUNCHES,
                "fused_decoder_fwd": fused_decoder.LAUNCHES}
    for k in kernels:
        k["launches"] = launches[k["name"]]
    if launches != {"fused_block_infer": 12 * REQUESTS, "fused_decoder_fwd": 4 * REQUESTS}:
        raise AssertionError(f"launch counts {launches}")

    shapes = {"rgb": (BATCH, 224, 224, 3), "depth": (BATCH, 224, 224, 1),
              "semseg": (BATCH, 56, 56, 133), "norm_rgb": (BATCH, 224, 224, 3)}
    for i, (preds, masks, task_losses) in enumerate(results):
        for t, p in preds.items():
            if tuple(p.shape) != shapes[t] or not bool(torch.isfinite(p).all()):
                raise AssertionError(f"request {i}: pred {t} {tuple(p.shape)} not finite "
                                     f"or not {shapes[t]}")
        if not all(v == v and abs(v) < float("inf") for v in task_losses.values()):
            raise AssertionError(f"request {i}: losses {task_losses}")
        visible = sum(int((m == 0).sum()) for m in masks.values())
        if visible != 98 * BATCH:
            raise AssertionError(f"request {i}: {visible} visible tokens")
        log(5, f"request {i}: losses " + ", ".join(f"{t} {v:.4f}" for t, v in task_losses.items()))

    # The same model on the plain twins, with request 0's masks.
    batch, masks = batches[0], results[0][1]

    def forward():
        return model(batch, num_encoded_tokens=98, task_masks=masks)

    def plain_forward():
        fused_block.set_force_mode("plain")
        fused_decoder.set_force_mode("plain")
        try:
            return forward()
        finally:
            fused_block.set_force_mode(None)
            fused_decoder.set_force_mode(None)

    with torch.inference_mode():
        kern, _ = forward()
        plain, _ = plain_forward()
        fwd_ms, plain_fwd_ms = ab_ms(torch, forward, plain_forward, iters=10)
    for t in kern:
        a, r = kern[t].double(), plain[t].double()
        rel = float(torch.sqrt(((a - r) ** 2).mean() / (r ** 2).mean()))
        log(5, f"pred {t} vs plain twins: rel RMS {rel:.3e} (limit {SLICE_TOLERANCE})")
        if not rel <= SLICE_TOLERANCE:
            raise AssertionError(f"pred {t} differs from the plain-twin model: {rel}")
    log(5, f"forward at batch {BATCH}: {fwd_ms:.3f} ms ({BATCH / fwd_ms * 1e3:.1f} samples/s) "
           f"with the kernels, {plain_fwd_ms:.3f} ms on the plain twins")

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
