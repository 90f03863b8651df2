#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving forward and pretraining step on
one NVIDIA card.

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
     preds match the same model run on the plain twins;
  6. K1 fused_decoder_bwd against its plain twin at (B, 196, 99, 256,
     8 heads, depth 2) for B=32 and the training slice's B=128, bf16 and
     fp32: dq, dc and all 28 fp32 weight gradients, times, and two runs
     bit-equal;
  7. the training slice: MultiMAE ViT-B pretraining (bf16, fp32 semseg
     decoder, return_patches, uncertainty balancer, AdamW (0.9, 0.95) with
     wd 0.05, cosine LR from 1e-4 * 128 / 256 without warmup,
     standardize_depth) takes STEPS steps at batch 128 on one synthetic
     batch with masks drawn once from a seeded generator on the card;
     every step launches K1 fwd 4 and K1 bwd 4 times and K4 never, its
     losses and grad norm are finite, the loss falls, and the first step
     matches the same step on the plain twins (losses, grad norm, and
     every decoder parameter's gradient); ms per step, samples/s and peak
     memory for both paths.
Then it prints the card line, a JSON line of the kernels and, last,
{"ok": true, "device": {...}}. A time is per call, from CUDA events
around back-to-back calls (median of windows; kernel and plain twin
timed in turns).

Without a CUDA card, or without the multimae_tpu_torch package beside
it, the script exits non-zero and prints no result.
"""

import contextlib
import copy
import json
import math
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

# The training slice. Its first step against the same step on the plain
# twins, from the same state and masks: the encoder runs the same module
# path on both sides, so the differences are the decoders' rounding flips,
# which average out over the batch. Limits: relative STEP_TOLERANCE for
# every loss and the grad norm; relative RMS STEP_GRAD_TOLERANCE[dtype]
# for the gradient of each parameter of a decoder computing in dtype.
# Each is three to four times the largest reading on an H100 (the run is
# deterministic): 7.3e-6 (the rgb loss), and 1.4e-3 for a parameter of a
# bf16 decoder, 3.7e-7 for one of the fp32 semseg decoder.
TRAIN_BATCH = 128
STEPS = 6
TASKS = ("rgb", "depth", "semseg", "norm_rgb")
STEP_TOLERANCE = 2e-5
STEP_GRAD_TOLERANCE = {"torch.bfloat16": 5e-3, "torch.float32": 1.5e-6}


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


@contextlib.contextmanager
def plain_twins():
    """Every kernel wrapper takes its plain twin, on the card."""
    from multimae_tpu_torch.ops import fused_block, fused_decoder

    fused_block.set_force_mode("plain")
    fused_decoder.set_force_mode("plain")
    try:
        yield
    finally:
        fused_block.set_force_mode(None)
        fused_decoder.set_force_mode(None)


def check_on_card(state, batch, masks):
    """Raise unless the model, the balancer, the batch, the masks and the
    optimizer's state all lie on the card."""
    import torch

    off = [n for n, p in list(state.model.named_parameters())
           + list(state.balancer.named_parameters()) if not p.is_cuda]
    off += [t for t, v in list(batch.items()) + list(masks.items()) if not v.is_cuda]
    off += [f"optimizer {k}" for st in state.optimizer.state.values()
            for k, v in st.items() if torch.is_tensor(v) and v.dim() > 0 and not v.is_cuda]
    if off:
        raise AssertionError(f"the training step would not run on the card: {off[:5]}")


def rel_rms(a, b):
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt().clamp_min(1e-30))


def train_slice(torch, dev):
    """Phase 7; returns each kernel's launches over the STEPS steps."""
    from multimae_tpu_torch.cli.factory import (
        build_pretrain_losses, build_pretrain_trainer, make_synthetic_batch)
    from multimae_tpu_torch.ops import fused_block, fused_decoder, masking
    from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step

    t0 = time.perf_counter()
    state, step = build_pretrain_trainer(batch_size=TRAIN_BATCH, seed=0, device=dev)
    batch = make_synthetic_batch(TRAIN_BATCH, seed=0, device=dev)
    mask_gen = torch.Generator(device=dev).manual_seed(1)
    mask_list, _, _ = masking.generate_random_masks(mask_gen, TRAIN_BATCH, [196] * 3, 98)
    masks = dict(zip(("rgb", "depth", "semseg"), mask_list))
    plain_state = copy.deepcopy(state)
    plain_step = make_pretrain_train_step(plain_state.model, plain_state.balancer,
                                          build_pretrain_losses(("rgb", "depth", "semseg")))
    model = state.model

    def decoder_grads(m):
        """{decoder: {parameter: fp32 copy of its gradient}}."""
        return {t: {n: p.grad.float().clone() for n, p in a.named_parameters()
                    if p.grad is not None}
                for t, a in m.output_adapters.items()}

    check_on_card(state, batch, masks)
    n_params = sum(p.numel() for p in model.parameters())
    log(7, f"MultiMAE ViT-B pretraining state ({n_params} parameters, bf16, fp32 semseg "
           f"decoder, uncertainty balancer, AdamW) built in {time.perf_counter() - t0:.1f} s; "
           f"batch {TRAIN_BATCH}, lr {state.lr_values[0]:.3e}")

    fused_block.LAUNCHES = fused_decoder.LAUNCHES = fused_decoder.LAUNCHES_BWD = 0
    torch.cuda.reset_peak_memory_stats(dev)
    history = []
    for i in range(STEPS):
        before = (fused_block.LAUNCHES, fused_decoder.LAUNCHES, fused_decoder.LAUNCHES_BWD)
        metrics = {k: float(v) for k, v in step(state, batch, task_masks=masks).items()}
        per_step = (fused_block.LAUNCHES - before[0], fused_decoder.LAUNCHES - before[1],
                    fused_decoder.LAUNCHES_BWD - before[2])
        if per_step != (0, 4, 4):
            raise AssertionError(f"step {i} launched K4, K1 fwd, K1 bwd {per_step}; "
                                 f"expected (0, 4, 4)")
        if not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"]:
            raise AssertionError(f"step {i}: metrics {metrics}")
        if i == 0:
            check_on_card(state, batch, masks)
            first_grads = decoder_grads(model)
        history.append(metrics)
        log(7, f"step {i}: loss {metrics['loss']:.4f}, grad norm {metrics['grad_norm']:.4f}; "
               + ", ".join(f"{t} {metrics[t + '_loss']:.4f}" for t in TASKS))
    torch.cuda.synchronize()
    launches = {"fused_block_infer": fused_block.LAUNCHES,
                "fused_decoder_fwd": fused_decoder.LAUNCHES,
                "fused_decoder_bwd": fused_decoder.LAUNCHES_BWD}
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != {"fused_block_infer": 0, "fused_decoder_fwd": 4 * STEPS,
                    "fused_decoder_bwd": 4 * STEPS}:
        raise AssertionError(f"launch counts over {STEPS} steps: {launches}")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"the loss did not fall: {history[0]['loss']} -> "
                             f"{history[-1]['loss']}")

    # The first step again, on the plain twins, from the same state and masks.
    torch.cuda.reset_peak_memory_stats(dev)
    with plain_twins():
        plain = {k: float(v) for k, v in plain_step(plain_state, batch, task_masks=masks).items()}
    plain_peak = torch.cuda.max_memory_allocated(dev)
    rels = {k: abs(history[0][k] - plain[k]) / abs(plain[k])
            for k in ["loss", "grad_norm"] + [f"{t}_loss" for t in TASKS]
            + [f"{t}_loss_weighted" for t in TASKS]}
    log(7, "step 0 vs plain twins, rel: " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
    for k, rel in rels.items():
        if not rel <= STEP_TOLERANCE:
            raise AssertionError(f"step 0 {k}: {history[0][k]} vs {plain[k]} on the plain "
                                 f"twins (rel {rel:.3e}, limit {STEP_TOLERANCE})")
    log(7, f"step 0 vs plain twins: loss {history[0]['loss']:.6f} / {plain['loss']:.6f}, "
           f"grad norm {history[0]['grad_norm']:.6f} / {plain['grad_norm']:.6f} "
           f"(limit rel {STEP_TOLERANCE})")
    for t, grads in decoder_grads(plain_state.model).items():
        limit = STEP_GRAD_TOLERANCE[str(model.output_adapters[t].dtype)]
        if set(grads) != set(first_grads[t]):
            raise AssertionError(f"decoder {t}: gradients of {sorted(first_grads[t])} "
                                 f"vs {sorted(grads)} on the plain twins")
        rels = {n: rel_rms(first_grads[t][n], g) for n, g in grads.items()}
        worst = max(rels, key=rels.get)
        log(7, f"step 0 decoder {t}: {len(rels)} parameter gradients vs plain twins, worst "
               f"rel RMS {rels[worst]:.3e} ({worst}; limit {limit})")
        bad = {n: r for n, r in rels.items() if not r <= limit}
        if bad:
            raise AssertionError(f"decoder {t} gradients differ from the plain twins: {bad}")

    def plain_train_step():
        with plain_twins():
            plain_step(plain_state, batch, task_masks=masks)

    ms, plain_ms = ab_ms(torch, lambda: step(state, batch, task_masks=masks),
                         plain_train_step, iters=3, warmup=1, repeats=3)
    log(7, f"step at batch {TRAIN_BATCH}: {ms:.3f} ms ({TRAIN_BATCH / ms * 1e3:.1f} samples/s) "
           f"with the kernels, {plain_ms:.3f} ms ({TRAIN_BATCH / plain_ms * 1e3:.1f} "
           f"samples/s) on the plain twins; peak memory {peak / 2**30:.2f} GiB with the "
           f"kernels, {plain_peak / 2**30:.2f} GiB on the plain twins")
    return launches


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
        with plain_twins():
            return forward()

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

    # 6. K1 backward against its twin, bf16 and fp32, at the batch of
    # phase 4 and at the training slice's, which phase 7 launches it at
    k1b = {"name": "fused_decoder_bwd", "route": "cuda",
           "source": "multimae_tpu_torch/csrc/fused_decoder_bwd.cu",
           "replaces": "multimae_tpu/ops/fused_decoder_pallas.py:763"}
    names = ["dq", "dc"] + ["d" + f for f in fused_decoder.DecoderCoreWeights._fields]
    for bb, btag in ((b, ""), (TRAIN_BATCH, f"b{TRAIN_BATCH}_")):
        for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "fp32_")):
            q = torch.randn((bb, nq, dd), generator=gen).to(dev, dtype)
            c = torch.randn((bb, nc, dd), generator=gen).to(dev, dtype)
            g = torch.randn((bb, nq, dd), generator=gen).to(dev, dtype)

            def bwd(q=q, c=c, g=g):
                dq, dc, dw = fused_decoder.fused_decoder_core_bwd(q, c, w1, g, hh, depth)
                return [dq, dc, *dw]

            def plain_bwd(q=q, c=c, g=g):
                dq, dc, dw = fused_decoder.decoder_core_bwd_ref(q, c, w1, g, hh, depth)
                return [dq, dc, *dw]

            out = bwd()
            again = bwd()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip(out, again)):
                raise AssertionError(f"K1 bwd {dtype} B={bb}: two runs on the same inputs "
                                     f"differ")
            errs = [(assert_matches_twin(o, r, f"K1 bwd {dtype} B={bb} {n}", grad_of=dtype), n)
                    for o, r, n in zip(out, plain_bwd(), names)]
            del out, again
            err = max(e[0] for e, _ in errs)
            worst_rel, worst = max((e[1], n) for e, n in errs)
            ms, plain_ms = ab_ms(torch, bwd, plain_bwd, iters=5)
            log(6, f"K1 bwd {dtype} ({bb},{nq},{nc},{dd}) 30 outputs within GRAD_TOLERANCE, "
                   f"bit-equal over two runs; max abs {err:.3e}, worst rel RMS "
                   f"{worst_rel:.3e} ({worst}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            log(6, "rel RMS per output: " + ", ".join(f"{n} {e[1]:.2e}" for e, n in errs))
            k1b.update({f"{btag}{tag}max_abs_err": err, f"{btag}{tag}ms": ms,
                        f"{btag}{tag}plain_ms": plain_ms})
    kernels.append(k1b)

    # 7. the training slice
    step_launches = train_slice(torch, dev)
    for k in kernels:
        if k["name"] == "fused_decoder_bwd":
            k["launches"] = step_launches["fused_decoder_bwd"]
        else:
            k["step_launches"] = step_launches[k["name"]]

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
