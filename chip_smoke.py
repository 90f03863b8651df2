#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving forward, pretraining step,
semantic segmentation fine-tune, the pretraining, semseg, classification,
depth and Taskonomy CLIs, the demo and the tools, the parallel layouts
(TP, PP, FSDP), NYUv2's preparation, the decoder variants,
--approx_gelu, AutoAugment and AugMix, the starts from a JAX .msgpack,
the new image formats and a JAX-layout resume on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits
non-zero:
  1. environment: torch and CUDA versions, the card's name and power limit;
  2. kernel build: nvcc builds multimae_tpu_torch/csrc/*.cu (first use);
  3. K4 fused_block_infer against its plain twin at the encoder's shape
     (B=32, N=99, D=768, 12 heads, hidden 3072, bf16): errors, two runs
     bit-equal, times, bound and the device time of each kernel of one
     launch (the stage split, torch.profiler); then K4's library yardstick
     at every K4 shape (K4_LIBRARY_SHAPES): nn.TransformerEncoderLayer
     with K4's weights on its one-call fast path, within TWIN_TOLERANCE of
     K4's twin, timed beside K4;
  4. K1 fused_decoder_fwd against its plain twin at the decoders' shape
     (B=32, 196 queries, 99 context, D=256, 8 heads, depth 2) and at the
     training slice's B=128, bf16 and fp32: errors, times, at B=128 two
     runs bit-equal and the device time of each kernel of one launch
     (torch.profiler);
  5. the slice: MultiMAE ViT-B (224 px, RGB + depth + semseg, 98 visible
     tokens, four decoders, fp32 semseg decoder) with seeded random
     weights answers three requests of 32 samples; every pred and loss is
     finite, each forward launches K4 12 times and K1 4 times, and the
     preds match the same model run on the plain twins;
  6. K1 fused_decoder_bwd against its plain twin at (B, 196, 99, 256,
     8 heads, depth 2) for B=32 and the training slice's B=128, bf16 and
     fp32: dq, dc and all 28 fp32 weight gradients, times, two runs
     bit-equal, and at B=128 the device time of each kernel of one launch
     (the stage split, torch.profiler);
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
  8. K2 short_attention forward and backward against their plain twins
     at (4, 2049, 12 heads, 64), (4, 1174, 12, 64) (the Segmenter
     head's blocks), (4, 1025, 12, 64) and (4, 577, 12, 64) (the regime
     of the JAX package's flash wrapper, which K2 serves),
     bf16: o, lse, dq, dk and dv, the backward bit-equal over two runs;
     kernel, twin and torch's scaled_dot_product_attention (the
     yardstick, never called by the port) timed at 197, 577, 1025 and
     2049 keys;
  9. K3b fused_ln_mlp_res and K3a fused_mlp forward and backward against
     their plain twins at the ConvNeXt head's (65,536, 384, hidden 1536),
     bf16: the outputs and all gradients, bit-equal over two runs, times,
     bounds and K3b's stage splits (no path runs K3a: the ConvNeXt block
     takes K3b); then K3b against the block's module path at 4096, 16384
     and 65536 rows, forward and training forward + backward (the data
     for the gate's row floor, fused_mlp.MIN_ROWS);
 10. K4 against its twin at the fine-tune's eval shape (4, 2049, 768):
     its attention step runs the K2 forward kernel; times, bound and the
     stage split;
 11. the fine-tune slice: MultiViT-B with RGB + depth at 512 px (2049
     tokens) and the ConvNeXt head, 40 classes, bf16, batch 4, drop_path
     0.1 from a seeded generator on the card, AdamW with layer decay 0.75
     (cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml)
     takes STEPS steps on one synthetic batch; every step launches K2 fwd
     12, K2 bwd 12, K3b fwd 4, K3b bwd 4 times and K4 and K1 never, its
     metrics are finite, the loss falls, and the first step matches the
     same step on the plain twins (same state, same drop_path draws);
     then the eval step (K4 12 and K3b fwd 4 launches) matches the plain
     twins, its confusion matrix counts every non-ignored pixel, and
     mIoU is printed; ms per step, samples/s and peak memory for both
     paths, and ms per eval batch.
 12. the pretraining CLI (multimae_tpu_torch.cli.run_pretraining_multimae,
     get_args + main) at full width from a dataset folder: a tree of
     CLI_SAMPLES aligned samples in 2 classes at 256 x 320 (8-bit RGB,
     16-bit depth, palette semseg PNGs of photo-like scenes, written by the
     port's PNG writer with adaptive row filters as PIL and libpng write
     them; the rows per filter type are printed) under build/; the flagship
     YAML with batch 32, 2 epochs of 2 steps, no warmup, 4 loader workers
     and a save every epoch: the losses are finite, log.txt has 2 lines,
     checkpoint-0.pth and checkpoint-1.pth exist, K1 fwd and bwd launch 4
     times per step and nothing else launches (phase 21 resumes a run;
     tests/test_torch_checkpoint.py holds the fallback past a damaged
     save). Printed: the native loader's samples/s (one
     process, and 4 workers, at batch 8), for the native library and its
     numpy twins (the data path before it; the twins over TWIN_SAMPLES
     samples) ms per sample decoding, augmenting and in the rgb resample
     alone (the two paths' arrays must be equal); the CLI's step ms fed by
     the loader (and on
     synthetic batches of 32), the share of each step spent waiting for
     data; and the checkpoint save seconds. Every loader's close
     raises if a worker did not exit cleanly. The tree and the checkpoints
     are deleted, but for the newest checkpoint, which phase 13 starts
     from. Then JPEG: every committed fixture of tests/fixtures/jpeg/,
     decoded by the native library this machine's g++ built, must have the
     SHA-256 that expected.json holds (PIL's decode where the fixtures were
     written; the one file the decoder must refuse raises naming what
     expected.json says), and each 500 x 375 photo's decode is timed, in
     one thread and (4:2:0) in 4 threads at once; then
     the same CLI for one epoch (batch 32, 4 workers, no save) over an
     ImageNet-layout tree of CLI_SAMPLES samples at 375 x 500 whose rgb
     images are those photos as .jpg, beside depth and semseg PNGs written
     by the port's writer: K1 fwd and bwd launch 4 times per step and
     nothing else launches, the losses are finite; printed with the card
     line: the loader's samples/s (one process, and 4 workers) and ms per
     sample decoding the JPEG.
 13. the semantic segmentation fine-tune CLI
     (multimae_tpu_torch.cli.run_finetuning_semseg, get_args + main): K4
     against its twin at the Segmenter's eval shapes (4, 1025, 768) and
     (4, 1174, 768), where its attention step runs the K2 forward; then
     NYUv2-shaped trees of FT_TRAIN and FT_VAL samples (640 x 480 PNGs of
     photo-like scenes with adaptive row filters: RGB, 16-bit depth, 40
     classes with patches of 255, mask_valid) under the NYU rgb-depth
     recipe (MultiViT-B at 512 px, ConvNeXt head, bf16, batch 4, layer
     decay 0.75, 1-epoch warmup, 4 workers), started with --finetune from
     phase 12's checkpoint (pos-embs 14x14 -> 32x32): run A trains one
     epoch with a save and an mIoU eval over all FT_VAL images (a partial
     batch of 2 included) (phases 15 and 16 run the resume runs B and C
     through the same cli/finetune_loop.py). Every loss and mIoU is
     finite, 0 <= mIoU <= 1, checkpoint-best.pth exists. An --eval run
     from checkpoint-0.pth counts the launches per eval batch, and run A's
     totals less its eval's give those per training step: each training step launches K2
     fwd and bwd 12 and K3b fwd and bwd 4 times and each eval batch K4 12
     and K3b fwd 4 times. Then run D: the Segmenter head (dim 768,
     depth 2) under the ADE recipe (rgb, 150 classes, reduce_zero_label)
     for one epoch, and its --eval run: K2 fwd and bwd 14 times per step
     (the encoder's 1025 keys and the head's 1174) and K4 14 per eval
     batch. Then run E: the DPT semseg head (--output_adapter dpt) under
     the NYU recipe for one epoch, and its --eval run: K2 fwd and bwd 12
     times per step, K4 12 per eval batch, nothing else. Printed: the
     launches, the fine-tune start's missing and unexpected keys, the
     loader-fed step's host ms and data-wait share; ms per sample decoding
     and augmenting over TWIN_SAMPLES samples (native and twin arrays must
     be equal); eval ms per batch, checkpoint save seconds.
 14. the classification fine-tune CLI
     (multimae_tpu_torch.cli.run_finetuning_cls, get_args + main): K4
     against its twin at the cls eval shape (CLS_BATCH, 197, 768), bit-equal
     over two runs; K2 against the module path that training takes at the
     recipe's 197 keys (the gate, SHORT_KERNEL_MIN_KV, stays at 512), at
     (CLS_BATCH, 197, 12, 64) bf16, forward and forward + backward; then an
     ImageNet-layout tree of CLS_TRAIN + CLS_VAL samples in CLS_CLASSES
     classes (links to the 500 x 375 photo fixtures) under the ImageNet-1K
     recipe (MultiViT-B at 224 px, mean-pooling head, bf16, batch
     CLS_BATCH, RandAugment rand-m9-mstd0.5-inc1, mixup 0.8 and cutmix 1.0,
     label smoothing 0.1, layer decay 0.65, 4 workers) with the EMA on,
     started with --finetune from phase 12's checkpoint: run A trains 2
     epochs with a top-1/5 eval over all CLS_VAL images per epoch and
     saves checkpoint-0, -1 and -best.pth; an --eval run from
     checkpoint-1.pth counts the launches per eval batch and run A's totals
     less its evals' give those per step: no kernel in a training step, K4
     12 times per eval batch; run B (--epochs 3 at LR 0) auto-resumes from
     checkpoint-1.pth with bit-equal parameters, evaluates to run A's
     epoch-1 top-1, and keeps the best top-1 and checkpoint-best.pth
     untouched. Printed: the loader-fed step's host ms and data-wait share,
     eval ms per batch with top-1/5, save and load seconds, the native
     loader's samples/s (one process and 4 workers), and for the native
     library and the numpy twins (over
     TWIN_SAMPLES) ms per sample decoding and augmenting, with
     RandAugment's part (the two paths' arrays must be equal).
 15. the depth fine-tune CLI (multimae_tpu_torch.cli.run_finetuning_depth,
     get_args + main) under the NYUv2 depth recipe as it stands (MultiViT-B
     with the DPT head at 256 px, fp32 with TF32 off, batch DEPTH_BATCH,
     berhu against mask_valid, layer decay 0.75, 4 workers; without its
     100-epoch warmup), started with --finetune from phase 12's checkpoint,
     over a NYUv2-shaped tree (640 x 480 photo-like rgb, 16-bit depth and
     mask_valid PNGs) of DEPTH_TRAIN training records linked to
     DEPTH_WRITTEN written samples and DEPTH_VAL validation samples: run A
     trains 2 epochs with an evaluation each (rmse ... delta_3 over all
     DEPTH_VAL images) and saves checkpoint-0, -1 and -best.pth; an --eval
     run of checkpoint-1.pth counts the launches per eval batch (run A's
     totals less its evals' give those per step: none in either, the fp32
     path takes the modules, as in the JAX package) and evaluates to run
     A's epoch-1 delta_1; run B (--epochs 3 at LR 0) auto-resumes at epoch
     2 with bit-equal parameters, evaluates to the same delta_1 and keeps
     the best delta_1 and checkpoint-best.pth; run C from a copy of
     checkpoint-0.pth alone, at run A's LR and without loader workers,
     resumes at epoch 1 and its first loss equals run A's first of epoch
     1; since run A launched no
     kernel, its first loss is the plain path's, and no rerun on the plain
     twins is made. Printed: the launches, the
     fine-tune start's keys, the losses and delta_1, the loader's samples/s
     (one process and 4 workers, native, over the written
     samples), the loader-fed step's host ms and data-wait share, eval ms
     per batch, save and load seconds, with the card line.
 16. the Taskonomy fine-tune CLI
     (multimae_tpu_torch.cli.run_finetuning_taskonomy): K2 forward and
     backward at (TK_BATCH, 577, 12, 64) and K4 at (TK_BATCH, 577, 768),
     bf16, against their twins, bit-equal over two runs, with their
     twins', SDPA's and the bounds' times; then the rgb2depth_zbuffer
     recipe (MultiViT-B with the DPT head at 384 px, bf16, batch TK_BATCH,
     drop_path 0.1, masked L1, 4 workers; no warmup) from phase 12's
     checkpoint (pos-embs 14 x 14 -> 24 x 24) over a written Taskonomy
     tree of TK_TRAIN + TK_VAL rows at 512 x 512 with its CSV splits, the
     runs of phase 15 (the best L1 kept): each step launches K2 fwd and bwd
     12 times and each eval batch K4 12 times; run A's first epoch again
     on the plain twins: the first loss and grad norm within
     TK_CLI_LOSS_TOLERANCE and TK_CLI_NORM_TOLERANCE of those.
 17. the demo and the tools (multimae_tpu_torch/cli/demo.py and tools/):
     K4 at ViT-L's width (D 1024, 16 heads, hidden 4096) at (256, 197) and
     (16, 2049), K2 forward and backward at 16 heads (4, 2049, 16, 64) and
     K3b forward at bench_infer's 524,288 rows against their twins,
     bit-equal over two runs, timed with their twins, bounds (and SDPA for
     K2); then, each with the counts set to 0 before it and read after:
     the demo on phase 12's .pth (fp32: K1 fwd 3 launches) with a
     committed photo, a 16-bit depth PNG and a palette semseg PNG it
     writes, once with --visible_rgb and once masking at random, each
     against the same call on the plain twins (fp32 TWIN_TOLERANCE), its
     6 PNGs read back at their sizes; bench_infer's four shapes at the
     default batches (ViT-B and ViT-L; TOOL_STEPS chained forwards:
     K4 12 or 24 per forward, K3b fwd 4 per semseg forward);
     bench_finetune's semseg on both engines (where a leg ran out of
     memory at the default batch, the other again at its batch, and the
     kernel speedup at that one batch), Taskonomy, ViT-L semseg
     (TOOL_STEPS after TOOL_WARMUP: K2 12 or 24 + the same, K3b 4 + 4 per
     step; the module engine K3b only), cls and depth one step each (no
     launch), with the batch and peak memory of each leg; profile_step
     --mode pretrain --large (K1 4 + 4 per step) and --mode
     taskonomy384 (K2 12 + 12), with their tables by kind and by module.
 18. the parallel paths (parallel/): K2 forward and backward at tensor
     parallelism's local head counts, (4, 2049, 8, 64) (ViT-L under TP 2)
     and (4, 2049, 6, 64) (ViT-B), bf16, against their twins, bit-equal
     over two runs, timed with their twins, SDPA and bounds; then four
     spawned processes on the card, two gloo groups of two with CUDA
     tensors (NCCL refuses two ranks of one communicator on one card):
     TP 2, ViT-L semseg at 512 px, batch 4 (the reference's one-process
     first step on rank 0 first), PARALLEL_STEPS steps launching K2 24 +
     24 and K3b 4 + 4 per rank step and an eval batch launching K2 24, K3b
     fwd 4 and no K4; and PP 2 x PP_MICRO, the ViT-B pretraining step at
     TRAIN_BATCH (K1 4 + 4 per rank step; the hops through the host);
     meanwhile in this process FSDP2 at world 1 over NCCL, the same
     pretraining step (K1 4 + 4), its peak memory, and a save under FSDP
     that loads into the plain state bit-equal. Each path's first step
     against the one-process step (TP_LOSS_TOLERANCE / TP_NORM_TOLERANCE,
     PP_TOLERANCE), the loss falling over the steps, the ranks' metrics
     equal, each path's launches with the counts set to 0 before it.
 19. the last modules of the JAX package: the committed NYUv2 fixture
     (tests/fixtures/nyuv2: MATLAB v7.3's HDF5 layout at 640 x 480) read by
     the port's HDF5 reader, each dataset's SHA-256 against h5py's in
     expected.json; tools/prepare_nyuv2.py over it with and without the
     class map, each PNG's pixel digest against the JAX tool's tree, ms
     per frame; the semseg CLI over the class-mapped tree (NYU rgb-depth
     recipe, MultiViT-B at 512 px, batch NYU_BATCH, --finetune ''): one
     epoch with an eval and an --eval run, K2 fwd and bwd 12 and K3b 4 per
     step, K4 12 and K3b fwd 4 per eval batch, finite losses and mIoU; K1
     forward and backward against the plain twins on the queries, context
     and output gradient each of its launches took in one step at
     K1_INPUTS_BATCH, for the default decoders and those without task
     queries (TWIN_TOLERANCE, GRAD_TOLERANCE), the fp32 one's kernel and
     twin also against float64 autograd; the
     pretraining step at VARIANT_BATCH (phase 7's recipe, VARIANT_STEPS
     steps) with decoders without task queries and under --approx_gelu (K1
     fwd and bwd 4 per step; the first step against the plain twins at
     phase 7's bounds), and the pretraining CLI with `decoder_use_xattn:
     false` in a YAML (no launch; its first step again on the twins); each
     AutoAugment policy and AugMix (AA_POLICIES) and the nearest and
     Lanczos resizes over the photo fixtures, native against twin,
     bit-equal, ms per sample; the cls CLI's first step and eval batch
     under --aa AA_CLI --train_interpolation AA_INTERP (nothing in the
     step, K4 12 in the eval batch).
 20. the last loaders (utils/flax_msgpack.py, data/image_io.py): every
     fixture of tests/fixtures/images (Adam7 PNG, BMP, netpbm, TIFF),
     tests/fixtures/webp (VP8, VP8L, ALPH, animations) and
     tests/fixtures/jpeg2000 (JP2 and J2K: 5/3 and 9/7, every code-block
     style, PPM, PPT, POC, ROI, sub-sampled components, pclr palettes) and
     tests/fixtures/tiff_codecs (CCITT RLE, Group 3, Group 4 and RLEW,
     LZMA, ZSTD, ThunderScan, CIELab, the one-band planar file) against
     PIL's digests, the damaged ones raising ValueError, and whether this
     host's Python imports lzma; a MultiMAE-B params file in the JAX
     package's own format (flax msgpack, from seeded weights through the port's inverse
     converter and writer) starts the demo (preds bit-equal to the same
     weights as a .pth; K1 fwd 3), the cls CLI (a step and an eval batch
     at LOADER_CLS_BATCH: K4 12) and the semseg CLI (512 px, a step and an
     eval batch at LOADER_SEG_BATCH: K2 12 + 12, K3b 4 + 4, K4 12, K3b fwd
     4); one epoch of the pretraining CLI over LOADER_SAMPLES samples whose
     rgb images are the new formats (WebP lossy 4:2:0, with alpha,
     lossless and an animation's first frame, and four .jpx JPEG 2000
     files among them), and one over a
     TIFF tree (the
     tree_*.tif fixtures: LZW with predictor 2, Deflate, PackBits, tiled,
     planar, associated alpha, 16-bit RGB, JPEG-compressed at 4:2:0 in
     strips and in tiles, old-style JPEG at 4:2:0, LZW YCbCr at 2 x 2;
     16-bit depth in both byte orders; palette semseg), and one over a tree
     of the codecs of item 11h (CCITT Group 4 and 2-D Group 3, LZMA, ZSTD,
     ThunderScan and CIELab rgb files): K1 4 + 4 per step, no resampled
     sample.
 21. a JAX-layout resume at full width (train/checkpoint.py,
     utils/jax_state.py): the pretraining CLI (MultiMAE-B, uncertainty
     balancer, AdamW, TRAIN_BATCH, RESUME_STEPS synthetic steps an epoch)
     and the semseg CLI over the NYUv2 fixture's class-mapped tree (NYU
     rgb-depth recipe at 512 px, NYU_BATCH: a step and an eval batch an
     epoch). Run P trains two epochs; run M saves epoch 0 with
     --ckpt_backend msgpack and is stopped after that save, and its
     relaunch auto-resumes epoch 1 from the file: the file's every path,
     shape and dtype as tests/fixtures/jax_state/*.json holds the JAX
     package's layout; the relaunch's metrics, evaluation and epoch-1
     save (parameters, optimizer moments and counts) bit-equal to run
     P's; K1 4 + 4 per pretraining step, K2 12 + 12 and K3b 4 + 4 per
     semseg step, K4 12 and K3b fwd 4 per eval batch in the relaunch;
     the file's MiB, write and load seconds.
Then it prints the seconds each phase took, the card line, a JSON line of the kernels and, last,
{"ok": true, "device": {...}}. A time is per call, from CUDA events
around back-to-back calls (median of windows; kernel and plain twin
timed in turns). Each kernel's `bound_ms` is the least time an H100 SXM
could take for its work at the main path's shape: the larger of its
operations over the peak rate for their type (989 TFLOP/s bf16 dense,
67 TFLOP/s fp32) and its bytes (each input read once, each output
written once) over 3.35 TB/s.

Without a CUDA card, or without the multimae_tpu_torch package beside
it, the script exits non-zero and prints no result.
"""

import contextlib
import copy
import faulthandler
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

# The fine-tune slice (phase 11). Its first step against the same step on
# the plain twins, from the same state and drop_path draws: relative
# SEMSEG_LOSS_TOLERANCE for the loss, SEMSEG_NORM_TOLERANCE for the grad
# norm, and relative RMS SEMSEG_GRAD_TOLERANCE for every parameter's
# gradient. Unlike phase 7 the whole model runs through kernels (K2 in all
# 12 encoder blocks, K3b in the head), so bf16 rounding flips reach every
# gradient. Each limit is three to four times the reading on an H100:
# 4.8e-6 (loss), 7.3e-3 (the worst parameter, the rgb patch projection).
# The grad norm's reading depends on which of K2's bf16 roundings of p flip
# against the twin's: 8.8e-6 and 1.35e-5 with the first K2 kernels,
# 3.13e-5 to 3.50e-5 with the current two-pass forward (six runs with the
# same kernel outputs; the twin path moves by up to 3e-6, atomic adds in
# torch's bilinear-resize backward), and 8.11e-5 with a variant of that
# forward that summed each row over 128-key steps (o within 1.54e-4 rel
# RMS of the twin, as the kept kernel's); the limit is three times that
# largest reading, within the 1e-2 cap set for it. The eval preds against
# the plain twins within SLICE_TOLERANCE.
SEMSEG_BATCH = 4
SEMSEG_LOSS_TOLERANCE = 2e-5
SEMSEG_NORM_TOLERANCE = 2.5e-4
SEMSEG_GRAD_TOLERANCE = 2.5e-2
SEMSEG_CLASSES = 40

# The pretraining CLI (phase 12): a written tree of CLI_SAMPLES samples at
# CLI_HW, the flagship YAML at CLI_BATCH per step.
CLI_SAMPLES = 64
# The numpy twins' per-sample splits in phases 12-14 (each against the
# native library's arrays) run over this many samples of each tree.
TWIN_SAMPLES = 8
CLI_HW = (256, 320)
CLI_BATCH = 32
CLI_WORKERS = 4
CLI_YAML = "cfgs/pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml"
# Phase 12's JPEG tree: the committed photo-like fixtures at JPEG_HW
# (ImageNet's typical 500 x 375) as rgb .jpg under CLI_SAMPLES names, with
# depth and semseg PNGs of the same size; one epoch of the same CLI.
JPEG_FIXTURES = os.path.join(HERE, "tests", "fixtures", "jpeg")
JPEG_HW = (375, 500)
JPEG_TIMED_FILES = 40

# The semseg fine-tune CLI (phase 13): NYUv2-shaped trees (640 x 480 RGB,
# 16-bit depth, 40 classes with patches of 255, mask_valid) of FT_TRAIN +
# FT_VAL samples under the NYU rgb-depth recipe, started from phase 12's
# pretraining checkpoint; then the Segmenter head under the ADE recipe.
FT_TRAIN, FT_VAL = 8, 6
FT_HW = (480, 640)
FT_YAML = "cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml"
ADE_YAML = "cfgs/finetune/semseg/ade/ft_ade_64e_multimae-b_rgb.yaml"
ADE_TRAIN, ADE_HW = 8, (384, 512)

# The classification fine-tune CLI (phase 14): an ImageNet-layout tree of
# CLS_TRAIN + CLS_VAL samples in CLS_CLASSES classes, links to the photo
# fixtures, under the ImageNet-1K recipe at its batch of CLS_BATCH, started
# from phase 12's pretraining checkpoint.
CLS_TRAIN, CLS_VAL, CLS_CLASSES = 256, 128, 8
CLS_BATCH = 128
CLS_YAML = "cfgs/finetune/cls/ft_in1k_100e_multimae-b.yaml"

# The depth fine-tune CLI (phase 15): the NYUv2 depth recipe (fp32, berhu,
# mask_valid) at its batch of DEPTH_BATCH over a NYUv2-shaped tree whose
# DEPTH_TRAIN training records are links to DEPTH_WRITTEN written samples,
# and DEPTH_VAL validation samples.
DEPTH_YAML = "cfgs/finetune/depth/ft_nyu_2000e_multimae-b.yaml"
DEPTH_WRITTEN, DEPTH_TRAIN, DEPTH_VAL, DEPTH_BATCH = 16, 128, 16, 64
# The Taskonomy fine-tune CLI (phase 16): rgb -> depth_zbuffer (bf16, 384
# px: 577 tokens) at its batch of TK_BATCH over a Taskonomy-layout tree of
# TK_TRAIN + TK_VAL rows at TK_HW with its CSV splits.
TK_YAML = "cfgs/finetune/taskonomy/rgb2depth-1k/ft_rgb2depth_multimae-b.yaml"
TK_TRAIN, TK_VAL, TK_BATCH, TK_HW = 8, 8, 8, (512, 512)
# The Taskonomy CLI's first loader-fed step against the same step on the
# plain twins (same data and drop_path draws): relative gaps of the loss
# and of the gradient norm. K2 runs the training attention of all 12
# blocks, and its bf16 roundings of P move the L1 loss of the DPT head's
# regression directly. Readings on an H100 at 700 W, from a random-weight
# pretraining .pth: loss up to 1.66e-4 in this phase and 2.49e-4 in the
# card test, grad norm up to 3.0e-4 here and 9.0e-5 there; the card test's
# control with K2's ragged tail dropped read 2.71e-2 and 1.60e-2. Each
# limit sits between the two, at about 4-7 times the sound readings.
TK_CLI_LOSS_TOLERANCE = 1e-3
TK_CLI_NORM_TOLERANCE = 2e-3

# Phase 19, the last modules of the JAX package: the committed NYUv2
# fixture (MATLAB v7.3's layout, 4 frames at 640 x 480, 2 + 2 in its
# splits) through the HDF5 reader and prepare_nyuv2, its class-mapped tree
# through the semseg CLI at NYU_BATCH; VARIANT_STEPS pretraining steps at
# VARIANT_BATCH for the decoders without task queries, without
# cross-attention and under --approx_gelu; AA_POLICIES and the nearest and
# Lanczos resizes over the photo fixtures, then the cls CLI's first step and
# an eval batch under --aa AA_CLI --train_interpolation AA_INTERP.
# The variants run at phase 7's batch because phase 7's bounds were set
# there: the twins' rounding flips in the decoders average over the batch.
# At batch 32, after K1's fp32 dq repair, the first step's grad norm read
# 2.95e-5 relative for the default decoders, 4.65e-5 without task queries
# and 2.37e-5 under --approx_gelu, past STEP_TOLERANCE; at 128 1.74e-6 and
# 1.19e-5 (the default decoders 1.25e-5; H100, 700 W). In all three the
# first tensor of the step to part from the twins' is the rgb decoder's
# K1 output (3.1e-3 to 3.4e-3 relative, bf16 rounding within
# TWIN_TOLERANCE); every tensor before it is equal.
# K1 against its twin on the inputs its launches took: the queries, context
# and output gradient of each decoder in one step of phase 7's recipe at
# K1_INPUTS_BATCH, for the default decoders and those without task queries.
NYU_FIXTURE = os.path.join(HERE, "tests", "fixtures", "nyuv2")
NYU_BATCH = 2
VARIANT_BATCH, VARIANT_STEPS = TRAIN_BATCH, 3
K1_INPUTS_BATCH = 32
AA_POLICIES = ("original", "originalr", "v0", "v0r", "augmix-m3-w3-mstd0.5")
AA_CLI, AA_INTERP = "augmix-m3-w3-mstd0.5", "lanczos"

# Phase 20, the last loaders: a MultiMAE-B params file in the JAX package's
# own format (flax msgpack, written by the port's writer from seeded random
# weights) starts the demo (against the same weights as a .pth), the cls
# CLI (one step at LOADER_CLS_BATCH and an eval batch) and the semseg CLI
# (512 px, LOADER_SEG_BATCH: one step and an eval batch); then one epoch
# of the pretraining CLI at LOADER_PT_BATCH over LOADER_SAMPLES samples
# whose rgb images are the new formats' tree fixtures (arithmetic-coded
# and smoothed JPEG, Adam7 PNG, BMP with RLE8, PPM; WebP lossy 4:2:0, lossy
# with alpha, lossless and an animation's first frame; JPEG 2000 5/3
# lossless, 9/7 with layers, tiled RPCL and hand-written with every
# code-block style, SOP/EPH and the RCT; all 48 x 64), and
# one over a tree of TIFF files only (the tree_*.tif fixtures as rgb, the
# JPEG-compressed and YCbCr ones among them).
IMAGE_FIXTURES = os.path.join(HERE, "tests", "fixtures", "images")
TIFF_CODECS_FIXTURES = os.path.join(HERE, "tests", "fixtures", "tiff_codecs")
WEBP_FIXTURES = os.path.join(HERE, "tests", "fixtures", "webp")
JPEG2000_FIXTURES = os.path.join(HERE, "tests", "fixtures", "jpeg2000")
LOADER_CLS_BATCH, LOADER_SEG_BATCH, LOADER_PT_BATCH, LOADER_SAMPLES = 32, 2, 8, 16
LOADER_HW = (48, 64)

# The least time an H100 SXM could take (NVIDIA's data sheet, dense).
BF16_PEAK = 989e12  # FLOP/s, tensor cores
FP32_PEAK = 67e12   # FLOP/s, outside the tensor cores
HBM_RATE = 3.35e12  # bytes/s


PHASE_SPAN = {}  # phase: [the time of its first line, of its last]


def log(phase, msg):
    now = time.perf_counter()
    PHASE_SPAN.setdefault(phase, [now, now])[1] = now
    print(f"[{phase}] {msg}", flush=True)


def log_phase_times():
    log("timing", "seconds from each phase's first line to its last: " + ", ".join(
        f"{p} {t1 - t0:.1f}" for p, (t0, t1) in PHASE_SPAN.items()))


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


def kernel_modules():
    from multimae_tpu_torch.ops import fused_block, fused_decoder, fused_mlp, short_attention

    return fused_block, fused_decoder, fused_mlp, short_attention


@contextlib.contextmanager
def plain_twins():
    """Every kernel wrapper takes its plain twin, on the card."""
    for m in kernel_modules():
        m.set_force_mode("plain")
    try:
        yield
    finally:
        for m in kernel_modules():
            m.set_force_mode(None)


def launch_counts():
    """{kernel name: launches so far}."""
    fused_block, fused_decoder, fused_mlp, short_attention = kernel_modules()
    return {"fused_block_infer": fused_block.LAUNCHES,
            "fused_decoder_fwd": fused_decoder.LAUNCHES,
            "fused_decoder_bwd": fused_decoder.LAUNCHES_BWD,
            "short_attention_fwd": short_attention.LAUNCHES,
            "short_attention_bwd": short_attention.LAUNCHES_BWD,
            "fused_ln_mlp_res_fwd": fused_mlp.LAUNCHES,
            "fused_ln_mlp_res_bwd": fused_mlp.LAUNCHES_BWD,
            "fused_mlp_fwd": fused_mlp.LAUNCHES_MLP,
            "fused_mlp_bwd": fused_mlp.LAUNCHES_MLP_BWD}


def reset_launch_counts():
    fused_block, fused_decoder, fused_mlp, short_attention = kernel_modules()
    fused_block.LAUNCHES = 0
    fused_decoder.LAUNCHES = fused_decoder.LAUNCHES_BWD = 0
    fused_mlp.LAUNCHES = fused_mlp.LAUNCHES_BWD = 0
    fused_mlp.LAUNCHES_MLP = fused_mlp.LAUNCHES_MLP_BWD = 0
    short_attention.LAUNCHES = short_attention.LAUNCHES_BWD = 0


def bound(flops, nbytes, peak=BF16_PEAK):
    """(bound_ms, bound_by): the larger of the operations over the peak
    rate and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_RATE
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def kernel_split(torch, fn, iters=3):
    """{kernel: device ms per call of fn()}, from torch.profiler over
    `iters` calls after one warm-up; names without namespaces and
    arguments, template arguments kept."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
            name = name.removeprefix("void ").replace("mm::dtc::", "").replace("mm::", "")
            split[name] = split.get(name, 0.0) + e.time_range.elapsed_us() / iters / 1e3
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def log_split(phase, what, split):
    log(phase, f"{what}: device {sum(split.values()):.4f} ms in {len(split)} kernels: "
               + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))


def block_work(b, n, d, hidden):
    """(FLOPs, weight elements) of one pre-LN ViT block over b x n tokens."""
    m = b * n
    flops = 2 * m * (3 * d * d + d * d + 2 * d * hidden) + 4 * b * n * n * d
    return flops, 4 * d * d + 2 * d * hidden + 4 * d + hidden + 4 * d


def decoder_work(b, nq, nc, d, hidden, depth):
    """(FLOPs, weight elements) of the decoder body (K1)."""
    mq, mc = b * nq, b * nc
    flops = (2 * mq * d * d + 2 * mc * 2 * d * d + 4 * b * nq * nc * d + 2 * mq * d * d
             + 4 * mq * d * hidden)
    weights = 4 * d * d + 2 * d * hidden + 10 * d + hidden
    blk_flops, blk_weights = block_work(b, nq, d, hidden)
    return flops + depth * blk_flops, weights + depth * blk_weights


def check_on_card(state, *tensors):
    """Raise unless the model, the balancer (if any), the tensors of each
    dict in `tensors` and the optimizer's state all lie on the card."""
    import torch

    off = [n for n, p in state.model.named_parameters() if not p.is_cuda]
    if state.balancer is not None:
        off += [n for n, p in state.balancer.named_parameters() if not p.is_cuda]
    off += [t for d in tensors for t, v in d.items() if not v.is_cuda]
    off += [f"optimizer {k}" for st in state.optimizer.state.values()
            for k, v in st.items() if torch.is_tensor(v) and v.dim() > 0 and not v.is_cuda]
    if off:
        raise AssertionError(f"the training step would not run on the card: {off[:5]}")


def rel_rms(a, b):
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt().clamp_min(1e-30))


def decoder_grads(m):
    """{decoder: {parameter: fp32 copy of its gradient}}."""
    return {t: {n: p.grad.float().clone() for n, p in a.named_parameters()
                if p.grad is not None}
            for t, a in m.output_adapters.items()}


def steps_against_twins(torch, dev, phase, state, step, plain_state, plain_step, batch, masks,
                        steps, expect):
    """`steps` pretraining steps on one batch with fixed masks, each
    launching `expect` ({kernel: count}), with finite metrics and a falling
    loss; then the first step again on the plain twins from `plain_state`
    (a copy of the state before it): every loss and the grad norm within
    STEP_TOLERANCE, each decoder parameter's gradient within
    STEP_GRAD_TOLERANCE. Returns (the metrics of each step, the peak
    memory of the steps, of the plain step)."""
    torch.cuda.reset_peak_memory_stats(dev)
    history = []
    for i in range(steps):
        before = launch_counts()
        metrics = {k: float(v) for k, v in step(state, batch, task_masks=masks).items()}
        per_step = {k: v - before[k] for k, v in launch_counts().items()}
        if per_step != expect:
            raise AssertionError(f"[{phase}] step {i} launched {per_step}; expected {expect}")
        if not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"]:
            raise AssertionError(f"[{phase}] step {i}: metrics {metrics}")
        if i == 0:
            check_on_card(state, batch, masks)
            first_grads = decoder_grads(state.model)
        history.append(metrics)
        log(phase, f"step {i}: loss {metrics['loss']:.4f}, grad norm "
                   f"{metrics['grad_norm']:.4f}; "
                   + ", ".join(f"{t} {metrics[t + '_loss']:.4f}" for t in TASKS))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"[{phase}] the loss did not fall: {history[0]['loss']} -> "
                             f"{history[-1]['loss']}")

    torch.cuda.reset_peak_memory_stats(dev)
    with plain_twins():
        plain = {k: float(v) for k, v in plain_step(plain_state, batch, task_masks=masks).items()}
    plain_peak = torch.cuda.max_memory_allocated(dev)
    rels = {k: abs(history[0][k] - plain[k]) / abs(plain[k])
            for k in ["loss", "grad_norm"] + [f"{t}_loss" for t in TASKS]
            + [f"{t}_loss_weighted" for t in TASKS]}
    log(phase, "step 0 vs plain twins, rel: " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
    for k, rel in rels.items():
        if not rel <= STEP_TOLERANCE:
            raise AssertionError(f"[{phase}] step 0 {k}: {history[0][k]} vs {plain[k]} on the "
                                 f"plain twins (rel {rel:.3e}, limit {STEP_TOLERANCE})")
    log(phase, f"step 0 vs plain twins: loss {history[0]['loss']:.6f} / {plain['loss']:.6f}, "
               f"grad norm {history[0]['grad_norm']:.6f} / {plain['grad_norm']:.6f} "
               f"(limit rel {STEP_TOLERANCE})")
    for t, grads in decoder_grads(plain_state.model).items():
        limit = STEP_GRAD_TOLERANCE[str(state.model.output_adapters[t].dtype)]
        if set(grads) != set(first_grads[t]):
            raise AssertionError(f"[{phase}] decoder {t}: gradients of "
                                 f"{sorted(first_grads[t])} vs {sorted(grads)} on the plain twins")
        rels = {n: rel_rms(first_grads[t][n], g) for n, g in grads.items()}
        worst = max(rels, key=rels.get)
        log(phase, f"step 0 decoder {t}: {len(rels)} parameter gradients vs plain twins, worst "
                   f"rel RMS {rels[worst]:.3e} ({worst}; limit {limit})")
        bad = {n: r for n, r in rels.items() if not r <= limit}
        if bad:
            raise AssertionError(f"[{phase}] decoder {t} gradients differ from the plain "
                                 f"twins: {bad}")
    return history, peak, plain_peak


def fixed_mask_batch(torch, dev, batch_size):
    """A synthetic pretraining batch and masks drawn once from a seeded
    generator on the card (98 of 3 x 196 tokens visible)."""
    from multimae_tpu_torch.cli.factory import make_synthetic_batch
    from multimae_tpu_torch.ops import masking

    batch = make_synthetic_batch(batch_size, seed=0, device=dev)
    mask_gen = torch.Generator(device=dev).manual_seed(1)
    mask_list, _, _ = masking.generate_random_masks(mask_gen, batch_size, [196] * 3, 98)
    return batch, dict(zip(("rgb", "depth", "semseg"), mask_list))


def train_slice(torch, dev):
    """Phase 7; returns each kernel's launches over the STEPS steps."""
    from multimae_tpu_torch.cli.factory import build_pretrain_losses, build_pretrain_trainer
    from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step

    t0 = time.perf_counter()
    state, step = build_pretrain_trainer(batch_size=TRAIN_BATCH, seed=0, device=dev)
    batch, masks = fixed_mask_batch(torch, dev, TRAIN_BATCH)
    plain_state = copy.deepcopy(state)
    plain_step = make_pretrain_train_step(plain_state.model, plain_state.balancer,
                                          build_pretrain_losses(("rgb", "depth", "semseg")))
    model = state.model
    check_on_card(state, batch, masks)
    n_params = sum(p.numel() for p in model.parameters())
    log(7, f"MultiMAE ViT-B pretraining state ({n_params} parameters, bf16, fp32 semseg "
           f"decoder, uncertainty balancer, AdamW) built in {time.perf_counter() - t0:.1f} s; "
           f"batch {TRAIN_BATCH}, lr {state.lr_values[0]:.3e}")

    expect = dict.fromkeys(launch_counts(), 0)
    expect.update(fused_decoder_fwd=4, fused_decoder_bwd=4)
    reset_launch_counts()
    _, peak, plain_peak = steps_against_twins(torch, dev, 7, state, step, plain_state,
                                              plain_step, batch, masks, STEPS, expect)
    launches = launch_counts()
    if launches != {k: v * STEPS for k, v in expect.items()}:
        raise AssertionError(f"launch counts over {STEPS} steps: {launches}")

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


def free_card(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def short_attention_phase(torch, dev):
    """Phase 8; returns the K2 forward and backward entries of the kernel
    line (times at the slice's 2049 keys) and the flash wrapper's, which
    the K2 forward serves (times at 577 keys)."""
    import torch.nn.functional as F

    from multimae_tpu_torch.ops import short_attention as sa
    from multimae_tpu_torch.ops.functional import assert_matches_twin

    b, h, dh = SEMSEG_BATCH, 12, 64
    scale = dh ** -0.5
    gen = torch.Generator().manual_seed(8)

    def inputs(n):
        qkv = torch.randn((b, n, 3, h, dh), generator=gen).to(dev, torch.bfloat16)
        g = torch.randn((b, n, h, dh), generator=gen).to(dev, torch.bfloat16)
        return (*qkv.unbind(2), g)

    errors = {}
    for n in (2049, 1174, 1025, 577):
        q, k, v, g = inputs(n)
        o, lse = sa.short_attention_fwd(q, k, v, scale)
        grads = sa.short_attention_bwd(q, k, v, o, lse, g, scale)
        again = sa.short_attention_bwd(q, k, v, o, lse, g, scale)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(grads, again)):
            raise AssertionError(f"K2 bwd at {n} keys: two runs on the same inputs differ")
        ro, rlse = sa.short_attention_ref(q, k, v, scale)
        errs = {"o": assert_matches_twin(o, ro, f"K2 fwd o at {n} keys"),
                "lse": assert_matches_twin(lse, rlse, f"K2 fwd lse at {n} keys")}
        del ro, rlse
        refs = sa.short_attention_bwd_ref(q, k, v, g, lse, sa.attention_delta(o, g), scale)
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            errs[name] = assert_matches_twin(a, r, f"K2 bwd {name} at {n} keys",
                                             grad_of=torch.bfloat16)
        del refs, grads, again
        free_card(torch)
        log(8, f"K2 ({b},{n},{h},{dh}) bf16 within TWIN/GRAD_TOLERANCE, bwd bit-equal over "
               "two runs; max abs / rel RMS: "
               + ", ".join(f"{k} {e[0]:.3e} / {e[1]:.3e}" for k, e in errs.items()))
        errors[n] = (max(errs["o"][0], errs["lse"][0]),
                     max(errs[k][0] for k in ("dq", "dk", "dv")))

    sweep = {}
    for n in (197, 577, 1025, 2049):
        q, k, v, g = inputs(n)
        o, lse = sa.short_attention_fwd(q, k, v, scale)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        leaves = [t.detach().clone().requires_grad_() for t in (qt, kt, vt)]
        gt = g.transpose(1, 2)

        def twin_bwd():
            with plain_twins():
                sa.short_attention_bwd(q, k, v, o, lse, g, scale)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(*leaves).backward(gt)

        kw = dict(iters=5, warmup=1, repeats=3)
        fwd = ab_ms(torch, lambda: sa.short_attention_fwd(q, k, v, scale),
                    lambda: sa.short_attention_ref(q, k, v, scale), **kw)
        bwd = ab_ms(torch, lambda: sa.short_attention_bwd(q, k, v, o, lse, g, scale),
                    twin_bwd, **kw)
        sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), **kw)
        sdpa_fb = cuda_ms(torch, sdpa_fwd_bwd, **kw)
        sweep[n] = {"fwd_ms": fwd[0], "fwd_plain_ms": fwd[1], "sdpa_fwd_ms": sdpa,
                    "bwd_ms": bwd[0], "bwd_plain_ms": bwd[1], "sdpa_fwd_bwd_ms": sdpa_fb}
        log(8, f"K2 at {n} keys (B={b}, 12 heads of 64): fwd kernel {fwd[0]:.4f} ms, twin "
               f"{fwd[1]:.4f} ms, SDPA {sdpa:.4f} ms; bwd kernel {bwd[0]:.4f} ms, twin "
               f"{bwd[1]:.4f} ms; fwd+bwd kernels {fwd[0] + bwd[0]:.4f} ms, SDPA "
               f"{sdpa_fb:.4f} ms")
        del q, k, v, g, o, lse, leaves
        free_card(torch)

    # Where the forward's time goes at 2049 keys: each pass alone, and both
    # passes without the exponentials (stage entry of the kernel; dh 64).
    from multimae_tpu_torch.ops import _build

    q, k, v, _ = inputs(2049)
    ldq, ldk, ldv = sa._check(q, k, v)
    o = torch.empty_like(q)
    lib = _build.load()

    def stage(mode):
        rc = lib.mm_short_attention_fwd_stage_bf16(
            q.data_ptr(), ldq, k.data_ptr(), ldk, v.data_ptr(), ldv, o.data_ptr(), b, 2049,
            2049, h, mode, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, rc, "short_attention forward stage")

    stages = {name: cuda_ms(torch, lambda m=mode: stage(m), iters=10, warmup=2, repeats=3)
              for name, mode in (("pass 1", 1), ("pass 2", 2), ("both", 3),
                                 ("both without exponentials", 7))}
    log(8, "K2 fwd stages at 2049 keys (launched bare): "
           + ", ".join(f"{name} {ms:.4f} ms" for name, ms in stages.items()))
    del q, k, v, o
    free_card(torch)

    def bounds(n):
        """(forward, backward) bounds at n keys: q . k^T and p . v; the
        backward's five products. Forward in: q, k, v; out: o and the fp32
        lse. Backward in: q, k, v, o, do and the lse; out: dq, dk, dv."""
        fl = 4 * b * h * n * n * dh
        return (bound(fl, 2 * 4 * b * n * h * dh + 4 * b * h * n),
                bound(2.5 * fl, 2 * 8 * b * n * h * dh + 4 * b * h * n))

    (fwd_bound, bwd_bound), top = bounds(2049), sweep[2049]
    flash_bound, flash = bounds(577)[0], sweep[577]
    return [
        {"name": "short_attention_fwd", "route": "cuda",
         "source": "multimae_tpu_torch/csrc/short_attention_fwd.cu",
         "replaces": "multimae_tpu/ops/short_attention_pallas.py:255",
         "max_abs_err": errors[2049][0], "ms": top["fwd_ms"], "plain_ms": top["fwd_plain_ms"],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
         "library_ms": top["sdpa_fwd_ms"], "sweep": sweep, "stages_ms": stages},
        {"name": "short_attention_bwd", "route": "cuda",
         "source": "multimae_tpu_torch/csrc/short_attention_bwd.cu",
         "replaces": "multimae_tpu/ops/short_attention_pallas.py:319",
         "max_abs_err": errors[2049][1], "ms": top["bwd_ms"], "plain_ms": top["bwd_plain_ms"],
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
         "library_ms": top["sdpa_fwd_bwd_ms"],
         "library_is": "scaled_dot_product_attention forward + backward",
         "fwd_bwd_ms": top["fwd_ms"] + top["bwd_ms"]},
        {"name": "flash_attention_padded", "route": "cuda",
         "source": "multimae_tpu_torch/csrc/short_attention_fwd.cu",
         "replaces": "multimae_tpu/ops/attention.py:176",
         "served_by": "short_attention_fwd", "shape": [b, 577, h, dh],
         "max_abs_err": errors[577][0], "ms": flash["fwd_ms"],
         "plain_ms": flash["fwd_plain_ms"], "bound_ms": flash_bound[0],
         "bound_by": flash_bound[1], "library_ms": flash["sdpa_fwd_ms"]},
    ]


def fused_mlp_phase(torch, dev):
    """Phase 9; returns the K3b and K3a forward and backward entries."""
    from multimae_tpu_torch.ops import fused_mlp
    from multimae_tpu_torch.ops.functional import assert_matches_twin

    m, k, hid = SEMSEG_BATCH * 128 * 128, 384, 1536
    gen = torch.Generator().manual_seed(9)

    def rnd(*shape, scale, offset=0.0):
        return (torch.randn(shape, generator=gen) * scale + offset).to(dev)

    w = fused_mlp.MlpWeights(rnd(k, scale=0.1, offset=1.0), rnd(k, scale=0.1),
                             rnd(hid, k, scale=0.02), rnd(hid, scale=0.02),
                             rnd(k, hid, scale=0.02), rnd(k, scale=0.02))
    x, res, dy = (torch.randn((m, k), generator=gen).to(dev, torch.bfloat16) for _ in range(3))

    def grads():
        """The 8 gradients through the autograd Function: x, res, then the
        six parameters."""
        leaves = [x.clone().requires_grad_(), res.clone().requires_grad_()]
        wl = fused_mlp.MlpWeights(*(t.clone().requires_grad_() for t in w))
        fused_mlp.fused_ln_mlp_res(*leaves, wl).backward(dy)
        return [t.grad for t in leaves + list(wl)]

    with torch.inference_mode():
        out = fused_mlp.fused_ln_mlp_res(x, res, w)
        torch.cuda.synchronize()
        fwd_err = assert_matches_twin(out, fused_mlp.fused_ln_mlp_res_ref(x, res, w),
                                      "K3b fwd")
    kern, again = grads(), grads()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(kern, again)):
        raise AssertionError("K3b bwd: two runs on the same inputs differ")
    with plain_twins():
        plain = grads()
    names = ["dx", "dres"] + ["d" + f for f in fused_mlp.MlpWeights._fields]
    errs = {n: assert_matches_twin(a, r, f"K3b bwd {n}", grad_of=torch.bfloat16)
            for n, a, r in zip(names, kern, plain)}
    del kern, again, plain
    with torch.inference_mode():
        fwd = ab_ms(torch, lambda: fused_mlp.fused_ln_mlp_res(x, res, w),
                    lambda: fused_mlp.fused_ln_mlp_res_ref(x, res, w), iters=10)
    bwd = ab_ms(torch, lambda: fused_mlp.fused_ln_mlp_res_bwd(x, dy, w),
                lambda: fused_mlp.fused_ln_mlp_res_bwd_ref(x, dy, w), iters=5)
    wbytes = 2 * 2 * k * hid
    fwd_bound = bound(4 * m * k * hid, 2 * 3 * m * k + wbytes)
    bwd_bound = bound(10 * m * k * hid, 2 * 3 * m * k + wbytes + 4 * 2 * k * hid)
    log(9, f"K3b ({m},{k}) hidden {hid} bf16: fwd max abs {fwd_err[0]:.3e}, rel RMS "
           f"{fwd_err[1]:.3e}; 8 gradients within GRAD_TOLERANCE, bit-equal over two runs; "
           f"kernel / twin / bound fwd {fwd[0]:.4f} / {fwd[1]:.4f} / {fwd_bound[0]:.4f} ms, "
           f"bwd {bwd[0]:.4f} / {bwd[1]:.4f} / {bwd_bound[0]:.4f} ms")
    log(9, "max abs / rel RMS per gradient: "
           + ", ".join(f"{n} {e[0]:.2e} / {e[1]:.2e}" for n, e in errs.items()))
    with torch.inference_mode():
        fwd_split = kernel_split(torch, lambda: fused_mlp.fused_ln_mlp_res(x, res, w))
    bwd_split = kernel_split(torch, lambda: fused_mlp.fused_ln_mlp_res_bwd(x, dy, w))
    log_split(9, f"K3b fwd ({m},{k}) by kernel", fwd_split)
    log_split(9, f"K3b bwd ({m},{k}) by kernel", bwd_split)
    sweep = fused_mlp_rows_sweep(torch, fused_mlp, w, gen, dev)
    k3a = fused_mlp_core_part(torch, fused_mlp, x, dy, w, wbytes)
    del x, res, dy
    free_card(torch)
    return k3a + [
        {"name": "fused_ln_mlp_res_fwd", "route": "cuda",
         "source": "multimae_tpu_torch/csrc/fused_mlp_fwd.cu",
         "replaces": "multimae_tpu/ops/fused_mlp_pallas.py:298",
         "max_abs_err": fwd_err[0], "ms": fwd[0], "plain_ms": fwd[1],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": None,
         "stages_ms": fwd_split, "rows_sweep": sweep},
        {"name": "fused_ln_mlp_res_bwd", "route": "cuda",
         "source": "multimae_tpu_torch/csrc/fused_mlp_bwd.cu",
         "replaces": "multimae_tpu/ops/fused_mlp_pallas.py:320",
         "max_abs_err": max(e[0] for e in errs.values()), "ms": bwd[0], "plain_ms": bwd[1],
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": None,
         "stages_ms": bwd_split},
    ]


def fused_mlp_rows_sweep(torch, fused_mlp, w, gen, dev):
    """Phase 9: K3b against the ConvNeXt block's module path (the plain
    twin's LayerNorm, cuBLAS GEMMs and torch GELU, which is what the block
    runs where the gate refuses) at 4096, 16384 and 65536 rows of
    (384, hidden 1536): the forward under inference_mode, and a training
    forward + backward through autograd. The gate's row floor
    (fused_mlp.MIN_ROWS) is set from these numbers; it is lifted for the
    sweep. Returns {rows: {fwd, fwd_plain, train, train_plain} ms}."""
    k = w.ln_g.shape[0]
    out = {}
    saved = fused_mlp.MIN_ROWS
    fused_mlp.MIN_ROWS = 0
    try:
        for rows in (4096, 16384, 65536):
            x, res, dy = (torch.randn((rows, k), generator=gen).to(dev, torch.bfloat16)
                          for _ in range(3))
            leaves = [x.clone().requires_grad_(), res.clone().requires_grad_()]
            wl = fused_mlp.MlpWeights(*(t.clone().requires_grad_() for t in w))

            def train(fn):
                for t in leaves + list(wl):
                    t.grad = None
                fn(*leaves, wl).backward(dy)

            with torch.inference_mode():
                fwd = ab_ms(torch, lambda: fused_mlp.fused_ln_mlp_res(x, res, w),
                            lambda: fused_mlp.fused_ln_mlp_res_ref(x, res, w), iters=10)
            tr = ab_ms(torch, lambda: train(fused_mlp.fused_ln_mlp_res),
                       lambda: train(fused_mlp.fused_ln_mlp_res_ref), iters=5)
            out[rows] = {"fwd_ms": fwd[0], "fwd_plain_ms": fwd[1], "train_ms": tr[0],
                         "train_plain_ms": tr[1]}
            log(9, f"K3b at {rows} rows vs the module path: forward {fwd[0]:.4f} / "
                   f"{fwd[1]:.4f} ms, training forward + backward {tr[0]:.4f} / {tr[1]:.4f} ms")
            del x, res, dy, leaves, wl
    finally:
        fused_mlp.MIN_ROWS = saved
    return out


def fused_mlp_core_part(torch, fused_mlp, x, dy, w, wbytes):
    """Phase 9, K3a: fc2(GELU(fc1(x))) with K3b's fc1 and fc2 weights on its
    x and dy; returns the K3a forward and backward entries."""
    from multimae_tpu_torch.ops.functional import assert_matches_twin

    (m, k), hid = x.shape, w.w1.shape[0]
    wc = fused_mlp.MlpCoreWeights(*w[2:])
    with torch.inference_mode():
        out = fused_mlp.fused_mlp(x, wc)
        torch.cuda.synchronize()
        fwd_err = assert_matches_twin(out, fused_mlp.fused_mlp_ref(x, wc), "K3a fwd")
    kern, again = fused_mlp.fused_mlp_bwd(x, dy, wc), fused_mlp.fused_mlp_bwd(x, dy, wc)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip([kern[0], *kern[1]], [again[0], *again[1]])):
        raise AssertionError("K3a bwd: two runs on the same inputs differ")
    plain = fused_mlp.fused_mlp_bwd_ref(x, dy, wc)
    names = ["dx"] + ["d" + f for f in fused_mlp.MlpCoreWeights._fields]
    errs = {n: assert_matches_twin(a, r, f"K3a bwd {n}", grad_of=torch.bfloat16)
            for n, a, r in zip(names, [kern[0], *kern[1]], [plain[0], *plain[1]])}
    del out, kern, again, plain
    with torch.inference_mode():
        fwd = ab_ms(torch, lambda: fused_mlp.fused_mlp(x, wc),
                    lambda: fused_mlp.fused_mlp_ref(x, wc), iters=10)
    bwd = ab_ms(torch, lambda: fused_mlp.fused_mlp_bwd(x, dy, wc),
                lambda: fused_mlp.fused_mlp_bwd_ref(x, dy, wc), iters=5)
    log(9, f"K3a ({m},{k}) hidden {hid} bf16: fwd max abs {fwd_err[0]:.3e}, rel RMS "
           f"{fwd_err[1]:.3e}; 5 gradients within GRAD_TOLERANCE, bit-equal over two runs "
           "(max abs / rel RMS: " + ", ".join(f"{n} {e[0]:.2e} / {e[1]:.2e}"
                                              for n, e in errs.items())
           + f"); kernel / twin fwd {fwd[0]:.4f} / {fwd[1]:.4f} ms, bwd {bwd[0]:.4f} / "
           f"{bwd[1]:.4f} ms")
    # In: x (and dy), the bf16 weights; out: y, or dx and the fp32 dW, db.
    # The backward's five GEMMs: fc1 recomputed, dW2, dh, dW1, dx.
    fwd_bound = bound(4 * m * k * hid, 2 * 2 * m * k + wbytes)
    bwd_bound = bound(10 * m * k * hid, 2 * 3 * m * k + wbytes + 4 * (2 * k * hid + k + hid))
    return [
        {"name": "fused_mlp_fwd", "route": "cuda",
         "source": "multimae_tpu_torch/csrc/fused_mlp_fwd.cu",
         "replaces": "multimae_tpu/ops/fused_mlp_pallas.py:169",
         "max_abs_err": fwd_err[0], "ms": fwd[0], "plain_ms": fwd[1],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1], "library_ms": None},
        {"name": "fused_mlp_bwd", "route": "cuda",
         "source": "multimae_tpu_torch/csrc/fused_mlp_bwd.cu",
         "replaces": "multimae_tpu/ops/fused_mlp_pallas.py:190",
         "max_abs_err": max(e[0] for e in errs.values()), "ms": bwd[0], "plain_ms": bwd[1],
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1], "library_ms": None},
    ]


def semseg_slice(torch, dev):
    """Phase 11; returns each kernel's launches over the STEPS steps and
    over the eval batch."""
    from multimae_tpu_torch.cli.factory import build_semseg_trainer, make_synthetic_semseg_batch
    from multimae_tpu_torch.cli.run_finetuning_semseg import seg_cross_entropy_parts
    from multimae_tpu_torch.train.finetune_step import make_dense_eval_step, make_dense_train_step
    from multimae_tpu_torch.utils.metrics import confusion_matrix, miou_from_confusion

    t0 = time.perf_counter()
    domains = ("rgb", "depth")
    state, step = build_semseg_trainer(batch_size=SEMSEG_BATCH, seed=0, device=dev)
    batch = make_synthetic_semseg_batch(SEMSEG_BATCH, num_classes=SEMSEG_CLASSES, seed=0,
                                        device=dev)
    plain_state = copy.deepcopy(state)
    plain_step = make_dense_train_step(plain_state.model, "semseg", seg_cross_entropy_parts,
                                       in_domains=domains)
    model = state.model
    drop_gen = torch.Generator(device=dev).manual_seed(11)
    first_draws = drop_gen.get_state()
    check_on_card(state, batch)
    n_params = sum(p.numel() for p in model.parameters())
    log(11, f"MultiViT-B + ConvNeXt head fine-tune state ({n_params} parameters, bf16, rgb + "
            f"depth at 512 px, {SEMSEG_CLASSES} classes, drop_path 0.1, AdamW with layer "
            f"decay 0.75) built in {time.perf_counter() - t0:.1f} s; batch {SEMSEG_BATCH}, "
            f"lr {state.lr_values[0]:.3e}")

    expect = dict.fromkeys(launch_counts(), 0)
    expect.update(short_attention_fwd=12, short_attention_bwd=12, fused_ln_mlp_res_fwd=4,
                  fused_ln_mlp_res_bwd=4)
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    history = []
    for i in range(STEPS):
        before = launch_counts()
        metrics = {k: float(v) for k, v in step(state, batch, generator=drop_gen).items()}
        per_step = {k: v - before[k] for k, v in launch_counts().items()}
        if per_step != expect:
            raise AssertionError(f"fine-tune step {i} launched {per_step}; expected {expect}")
        if not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"]:
            raise AssertionError(f"fine-tune step {i}: metrics {metrics}")
        if i == 0:
            check_on_card(state, batch)
            first_grads = {n: p.grad.float().clone() for n, p in model.named_parameters()
                           if p.grad is not None}
        history.append(metrics)
        log(11, f"step {i}: loss {metrics['loss']:.4f}, grad norm {metrics['grad_norm']:.4f}")
    torch.cuda.synchronize()
    step_launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if step_launches != {k: v * STEPS for k, v in expect.items()}:
        raise AssertionError(f"launch counts over {STEPS} fine-tune steps: {step_launches}")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError(f"the fine-tune loss did not fall: {history[0]['loss']} -> "
                             f"{history[-1]['loss']}")

    # The first step again, on the plain twins, from the same state and draws.
    plain_gen = torch.Generator(device=dev)
    plain_gen.set_state(first_draws)
    torch.cuda.reset_peak_memory_stats(dev)
    with plain_twins():
        plain = {k: float(v) for k, v in
                 plain_step(plain_state, batch, generator=plain_gen).items()}
    plain_peak = torch.cuda.max_memory_allocated(dev)
    loss_rel = abs(history[0]["loss"] - plain["loss"]) / abs(plain["loss"])
    norm_rel = abs(history[0]["grad_norm"] - plain["grad_norm"]) / abs(plain["grad_norm"])
    log(11, f"step 0 vs plain twins: loss {history[0]['loss']:.6f} / {plain['loss']:.6f} "
            f"(rel {loss_rel:.2e}, limit {SEMSEG_LOSS_TOLERANCE}), grad norm "
            f"{history[0]['grad_norm']:.6f} / {plain['grad_norm']:.6f} (rel {norm_rel:.2e}, "
            f"limit {SEMSEG_NORM_TOLERANCE})")
    if not (loss_rel <= SEMSEG_LOSS_TOLERANCE and norm_rel <= SEMSEG_NORM_TOLERANCE):
        raise AssertionError("the fine-tune step differs from the plain twins")
    plain_grads = {n: p.grad for n, p in plain_state.model.named_parameters()
                   if p.grad is not None}
    if set(plain_grads) != set(first_grads):
        raise AssertionError("the two paths give gradients to different parameters")
    rels = {n: rel_rms(first_grads[n], g) for n, g in plain_grads.items()}
    ranked = sorted(rels, key=rels.get, reverse=True)
    log(11, f"step 0: {len(rels)} parameter gradients vs plain twins, worst rel RMS "
            + ", ".join(f"{n} {rels[n]:.3e}" for n in ranked[:4])
            + f"; median {statistics.median(rels.values()):.3e} (limit {SEMSEG_GRAD_TOLERANCE})")
    bad = {n: r for n, r in rels.items() if not r <= SEMSEG_GRAD_TOLERANCE}
    if bad:
        raise AssertionError(f"fine-tune gradients differ from the plain twins: {bad}")
    del first_grads, plain_grads

    def plain_train_step():
        with plain_twins():
            plain_step(plain_state, batch, generator=plain_gen)

    ms, plain_ms = ab_ms(torch, lambda: step(state, batch, generator=drop_gen),
                         plain_train_step, iters=2, warmup=1, repeats=2)
    log(11, f"fine-tune step at batch {SEMSEG_BATCH}: {ms:.3f} ms "
            f"({SEMSEG_BATCH / ms * 1e3:.2f} samples/s) with the kernels, {plain_ms:.3f} ms "
            f"({SEMSEG_BATCH / plain_ms * 1e3:.2f} samples/s) on the plain twins; peak memory "
            f"{peak / 2**30:.2f} GiB with the kernels, {plain_peak / 2**30:.2f} GiB on the "
            "plain twins")
    del plain_state
    free_card(torch)

    # The eval step: K4 in every encoder block, K3b forward in the head.
    eval_step = make_dense_eval_step(model, "semseg", domains)
    reset_launch_counts()
    pred = eval_step(batch)
    torch.cuda.synchronize()
    eval_launches = launch_counts()
    expect_eval = dict.fromkeys(expect, 0)
    expect_eval.update(fused_block_infer=12, fused_ln_mlp_res_fwd=4)
    if eval_launches != expect_eval:
        raise AssertionError(f"the eval step launched {eval_launches}; expected {expect_eval}")
    shape = (SEMSEG_BATCH, 512, 512, SEMSEG_CLASSES)
    if tuple(pred.shape) != shape or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"eval pred {tuple(pred.shape)} not finite or not {shape}")
    with plain_twins():
        plain_pred = eval_step(batch)
    rel = rel_rms(pred, plain_pred)
    log(11, f"eval pred vs plain twins: rel RMS {rel:.3e} (limit {SLICE_TOLERANCE})")
    if not rel <= SLICE_TOLERANCE:
        raise AssertionError(f"the eval preds differ from the plain twins: {rel}")
    # Where the difference comes from: the encoder (K4) alone, and the head
    # (K3b) alone on the twins' encoder tokens.
    with torch.inference_mode():
        tokens, info = model.process_input({d: batch[d] for d in domains})
        enc = model.run_encoder(tokens)
        head = model.output_adapters["semseg"]
        with plain_twins():
            plain_enc = model.run_encoder(tokens)
            plain_head = head(plain_enc, info)
        log(11, f"eval encoder tokens vs plain twins: rel RMS {rel_rms(enc, plain_enc):.3e}; "
                f"head on the same tokens: rel RMS {rel_rms(head(plain_enc, info), plain_head):.3e}")
    del tokens, enc, plain_enc, plain_head
    target = batch["target"]
    cm = confusion_matrix(pred.argmax(-1), target, SEMSEG_CLASSES)
    counted, valid = int(cm.sum()), int((target != 255).sum())
    if counted != valid:
        raise AssertionError(f"the confusion matrix counts {counted} pixels, not {valid}")
    stats = miou_from_confusion(cm)

    def plain_eval():
        with plain_twins():
            eval_step(batch)

    eval_ms, plain_eval_ms = ab_ms(torch, lambda: eval_step(batch), plain_eval,
                                   iters=3, warmup=1, repeats=3)
    log(11, f"eval batch of {SEMSEG_BATCH}: {counted} of {target.numel()} pixels counted "
            f"(the rest ignored), mIoU {stats['mIoU']:.4f}, aAcc {stats['aAcc']:.4f} (random "
            f"weights, random targets); {eval_ms:.3f} ms with the kernels, {plain_eval_ms:.3f} "
            "ms on the plain twins")
    del pred, plain_pred
    free_card(torch)
    return step_launches, eval_launches



def loader_rate(dataset, transform, workers, batch, epochs):
    """Samples/s of the port's Loader over `dataset`, after its first batch
    (worker start-up excluded). Loader.close raises if a worker did not
    exit cleanly."""
    from multimae_tpu_torch.data.loader import Loader

    loader = Loader(dataset, transform, global_batch_size=batch, num_workers=workers)
    next(loader)
    n = epochs * loader.steps_per_epoch
    t0 = time.perf_counter()
    for _ in range(n):
        next(loader)
    rate = n * batch / (time.perf_counter() - t0)
    loader.close()
    return rate


def filter_line(counts):
    """The rows written per PNG filter type."""
    names = ("none", "sub", "up", "average", "paeth")
    return ", ".join(f"{n} {int(c)}" for n, c in zip(names, counts))


def steady_share(runs):
    """(data-wait share of the loader-fed steps, the same without each
    run's first step, which waits for the workers to start)."""
    fed = [r for run in runs for r in run["steps"]]
    steady = [r for run in runs for r in run["steps"][1:]]
    wait, steady_wait = (sum(r["wait_s"] for r in x) for x in (fed, steady))
    return (wait / (wait + sum(r["step_s"] for r in fed)),
            steady_wait / (steady_wait + sum(r["step_s"] for r in steady)))


def sample_split(dataset, transform, rgb_fn=None, count=None):
    """Where one loader process spends a sample: ms reading and decoding its
    PNGs, ms augmenting them, and (with `rgb_fn`, called on the decoded rgb
    image) ms in rgb_fn; means over `dataset`, or its first `count`
    samples. Also the augmented samples."""
    import random

    decode = augment = rgb = 0.0
    outs = []
    count = len(dataset) if count is None else min(count, len(dataset))
    for i in range(count):
        t0 = time.perf_counter()
        sample, _ = dataset.load_raw(i)
        t1 = time.perf_counter()
        outs.append(transform(sample, rng=random.Random(i)))
        t2 = time.perf_counter()
        if rgb_fn is not None:
            rgb_fn(sample["rgb"], random.Random(i))
        decode, augment, rgb = (decode + t1 - t0, augment + t2 - t1,
                                rgb + time.perf_counter() - t2)
    n = count / 1e3
    return decode / n, augment / n, rgb / n, outs


def check_twin_split(phase, what, native_outs, twin_outs):
    """Raise unless the native and twin paths gave the same arrays."""
    import numpy as np

    for i, (a, b) in enumerate(zip(native_outs, twin_outs)):
        for k in b:
            if a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
                raise AssertionError(f"[{phase}] {what}: sample {i} {k} differs between the "
                                     f"native library and the numpy twins")


def pretrain_data(root, twin):
    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder
    from multimae_tpu_torch.data.pretrain_transforms import DataAugmentationForMultiMAE

    return (MultiTaskImageFolder(root, ["depth", "rgb", "semseg"], twin=twin),
            DataAugmentationForMultiMAE(224, twin=twin))


def pretrain_loader_rate(root, workers, twin=False, epochs=4):
    """Phase 12's tree with the pretraining transform. A worker makes whole
    batches, so the batch of 8 gives each of CLI_WORKERS workers two per
    epoch."""
    return loader_rate(*pretrain_data(root, twin), workers, batch=8, epochs=epochs)


def pretrain_split(root):
    """Phase 12's per-sample split, native (every sample) and twin (the
    first TWIN_SAMPLES): {path: (decode ms, augment ms, rgb resample ms)};
    the two paths' outputs must agree."""
    from multimae_tpu_torch import native
    from multimae_tpu_torch.data import pretrain_transforms as T

    aug = T.DataAugmentationForMultiMAE(224)

    def rgb_resample(twin):
        def run(img, rng):
            crop = T.random_resized_crop_params(*img.shape[:2], rng=rng)
            if twin:
                T.crop_resize_normalize_twin(img, crop, 224, aug.rgb_mean, aug.rgb_std, False)
            else:
                native.crop_resize_normalize(img, crop, (224, 224), aug.rgb_mean, aug.rgb_std)
        return run

    splits, outs = {}, {}
    for twin, path in ((False, "native"), (True, "twin")):
        *splits[path], outs[path] = sample_split(*pretrain_data(root, twin), rgb_resample(twin),
                                                 count=TWIN_SAMPLES if twin else None)
    check_twin_split(12, "the pretraining transform", outs["native"], outs["twin"])
    return splits


def cli_slice(torch, dev, keep):
    """Phase 12; returns K1's launches over the CLI's first run. The newest
    checkpoint is moved to `keep`."""
    import shutil

    from multimae_tpu_torch.cli.run_pretraining_multimae import get_args, main
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    root = os.path.join(HERE, "build", "chip_smoke_cli")
    tree, out = os.path.join(root, "tree"), os.path.join(root, "out")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    counts = write_random_tree(tree, CLI_SAMPLES, CLI_HW, smooth=True)
    log(12, f"wrote {CLI_SAMPLES} photo-like samples at {CLI_HW[0]}x{CLI_HW[1]} (rgb, depth, "
            f"semseg PNG) in {time.perf_counter() - t0:.1f} s; rows per filter type: "
            f"{filter_line(counts)}")
    try:
        base = ["-c", os.path.join(HERE, CLI_YAML), "--batch_size", str(CLI_BATCH),
                "--warmup_epochs", "0", "--num_workers", str(CLI_WORKERS)]
        run = base + ["--data_path", tree, "--save_ckpt_freq", "1", "--output_dir", out]
        reset_launch_counts()
        first = main(get_args(run + ["--epochs", "2"]))
        launches = launch_counts()
        steps = len(first["steps"])
        expect = dict.fromkeys(launches, 0)
        expect.update(fused_decoder_fwd=4 * steps, fused_decoder_bwd=4 * steps)
        if steps != 4 or launches != expect:
            raise AssertionError(f"CLI run: {steps} steps, launches {launches}; expected 4 "
                                 f"steps and {expect}")
        losses = [r["metrics"]["loss"] for r in first["steps"]]
        if not all(math.isfinite(v) for r in first["steps"] for v in r["metrics"].values()):
            raise AssertionError(f"CLI run: metrics {[r['metrics'] for r in first['steps']]}")
        with open(os.path.join(out, "log.txt")) as f:
            lines = f.read().splitlines()
        saves = [os.path.join(out, f"checkpoint-{e}.pth") for e in (0, 1)]
        if len(lines) != 2 or not all(os.path.exists(p) for p in saves):
            raise AssertionError(f"CLI run: {len(lines)} log lines, {os.listdir(out)}")
        log(12, "CLI run: losses " + ", ".join(f"{v:.4f}" for v in losses) + f"; K1 fwd "
                f"{launches['fused_decoder_fwd']}, bwd {launches['fused_decoder_bwd']} "
                f"launches over {steps} steps; log.txt 2 lines; checkpoint-0.pth and "
                f"checkpoint-1.pth ({os.path.getsize(saves[1]) / 2**30:.2f} GiB); saved in "
                + ", ".join(f"{t:.2f}" for t in first["save_s"]) + " s")

        synthetic = main(get_args(base + ["--synthetic_data", "--synthetic_steps_per_epoch",
                                          "6", "--epochs", "1", "--no_auto_resume"]))
        fed = first["steps"]
        step_ms = statistics.median(r["step_s"] for r in fed) * 1e3
        synth_ms = statistics.median(r["step_s"] for r in synthetic["steps"][1:]) * 1e3
        wait = sum(r["wait_s"] for r in first["steps"])
        share, steady = steady_share([first])
        # The native loader's rates only: the per-sample split below holds
        # the numpy twins' arrays equal to the native ones and times them.
        rates = (pretrain_loader_rate(tree, 0, epochs=4),
                 pretrain_loader_rate(tree, CLI_WORKERS))
        split = pretrain_split(tree)
        (one, many) = rates
        for path in ("native", "twin"):
            dec, aug, rgb = split[path]
            log(12, f"per sample ({path}; 256x320 PNG -> 224): {dec:.2f} ms decoding its 3 "
                    f"PNGs and {aug:.2f} ms augmenting; the rgb resample alone {rgb:.3f} ms")
        log(12, f"loader over the tree (native, batches of 8): {one:.1f} samples/s in one "
                f"process, {many:.1f} samples/s with {CLI_WORKERS} workers "
                f"({many / CLI_WORKERS:.1f} per worker)")
        log(12, f"the native and twin transforms gave the same arrays on the first "
                f"{TWIN_SAMPLES} samples; rgb resample {split['twin'][2] / split['native'][2]:.1f}x "
                f"faster native")
        log(12, f"CLI step at batch {CLI_BATCH}: {step_ms:.3f} ms fed by the loader (median "
                f"of {len(fed)}), {synth_ms:.3f} ms on synthetic batches (median of "
                f"{len(synthetic['steps']) - 1}); data wait {wait * 1e3:.1f} ms in all, "
                f"{share:.4f} of the loader-fed steps' time; {steady:.4f} without "
                f"each run's first step (worker start-up)")
        os.makedirs(os.path.dirname(keep), exist_ok=True)
        os.replace(saves[1], keep)
        return launches, {"cli_step_ms": step_ms, "cli_synthetic_step_ms": synth_ms,
                          "cli_data_wait_share": share, "cli_data_wait_share_steady": steady,
                          "loader_samples_per_s": one, "loader_samples_per_s_workers": many,
                          "decode_ms_per_sample": split["native"][0],
                          "augment_ms_per_sample": split["native"][1],
                          "rgb_resample_ms": split["native"][2],
                          "twin_decode_ms_per_sample": split["twin"][0],
                          "twin_augment_ms_per_sample": split["twin"][1],
                          "twin_rgb_resample_ms": split["twin"][2],
                          "tree_rows_per_filter": [int(c) for c in counts],
                          "ckpt_save_s": first["save_s"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def jpeg_fixture_check(card):
    """Every committed JPEG fixture (tests/fixtures/jpeg/) through the native
    library this machine's g++ built: the SHA-256 of its pixels must equal
    expected.json's (PIL's decode where the fixtures were written), and the
    file the decoder must refuse raises naming what expected.json says.
    Returns ms per decode of each 500 x 375 photo, on this host."""
    import hashlib

    from multimae_tpu_torch import native

    with open(os.path.join(JPEG_FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    t0 = time.perf_counter()
    native.lib()
    ready_s = time.perf_counter() - t0
    refused = []
    for name, want in sorted(expected.items()):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            data = f.read()
        if "error" in want:
            try:
                native.decode_jpeg(data)
            except ValueError as e:
                if want["error"] not in str(e):
                    raise AssertionError(f"[12] {name}: {e}; expected an error naming "
                                         f"{want['error']!r}") from e
                refused.append(name)
                continue
            raise AssertionError(f"[12] {name} decoded; expected an error naming "
                                 f"{want['error']!r}")
        rgb = native.decode_jpeg(data)
        digest = hashlib.sha256(rgb.tobytes()).hexdigest()
        if list(rgb.shape) != want["shape"] or digest != want["sha256"]:
            raise AssertionError(f"[12] {name}: {rgb.shape} sha256 {digest}; expected "
                                 f"{want['shape']} {want['sha256']}")
    log(12, f"JPEG fixtures: {len(expected) - len(refused)} files decode to the SHA-256 of "
            f"expected.json (PIL's decode), {', '.join(refused)} refused as expected; native "
            f"library ready in {ready_s:.2f} s "
            f"({'built now' if native.BUILD_SECONDS is not None else 'cached build'}; card "
            f"{card})")
    ms = {}
    for name in sorted(n for n in expected if n.startswith("photo_")):
        with open(os.path.join(JPEG_FIXTURES, name), "rb") as f:
            data = f.read()
        native.decode_jpeg(data)
        t0 = time.perf_counter()
        for _ in range(JPEG_TIMED_FILES):
            native.decode_jpeg(data)
        ms[name] = (time.perf_counter() - t0) / JPEG_TIMED_FILES * 1e3
    log(12, "JPEG decode, ms per 500x375 file on this host (one thread; card " + card + "): "
            + ", ".join(f"{n} {v:.3f}" for n, v in ms.items()))
    rates = {threads: jpeg_threads_rate(native, os.path.join(JPEG_FIXTURES, "photo_420_q90.jpg"),
                                        threads) for threads in (1, CLI_WORKERS)}
    log(12, f"JPEG decode of photo_420_q90.jpg in threads (the call drops the GIL): "
            f"{rates[1]:.1f} files/s in one, {rates[CLI_WORKERS]:.1f} in {CLI_WORKERS} "
            f"({rates[CLI_WORKERS] / rates[1]:.2f}x; card {card})")
    return ms, rates


def jpeg_threads_rate(native, path, threads):
    """Files/s decoding `path` JPEG_TIMED_FILES times in each of `threads`
    threads at once."""
    from concurrent.futures import ThreadPoolExecutor

    with open(path, "rb") as f:
        data = f.read()

    def work(_):
        for _ in range(JPEG_TIMED_FILES):
            native.decode_jpeg(data)

    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(work, range(threads)))  # warm the threads
        t0 = time.perf_counter()
        list(pool.map(work, range(threads)))
        return threads * JPEG_TIMED_FILES / (time.perf_counter() - t0)


def jpeg_cli_slice(card):
    """Phase 12's run of the pretraining CLI over an ImageNet-layout tree
    whose rgb images are JPEG files; returns K1's launches and its numbers."""
    import shutil

    from multimae_tpu_torch.cli.run_pretraining_multimae import get_args, main
    from multimae_tpu_torch.data.dataset_folder import write_random_tree
    from multimae_tpu_torch.data.image_io import load_image

    root = os.path.join(HERE, "build", "chip_smoke_jpeg")
    tree = os.path.join(root, "tree")
    shutil.rmtree(root, ignore_errors=True)
    photos = sorted(os.path.join(JPEG_FIXTURES, n) for n in os.listdir(JPEG_FIXTURES)
                    if n.startswith("photo_"))
    t0 = time.perf_counter()
    write_random_tree(tree, CLI_SAMPLES, JPEG_HW, smooth=True, rgb_files=photos)
    log(12, f"JPEG tree: {CLI_SAMPLES} samples at {JPEG_HW[0]}x{JPEG_HW[1]}, rgb the "
            f"{len(photos)} photo fixtures as .jpg, depth and semseg PNG written in "
            f"{time.perf_counter() - t0:.1f} s (card {card})")
    try:
        reset_launch_counts()
        run = main(get_args([
            "-c", os.path.join(HERE, CLI_YAML), "--batch_size", str(CLI_BATCH),
            "--warmup_epochs", "0", "--num_workers", "0", "--data_path", tree,
            "--output_dir", "", "--epochs", "1", "--no_auto_resume"]))
        launches = launch_counts()
        steps = len(run["steps"])
        expect = dict.fromkeys(launches, 0)
        expect.update(fused_decoder_fwd=4 * steps, fused_decoder_bwd=4 * steps)
        if steps != CLI_SAMPLES // CLI_BATCH or launches != expect:
            raise AssertionError(f"JPEG-tree CLI run: {steps} steps, launches {launches}; "
                                 f"expected {CLI_SAMPLES // CLI_BATCH} steps and {expect}")
        if not all(math.isfinite(v) for r in run["steps"] for v in r["metrics"].values()):
            raise AssertionError(f"JPEG-tree CLI run: metrics "
                                 f"{[r['metrics'] for r in run['steps']]}")
        log(12, "JPEG-tree CLI run: losses " + ", ".join(
            f"{r['metrics']['loss']:.4f}" for r in run["steps"]) + f"; K1 fwd "
            f"{launches['fused_decoder_fwd']}, bwd {launches['fused_decoder_bwd']} launches "
            f"over {steps} steps, nothing else launched")
        one = pretrain_loader_rate(tree, 0, epochs=2)
        many = pretrain_loader_rate(tree, CLI_WORKERS)
        dataset, transform = pretrain_data(tree, twin=False)
        paths = [p for p, _ in dataset.samples["rgb"]]
        t0 = time.perf_counter()
        for p in paths:
            load_image(p)
        jpeg_ms = (time.perf_counter() - t0) / len(paths) * 1e3
        decode_ms, augment_ms, _, _ = sample_split(dataset, transform)
        step_ms = statistics.median(r["step_s"] for r in run["steps"]) * 1e3
        log(12, f"loader over the JPEG tree (500x375 .jpg + 2 PNGs -> 224, batches of 8; card "
                f"{card}): {one:.1f} samples/s in one process, {many:.1f} samples/s with "
                f"{CLI_WORKERS} workers; one process spends {jpeg_ms:.3f} ms per sample "
                f"decoding its JPEG ({decode_ms:.3f} ms on all 3 files) and {augment_ms:.3f} "
                f"ms augmenting; CLI step {step_ms:.3f} ms (median of {steps})")
        return launches, {"jpeg_losses": [r["metrics"]["loss"] for r in run["steps"]],
                "jpeg_loader_samples_per_s": one, "jpeg_loader_samples_per_s_workers": many,
                "jpeg_decode_ms_per_sample": jpeg_ms, "jpeg_tree_decode_ms_per_sample": decode_ms,
                "jpeg_tree_augment_ms_per_sample": augment_ms, "jpeg_cli_step_ms": step_ms}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def k4_at(torch, fused_block, w4, n, gen, dev, b=SEMSEG_BATCH):
    """K4 against its twin at (b, n, D) with w4's width D (heads of 64),
    bit-equal over two runs: max abs error, rel RMS, kernel and twin ms,
    bound."""
    from multimae_tpu_torch.ops.functional import assert_matches_twin

    d, hidden = w4.n1_g.shape[0], w4.w1.shape[0]
    heads = d // 64
    x = torch.randn((b, n, d), generator=gen).to(dev, torch.bfloat16)
    with torch.inference_mode():
        out = fused_block.fused_block_infer(x, w4, heads)
        again = fused_block.fused_block_infer(x, w4, heads)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"K4 at ({b},{n},{d}): two runs on the same inputs differ")
        err, rel = assert_matches_twin(out, fused_block.block_infer_ref(x, w4, heads),
                                       f"K4 fused_block_infer at ({b},{n},{d})")
        del again
        ms, plain_ms = ab_ms(torch, lambda: fused_block.fused_block_infer(x, w4, heads),
                             lambda: fused_block.block_infer_ref(x, w4, heads), iters=10)
    flops, weights = block_work(b, n, d, hidden)
    return err, rel, ms, plain_ms, bound(flops, 2 * (2 * b * n * d + weights))


# K4's library yardstick (phase 3): every shape of PERF.md's K4 rows.
K4_LIBRARY_SHAPES = ((32, 99, 768), (4, 2049, 768), (4, 1025, 768), (4, 1174, 768),
                     (128, 197, 768), (8, 577, 768), (256, 197, 1024), (16, 2049, 1024))


def k4_library(torch, fused_block, gen, dev, card):
    """K4's library yardstick at each of K4_LIBRARY_SHAPES: PyTorch's
    nn.TransformerEncoderLayer (pre-LN, erf GELU, eps 1e-6, batch first,
    no dropout) holding K4's weights, in bf16, in eval under
    inference_mode, where PyTorch runs the block as one call
    (aten::_transformer_encoder_layer_fwd, seen with torch.profiler); its
    output held within TWIN_TOLERANCE of K4's plain twin, timed with K4 in
    turns. Returns {"b,n,d": numbers}; where the fast path did not run,
    "refused" says why (its module time is then no library call's)."""
    from torch.profiler import ProfilerActivity, profile

    from multimae_tpu_torch.ops.functional import assert_matches_twin

    out, weights = {}, {}
    for b, n, d in K4_LIBRARY_SHAPES:
        heads, hidden = d // 64, 4 * d
        if d not in weights:
            weights = {d: rand_block_weights(torch, fused_block, d, hidden, gen, dev)}
        w = weights[d]
        layer = torch.nn.TransformerEncoderLayer(d, heads, hidden, dropout=0.0, activation="gelu",
                                                 layer_norm_eps=1e-6, batch_first=True,
                                                 norm_first=True)
        with torch.no_grad():
            for dst, src in ((layer.self_attn.in_proj_weight, w.wqkv),
                             (layer.self_attn.in_proj_bias, w.bqkv),
                             (layer.self_attn.out_proj.weight, w.wp),
                             (layer.self_attn.out_proj.bias, w.bp), (layer.linear1.weight, w.w1),
                             (layer.linear1.bias, w.b1), (layer.linear2.weight, w.w2),
                             (layer.linear2.bias, w.b2), (layer.norm1.weight, w.n1_g),
                             (layer.norm1.bias, w.n1_b), (layer.norm2.weight, w.n2_g),
                             (layer.norm2.bias, w.n2_b)):
                dst.copy_(src)
        layer = layer.to(dev, torch.bfloat16).eval()
        x = torch.randn((b, n, d), generator=gen).to(dev, torch.bfloat16)
        with torch.inference_mode():
            lib = layer(x)
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                layer(x)
                torch.cuda.synchronize()
            ops = {e.name for e in prof.events()}
            fast = "aten::_transformer_encoder_layer_fwd" in ops
            err, rel = assert_matches_twin(lib, fused_block.block_infer_ref(x, w, heads),
                                           f"nn.TransformerEncoderLayer at ({b},{n},{d})")
            ms, lib_ms = ab_ms(torch, lambda: fused_block.fused_block_infer(x, w, heads),
                               lambda: layer(x), iters=5, repeats=3)
        refused = None if fast else ("aten::_transformer_encoder_layer_fwd not called; ops: "
                                     + ", ".join(sorted(o for o in ops if "transformer" in o
                                                        or "attention" in o)))
        out[f"{b},{n},{d}"] = {"ms": ms, "library_ms": lib_ms, "max_abs_err": err, "rel": rel,
                               "refused": refused}
        log(3, f"K4 library yardstick ({b},{n},{d}), {heads} heads: nn.TransformerEncoderLayer "
               + ("in one call (aten::_transformer_encoder_layer_fwd)" if fast
                  else f"off its fast path ({refused})")
               + f", vs K4's twin max abs {err:.3e}, rel RMS {rel:.3e}; K4 {ms:.4f} ms, library "
               f"{lib_ms:.4f} ms (card {card})")
        del layer, x, lib
        free_card(torch)
    return out


def semseg_data(root, twin=False):
    """The NYU tree with the fine-tune's training transform (512 px)."""
    from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder
    from multimae_tpu_torch.data.semseg_transforms import (
        DataAugmentationForSemSeg, SimpleTransform)

    return (MultiTaskImageFolder(root, ["depth", "rgb", "semseg", "mask_valid"], twin=twin),
            DataAugmentationForSemSeg(SimpleTransform(True, 512, twin=twin),
                                      seg_num_classes=SEMSEG_CLASSES))


def ft_sample_split(root):
    """Where one loader process spends a sample of the NYU tree, native and
    twin: {path: (ms reading and decoding its four PNGs, ms augmenting them
    with the fine-tune's training transform at 512 px)}, means over the
    tree's first TWIN_SAMPLES; the two paths' outputs must agree."""
    splits, outs = {}, {}
    for twin, path in ((False, "native"), (True, "twin")):
        dec, aug, _, outs[path] = sample_split(*semseg_data(root, twin), count=TWIN_SAMPLES)
        splits[path] = (dec, aug)
    check_twin_split(13, "the semseg training transform", outs["native"], outs["twin"])
    return splits


def check_run(name, summary, steps, evals, images):
    """Raise unless the run took `steps` steps and `evals` evaluations over
    `images` images each, with finite losses and 0 <= mIoU <= 1."""
    losses = [r["metrics"]["loss"] for r in summary["steps"]]
    mious = [e["mIoU"] for e in summary["evals"]]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: losses {losses}; expected {steps} finite")
    if len(mious) != evals or not all(0.0 <= v <= 1.0 for v in mious):
        raise AssertionError(f"{name}: mIoU {mious}; expected {evals} in [0, 1]")
    if any(e["images"] != images for e in summary["evals"]):
        raise AssertionError(f"{name}: evaluated {[e['images'] for e in summary['evals']]} "
                             f"images; expected {images} each")
    return losses, mious


def split_launches(name, launches, steps, evals, eval_run, eval_batches, images,
                   check=check_run):
    """({kernel: launches per training step}, {kernel: launches per eval
    batch}) of a CLI run that counted `launches` over `steps` steps and
    `evals` evals. `eval_run` is the summary of an --eval run of the same
    recipe, made with the counts set to 0 just before it and read here
    (and checked by `check`); the steps take what the evals leave."""
    per_eval_run = launch_counts()
    if ([e["batches"] for e in eval_run["evals"]], eval_run["steps"]) != ([eval_batches], []):
        raise AssertionError(f"{name}: the --eval run took {eval_run['evals']} and "
                             f"{len(eval_run['steps'])} steps")
    check(f"{name} --eval", eval_run, 0, 1, images)
    per_step, per_eval = {}, {}
    for k, n in launches.items():
        per_eval[k], rest = divmod(per_eval_run[k], eval_batches)
        per_step[k], rest_step = divmod(n - evals * per_eval_run[k], steps)
        if rest or rest_step or per_step[k] < 0:
            raise AssertionError(f"{name}: {k} launched {n} times over {steps} steps and "
                                 f"{evals} evals, {per_eval_run[k]} in an eval of "
                                 f"{eval_batches} batches: not a whole count per step")
    return per_step, per_eval


def ft_cli_slice(torch, dev, pretrain):
    """Phase 13; returns ({kernel: launches per training step}, {kernel:
    launches per eval batch}) of the NYU run and the numbers it prints."""
    import shutil

    from multimae_tpu_torch.cli.run_finetuning_semseg import get_args, main
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    root = os.path.join(HERE, "build", "chip_smoke_ft")
    train, val = os.path.join(root, "train"), os.path.join(root, "val")
    out = os.path.join(root, "out")
    t0 = time.perf_counter()
    nyu = dict(semseg_classes=SEMSEG_CLASSES, ignore_patches=True, mask_valid=True, smooth=True)
    counts = (write_random_tree(train, FT_TRAIN, FT_HW, **nyu)
              + write_random_tree(val, FT_VAL, FT_HW, seed=1, **nyu))
    log(13, f"wrote {FT_TRAIN} + {FT_VAL} photo-like NYUv2-shaped samples at "
            f"{FT_HW[1]}x{FT_HW[0]} (rgb, 16-bit depth, {SEMSEG_CLASSES}-class semseg with 255 "
            f"patches, mask_valid PNG) in {time.perf_counter() - t0:.1f} s; rows per filter "
            f"type: {filter_line(counts)}")
    try:
        base = ["-c", os.path.join(HERE, FT_YAML), "--finetune", pretrain,
                "--save_ckpt_freq", "1", "--num_workers", str(CLI_WORKERS),
                "--data_path", train, "--eval_data_path", val]
        steps_per_epoch, eval_batches = FT_TRAIN // SEMSEG_BATCH, math.ceil(FT_VAL / SEMSEG_BATCH)
        reset_launch_counts()
        first = main(get_args(base + ["--output_dir", out, "--epochs", "1"]))
        launches = launch_counts()
        losses, mious = check_run("run A", first, steps_per_epoch, 1, FT_VAL)
        reset_launch_counts()
        evaluated = main(get_args(base + ["--output_dir", out, "--eval", "--resume",
                                          os.path.join(out, "checkpoint-0.pth"),
                                          "--num_workers", "0"]))
        per_step, per_eval = split_launches("run A", launches, len(losses), 1, evaluated,
                                            eval_batches, FT_VAL)
        expect_step = dict.fromkeys(launches, 0)
        expect_step.update(short_attention_fwd=12, short_attention_bwd=12,
                           fused_ln_mlp_res_fwd=4, fused_ln_mlp_res_bwd=4)
        expect_eval = dict.fromkeys(launches, 0)
        expect_eval.update(fused_block_infer=12, fused_ln_mlp_res_fwd=4)
        if (per_step, per_eval) != (expect_step, expect_eval):
            raise AssertionError(f"run A: launches {per_step} per step and {per_eval} per "
                                 f"eval batch; expected {expect_step} and {expect_eval}")
        report = first["finetune"]
        missing, unexpected = report["missing"], report["unexpected"]
        if (any(not k.startswith("output_adapters.semseg.") for k in missing)
                or any(k.startswith("encoder.") or "pos_emb" in k and k.startswith(
                    ("input_adapters.rgb", "input_adapters.depth")) for k in unexpected)):
            raise AssertionError(f"fine-tune start: missing {missing}, unexpected "
                                 f"{unexpected[:20]}")
        saves = [os.path.join(out, f"checkpoint-{e}.pth") for e in ("0", "best")]
        with open(os.path.join(out, "log.txt")) as f:
            lines = f.read().splitlines()
        if len(lines) != 1 or not all(os.path.exists(p) for p in saves):
            raise AssertionError(f"run A: {len(lines)} log lines, {os.listdir(out)}")
        log(13, f"fine-tune start from {os.path.basename(pretrain)}: {len(missing)} missing "
                f"(the head's), {len(unexpected)} unexpected (the pretraining decoders and "
                f"the semseg input adapter), rgb and depth pos-embs 14x14 -> 32x32")
        log(13, "run A: losses " + ", ".join(f"{v:.4f}" for v in losses) + "; mIoU "
                + ", ".join(f"{v:.4f}" for v in mious) + f" over {FT_VAL} images each; "
                f"per training step K2 fwd {per_step['short_attention_fwd']}, bwd "
                f"{per_step['short_attention_bwd']}, K3b fwd {per_step['fused_ln_mlp_res_fwd']}"
                f", bwd {per_step['fused_ln_mlp_res_bwd']}; per eval batch K4 "
                f"{per_eval['fused_block_infer']}, K3b fwd {per_eval['fused_ln_mlp_res_fwd']} "
                f"(measured: totals {launches} over {len(losses)} steps and an eval, an "
                f"--eval run over {eval_batches} batches); "
                f"checkpoint-0, -best.pth saved in "
                + ", ".join(f"{t:.2f}" for t in first["save_s"]) + " s")

        # No resume runs here: the semseg, depth and Taskonomy CLIs share
        # cli/finetune_loop.py, and phases 15 and 16 resume through it (from
        # the newest save, and from checkpoint-0.pth alone).
        fed = first["steps"]
        step_ms = statistics.median(r["step_s"] for r in fed) * 1e3
        wait = sum(r["wait_s"] for r in fed)
        share, steady = steady_share([first])
        evals = first["evals"]
        eval_ms = statistics.median(e["ms_per_batch"] for e in evals)
        eval_data_ms = statistics.median(e["ms_per_batch_with_data"] for e in evals)
        # No loader rates over this tree: phases 12 and 14-16 time theirs.
        dec, aug = ft_sample_split(train)["native"]
        log(13, f"one loader process over the NYU tree's first {TWIN_SAMPLES} samples: "
                f"{dec:.2f} ms per sample decoding its 4 PNGs, {aug:.2f} ms augmenting "
                f"(640x480 -> 512 crops); the native and twin transforms gave the same arrays")
        log(13, f"CLI step at batch {SEMSEG_BATCH} fed by the loader: {step_ms:.3f} ms host "
                f"(median of {len(fed)}); data wait {wait * 1e3:.1f} ms in all, {share:.4f} of "
                f"the steps' time, {steady:.4f} without the run's first step; eval "
                f"{eval_ms:.3f} ms per batch on the card ({eval_data_ms:.3f} with the data)")
        numbers = {"ft_step_ms": step_ms, "ft_data_wait_share": share,
                   "ft_data_wait_share_steady": steady,
                   "ft_eval_ms_per_batch": eval_ms,
                   "ft_eval_ms_per_batch_with_data": eval_data_ms,
                   "ft_decode_ms_per_sample": dec, "ft_augment_ms_per_sample": aug,
                   "ft_tree_rows_per_filter": [int(c) for c in counts],
                   "ft_ckpt_save_s": first["save_s"],
                   "ft_missing": len(missing), "ft_unexpected": len(unexpected),
                   "ft_losses": losses, "ft_mIoU": mious}
        shutil.rmtree(out)
        free_card(torch)

        # The Segmenter head under the ADE recipe.
        ade = os.path.join(root, "ade")
        write_random_tree(os.path.join(ade, "train"), ADE_TRAIN, ADE_HW, seed=2,
                          semseg_classes=151, smooth=True)
        write_random_tree(os.path.join(ade, "val"), FT_VAL, ADE_HW, seed=3, semseg_classes=151,
                          smooth=True)
        seg_args = [
            "-c", os.path.join(HERE, ADE_YAML), "--finetune", pretrain,
            "--output_adapter", "segmenter", "--decoder_dim", "768", "--decoder_depth", "2",
            "--epochs", "1", "--num_workers", str(CLI_WORKERS),
            "--data_path", os.path.join(ade, "train"), "--eval_data_path",
            os.path.join(ade, "val"), "--output_dir", os.path.join(ade, "out")]
        reset_launch_counts()
        seg = main(get_args(seg_args))
        seg_launches = launch_counts()
        seg_losses, seg_miou = check_run("run D", seg, ADE_TRAIN // SEMSEG_BATCH, 1, FT_VAL)
        reset_launch_counts()
        evaluated = main(get_args(seg_args + ["--eval", "--num_workers", "0"]))
        seg_step, seg_eval = split_launches("run D", seg_launches, len(seg_losses), 1,
                                            evaluated, eval_batches, FT_VAL)
        expect_step = dict.fromkeys(seg_launches, 0)
        expect_step.update(short_attention_fwd=14, short_attention_bwd=14)
        expect_eval = dict.fromkeys(seg_launches, 0)
        expect_eval.update(fused_block_infer=14)
        if (seg_step, seg_eval) != (expect_step, expect_eval):
            raise AssertionError(f"run D: launches {seg_step} per step and {seg_eval} per "
                                 f"eval batch; expected {expect_step} and {expect_eval}")
        log(13, f"run D (Segmenter, ADE recipe, rgb, 150 classes): losses "
                + ", ".join(f"{v:.4f}" for v in seg_losses) + f", mIoU {seg_miou[0]:.4f}; K2 "
                f"fwd {seg_step['short_attention_fwd']} and bwd "
                f"{seg_step['short_attention_bwd']} per step (12 encoder blocks at 1025 keys, "
                f"2 head blocks at 1174), K4 {seg_eval['fused_block_infer']} per eval batch "
                f"(measured as in run A); eval {seg['evals'][0]['ms_per_batch']:.3f} ms "
                f"per batch")
        numbers.update(seg_losses=seg_losses, seg_mIoU=seg_miou[0],
                       seg_eval_ms_per_batch=seg["evals"][0]["ms_per_batch"],
                       seg_step_ms=statistics.median(r["step_s"] for r in seg["steps"]) * 1e3)
        free_card(torch)

        # Run E: the DPT semseg head (--output_adapter dpt) under the NYU
        # recipe for one epoch, and its --eval run.
        dpt_args = base + ["--output_dir", os.path.join(root, "out_dpt"), "--epochs", "1",
                           "--output_adapter", "dpt"]
        reset_launch_counts()
        dpt = main(get_args(dpt_args))
        dpt_launches = launch_counts()
        dpt_losses, dpt_miou = check_run("run E", dpt, steps_per_epoch, 1, FT_VAL)
        reset_launch_counts()
        evaluated = main(get_args(dpt_args + ["--eval", "--num_workers", "0"]))
        dpt_step, dpt_eval = split_launches("run E", dpt_launches, len(dpt_losses), 1,
                                            evaluated, eval_batches, FT_VAL)
        expect_step = dict(dict.fromkeys(dpt_launches, 0), short_attention_fwd=12,
                           short_attention_bwd=12)
        expect_eval = dict(dict.fromkeys(dpt_launches, 0), fused_block_infer=12)
        if (dpt_step, dpt_eval) != (expect_step, expect_eval):
            raise AssertionError(f"run E: launches {dpt_step} per step and {dpt_eval} per "
                                 f"eval batch; expected {expect_step} and {expect_eval}")
        dpt_ms = statistics.median(r["step_s"] for r in dpt["steps"]) * 1e3
        log(13, f"run E (--output_adapter dpt, NYU recipe, 512 px, batch {SEMSEG_BATCH}): "
                "losses " + ", ".join(f"{v:.4f}" for v in dpt_losses) + f", mIoU "
                f"{dpt_miou[0]:.4f}; K2 fwd {dpt_step['short_attention_fwd']} and bwd "
                f"{dpt_step['short_attention_bwd']} per step, K4 {dpt_eval['fused_block_infer']}"
                f" per eval batch, nothing else (measured as in run A); step {dpt_ms:.3f} ms "
                f"host (median of {len(dpt_losses)}), eval {dpt['evals'][0]['ms_per_batch']:.3f}"
                f" ms per batch")
        numbers.update(dpt_losses=dpt_losses, dpt_mIoU=dpt_miou[0], dpt_step_ms=dpt_ms,
                       dpt_eval_ms_per_batch=dpt["evals"][0]["ms_per_batch"],
                       dpt_step_launches=dpt_step, dpt_eval_launches=dpt_eval)
        return per_step, per_eval, numbers
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_card(torch)



def cls_data(root, twin=False):
    """An ImageNet-layout folder with the cls recipe's training transform."""
    from multimae_tpu_torch.data.cls_transforms import ClsTrainTransform, ImageRecord
    from multimae_tpu_torch.data.dataset_folder import ImageFolder

    return ImageFolder(root), ImageRecord(ClsTrainTransform(224, twin=twin))


def cls_sample_split(root):
    """Where one loader process spends a sample of the cls tree, native and
    twin: {path: (ms reading and decoding its JPEG, ms augmenting it with
    the recipe's training transform, of which ms in RandAugment)}, means
    over the folder (the twins': its first TWIN_SAMPLES); the two paths'
    outputs must agree."""
    import random

    splits, outs = {}, {}
    for twin, path in ((False, "native"), (True, "twin")):
        dataset, record = cls_data(root, twin)
        bare = copy.copy(record.transform)
        bare.aa = None
        decode = augment = without = 0.0
        outs[path] = []
        count = min(TWIN_SAMPLES, len(dataset)) if twin else len(dataset)
        for i in range(count):
            t0 = time.perf_counter()
            img, _ = dataset.load_raw(i)
            t1 = time.perf_counter()
            outs[path].append(record(img, random.Random(i)))
            t2 = time.perf_counter()
            bare(img, random.Random(i))
            decode, augment, without = (decode + t1 - t0, augment + t2 - t1,
                                        without + time.perf_counter() - t2)
        n = count / 1e3
        splits[path] = (decode / n, augment / n, (augment - without) / n)
    check_twin_split(14, "the cls training transform", outs["native"], outs["twin"])
    return splits


def check_cls_run(name, summary, steps, evals, images):
    """Raise unless the run took `steps` steps and `evals` evaluations over
    `images` images each, with finite losses and 0 <= top-1 <= top-5 <= 100."""
    losses = [r["metrics"]["loss"] for r in summary["steps"]]
    accs = [(e["acc1"], e["acc5"]) for e in summary["evals"]]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: losses {losses}; expected {steps} finite")
    if len(accs) != evals or not all(0.0 <= a <= b <= 100.0 for a, b in accs):
        raise AssertionError(f"{name}: top-1/5 {accs}; expected {evals} in order in [0, 100]")
    if any(e["images"] != images for e in summary["evals"]):
        raise AssertionError(f"{name}: evaluated {[e['images'] for e in summary['evals']]} "
                             f"images; expected {images} each")
    return losses, accs


def cls_attention_phase(torch, dev, card):
    """K2 against the module path at the cls recipe's 197 keys, (CLS_BATCH,
    197, 12, 64) bf16: the path the gate (SHORT_KERNEL_MIN_KV = 512) sends
    training to today, forward and forward + backward."""
    from multimae_tpu_torch.ops import attention
    from multimae_tpu_torch.ops import short_attention as sa
    from multimae_tpu_torch.ops.functional import assert_matches_twin

    b, n, h, dh = CLS_BATCH, 197, 12, 64
    scale = dh ** -0.5
    gen = torch.Generator().manual_seed(14)
    qkv = torch.randn((b, n, 3, h, dh), generator=gen).to(dev, torch.bfloat16)
    g = torch.randn((b, n, h, dh), generator=gen).to(dev, torch.bfloat16)
    q, k, v = (t.contiguous() for t in qkv.unbind(2))
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    with torch.no_grad():
        err, rel = assert_matches_twin(sa.short_attention(q, k, v, scale),
                                       attention.einsum_attention_bnhd(q, k, v, scale),
                                       "K2 against the module path at 197 keys")

    def fwd_bwd(fn):
        def run():
            for t in leaves:
                t.grad = None
            fn(*leaves, scale).backward(g)
        return run

    kw = dict(iters=10, warmup=2, repeats=3)
    with torch.no_grad():
        fwd = ab_ms(torch, lambda: sa.short_attention(q, k, v, scale),
                    lambda: attention.einsum_attention_bnhd(q, k, v, scale), **kw)
    both = ab_ms(torch, fwd_bwd(sa.short_attention),
                 fwd_bwd(attention.einsum_attention_bnhd), **kw)
    log(14, f"K2 against the module path at ({b},{n},{h},{dh}) bf16 (card {card}): max abs "
            f"{err:.3e}, rel RMS {rel:.3e}; forward {fwd[0]:.4f} ms, module path {fwd[1]:.4f} "
            f"ms; forward + backward {both[0]:.4f} ms, module path {both[1]:.4f} ms "
            f"(SHORT_KERNEL_MIN_KV stays {attention.SHORT_KERNEL_MIN_KV}: training takes the "
            f"module path at 197 keys, as the JAX package does)")
    del qkv, g, q, k, v, leaves
    free_card(torch)
    return {"shape": [b, n, h, dh], "max_abs_err": err, "fwd_ms": fwd[0],
            "module_fwd_ms": fwd[1], "fwd_bwd_ms": both[0], "module_fwd_bwd_ms": both[1]}


def cls_cli_slice(torch, dev, pretrain, card):
    """Phase 14; returns ({kernel: launches per training step}, {kernel:
    launches per eval batch}) of the cls run and the numbers it prints."""
    import shutil

    from multimae_tpu_torch.cli.run_finetuning_cls import get_args, main
    from multimae_tpu_torch.data.dataset_folder import write_imagenet_tree

    root = os.path.join(HERE, "build", "chip_smoke_cls")
    shutil.rmtree(root, ignore_errors=True)
    photos = sorted(os.path.join(JPEG_FIXTURES, n) for n in os.listdir(JPEG_FIXTURES)
                    if n.startswith("photo_"))
    train, val = write_imagenet_tree(os.path.join(root, "tree"), photos, CLS_TRAIN, CLS_VAL,
                                     CLS_CLASSES)
    out = os.path.join(root, "out")
    log(14, f"ImageNet-layout tree: {CLS_TRAIN} training and {CLS_VAL} validation samples in "
            f"{CLS_CLASSES} classes, links to the {len(photos)} 500x375 photo fixtures")
    try:
        base = ["-c", os.path.join(HERE, CLS_YAML), "--finetune", pretrain,
                "--data_set", "image_folder", "--nb_classes", str(CLS_CLASSES),
                "--data_path", train, "--eval_data_path", val, "--batch_size", str(CLS_BATCH),
                "--warmup_epochs", "0", "--num_workers", str(CLI_WORKERS),
                "--save_ckpt_freq", "1", "--model_ema", "--output_dir", out]
        steps_per_epoch, eval_batches = CLS_TRAIN // CLS_BATCH, math.ceil(CLS_VAL / CLS_BATCH)
        reset_launch_counts()
        first = main(get_args(base + ["--epochs", "2"]))
        launches = launch_counts()
        losses, accs = check_cls_run("run A", first, 2 * steps_per_epoch, 2, CLS_VAL)
        saves = [os.path.join(out, f"checkpoint-{e}.pth") for e in ("0", "1", "best")]
        if not all(os.path.exists(p) for p in saves):
            raise AssertionError(f"run A: {os.listdir(out)}")
        reset_launch_counts()
        evaluated = main(get_args(base + ["--eval", "--resume", saves[1], "--num_workers",
                                          "0"]))
        per_step, per_eval = split_launches("run A", launches, len(losses), 2, evaluated,
                                            eval_batches, CLS_VAL, check=check_cls_run)
        expect_step = dict.fromkeys(launches, 0)
        expect_eval = dict(expect_step, fused_block_infer=12)
        if (per_step, per_eval) != (expect_step, expect_eval):
            raise AssertionError(f"run A: launches {per_step} per step and {per_eval} per "
                                 f"eval batch; expected {expect_step} and {expect_eval}")
        if evaluated["evals"][0]["acc1"] != accs[1][0]:
            raise AssertionError(f"--eval from checkpoint-1.pth: top-1 "
                                 f"{evaluated['evals'][0]['acc1']}, run A's epoch 1 {accs[1][0]}")
        report = first["finetune"]
        head = sorted(f"output_adapters.cls.{m}.{p}" for m in ("head", "norm")
                      for p in ("bias", "weight"))
        if sorted(report["missing"]) != head or any(
                k.startswith(("encoder.", "input_adapters.rgb.", "global_tokens"))
                for k in report["unexpected"]):
            raise AssertionError(f"fine-tune start: missing {report['missing']}, unexpected "
                                 f"{report['unexpected'][:20]}")
        log(14, f"fine-tune start from {os.path.basename(pretrain)}: missing the head's 4 "
                f"keys, {len(report['unexpected'])} unexpected (the pretraining decoders, the "
                f"depth and semseg input adapters), rgb pos-emb 14x14 as saved")
        log(14, f"run A (batch {CLS_BATCH}, RandAugment rand-m9-mstd0.5-inc1, mixup 0.8 / "
                "cutmix 1.0, EMA on): losses " + ", ".join(f"{v:.4f}" for v in losses) + "; top-1/5 "
                + ", ".join(f"{a:.2f}/{b:.2f}" for a, b in accs) + f" over {CLS_VAL} images; "
                f"per training step {sum(per_step.values())} kernel launches (the 197-key "
                f"attention takes the module path), per eval batch K4 "
                f"{per_eval['fused_block_infer']} (measured: totals {launches} over "
                f"{len(losses)} steps and 2 evals, an --eval run over {eval_batches} batches); "
                f"checkpoint-best, -0, -1.pth ({os.path.getsize(saves[1]) / 2**30:.2f} GiB with "
                f"the EMA) saved in " + ", ".join(f"{t:.2f}" for t in first["save_s"]) + " s")

        best_stat = os.stat(saves[2])
        resumed = main(get_args(base + ["--epochs", "3", "--blr", "0", "--min_lr", "0",
                                        "--num_workers", "0"]))
        check_cls_run("run B", resumed, steps_per_epoch, 1, CLS_VAL)
        if (resumed["start_epoch"], resumed["resumed_from"], resumed.get("resume_bit_equal"),
                resumed["evals"][0]["acc1"]) != (2, saves[1], True, accs[1][0]):
            raise AssertionError(f"run B: start epoch {resumed['start_epoch']}, from "
                                 f"{resumed['resumed_from']}, bit-equal "
                                 f"{resumed.get('resume_bit_equal')}, top-1 "
                                 f"{resumed['evals'][0]['acc1']} (run A's epoch 1 {accs[1][0]})")
        after = os.stat(saves[2])
        best = max(a for a, _ in accs)
        if (resumed["best_acc1"], after.st_mtime_ns, after.st_size) != (
                best, best_stat.st_mtime_ns, best_stat.st_size):
            raise AssertionError(f"run B: best top-1 {resumed['best_acc1']} (run A's {best}); "
                                 f"checkpoint-best.pth rewritten")
        log(14, f"run B (--epochs 3 at LR 0): auto-resumed from checkpoint-1.pth at epoch 2, "
                f"parameters bit-equal to the save, loaded in {resumed['load_s']:.2f} s; top-1 "
                f"{resumed['evals'][0]['acc1']:.2f} as run A's epoch 1; the best top-1 "
                f"{best:.2f} kept and checkpoint-best.pth not rewritten"
                + ("" if resumed['evals'][0]['acc1'] > 0 else
                   " (top-1 0: the JAX CLI would not have rewritten it either)"))

        # A step's time holds no data wait; the waits are run A's alone, since
        # run B and the --eval run load in their process.
        fed = first["steps"] + resumed["steps"]
        step_ms = statistics.median(r["step_s"] for r in fed) * 1e3
        share, steady = steady_share([first])
        evals = first["evals"]
        eval_ms = statistics.median(e["ms_per_batch"] for e in evals)
        eval_data_ms = statistics.median(e["ms_per_batch_with_data"] for e in evals)
        # The native loader's rates only: the per-sample split holds the
        # numpy twins' arrays equal to the native ones and times them.
        one, many = (loader_rate(*cls_data(val), workers, batch=8, epochs=epochs)
                     for workers, epochs in ((0, 1), (CLI_WORKERS, 2)))
        split = cls_sample_split(val)
        log(14, f"loader over the cls tree (native; 500x375 JPEG -> 224, batches of 8; card "
                f"{card}): {one:.1f} samples/s in one process, {many:.1f} samples/s with "
                f"{CLI_WORKERS} workers")
        for path in ("native", "twin"):
            dec, aug, ra = split[path]
            log(14, f"per sample ({path}): {dec:.3f} ms decoding its JPEG and {aug:.3f} ms "
                    f"augmenting, {ra:.3f} of it ({ra / aug:.2f}) in RandAugment")
        log(14, f"the native and twin transforms gave the same arrays on the first "
                f"{TWIN_SAMPLES} samples")
        log(14, f"CLI step at batch {CLS_BATCH} fed by the loader: {step_ms:.3f} ms host "
                f"(median of {len(fed)}; card {card}); data wait {share:.4f} of the steps' "
                f"time, {steady:.4f} without each run's first step; eval {eval_ms:.3f} ms per "
                f"batch of {CLS_BATCH} on the card ({eval_data_ms:.3f} with the data)")
        numbers = {"cls_losses": losses, "cls_top1_top5": accs, "cls_step_ms": step_ms,
                   "cls_data_wait_share": share, "cls_data_wait_share_steady": steady,
                   "cls_eval_ms_per_batch": eval_ms,
                   "cls_eval_ms_per_batch_with_data": eval_data_ms,
                   "cls_loader_samples_per_s": one, "cls_loader_samples_per_s_workers": many,
                   "cls_decode_ms_per_sample": split["native"][0],
                   "cls_augment_ms_per_sample": split["native"][1],
                   "cls_randaugment_ms_per_sample": split["native"][2],
                   "cls_twin_decode_ms_per_sample": split["twin"][0],
                   "cls_twin_augment_ms_per_sample": split["twin"][1],
                   "cls_twin_randaugment_ms_per_sample": split["twin"][2],
                   "cls_ckpt_save_s": first["save_s"], "cls_ckpt_load_s": resumed["load_s"],
                   "cls_best_top1": best}
        return per_step, per_eval, numbers
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_card(torch)

def link_records(src, dst, copies):
    """dst: the MultiTaskImageFolder tree `src` with each file linked
    `copies` times under new names (more records than written samples)."""
    for task in os.listdir(src):
        for cls in os.listdir(os.path.join(src, task)):
            os.makedirs(os.path.join(dst, task, cls))
            for name in os.listdir(os.path.join(src, task, cls)):
                stem, ext = os.path.splitext(name)
                for k in range(copies):
                    os.symlink(os.path.join(src, task, cls, name),
                               os.path.join(dst, task, cls, f"{stem}_{k}{ext}"))


def check_regression_run(name, summary, steps, evals, images, key):
    """Raise unless the run took `steps` steps and `evals` evaluations over
    `images` images each, with finite losses and a finite `key` metric."""
    losses = [r["metrics"]["loss"] for r in summary["steps"]]
    values = [e[key] for e in summary["evals"]]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{name}: losses {losses}; expected {steps} finite")
    if len(values) != evals or not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{name}: {key} {values}; expected {evals} finite")
    if any(e["images"] != images for e in summary["evals"]):
        raise AssertionError(f"{name}: evaluated {[e['images'] for e in summary['evals']]} "
                             f"images; expected {images} each")
    return losses, values


def regression_cli_runs(phase, cli, base, out, *, batch, train, val, key, better,
                        expect_step, expect_eval, data, card, twin_tolerance):
    """Phases 15 and 16: run A (2 epochs, an evaluation each, checkpoint-0,
    -1 and -best.pth), an --eval run of checkpoint-1.pth that counts the
    launches per eval batch, run B (--epochs 3 at LR 0: it resumes at epoch
    2, evaluates to run A's epoch-1 metric and keeps the best one and
    checkpoint-best.pth), run C (from a copy of checkpoint-0.pth alone, at
    run A's LR, in one process: its first loss is run A's first of epoch 1,
    bit for bit: the shared cli/finetune_loop.py resumes the data order and
    the state training goes on from, and the loader's batches do not depend
    on its workers), where the recipe launches a kernel run A's first
    epoch again on the plain twins (the first step's loss and grad norm
    within `twin_tolerance` = (loss, norm) relative), and the loader's
    samples/s of the native path (`data()` -> dataset, transform).
    Returns (launches per step, per eval batch, numbers)."""
    import functools

    steps_per_epoch, eval_batches = train // batch, math.ceil(val / batch)
    check = functools.partial(check_regression_run, key=key)
    reset_launch_counts()
    first = cli.main(cli.get_args(base + ["--output_dir", out, "--epochs", "2"]))
    launches = launch_counts()
    losses, values = check("run A", first, 2 * steps_per_epoch, 2, val)
    saves = [os.path.join(out, f"checkpoint-{e}.pth") for e in ("0", "1", "best")]
    if not all(os.path.exists(p) for p in saves):
        raise AssertionError(f"[{phase}] run A: {os.listdir(out)}")
    reset_launch_counts()
    evaluated = cli.main(cli.get_args(base + ["--output_dir", out, "--eval", "--resume",
                                              saves[1], "--num_workers", "0"]))
    per_step, per_eval = split_launches(f"[{phase}] run A", launches, len(losses), 2, evaluated,
                                        eval_batches, val, check=check)
    want_step = dict(dict.fromkeys(launches, 0), **expect_step)
    want_eval = dict(dict.fromkeys(launches, 0), **expect_eval)
    if (per_step, per_eval) != (want_step, want_eval):
        raise AssertionError(f"[{phase}] run A: launches {per_step} per step and {per_eval} "
                             f"per eval batch; expected {want_step} and {want_eval}")
    if evaluated["evals"][0][key] != values[1]:
        raise AssertionError(f"[{phase}] --eval of checkpoint-1.pth: {key} "
                             f"{evaluated['evals'][0][key]}, run A's epoch 1 {values[1]}")
    report = first["finetune"]
    best = better(values)
    log(phase, f"fine-tune start from phase 12's .pth: {len(report['missing'])} missing (the "
               f"DPT head's), {len(report['unexpected'])} unexpected (the pretraining decoders "
               f"and input adapters)")
    log(phase, f"run A: losses " + ", ".join(f"{v:.4f}" for v in losses) + f"; {key} "
               + ", ".join(f"{v:.4f}" for v in values) + f" over {val} images; per training "
               f"step {per_step}, per eval batch {per_eval} (measured: totals {launches} over "
               f"{len(losses)} steps and 2 evals, an --eval run over {eval_batches} batch(es)); "
               f"checkpoint-best, -0, -1.pth ({os.path.getsize(saves[1]) / 2**30:.2f} GiB) saved "
               f"in " + ", ".join(f"{t:.2f}" for t in first["save_s"]) + " s")

    best_stat = os.stat(saves[2])
    resumed = cli.main(cli.get_args(base + ["--output_dir", out, "--epochs", "3", "--lr", "0",
                                            "--min_lr", "0", "--num_workers", "0"]))
    check("run B", resumed, steps_per_epoch, 1, val)
    after = os.stat(saves[2])
    if ((resumed["start_epoch"], resumed["resumed_from"], resumed.get("resume_bit_equal"),
         resumed["evals"][0][key], resumed[f"best_{key}"], after.st_mtime_ns, after.st_size)
            != (2, saves[1], True, values[1], best, best_stat.st_mtime_ns, best_stat.st_size)):
        raise AssertionError(f"[{phase}] run B: start epoch {resumed['start_epoch']}, from "
                             f"{resumed['resumed_from']}, bit-equal "
                             f"{resumed.get('resume_bit_equal')}, {key} "
                             f"{resumed['evals'][0][key]} (run A's epoch 1 {values[1]}), best "
                             f"{resumed[f'best_{key}']} (run A's {best}); checkpoint-best.pth "
                             f"{'kept' if after.st_mtime_ns == best_stat.st_mtime_ns else 'rewritten'}")
    log(phase, f"run B (--epochs 3 at LR 0): auto-resumed from checkpoint-1.pth at epoch 2, "
               f"parameters bit-equal to the save, loaded in {resumed['load_s']:.2f} s; {key} "
               f"{resumed['evals'][0][key]:.4f} as run A's epoch 1; the best {key} {best:.4f} "
               f"kept and checkpoint-best.pth not rewritten")

    import shutil

    out_c = out + "_c"  # checkpoint-0.pth alone, at run A's LR: training goes on as in run A
    os.makedirs(out_c)
    shutil.copy(saves[0], out_c)
    again = cli.main(cli.get_args(base + ["--output_dir", out_c, "--epochs", "2",
                                          "--no_save_ckpt", "--eval_freq", "100",
                                          "--num_workers", "0"]))
    a_loss = first["steps"][steps_per_epoch]["metrics"]["loss"]
    c_loss = again["steps"][0]["metrics"]["loss"]
    if (again["start_epoch"], again.get("resume_bit_equal"), c_loss) != (1, True, a_loss):
        raise AssertionError(f"[{phase}] run C: start epoch {again['start_epoch']}, bit-equal "
                             f"{again.get('resume_bit_equal')}, first loss {c_loss}, run A's "
                             f"at that step {a_loss}")
    log(phase, f"run C (from checkpoint-0.pth alone, at run A's LR): resumed at epoch 1, first "
               f"loss {c_loss:.6f} equal to run A's at that step")
    shutil.rmtree(out_c)

    gaps = None
    if any(per_step.values()):
        with plain_twins():  # one epoch, no eval, no save: the same first batch as run A's
            plain = cli.main(cli.get_args(base + [
                "--output_dir", out + "_plain", "--epochs", "1", "--no_save_ckpt",
                "--eval_freq", "100", "--num_workers", "0"]))
        pairs = [(first["steps"][0]["metrics"][m], plain["steps"][0]["metrics"][m])
                 for m in ("loss", "grad_norm")]
        gaps = [abs(k - p) / abs(p) for k, p in pairs]
        if not all(g <= t for g, t in zip(gaps, twin_tolerance)):
            raise AssertionError(f"[{phase}] the first step's (loss, grad norm) {pairs} with "
                                 f"the kernels and on the plain twins: relative gaps {gaps}, "
                                 f"limits {twin_tolerance}")
        log(phase, "first step on the plain twins: " + "; ".join(
            f"{m} {p:.6f} against {k:.6f} (relative gap {g:.3e}, limit {t})"
            for m, (k, p), g, t in zip(("loss", "grad norm"), pairs, gaps, twin_tolerance)))
    else:
        log(phase, "run A launched no kernel: its steps ran the plain path, so its first "
                   "loss is the plain twins' (no rerun)")

    # A step's time holds no data wait; the waits are run A's alone, since the
    # other runs load in their process (no worker start-up).
    fed = first["steps"] + resumed["steps"]
    step_ms = statistics.median(r["step_s"] for r in fed) * 1e3
    share, steady = steady_share([first])
    evals = first["evals"]
    eval_ms = statistics.median(e["ms_per_batch"] for e in evals)
    eval_data_ms = statistics.median(e["ms_per_batch_with_data"] for e in evals)
    one, many = (loader_rate(*data(), workers, batch=8, epochs=2)
                 for workers in (0, CLI_WORKERS))
    log(phase, f"loader (native; the training transform over {len(data()[0])} samples in "
               f"batches of 8; "
               f"card {card}): {one:.1f} samples/s in one process, {many:.1f} with "
               f"{CLI_WORKERS} workers")
    log(phase, f"CLI step at batch {batch} fed by the loader: {step_ms:.3f} ms host (median of "
               f"{len(fed)}; card {card}), {batch / step_ms * 1e3:.1f} samples/s; data wait "
               f"{share:.4f} of the steps' time, {steady:.4f} without each run's first step; "
               f"eval {eval_ms:.3f} ms per batch on the card ({eval_data_ms:.3f} with the data)")
    numbers = {"losses": losses, key: values, "best": best, "step_ms": step_ms,
               "data_wait_share": share, "data_wait_share_steady": steady,
               "eval_ms_per_batch": eval_ms, "eval_ms_per_batch_with_data": eval_data_ms,
               "first_step_plain_gaps": gaps,
               "loader_samples_per_s": one, "loader_samples_per_s_workers": many,
               "ckpt_save_s": first["save_s"], "ckpt_load_s": resumed["load_s"],
               "missing": len(report["missing"]), "unexpected": len(report["unexpected"])}
    return per_step, per_eval, numbers


def depth_cli_slice(torch, dev, pretrain, card):
    """Phase 15; returns ({kernel: launches per step}, {kernel: launches per
    eval batch}) of the depth run and the numbers it prints."""
    import shutil

    from multimae_tpu_torch.cli import run_finetuning_depth as cli
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    root = os.path.join(HERE, "build", "chip_smoke_depth")
    shutil.rmtree(root, ignore_errors=True)
    written, train, val = (os.path.join(root, d) for d in ("written", "train", "val"))
    t0 = time.perf_counter()
    nyu = dict(semseg_classes=SEMSEG_CLASSES, mask_valid=True, smooth=True)
    write_random_tree(written, DEPTH_WRITTEN, FT_HW, seed=5, **nyu)
    write_random_tree(val, DEPTH_VAL, FT_HW, seed=6, **nyu)
    link_records(written, train, DEPTH_TRAIN // DEPTH_WRITTEN)
    log(15, f"wrote {DEPTH_WRITTEN} + {DEPTH_VAL} photo-like NYUv2-shaped samples at "
            f"{FT_HW[1]}x{FT_HW[0]} (rgb, 16-bit depth, mask_valid) in "
            f"{time.perf_counter() - t0:.1f} s; {DEPTH_TRAIN} training records link to the "
            f"{DEPTH_WRITTEN}")
    base = ["-c", os.path.join(HERE, DEPTH_YAML), "--finetune", pretrain,
            "--warmup_epochs", "0", "--eval_freq", "1", "--save_ckpt_freq", "1",
            "--num_workers", str(CLI_WORKERS), "--data_path", train, "--eval_data_path", val]
    domains = ["depth", "rgb", "mask_valid"]

    def data():  # the written samples, with the training transform
        dataset, transform, _, _ = cli.nyu_datasets(
            cli.get_args(base + ["--data_path", written]), domains)
        return dataset, transform

    try:
        per_step, per_eval, numbers = regression_cli_runs(
            15, cli, base, os.path.join(root, "out"), batch=DEPTH_BATCH, train=DEPTH_TRAIN,
            val=DEPTH_VAL, key="delta_1", better=max, expect_step={}, expect_eval={},
            data=data, card=card, twin_tolerance=None)
        log(15, "the depth recipe (fp32, TF32 off) launches no kernel in a step or an eval "
                "batch, as in the JAX package: K2 and K4 take bf16 only")
        return per_step, per_eval, numbers
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_card(torch)


def k2_at(torch, dev, b, n, h, dh, phase, card, seed):
    """K2 forward and backward at (b, n, h, dh), bf16, against their twins,
    each bit-equal over two runs, timed with their twins, SDPA and bounds.
    Returns the forward's and the backward's numbers."""
    import torch.nn.functional as F

    from multimae_tpu_torch.ops import short_attention as sa
    from multimae_tpu_torch.ops.functional import assert_matches_twin

    scale = dh ** -0.5
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, dh), generator=gen).to(dev, torch.bfloat16)
    q, k, v = (t.contiguous() for t in qkv.unbind(2))
    g = torch.randn((b, n, h, dh), generator=gen).to(dev, torch.bfloat16)
    o, lse = sa.short_attention_fwd(q, k, v, scale)
    o2, lse2 = sa.short_attention_fwd(q, k, v, scale)
    grads = sa.short_attention_bwd(q, k, v, o, lse, g, scale)
    again = sa.short_attention_bwd(q, k, v, o, lse, g, scale)
    torch.cuda.synchronize()
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)
            and all(torch.equal(x, y) for x, y in zip(grads, again))):
        raise AssertionError(f"K2 at ({b},{n},{h},{dh}): two runs on the same inputs differ")
    ro, rlse = sa.short_attention_ref(q, k, v, scale)
    fwd_err = max(assert_matches_twin(o, ro, f"K2 fwd o at ({b},{n},{h},{dh})")[0],
                  assert_matches_twin(lse, rlse, f"K2 fwd lse at ({b},{n},{h},{dh})")[0])
    refs = sa.short_attention_bwd_ref(q, k, v, g, lse, sa.attention_delta(o, g), scale)
    bwd_err = max(assert_matches_twin(a, r, f"K2 bwd {nm} at ({b},{n},{h},{dh})",
                                      grad_of=torch.bfloat16)[0]
                  for nm, a, r in zip(("dq", "dk", "dv"), grads, refs))
    del ro, rlse, refs, o2, lse2, again
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    leaves = [t.detach().clone().requires_grad_() for t in (qt, kt, vt)]
    gt = g.transpose(1, 2)

    def twin_bwd():
        with plain_twins():
            sa.short_attention_bwd(q, k, v, o, lse, g, scale)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(*leaves).backward(gt)

    kw = dict(iters=10, warmup=2, repeats=3)
    fwd = ab_ms(torch, lambda: sa.short_attention_fwd(q, k, v, scale),
                lambda: sa.short_attention_ref(q, k, v, scale), **kw)
    bwd = ab_ms(torch, lambda: sa.short_attention_bwd(q, k, v, o, lse, g, scale), twin_bwd, **kw)
    sdpa = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt), **kw)
    sdpa_fb = cuda_ms(torch, sdpa_fwd_bwd, **kw)
    fl = 4 * b * h * n * n * dh
    fwd_bound = bound(fl, 2 * 4 * b * n * h * dh + 4 * b * h * n)
    bwd_bound = bound(2.5 * fl, 2 * 8 * b * n * h * dh + 4 * b * h * n)
    log(phase, f"K2 ({b},{n},{h},{dh}) bf16 within TWIN/GRAD_TOLERANCE, fwd and bwd bit-equal "
               f"over two runs (max abs fwd {fwd_err:.3e}, bwd {bwd_err:.3e}); fwd kernel "
               f"{fwd[0]:.4f} ms, twin {fwd[1]:.4f} ms, SDPA {sdpa:.4f} ms, bound "
               f"{fwd_bound[0]:.4f} ms ({fwd_bound[1]}); bwd kernel {bwd[0]:.4f} ms, twin "
               f"{bwd[1]:.4f} ms, bound {bwd_bound[0]:.4f} ms; fwd+bwd {fwd[0] + bwd[0]:.4f} ms, "
               f"SDPA {sdpa_fb:.4f} ms (card {card})")
    del q, k, v, g, o, lse, grads, leaves, qkv
    free_card(torch)
    return ({"max_abs_err": fwd_err, "ms": fwd[0], "plain_ms": fwd[1], "bound_ms": fwd_bound[0],
             "bound_by": fwd_bound[1], "library_ms": sdpa},
            {"max_abs_err": bwd_err, "ms": bwd[0], "plain_ms": bwd[1], "bound_ms": bwd_bound[0],
             "bound_by": bwd_bound[1], "library_ms": sdpa_fb})


def prefixed(tag, numbers):
    return {f"{tag}_{k}": v for k, v in numbers.items()}


def taskonomy_attention_and_block(torch, fused_block, w4, gen, dev, card):
    """K2 forward and backward at (TK_BATCH, 577, 12, 64) and K4 at
    (TK_BATCH, 577, 768), bf16, against their twins, bit-equal over two
    runs, timed with their twins, SDPA and bounds: the Taskonomy recipe's
    shapes. Returns (K2 fwd numbers, K2 bwd numbers, K4 numbers)."""
    b, n = TK_BATCH, 577
    k2f, k2b = k2_at(torch, dev, b, n, 12, 64, 16, card, seed=16)
    err, rel, ms, plain_ms, k4_bound = k4_at(torch, fused_block, w4, n, gen, dev, b=b)
    log(16, f"K4 bf16 ({b},{n},768) max abs {err:.3e}, rel RMS {rel:.3e}, bit-equal over two "
            f"runs; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {k4_bound[0]:.4f} ms "
            f"({k4_bound[1]}; card {card})")
    free_card(torch)
    return (prefixed("taskonomy", k2f), prefixed("taskonomy", k2b),
            {"taskonomy_max_abs_err": err, "taskonomy_ms": ms, "taskonomy_plain_ms": plain_ms,
             "taskonomy_bound_ms": k4_bound[0], "taskonomy_bound_by": k4_bound[1]})


def taskonomy_cli_slice(torch, dev, pretrain, card):
    """Phase 16's CLI runs; returns ({kernel: launches per step}, {kernel:
    launches per eval batch}) and the numbers it prints."""
    import shutil

    from multimae_tpu_torch.cli import run_finetuning_taskonomy as cli
    from multimae_tpu_torch.data.taskonomy import TaskonomyDataset, write_taskonomy_tree

    root = os.path.join(HERE, "build", "chip_smoke_taskonomy")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    domains = ["depth_zbuffer", "rgb", "mask_valid"]
    write_taskonomy_tree(root, domains, {"train": TK_TRAIN, "val": TK_VAL}, hw=TK_HW, seed=7)
    log(16, f"wrote a Taskonomy-layout tree of {TK_TRAIN} + {TK_VAL} rows at "
            f"{TK_HW[1]}x{TK_HW[0]} (rgb/, depth_zbuffer/ and mask_valid/<building>/"
            f"point_P_view_V_domain_*.png, 16-bit depth with an invalid patch, the "
            f"splits CSVs) in {time.perf_counter() - t0:.1f} s")
    base = ["-c", os.path.join(HERE, TK_YAML), "--finetune", pretrain, "--data_path", root,
            "--warmup_epochs", "0", "--eval_freq", "1", "--save_ckpt_freq", "1",
            "--num_workers", str(CLI_WORKERS)]

    def data():
        return TaskonomyDataset(root, domains, split="train", image_size=384), None

    try:
        return regression_cli_runs(
            16, cli, base, os.path.join(root, "out"), batch=TK_BATCH, train=TK_TRAIN,
            val=TK_VAL, key="l1", better=min,
            expect_step={"short_attention_fwd": 12, "short_attention_bwd": 12},
            expect_eval={"fused_block_infer": 12}, data=data, card=card,
            twin_tolerance=(TK_CLI_LOSS_TOLERANCE, TK_CLI_NORM_TOLERANCE))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_card(torch)


# Phase 17: the demo, the benches and the profiler of multimae_tpu_torch/tools
# at the JAX tools' default batches (--large: ViT-L), with the steps cut to
# TOOL_STEPS after TOOL_WARMUP; the demo's RGB input is a committed photo.
TOOL_STEPS, TOOL_WARMUP = 2, 1
DEMO_RGB = os.path.join(JPEG_FIXTURES, "photo_420_q90.jpg")
DEMO_VISIBLE = "0,0 1,0 2,0 5,5 6,6 7,7 8,8 13,13"


def expect_launches(what, got, **expected):
    want = dict(dict.fromkeys(got, 0), **expected)
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def demo_part(torch, pretrain, root, card):
    """Phase 17's demo runs on phase 12's .pth: --visible_rgb and random
    masking, each against the same call on the plain twins; returns
    {run: launches}."""
    from multimae_tpu_torch.cli import demo
    from multimae_tpu_torch.data.image_io import load_image, write_png
    from multimae_tpu_torch.ops.functional import assert_matches_twin

    import numpy as np

    rng = np.random.default_rng(17)
    y, x = np.mgrid[0:375, 0:500]
    depth = (20000 + 15000 * np.sin(x / 40.0) * np.cos(y / 30.0)
             + rng.normal(0, 300, (375, 500))).astype(np.uint16)
    classes = ((x // 60 + y // 45) % 40).astype(np.uint8)
    palette = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    os.makedirs(root, exist_ok=True)
    write_png(os.path.join(root, "depth.png"), depth)
    write_png(os.path.join(root, "semseg.png"), classes, palette=palette)
    base = ["--checkpoint", pretrain, "--rgb", DEMO_RGB, "--depth",
            os.path.join(root, "depth.png"), "--semseg", os.path.join(root, "semseg.png")]
    launches = {}
    for run, extra in (("visible", ["--visible_rgb", DEMO_VISIBLE]), ("random", ["--seed", "5"])):
        argv = base + extra + ["--out_dir", os.path.join(root, run)]
        reset_launch_counts()
        t0 = time.perf_counter()
        out = demo.main(argv)
        seconds = time.perf_counter() - t0
        launches[run] = launch_counts()
        expect_launches(f"demo ({run})", launches[run], fused_decoder_fwd=3)
        with plain_twins():
            plain = demo.main(argv[:-1] + [os.path.join(root, run + "_plain")])
        errs = {t: assert_matches_twin(p, plain["preds"][t], f"demo pred {t} ({run})")
                for t, p in out["preds"].items()}
        shapes = {"pred_rgb": (224, 224, 3), "pred_depth": (224, 224),
                  "pred_semseg": (56, 56), "mask_rgb": (224, 224), "mask_depth": (224, 224),
                  "mask_semseg": (224, 224)}
        got = {os.path.basename(p)[:-4]: load_image(p, convert_rgb=False).shape
               for p in out["paths"]}
        if got != shapes:
            raise AssertionError(f"demo ({run}) wrote {got}, expected {shapes}")
        visible = sum(int((m == 0).sum()) for m in out["masks"].values())
        log(17, f"demo ({run}; fp32 MultiMAE-B from {os.path.basename(pretrain)}): "
                f"{visible} visible tokens, K1 fwd {launches[run]['fused_decoder_fwd']} "
                f"launches, preds vs the plain twins (fp32 TWIN_TOLERANCE) max abs / rel RMS "
                + ", ".join(f"{t} {e[0]:.2e} / {e[1]:.2e}" for t, e in errs.items())
                + f"; {len(got)} PNGs read back at their sizes; {seconds:.2f} s host for the "
                f"run (model build, .pth load, forward, PNGs; card {card})")
        del out, plain
        free_card(torch)
    return launches


def tools_slice(torch, dev, pretrain, gen, card):
    """Phase 17: K4 at ViT-L's width, K2 at 16 heads and K3b at bench_infer's
    rows against their twins; then the demo, bench_infer, bench_finetune and
    profile_step, each run with the counts set to 0 before it and read after.
    Returns ({kernel: extra entries}, {run: launches}, numbers)."""
    import json as _json

    from multimae_tpu_torch.ops import fused_block, fused_mlp
    from multimae_tpu_torch.ops.functional import assert_matches_twin
    from multimae_tpu_torch.tools import bench_finetune, bench_infer, profile_step

    extra = {}
    wl = rand_block_weights(torch, fused_block, 1024, 4096, gen, dev)
    for b, n, tag in ((256, 197, "vitl_cls"), (16, 2049, "vitl_semseg")):
        err, rel, ms, plain_ms, k4_bound = k4_at(torch, fused_block, wl, n, gen, dev, b=b)
        log(17, f"K4 bf16 ({b},{n},1024), 16 heads, hidden 4096: max abs {err:.3e}, rel RMS "
                f"{rel:.3e}, bit-equal over two runs; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                f"ms, bound {k4_bound[0]:.4f} ms ({k4_bound[1]}; card {card})")
        extra.setdefault("fused_block_infer", {}).update(prefixed(tag, {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": k4_bound[0],
            "bound_by": k4_bound[1]}))
        free_card(torch)
    del wl
    k2f, k2b = k2_at(torch, dev, 4, 2049, 16, 64, 17, card, seed=17)
    extra["short_attention_fwd"] = prefixed("vitl", k2f)
    extra["short_attention_bwd"] = prefixed("vitl", k2b)

    m, k, hid = 32 * 1024 * 16, 384, 1536
    w = fused_mlp.MlpWeights(
        *(t.to(dev) for t in (1 + 0.1 * torch.randn(k, generator=gen), 0.1 * torch.randn(
            k, generator=gen), 0.02 * torch.randn(hid, k, generator=gen), 0.02 * torch.randn(
            hid, generator=gen), 0.02 * torch.randn(k, hid, generator=gen), 0.02 * torch.randn(
            k, generator=gen))))
    x, res = (torch.randn((m, k), generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    with torch.inference_mode():
        out = fused_mlp.fused_ln_mlp_res(x, res, w)
        again = fused_mlp.fused_ln_mlp_res(x, res, w)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"K3b fwd at {m} rows: two runs on the same inputs differ")
        err, rel = assert_matches_twin(out, fused_mlp.fused_ln_mlp_res_ref(x, res, w),
                                       f"K3b fwd at {m} rows")
        del out, again
        fwd = ab_ms(torch, lambda: fused_mlp.fused_ln_mlp_res(x, res, w),
                    lambda: fused_mlp.fused_ln_mlp_res_ref(x, res, w), iters=5, repeats=3)
    k3_bound = bound(4 * m * k * hid, 2 * 3 * m * k + 2 * 2 * k * hid)
    log(17, f"K3b fwd bf16 ({m},{k}) hidden {hid} (bench_infer's ConvNeXt head at batch 32): "
            f"max abs {err:.3e}, rel RMS {rel:.3e}, bit-equal over two runs; kernel "
            f"{fwd[0]:.4f} ms, plain {fwd[1]:.4f} ms, bound {k3_bound[0]:.4f} ms "
            f"({k3_bound[1]}; card {card})")
    extra["fused_ln_mlp_res_fwd"] = prefixed("infer_rows", {
        "max_abs_err": err, "ms": fwd[0], "plain_ms": fwd[1], "bound_ms": k3_bound[0],
        "bound_by": k3_bound[1]})
    del x, res, w
    free_card(torch)

    root = os.path.join(HERE, "build", "chip_smoke_tools")
    launches, numbers = {}, {}
    try:
        launches.update(demo_part(torch, pretrain, os.path.join(root, "demo"), card))
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)

    runs = TOOL_STEPS + TOOL_WARMUP
    fwd = 2 * TOOL_STEPS  # bench_infer: a warm-up run and a timed run of TOOL_STEPS each
    for name, call, expected in (
            ("infer_cls224_vitb", lambda: bench_infer.bench_cls(256, TOOL_STEPS, device=dev),
             dict(fused_block_infer=12 * fwd)),
            ("infer_semseg512_rgbd", lambda: bench_infer.bench_semseg(32, TOOL_STEPS, device=dev),
             dict(fused_block_infer=12 * fwd, fused_ln_mlp_res_fwd=4 * fwd)),
            ("infer_cls224_vitl", lambda: bench_infer.bench_cls(
                256, TOOL_STEPS, "multivit_large", dev), dict(fused_block_infer=24 * fwd)),
            ("infer_semseg512_rgbd_vitl", lambda: bench_infer.bench_semseg(
                16, TOOL_STEPS, "multivit_large", dev),
             dict(fused_block_infer=24 * fwd, fused_ln_mlp_res_fwd=4 * fwd))):
        reset_launch_counts()
        rate = call()
        launches[name] = launch_counts()
        expect_launches(name, launches[name], **expected)
        numbers[name] = rate
        log(17, f"bench_infer {name}: {rate:.1f} images/s over {TOOL_STEPS} chained forwards "
                f"(steps cut from 20 / 10; card {card}); launches {launches[name]}")
        print(bench_infer.metric_line(name, rate), flush=True)
        free_card(torch)

    def finetune(name, argv, expected, engine=None):
        args = bench_finetune.get_args(argv + ["--steps", str(TOOL_STEPS)])
        reset_launch_counts()
        with (bench_finetune.module_engine() if engine == "module"
              else contextlib.nullcontext()):
            line = bench_finetune.measure(args, engine or "kernels", dev, TOOL_WARMUP)
        launches[name] = launch_counts()
        if line["retried"]:  # steps cut short by the out-of-memory retries launched too
            if any(launches[name][k] < v * runs for k, v in expected.items()):
                raise AssertionError(f"{name}: launches {launches[name]}")
        else:
            expect_launches(name, launches[name], **{k: v * runs for k, v in expected.items()})
        numbers[name] = line
        log(17, f"bench_finetune {name}: {line['value']} samples/s at batch {line['batch']} "
                f"(of {args.batch}), peak {line['peak_gib']:.2f} GiB of the card's 80, "
                f"{TOOL_STEPS} steps after {TOOL_WARMUP}; launches {launches[name]} (card {card})")
        free_card(torch)

    k2 = dict(short_attention_fwd=12, short_attention_bwd=12)
    k3 = dict(fused_ln_mlp_res_fwd=4, fused_ln_mlp_res_bwd=4)
    finetune("finetune_semseg_512px_throughput_kernels", ["--task", "semseg"], dict(k2, **k3))
    finetune("finetune_semseg_512px_throughput_module", ["--task", "semseg"], k3, "module")
    kernels, module = (numbers[f"finetune_semseg_512px_throughput_{e}"]
                       for e in ("kernels", "module"))
    if kernels["batch"] != module["batch"]:  # as bench_finetune.main: compare at one batch
        small = min(kernels["batch"], module["batch"])
        engine = "kernels" if kernels["batch"] > small else "module"
        name = f"finetune_semseg_512px_throughput_{engine}_batch{small}"
        finetune(name, ["--task", "semseg", "--batch", str(small)],
                 dict(k2, **k3) if engine == "kernels" else k3, engine)
        kernels, module = (numbers[name] if e == engine else line
                           for e, line in (("kernels", kernels), ("module", module)))
    ratio = bench_finetune.speedup_line(bench_finetune.get_args(["--task", "semseg"]),
                                        kernels, module)
    if ratio is None:
        raise AssertionError(f"bench_finetune semseg: the legs ran at batches "
                             f"{kernels['batch']} and {module['batch']}")
    numbers["finetune_semseg_512px_kernel_speedup"] = ratio
    log(17, f"bench_finetune semseg kernel_speedup {ratio['value']} at batch "
            f"{ratio['batch_kernels']} on both engines (card {card})")
    finetune("finetune_taskonomy_384px_throughput_kernels", ["--task", "taskonomy"], k2)
    finetune("finetune_semseg_512px_large_throughput_kernels", ["--task", "semseg", "--large"],
             dict(short_attention_fwd=24, short_attention_bwd=24, **k3))
    for task in ("cls", "depth"):  # 197 and 257 keys: below the gate, no launch
        args = bench_finetune.get_args(["--task", task, "--steps", "1"])
        reset_launch_counts()
        line = bench_finetune.measure(args, "module" if task == "cls" else "kernels", dev, 0)
        launches[f"finetune_{task}"] = launch_counts()
        expect_launches(f"bench_finetune {task}", launches[f"finetune_{task}"])
        numbers[line["metric"]] = line
        log(17, f"bench_finetune {task}: one step at batch {line['batch']}, no launch "
                f"(card {card})")
        free_card(torch)

    for name, argv, expected in (
            ("profile_pretrain_large", ["--mode", "pretrain", "--large"],
             dict(fused_decoder_fwd=4, fused_decoder_bwd=4)),
            ("profile_taskonomy384", ["--mode", "taskonomy384"], k2)):
        args = profile_step.get_args(argv + ["--steps", str(TOOL_STEPS), "--warmup",
                                             str(TOOL_WARMUP), "--top", "12"])
        step, state, batch = profile_step.build(args, dev)
        reset_launch_counts()
        prof, host_ms = profile_step.profile_steps(step, state, batch, args.steps, args.warmup,
                                                   dev)
        launches[name] = launch_counts()
        expect_launches(name, launches[name], **{k: v * runs for k, v in expected.items()})
        tables = profile_step.report(prof, args.steps, host_ms, args.batch, dev, args.top)
        device_ms = sum(tables["by_kernel"].values())
        numbers[name] = {"host_ms_per_step": host_ms, "device_ms_per_step": device_ms,
                         "by_module": tables["by_module"]}
        log(17, f"profile_step {' '.join(argv)} at batch {args.batch}: {host_ms:.3f} ms host per "
                f"step under the profiler, device {device_ms:.3f} ms; by module: "
                + ", ".join(f"{k} {v:.2f}" for k, v in list(tables["by_module"].items())[:8])
                + f"; launches {launches[name]} (card {card})")
        del step, state, batch, prof
        free_card(torch)
    log(17, "numbers: " + _json.dumps(numbers))
    return extra, launches, numbers




# 18. the parallel paths on the one card. TP 2 runs ViT-L at 512 px (the
# shape bench_finetune --large ran) and PP 2 x 4 microbatches ViT-B
# pretraining, each pair of ranks in a gloo group of its own with CUDA
# tensors (NCCL does not put two ranks of one communicator on one card);
# FSDP2 runs in this process over a one-rank NCCL group.
TP_MODEL = "multivit_large"
PARALLEL_STEPS = 3
PP_MICRO = 4
# The first TP step against the one-process step, both on the kernels:
# the same draws; TP sums proj and fc2 over 2 partial products in fp32 and
# rounds them to bf16 once more. Limits about four times the readings on
# an H100: loss 1.0e-4, grad norm 5.4e-4 relative.
TP_LOSS_TOLERANCE = 4e-4
TP_NORM_TOLERANCE = 2e-3
# PP and FSDP at world 1 compute what the one process does, per sample;
# the microbatches' GEMMs and FSDP's copies change only summation order
# (readings: losses equal, grad norms 3.2e-5 and 2.1e-7 apart).
PP_TOLERANCE = 1e-4
PARALLEL_TIMEOUT = 400  # s for the TP and PP processes, start-up included
# The two ranks of a group compute the replicated parts (the head, the
# decoders, the losses) each on its own; the convolutions' cuDNN
# algorithms, picked per process, may round differently.
RANK_TOLERANCE = 1e-5


def tp_child(torch, dist, dev, rank):
    """TP 2 over the world of two: the ViT-L semseg fine-tune's first step
    in one process (rank 0), then PARALLEL_STEPS steps and an eval batch
    under TP, with each rank's launches per step and per eval batch."""
    from multimae_tpu_torch.cli.factory import build_semseg_trainer, make_synthetic_semseg_batch
    from multimae_tpu_torch.parallel import dist as dist_lib, mesh as mesh_lib
    from multimae_tpu_torch.train.finetune_step import make_dense_eval_step

    out = {}
    t = torch.full((8,), rank + 1.0, device=dev)
    dist.all_reduce(t)
    b = torch.full((8,), float(rank), device=dev)
    dist.broadcast(b, src=1)
    torch.cuda.synchronize(dev)
    if not (bool((t == 3).all()) and bool((b == 1).all())):
        raise AssertionError(f"gloo on CUDA tensors: all_reduce {t.tolist()}, broadcast "
                             f"{b.tolist()}")
    out["gloo_cuda"] = "all_reduce and broadcast of CUDA tensors ran"
    log(18, f"TP rank {rank}: gloo ran all_reduce and broadcast on CUDA tensors")
    batch = make_synthetic_semseg_batch(SEMSEG_BATCH, num_classes=SEMSEG_CLASSES, seed=0,
                                        device=dev)
    kw = dict(batch_size=SEMSEG_BATCH, seed=0, device=dev, model=TP_MODEL)
    if rank == 0:
        # the one-process step: no batch-wide sums
        state, step = build_semseg_trainer(**kw, parallel=dist_lib.single_process)
        gen = torch.Generator(device=dev).manual_seed(11)
        out["one_process"] = {k: float(v) for k, v in step(state, batch, generator=gen).items()}
        del state, step
        free_card(torch)
        log(18, f"TP rank 0: the one-process step, loss {out['one_process']['loss']:.4f}")
    dist.barrier()
    mesh = mesh_lib.create_mesh(model=2, device="cuda")
    log(18, f"TP rank {rank}: {mesh}")
    state, step = build_semseg_trainer(**kw, parallel=lambda m: mesh_lib.layout_model(m, mesh))
    gen = torch.Generator(device=dev).manual_seed(11)
    expect = dict.fromkeys(launch_counts(), 0)
    expect.update(short_attention_fwd=24, short_attention_bwd=24, fused_ln_mlp_res_fwd=4,
                  fused_ln_mlp_res_bwd=4)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    history = []
    for i in range(PARALLEL_STEPS):
        before = launch_counts()
        metrics = {k: float(v) for k, v in step(state, batch, generator=gen).items()}
        per_step = {k: v - before[k] for k, v in launch_counts().items()}
        if per_step != expect:
            raise AssertionError(f"TP step {i} launched {per_step}; expected {expect}")
        if not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"]:
            raise AssertionError(f"TP step {i}: metrics {metrics}")
        history.append(metrics)
        log(18, f"TP rank {rank} step {i}: loss {metrics['loss']:.4f}")
    torch.cuda.synchronize(dev)
    out.update(history=history, launches=launch_counts(),
               peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    eval_step = make_dense_eval_step(state.model, "semseg", ("rgb", "depth"))
    reset_launch_counts()
    pred = eval_step(batch)
    torch.cuda.synchronize(dev)
    out["eval_launches"] = launch_counts()
    expect_eval = dict.fromkeys(expect, 0)
    expect_eval.update(short_attention_fwd=24, fused_ln_mlp_res_fwd=4)
    if out["eval_launches"] != expect_eval:
        raise AssertionError(f"TP eval launched {out['eval_launches']}; expected {expect_eval}")
    shape = (SEMSEG_BATCH, 512, 512, SEMSEG_CLASSES)
    if tuple(pred.shape) != shape or not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"TP eval pred {tuple(pred.shape)} not finite or not {shape}")
    return out


def laid_out_steps(torch, dev, tag, layout):
    """The ViT-B pretraining step (phase 7's recipe at TRAIN_BATCH) laid out
    by `layout(model)`: PARALLEL_STEPS steps, K1 fwd 4 and bwd 4 launches
    each and nothing else. Returns (state, per-step metrics, launches,
    peak GiB)."""
    from multimae_tpu_torch.cli.factory import build_pretrain_trainer

    batch, masks = fixed_mask_batch(torch, dev, TRAIN_BATCH)
    state, step = build_pretrain_trainer(batch_size=TRAIN_BATCH, seed=0, device=dev,
                                         parallel=layout)
    expect = dict.fromkeys(launch_counts(), 0)
    expect.update(fused_decoder_fwd=4, fused_decoder_bwd=4)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    history = []
    for i in range(PARALLEL_STEPS):
        before = launch_counts()
        metrics = {k: float(v) for k, v in step(state, batch, task_masks=masks).items()}
        per_step = {k: v - before[k] for k, v in launch_counts().items()}
        if per_step != expect:
            raise AssertionError(f"{tag} step {i} launched {per_step}; expected {expect}")
        if not all(math.isfinite(v) for v in metrics.values()) or metrics["skipped"]:
            raise AssertionError(f"{tag} step {i}: metrics {metrics}")
        history.append(metrics)
        log(18, f"{tag} step {i}: loss {metrics['loss']:.4f}")
    torch.cuda.synchronize(dev)
    return state, history, launch_counts(), torch.cuda.max_memory_allocated(dev) / 2**30


def one_process_pretrain_step(torch, dev):
    """The first step of phase 7's recipe in one process, on the kernels
    (in a process of a group, with no batch-wide sums)."""
    from multimae_tpu_torch.cli.factory import build_pretrain_trainer
    from multimae_tpu_torch.parallel import dist as dist_lib

    batch, masks = fixed_mask_batch(torch, dev, TRAIN_BATCH)
    state, step = build_pretrain_trainer(batch_size=TRAIN_BATCH, seed=0, device=dev,
                                         parallel=dist_lib.single_process)
    out = {k: float(v) for k, v in step(state, batch, task_masks=masks).items()}
    del state, step
    free_card(torch)
    return out


def pp_child(torch, dist, dev, rank):
    """PP 2 x PP_MICRO over the world of two: the one-process first step
    (rank 0), then PARALLEL_STEPS pipelined steps on each stage rank."""
    from multimae_tpu_torch.parallel import mesh as mesh_lib

    out = {"one_process": one_process_pretrain_step(torch, dev)} if rank == 0 else {}
    dist.barrier()
    mesh = mesh_lib.create_pp_mesh(stage=2, device="cuda")
    log(18, f"PP stage {rank}: {mesh}")
    _, history, launches, peak = laid_out_steps(
        torch, dev, f"PP stage {rank}", lambda m: mesh_lib.layout_model(m, mesh, n_micro=PP_MICRO))
    out.update(history=history, launches=launches, peak_gib=peak)
    return out


def parallel_child(index, ports, out_dir):
    """One process of phase 18's pairs: 0 and 1 run TP, 2 and 3 PP, each
    pair in a gloo group of two on the one card; writes its numbers to
    out_dir/<pair><rank>.json."""
    sys.path.insert(0, HERE)
    import torch
    import torch.distributed as dist

    from multimae_tpu_torch.ops import _build

    pair, rank = divmod(index, 2)
    # Where a rank waits long, every thread's stack goes to stderr.
    faulthandler.dump_traceback_later(150, repeat=True)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{ports[pair]}",
                            world_size=2, rank=rank)
    result = (tp_child if pair == 0 else pp_child)(torch, dist, dev, rank)
    with open(os.path.join(out_dir, f"{pair}{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def fsdp_part(torch, dev):
    """FSDP2 at world 1 over NCCL in this process: PARALLEL_STEPS ViT-B
    pretraining steps against the one-process first step; a save under
    FSDP loads into the plain state bit-equal. Returns its numbers."""
    import tempfile

    import torch.distributed as dist

    from multimae_tpu_torch.cli.factory import build_pretrain_trainer
    from multimae_tpu_torch.parallel import dist as dist_lib, mesh as mesh_lib
    from multimae_tpu_torch.parallel.fsdp import is_sharded
    from multimae_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

    one = one_process_pretrain_step(torch, dev)
    dist_lib.init_single_process_group("cuda")
    try:
        mesh = mesh_lib.create_mesh(device="cuda")
        state, history, launches, peak = laid_out_steps(
            torch, dev, "FSDP", lambda m: mesh_lib.layout_model(m, mesh, fsdp=True))
        sharded = sum(is_sharded(p) for p in state.model.parameters())
        with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as tmp:
            path = save_checkpoint(tmp, 0, state)
            full = state.state_dict()["model"]
            plain, _ = build_pretrain_trainer(batch_size=TRAIN_BATCH, seed=1, device=dev)
            load_checkpoint(path, plain)
            equal = all(torch.equal(v, full[k].to(v.device))
                        for k, v in plain.model.state_dict().items())
        del state, plain, full
    finally:
        dist.destroy_process_group()
    free_card(torch)
    if not equal:
        raise AssertionError("a save under FSDP does not load into the plain state bit-equal")
    return {"one_process": one, "history": history, "launches": launches, "peak_gib": peak,
            "dtensor_parameters": sharded}


def rank_gap(a, b):
    """The largest relative gap between two ranks' metrics over the steps."""
    return max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-30) for x, y in zip(a, b) for k in y)


def step_gap(phase, tag, got, one, limits):
    """Log the first step's loss and grad norm against the one-process
    step's; raise past `limits` (loss, grad norm), relative."""
    rel = {k: abs(got[k] - one[k]) / abs(one[k]) for k in ("loss", "grad_norm")}
    log(phase, f"{tag} step 0 vs one process: loss {got['loss']:.6f} / {one['loss']:.6f} "
               f"(rel {rel['loss']:.2e}, limit {limits[0]}), grad norm "
               f"{got['grad_norm']:.6f} / {one['grad_norm']:.6f} (rel {rel['grad_norm']:.2e}, "
               f"limit {limits[1]})")
    if not (rel["loss"] <= limits[0] and rel["grad_norm"] <= limits[1]):
        raise AssertionError(f"{tag}: the first step differs from the one-process step {rel}")
    return rel


def parallel_slice(torch, dev, card):
    """Phase 18: K2 at TP's local head counts, then the TP, PP and FSDP
    paths. Returns the kernel numbers to add and the launches of each
    path."""
    import socket

    import torch.multiprocessing as mp

    k2 = {}
    for h, tag in ((8, "tp8"), (6, "tp6")):
        fwd, bwd = k2_at(torch, dev, SEMSEG_BATCH, 2049, h, 64, 18, card, seed=18 + h)
        k2[tag] = (fwd, bwd)
    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    out_dir = os.path.join(HERE, "build", "chip_smoke_parallel")
    os.makedirs(out_dir, exist_ok=True)
    children = mp.start_processes(parallel_child, args=(ports, out_dir), nprocs=4, join=False,
                                  start_method="spawn")
    log(18, f"TP 2 ({TP_MODEL} semseg, 512 px, batch {SEMSEG_BATCH}) and PP 2 x {PP_MICRO} "
            f"(ViT-B pretraining, batch {TRAIN_BATCH}) started: 4 processes on the card")
    fsdp = fsdp_part(torch, dev)
    deadline = time.perf_counter() + PARALLEL_TIMEOUT
    while not children.join(timeout=5):
        if time.perf_counter() > deadline:
            for p in children.processes:
                p.kill()
            raise AssertionError(f"the TP and PP processes did not end in {PARALLEL_TIMEOUT} s")
    res = {}
    for name in ("00", "01", "10", "11"):
        with open(os.path.join(out_dir, f"{name}.json")) as f:
            res[name] = json.load(f)
    import shutil

    shutil.rmtree(out_dir, ignore_errors=True)

    tp0, tp1 = res["00"], res["01"]
    log(18, f"gloo on one card: {tp0['gloo_cuda']}")
    for r, tp in enumerate((tp0, tp1)):
        log(18, f"TP rank {r}: losses " + ", ".join(f"{m['loss']:.4f}" for m in tp["history"])
                + f"; grad norms " + ", ".join(f"{m['grad_norm']:.4f}" for m in tp["history"])
                + f"; launches over {PARALLEL_STEPS} steps {tp['launches']}; eval batch "
                  f"{tp['eval_launches']}; peak {tp['peak_gib']:.2f} GiB")
    tp_ranks = rank_gap(tp0["history"], tp1["history"])
    tp_rel = step_gap(18, "TP 2", tp0["history"][0], tp0["one_process"],
                      (TP_LOSS_TOLERANCE, TP_NORM_TOLERANCE))
    for r in ("10", "11"):
        pp = res[r]
        log(18, f"PP stage {r[1]}: losses " + ", ".join(f"{m['loss']:.4f}" for m in pp["history"])
                + f"; launches over {PARALLEL_STEPS} steps {pp['launches']}; peak "
                  f"{pp['peak_gib']:.2f} GiB")
    pp_ranks = rank_gap(res["10"]["history"], res["11"]["history"])
    log(18, f"the ranks' metrics over {PARALLEL_STEPS} steps, largest relative gap: TP "
            f"{tp_ranks:.2e}, PP {pp_ranks:.2e} (limit {RANK_TOLERANCE})")
    if not (tp_ranks <= RANK_TOLERANCE and pp_ranks <= RANK_TOLERANCE):
        raise AssertionError("the ranks of one group report different metrics")
    pp_rel = step_gap(18, f"PP 2 x {PP_MICRO}", res["10"]["history"][0],
                      res["10"]["one_process"], (PP_TOLERANCE, PP_TOLERANCE))
    log(18, f"FSDP (world 1, NCCL, {fsdp['dtensor_parameters']} DTensor parameters): losses "
            + ", ".join(f"{m['loss']:.4f}" for m in fsdp["history"])
            + f"; launches over {PARALLEL_STEPS} steps {fsdp['launches']}; peak "
              f"{fsdp['peak_gib']:.2f} GiB; a save under FSDP loads into the plain state "
              f"bit-equal")
    fsdp_rel = step_gap(18, "FSDP", fsdp["history"][0], fsdp["one_process"],
                        (PP_TOLERANCE, PP_TOLERANCE))
    for path, runs in (("TP", [tp0, tp1]), ("PP", [res["10"], res["11"]]), ("FSDP", [fsdp])):
        if not runs[0]["history"][-1]["loss"] < runs[0]["history"][0]["loss"]:
            raise AssertionError(f"{path}: the loss did not fall")
    extra = {"short_attention_fwd": {}, "short_attention_bwd": {}}
    for tag, (fwd, bwd) in k2.items():
        extra["short_attention_fwd"].update(prefixed(tag, fwd))
        extra["short_attention_bwd"].update(prefixed(tag, bwd))
    numbers = {"tp_first_step_rel": tp_rel, "pp_first_step_rel": pp_rel,
               "tp_rank_gap": tp_ranks, "pp_rank_gap": pp_ranks,
               "fsdp_first_step_rel": fsdp_rel, "tp_peak_gib": tp0["peak_gib"],
               "pp_peak_gib": res["10"]["peak_gib"], "fsdp_peak_gib": fsdp["peak_gib"]}
    launches = {"tp_step": {k: v // PARALLEL_STEPS for k, v in tp0["launches"].items()},
                "tp_eval": tp0["eval_launches"],
                "pp_step": {k: v // PARALLEL_STEPS for k, v in res["10"]["launches"].items()},
                "fsdp_step": {k: v // PARALLEL_STEPS for k, v in fsdp["launches"].items()}}
    return extra, launches, numbers


def nyu_fixture_part(root):
    """Phase 19, part 1: the committed NYUv2 fixture through the port's
    HDF5 reader (each dataset's SHA-256 against h5py's, expected.json) and
    tools/prepare_nyuv2.py with and without the class map (each PNG's digest
    against the JAX tool's tree). Returns (the class-mapped tree, numbers)."""
    import hashlib

    from multimae_tpu_torch.tools import prepare_nyuv2
    from multimae_tpu_torch.utils.hdf5 import File

    with open(os.path.join(NYU_FIXTURE, "expected.json")) as f:
        expected = json.load(f)
    mat = os.path.join(NYU_FIXTURE, "nyu_depth_v2_labeled.mat")
    t0 = time.perf_counter()
    with File(mat) as f:
        for name, want in expected["datasets"].items():
            arr = f[name].read()
            got = [list(arr.shape), arr.dtype.str, hashlib.sha256(arr.tobytes()).hexdigest()]
            if got != [want["shape"], want["dtype"], want["sha256"]]:
                raise AssertionError(f"[19] {name}: {got}; expected.json holds {want}")
    read_ms = (time.perf_counter() - t0) * 1e3
    log(19, f"the port's HDF5 reader: the fixture's {len(expected['datasets'])} datasets "
            f"({', '.join(expected['datasets'])}) have h5py's SHA-256 (expected.json); read "
            f"whole in {read_ms:.1f} ms")
    numbers = {"nyu_read_ms": read_ms}
    for tree, mapped in (("class40", True), ("raw", False)):
        out = os.path.join(root, tree)
        summary = prepare_nyuv2.prepare(
            mat, os.path.join(NYU_FIXTURE, "splits.mat"), out, verbose=False,
            class_mapping_path=os.path.join(NYU_FIXTURE, "classMapping40.mat") if mapped else None)
        digests, want = prepare_nyuv2.tree_digests(out), expected["trees"][tree]
        bad = sorted(k for k in set(digests) | set(want) if digests.get(k) != want.get(k))
        if bad or summary["frames"] != expected["splits"]:
            raise AssertionError(f"[19] prepare_nyuv2 ({tree}): frames {summary['frames']}, "
                                 f"{len(bad)} PNGs differ from the JAX tool's: {bad[:6]}")
        numbers[f"nyu_prepare_{tree}_ms_per_frame"] = summary["ms_per_frame"]
        log(19, f"prepare_nyuv2 over the fixture ({'with' if mapped else 'without'} the class "
                f"map; {sum(summary['frames'].values())} frames at 640x480, "
                f"{summary['frames']}): {summary['ms_per_frame']:.1f} ms per frame; its "
                f"{len(digests)} PNGs have the JAX tool's pixel digests (expected.json)")
    return os.path.join(root, "class40"), numbers


def nyu_semseg_part(tree):
    """Phase 19, part 2: the semseg CLI over the class-mapped tree under the
    NYU rgb-depth recipe at NYU_BATCH, one epoch with an eval, then an
    --eval run; returns the launches per step and per eval batch and the
    numbers."""
    from multimae_tpu_torch.cli.run_finetuning_semseg import get_args, main

    out = os.path.join(os.path.dirname(tree), "out")
    n_train = len(os.listdir(os.path.join(tree, "train", "rgb", "all")))
    n_val = len(os.listdir(os.path.join(tree, "test", "rgb", "all")))
    base = ["-c", os.path.join(HERE, FT_YAML), "--finetune", "", "--batch_size",
            str(NYU_BATCH), "--warmup_epochs", "0", "--num_workers", "0",
            "--data_path", os.path.join(tree, "train"),
            "--eval_data_path", os.path.join(tree, "test"), "--output_dir", out]
    reset_launch_counts()
    run = main(get_args(base + ["--epochs", "1"]))
    launches = launch_counts()
    losses, mious = check_run("[19] the NYU fixture's run", run, n_train // NYU_BATCH, 1, n_val)
    reset_launch_counts()
    evaluated = main(get_args(base + ["--eval", "--resume",
                                      os.path.join(out, "checkpoint-0.pth")]))
    eval_batches = math.ceil(n_val / NYU_BATCH)
    per_step, per_eval = split_launches("[19] the NYU fixture's run", launches, len(losses), 1,
                                        evaluated, eval_batches, n_val)
    expect_step = dict(dict.fromkeys(launches, 0), short_attention_fwd=12,
                       short_attention_bwd=12, fused_ln_mlp_res_fwd=4, fused_ln_mlp_res_bwd=4)
    expect_eval = dict(dict.fromkeys(launches, 0), fused_block_infer=12, fused_ln_mlp_res_fwd=4)
    if (per_step, per_eval) != (expect_step, expect_eval):
        raise AssertionError(f"[19] NYU fixture: launches {per_step} per step and {per_eval} "
                             f"per eval batch; expected {expect_step} and {expect_eval}")
    log(19, f"semseg CLI over the prepared tree (NYU rgb-depth recipe, MultiViT-B at 512 px, "
            f"--finetune '', batch {NYU_BATCH}, {n_train} + {n_val} frames): losses "
            + ", ".join(f"{v:.4f}" for v in losses) + f", mIoU {mious[0]:.4f}; per step K2 "
            f"fwd {per_step['short_attention_fwd']}, bwd {per_step['short_attention_bwd']}, "
            f"K3b fwd {per_step['fused_ln_mlp_res_fwd']}, bwd "
            f"{per_step['fused_ln_mlp_res_bwd']}; per eval batch K4 "
            f"{per_eval['fused_block_infer']}, K3b fwd {per_eval['fused_ln_mlp_res_fwd']} "
            f"(totals {launches}, an --eval run over {eval_batches} batch)")
    return per_step, per_eval, {"nyu_losses": losses, "nyu_mIoU": mious[0]}


def variant_steps(torch, dev, phase, tag, **options):
    """VARIANT_STEPS steps of phase 7's recipe at VARIANT_BATCH with the
    decoder or GELU `options` of build_pretrain_trainer, each launching K1
    fwd and bwd 4 times (the decoders keep their cross-attention), the first
    against the plain twins at phase 7's bounds. Returns the launches per
    step and the first step's metrics."""
    from multimae_tpu_torch.cli.factory import build_pretrain_losses, build_pretrain_trainer
    from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step

    state, step = build_pretrain_trainer(batch_size=VARIANT_BATCH, seed=0, device=dev,
                                         **options)
    batch, masks = fixed_mask_batch(torch, dev, VARIANT_BATCH)
    plain_state = copy.deepcopy(state)
    plain_step = make_pretrain_train_step(plain_state.model, plain_state.balancer,
                                          build_pretrain_losses(("rgb", "depth", "semseg")))
    expect = dict(dict.fromkeys(launch_counts(), 0), fused_decoder_fwd=4, fused_decoder_bwd=4)
    log(phase, f"{tag}: MultiMAE ViT-B pretraining ({options}), batch {VARIANT_BATCH}")
    history, _, _ = steps_against_twins(torch, dev, phase, state, step, plain_state, plain_step,
                                        batch, masks, VARIANT_STEPS, expect)
    del state, plain_state
    free_card(torch)
    return expect, history[0]


def k1_launch_inputs(torch, dev, **options):
    """One step of phase 7's recipe at K1_INPUTS_BATCH with the decoder
    `options`, keeping what each K1 launch took (a wrapper around
    fused_decoder.fused_decoder_core): {task: {"q", "c", "w", "g" (the
    output's gradient), "heads", "depth"}}, the weights as they were."""
    from multimae_tpu_torch.cli.factory import build_pretrain_trainer
    from multimae_tpu_torch.ops import fused_decoder

    state, step = build_pretrain_trainer(batch_size=K1_INPUTS_BATCH, seed=0, device=dev,
                                         **options)
    batch, masks = fixed_mask_batch(torch, dev, K1_INPUTS_BATCH)
    taken, core = [], fused_decoder.fused_decoder_core

    def keep(q, c, w, heads, depth):
        out = core(q, c, w, heads, depth)
        entry = {"q": q.detach().clone(), "c": c.detach().clone(), "heads": heads,
                 "depth": depth, "w": fused_decoder.DecoderCoreWeights(
                     *[x.detach().clone() for x in w])}
        out.register_hook(lambda g: entry.__setitem__("g", g.detach().to(q.dtype).contiguous()))
        taken.append(entry)
        return out

    fused_decoder.fused_decoder_core = keep
    try:
        step(state, batch, task_masks=masks)
    finally:
        fused_decoder.fused_decoder_core = core
    tasks = list(state.model.output_adapters)
    if len(taken) != len(tasks) or not all("g" in e for e in taken):
        raise AssertionError(f"[19] {len(taken)} K1 launches kept for decoders {tasks}")
    return dict(zip(tasks, taken))


def k1_on_its_inputs(torch, dev, tag, **options):
    """Phase 19: K1's forward and backward on the inputs its launches took
    (`k1_launch_inputs`) against the plain twins within TWIN_TOLERANCE and
    GRAD_TOLERANCE, each printed first, and an fp32 decoder's kernel and
    twin against float64 autograd (`fused_decoder.decoder_core_f64`).
    Returns {task: (forward rel RMS, backward worst rel RMS)}."""
    from multimae_tpu_torch.ops import fused_decoder
    from multimae_tpu_torch.ops.functional import assert_matches_twin, twin_error

    taken = k1_launch_inputs(torch, dev, **options)
    free_card(torch)
    names = ["dq", "dc"] + ["d" + f for f in fused_decoder.DecoderCoreWeights._fields]
    readings, outputs = {}, {}
    for task, e in taken.items():
        q, c, w, g, dtype = e["q"], e["c"], e["w"], e["g"], e["q"].dtype
        args = (e["heads"], e["depth"])
        with torch.no_grad():
            out = fused_decoder.fused_decoder_core(q, c, w, *args)
            ref = fused_decoder.decoder_core_ref(q, c, w, *args)
            dq, dc, dw = fused_decoder.fused_decoder_core_bwd(q, c, w, g, *args)
            rq, rc, rw = fused_decoder.decoder_core_bwd_ref(q, c, w, g, *args)
        grads, twin_grads = [dq, dc, *dw], [rq, rc, *rw]
        outputs[task] = (out, ref, grads, twin_grads, dtype)
        fwd = twin_error(out, ref)
        bwd = {n: twin_error(o, r) for o, r, n in zip(grads, twin_grads, names)}
        name = max(bwd, key=lambda n: bwd[n][1])
        readings[task] = (fwd[1], bwd[name][1])
        log(19, f"{tag}, K1 on the {task} decoder's own inputs ({tuple(q.shape)} queries, "
                f"{tuple(c.shape)} context, {dtype}) against the twins: fwd max abs "
                f"{fwd[0]:.3e}, rel RMS {fwd[1]:.3e}; bwd worst rel RMS {bwd[name][1]:.3e} "
                f"({name}), max abs {max(v[0] for v in bwd.values()):.3e}")
        if dtype == torch.float32:  # where two fp32 roundings part, which is nearer exact
            exact = fused_decoder.decoder_core_f64(q, c, w, g, *args)
            far = {n: (rel_rms(o, x), rel_rms(r, x))
                   for o, r, x, n in zip([out] + grads, [ref] + twin_grads, exact,
                                         ["out"] + names)}
            log(19, f"{tag}, {task} (fp32) against float64 autograd, rel RMS kernel / twin: "
                    + ", ".join(f"{n} {a:.2e} / {b:.2e}" for n, (a, b) in far.items()))
    for task, (out, ref, grads, twin_grads, dtype) in outputs.items():
        assert_matches_twin(out, ref, f"[19] {tag} K1 fwd on the {task} decoder's inputs")
        for o, r, n in zip(grads, twin_grads, names):
            assert_matches_twin(o, r, f"[19] {tag} K1 bwd {n} on the {task} decoder's inputs",
                                grad_of=dtype)
    del taken
    free_card(torch)
    return readings


def no_xattn_cli_part(torch, root):
    """Phase 19: the pretraining CLI (get_args + main) with
    `decoder_use_xattn: false` in a YAML, VARIANT_STEPS synthetic steps at
    VARIANT_BATCH: no kernel launches; the first step again on the plain
    twins."""
    from multimae_tpu_torch.cli.run_pretraining_multimae import get_args, main

    cfg = os.path.join(root, "no_xattn.yaml")
    with open(os.path.join(HERE, CLI_YAML)) as src, open(cfg, "w") as dst:
        dst.write(src.read() + "\ndecoder_use_xattn: false\n")
    args = ["-c", cfg, "--synthetic_data", "--synthetic_steps_per_epoch", str(VARIANT_STEPS),
            "--batch_size", str(VARIANT_BATCH), "--epochs", "1", "--warmup_epochs", "0",
            "--output_dir", ""]
    parsed = get_args(args)
    if parsed.decoder_use_xattn is not False:
        raise AssertionError(f"[19] decoder_use_xattn: {parsed.decoder_use_xattn} from {cfg}")
    reset_launch_counts()
    run = main(parsed)
    launches = launch_counts()
    metrics = [r["metrics"] for r in run["steps"]]
    if any(launches.values()) or len(metrics) != VARIANT_STEPS or not all(
            math.isfinite(m["loss"]) for m in metrics):
        raise AssertionError(f"[19] decoder_use_xattn false: launches {launches}, "
                             f"losses {[m['loss'] for m in metrics]}")
    with plain_twins():
        plain = main(get_args(args + ["--synthetic_steps_per_epoch", "1"]))["steps"][0]["metrics"]
    rels = {k: abs(metrics[0][k] - v) / abs(v) for k, v in plain.items()
            if k == "grad_norm" or k.endswith("_loss")}
    if not all(r <= STEP_TOLERANCE for r in rels.values()):
        raise AssertionError(f"[19] decoder_use_xattn false: step 0 vs plain twins {rels}")
    log(19, f"pretraining CLI with decoder_use_xattn: false (YAML), batch {VARIANT_BATCH}: "
            "losses " + ", ".join(f"{m['loss']:.4f}" for m in metrics) + "; no kernel "
            f"launched (K1 needs the cross-attention form); step 0 vs plain twins worst rel "
            f"{max(rels.values()):.2e} (limit {STEP_TOLERANCE})")
    free_card(torch)
    return launches, [m["loss"] for m in metrics]


def cls_host_part(card):
    """Phase 19: over the 500 x 375 photo fixtures resized to 224 x 224, each
    AutoAugment policy and AugMix (AA_POLICIES), and PIL's nearest and
    Lanczos resizes of the photos, native against the numpy twins, bit-equal;
    ms per sample of each."""
    import random

    import numpy as np

    from multimae_tpu_torch.data import auto_augment, pil_ops
    from multimae_tpu_torch.data.image_io import load_image
    from multimae_tpu_torch.utils.data_constants import IMAGENET_DEFAULT_MEAN

    photos = [load_image(os.path.join(JPEG_FIXTURES, n))
              for n in sorted(os.listdir(JPEG_FIXTURES)) if n.startswith("photo_")]
    crops = [pil_ops.NATIVE_OPS.resize(p, (224, 224), "bicubic") for p in photos]
    fill = tuple(min(255, round(255 * m)) for m in IMAGENET_DEFAULT_MEAN)
    numbers, runs = {}, 4
    for config in AA_POLICIES:
        ms = {}
        outs = {}
        for twin in (False, True):
            aa = auto_augment.create_aa_transform(config, {"img_mean": fill}, twin=twin)
            t0 = time.perf_counter()
            outs[twin] = [aa(img, random.Random(i * runs + r)) for i, img in enumerate(crops)
                          for r in range(runs)]
            ms[twin] = (time.perf_counter() - t0) * 1e3 / len(outs[twin])
        if not all(np.array_equal(a, b) for a, b in zip(outs[False], outs[True])):
            raise AssertionError(f"[19] --aa {config}: native and twin arrays differ")
        numbers[f"aa_{config}_ms"] = ms[False]
        numbers[f"aa_{config}_twin_ms"] = ms[True]
    for resample in ("nearest", "lanczos"):
        ms = {}
        outs = {}
        for twin, ops in ((False, pil_ops.NATIVE_OPS), (True, pil_ops.TWIN_OPS)):
            t0 = time.perf_counter()
            outs[twin] = [ops.resize(p, size, resample) for p in photos
                          for size in ((224, 224), (256, 341))]
            ms[twin] = (time.perf_counter() - t0) * 1e3 / len(outs[twin])
        if not all(np.array_equal(a, b) for a, b in zip(outs[False], outs[True])):
            raise AssertionError(f"[19] {resample} resize: native and twin arrays differ")
        numbers[f"resize_{resample}_ms"], numbers[f"resize_{resample}_twin_ms"] = ms[False], ms[True]
    log(19, f"cls host transforms over the {len(photos)} photo fixtures, native and twin "
            f"bit-equal (card {card}; ms per sample, native / twin): " + ", ".join(
                f"{c} {numbers[f'aa_{c}_ms']:.2f} / {numbers[f'aa_{c}_twin_ms']:.2f}"
                for c in AA_POLICIES) + "; " + ", ".join(
                f"{r} resize {numbers[f'resize_{r}_ms']:.2f} / {numbers[f'resize_{r}_twin_ms']:.2f}"
                for r in ("nearest", "lanczos")))
    return numbers


def cls_policy_cli_part(root):
    """Phase 19: the cls CLI's first step and an eval batch at CLS_BATCH
    with --aa AA_CLI --train_interpolation AA_INTERP over links to the photo
    fixtures: the step launches nothing, the eval batch K4 12 times."""
    from multimae_tpu_torch.cli.run_finetuning_cls import get_args, main
    from multimae_tpu_torch.data.dataset_folder import write_imagenet_tree

    photos = sorted(os.path.join(JPEG_FIXTURES, n) for n in os.listdir(JPEG_FIXTURES)
                    if n.startswith("photo_"))
    train, val = write_imagenet_tree(os.path.join(root, "cls"), photos, CLS_BATCH, CLS_BATCH,
                                     CLS_CLASSES)
    args = ["-c", os.path.join(HERE, CLS_YAML), "--finetune", "", "--data_set", "image_folder",
            "--nb_classes", str(CLS_CLASSES), "--data_path", train, "--eval_data_path", val,
            "--batch_size", str(CLS_BATCH), "--warmup_epochs", "0", "--epochs", "1",
            "--num_workers", str(CLI_WORKERS), "--aa", AA_CLI, "--train_interpolation",
            AA_INTERP, "--output_dir", ""]
    reset_launch_counts()
    run = main(get_args(args))
    launches = launch_counts()
    losses, accs = check_cls_run("[19] cls CLI", run, 1, 1, CLS_BATCH)
    expect = dict(dict.fromkeys(launches, 0), fused_block_infer=12)
    if launches != expect:
        raise AssertionError(f"[19] cls CLI: launches {launches} over a step and an eval "
                             f"batch; expected {expect}")
    step_ms = run["steps"][0]["step_s"] * 1e3
    log(19, f"cls CLI (--aa {AA_CLI} --train_interpolation {AA_INTERP}, batch {CLS_BATCH}): "
            f"first loss {losses[0]:.4f}, top-1/5 {accs[0][0]:.2f}/{accs[0][1]:.2f}; K4 "
            f"{launches['fused_block_infer']} in the eval batch, nothing in the step; step "
            f"{step_ms:.1f} ms host, eval {run['evals'][0]['ms_per_batch']:.3f} ms per batch")
    return launches, {"cls_policy_loss": losses[0], "cls_policy_step_ms": step_ms}


def last_modules_slice(torch, dev, card):
    """Phase 19; returns ({path: {kernel: launches}}, numbers)."""
    import shutil

    root = os.path.join(HERE, "build", "chip_smoke_last")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        tree, numbers = nyu_fixture_part(root)
        per_step, per_eval, nyu = nyu_semseg_part(tree)
        numbers.update(nyu)
        free_card(torch)
        launches = {"nyu_semseg_step": per_step, "nyu_semseg_eval": per_eval}
        kinds = (("default", "default decoders", {}),
                 ("no_task_queries", "decoders without task queries",
                  {"decoder_use_task_queries": False}))
        for key, tag, options in kinds:
            numbers[f"k1_inputs_{key}"] = k1_on_its_inputs(torch, dev, tag, **options)
        log(19, f"K1 against its twin on its own inputs at batch {K1_INPUTS_BATCH} (fwd / bwd "
                "worst rel RMS by decoder): " + "; ".join(
                    f"{tag}: " + ", ".join(f"{t} {f:.2e} / {b:.2e}" for t, (f, b) in
                                           numbers[f"k1_inputs_{key}"].items())
                    for key, tag, _ in kinds))
        launches["no_task_queries_step"], first = variant_steps(
            torch, dev, 19, "decoders without task queries", decoder_use_task_queries=False)
        numbers["no_task_queries_loss"] = first["loss"]
        launches["no_xattn_cli"], numbers["no_xattn_losses"] = no_xattn_cli_part(torch, root)
        launches["approx_gelu_step"], first = variant_steps(
            torch, dev, 19, "--approx_gelu", approx_gelu=True)
        numbers["approx_gelu_loss"] = first["loss"]
        numbers.update(cls_host_part(card))
        launches["cls_policy_cli"], cls = cls_policy_cli_part(root)
        numbers.update(cls)
        return launches, numbers
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_card(torch)


def image_fixture_check(card):
    """Phase 20: every fixture of tests/fixtures/images (Adam7 PNG, BMP,
    netpbm, TIFF), tests/fixtures/webp, tests/fixtures/jpeg2000 and
    tests/fixtures/tiff_codecs through this machine's build of the native
    library: the SHA-256 of its RGB and raw forms equal expected.json's
    (PIL's; the JPEG-compressed and YCbCr TIFF files of item 11g and the
    codecs of item 11h among them), a damaged file raises ValueError naming
    what expected.json says. Logs whether this host's Python imports lzma
    (LZMA strips go through it)."""
    import hashlib

    from multimae_tpu_torch.data.image_io import load_image

    try:
        import lzma

        has_lzma = f"imports lzma ({lzma.__file__})"
    except ImportError as e:
        has_lzma = f"cannot import lzma: {e}"
    log(20, f"this host's Python {sys.version.split()[0]} {has_lzma}")
    expected = {}
    for folder in (IMAGE_FIXTURES, WEBP_FIXTURES, JPEG2000_FIXTURES, TIFF_CODECS_FIXTURES):
        with open(os.path.join(folder, "expected.json")) as f:
            expected.update({os.path.join(folder, n): want for n, want in json.load(f).items()})
    kinds = {"read": 0, "refused": 0, "tiff": 0, "jpeg_ycbcr_tiff": 0, "webp": 0,
             "webp_refused": 0, "jpeg2000": 0, "jpeg2000_refused": 0, "ported_in": 0}
    codecs = {}
    for path, want in sorted(expected.items()):
        name = os.path.basename(path)
        kinds["tiff"] += name.endswith(".tif")
        kinds["webp" if "sha256" in want else "webp_refused"] += name.endswith(".webp")
        kinds["jpeg2000" if "sha256" in want else "jpeg2000_refused"] += name.endswith(
            (".jp2", ".j2k", ".jpx"))
        kinds["jpeg_ycbcr_tiff"] += (name.endswith(".tif") and "sha256" in want
                                     and ("jpeg" in name or "ycbcr" in name))
        if "error" in want:  # a damaged file: ValueError naming what expected.json says
            try:
                load_image(path)
            except ValueError as e:
                if not all(text in str(e) for text in (name, want["error"])):
                    raise AssertionError(f"[20] {name}: {e}; expected ValueError naming "
                                         f"{want['error']!r}") from e
                kinds["refused"] += 1
                continue
            raise AssertionError(f"[20] {name} decoded; expected ValueError naming "
                                 f"{want['error']!r}")
        for form, array in (("sha256", load_image(path)),
                            ("raw_sha256", load_image(path, convert_rgb=False))):
            if hashlib.sha256(array.tobytes()).hexdigest() != want[form]:
                raise AssertionError(f"[20] {name}: {form} differs from expected.json's")
        kinds["read"] += 1
        kinds["ported_in"] += "ported_in" in want
        if "codec" in want:
            codecs[want["codec"]] = codecs.get(want["codec"], 0) + 1
    log(20, f"image fixtures: {kinds['read']} PNG, BMP, netpbm, TIFF, WebP and JPEG 2000 files "
            f"decode to PIL's SHA-256 in both forms ({kinds['jpeg_ycbcr_tiff']} JPEG-compressed "
            f"or YCbCr TIFF, {kinds['webp']} WebP, {kinds['jpeg2000']} JPEG 2000; of item 11h: "
            + ", ".join(f"{v} {k}" for k, v in sorted(codecs.items()))
            + f"; {kinds['ported_in']} once refused), {kinds['refused']} damaged ones raise "
            f"ValueError ({kinds['webp_refused']} WebP, {kinds['jpeg2000_refused']} JPEG 2000); "
            f"{kinds['tiff']} of them TIFF (card {card})")
    kinds["codecs"] = codecs
    return kinds


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def pretrain_epoch(pt_cli, tree, what, rgb_files):
    """Phase 20: one epoch of the pretraining CLI (CLI_YAML, ViT-B at full
    width) at LOADER_PT_BATCH over `tree`: K1 fwd and bwd 4 per step, no
    resample line, finite metrics. Returns (launches, losses)."""
    tee = _Tee(sys.stdout)
    reset_launch_counts()
    with contextlib.redirect_stdout(tee):
        run = pt_cli.main(pt_cli.get_args([
            "-c", os.path.join(HERE, CLI_YAML), "--batch_size", str(LOADER_PT_BATCH),
            "--warmup_epochs", "0", "--num_workers", "0", "--data_path", tree,
            "--output_dir", "", "--epochs", "1", "--no_auto_resume"]))
    launches = launch_counts()
    steps = len(run["steps"])
    expect_launches(f"[20] pretraining CLI over {what}", launches,
                    fused_decoder_fwd=4 * steps, fused_decoder_bwd=4 * steps)
    resampled = "resampling" in "".join(tee.parts)
    if steps != LOADER_SAMPLES // LOADER_PT_BATCH or resampled or not all(
            math.isfinite(v) for r in run["steps"] for v in r["metrics"].values()):
        raise AssertionError(f"[20] pretraining CLI over {what}: {steps} steps, resample "
                             f"lines {resampled}, metrics {[r['metrics'] for r in run['steps']]}")
    losses = [r["metrics"]["loss"] for r in run["steps"]]
    log(20, f"pretraining CLI over {LOADER_SAMPLES} samples of {what} (rgb images "
            + ", ".join(os.path.basename(p) for p in rgb_files) + "): losses "
            + ", ".join(f"{v:.4f}" for v in losses)
            + f"; K1 fwd {launches['fused_decoder_fwd']}, bwd {launches['fused_decoder_bwd']} "
            f"over {steps} steps; no sample resampled")
    return launches, losses


def loaders_slice(torch, dev, card):
    """Phase 20; returns ({path: {kernel: launches}}, numbers)."""
    import shutil

    import numpy as np

    from multimae_tpu_torch.cli import demo
    from multimae_tpu_torch.cli import run_finetuning_cls as cls_cli
    from multimae_tpu_torch.cli import run_finetuning_semseg as seg_cli
    from multimae_tpu_torch.cli import run_pretraining_multimae as pt_cli
    from multimae_tpu_torch.cli.factory import build_pretrain_model
    from multimae_tpu_torch.data.dataset_folder import write_imagenet_tree, write_random_tree
    from multimae_tpu_torch.utils.convert import state_dict_to_jax_params
    from multimae_tpu_torch.utils.flax_msgpack import msgpack_serialize
    from multimae_tpu_torch.utils.torch_compat import proj_shapes_of

    root = os.path.join(HERE, "build", "chip_smoke_loaders")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    launches, numbers = {}, {}
    try:
        numbers["image_fixtures"] = image_fixture_check(card)

        # The JAX package's params file of a MultiMAE-B, from the port's writer.
        model = build_pretrain_model(device="cpu")
        model.init_weights(torch.Generator().manual_seed(20))
        sd = model.state_dict()
        t0 = time.perf_counter()
        params, _ = state_dict_to_jax_params(sd, proj_shapes_of(model))
        data = msgpack_serialize({"params": {"model": params, "balancer": {
            "log_vars": np.zeros(3, np.float32)}}, "step": 0, "epoch": 0})
        msgpack = os.path.join(root, "checkpoint-0.msgpack")
        with open(msgpack, "wb") as f:
            f.write(data)
        write_s = time.perf_counter() - t0
        pth = os.path.join(root, "checkpoint-0.pth")
        torch.save({"model": sd}, pth)
        del model, sd, params, data
        log(20, f"MultiMAE-B params as the JAX package saves them: {os.path.getsize(msgpack) / 2**20:.1f} "
                f"MiB of flax msgpack, converted and written in {write_s:.2f} s; the same "
                f"weights as a .pth")

        # The demo from both files: the same preds, bit for bit.
        demo_root = os.path.join(root, "demo")
        os.makedirs(demo_root)
        rng = np.random.default_rng(20)
        from multimae_tpu_torch.data.image_io import write_png
        write_png(os.path.join(demo_root, "depth.png"),
                  rng.integers(1000, 60000, (375, 500)).astype(np.uint16))
        write_png(os.path.join(demo_root, "semseg.png"),
                  rng.integers(0, 40, (375, 500)).astype(np.uint8),
                  palette=rng.integers(0, 256, (256, 3), dtype=np.uint8))
        preds = {}
        for kind, path in (("msgpack", msgpack), ("pth", pth)):
            reset_launch_counts()
            t0 = time.perf_counter()
            out = demo.main(["--checkpoint", path, "--rgb", DEMO_RGB, "--depth",
                             os.path.join(demo_root, "depth.png"), "--semseg",
                             os.path.join(demo_root, "semseg.png"), "--visible_rgb",
                             DEMO_VISIBLE, "--out_dir", os.path.join(demo_root, kind)])
            numbers[f"demo_{kind}_s"] = time.perf_counter() - t0
            launches[f"demo_{kind}"] = launch_counts()
            expect_launches(f"[20] demo ({kind})", launches[f"demo_{kind}"], fused_decoder_fwd=3)
            preds[kind] = {t: p.cpu() for t, p in out["preds"].items()}
            del out
            free_card(torch)
        if not all(torch.equal(preds["msgpack"][t], preds["pth"][t]) for t in preds["pth"]):
            raise AssertionError("[20] the demo's preds from the .msgpack differ from the .pth's")
        log(20, f"demo from the .msgpack and from the .pth: preds of "
                f"{', '.join(preds['pth'])} bit-equal; K1 fwd "
                f"{launches['demo_msgpack']['fused_decoder_fwd']} launches each (fp32); "
                f"{numbers['demo_msgpack_s']:.2f} / {numbers['demo_pth_s']:.2f} s host")

        # The cls CLI from the .msgpack: one step and one eval batch.
        photos = sorted(os.path.join(JPEG_FIXTURES, n) for n in os.listdir(JPEG_FIXTURES)
                        if n.startswith("photo_"))
        train, val = write_imagenet_tree(os.path.join(root, "cls"), photos, LOADER_CLS_BATCH,
                                         LOADER_CLS_BATCH, CLS_CLASSES)
        reset_launch_counts()
        run = cls_cli.main(cls_cli.get_args([
            "-c", os.path.join(HERE, CLS_YAML), "--finetune", msgpack, "--data_set",
            "image_folder", "--nb_classes", str(CLS_CLASSES), "--data_path", train,
            "--eval_data_path", val, "--batch_size", str(LOADER_CLS_BATCH),
            "--warmup_epochs", "0", "--epochs", "1", "--num_workers", "0", "--output_dir", ""]))
        launches["cls_cli_msgpack"] = launch_counts()
        losses, accs = check_cls_run("[20] cls CLI", run, 1, 1, LOADER_CLS_BATCH)
        expect_launches("[20] cls CLI from the .msgpack", launches["cls_cli_msgpack"],
                        fused_block_infer=12)
        report = run["finetune"]
        if not 0 < report["loaded"] < report["total"]:
            raise AssertionError(f"[20] cls start: loaded {report['loaded']}/{report['total']}")
        log(20, f"cls CLI --finetune checkpoint-0.msgpack (batch {LOADER_CLS_BATCH}): loaded "
                f"{report['loaded']}/{report['total']} tensors by the JAX CLI's rule (the "
                f"head's at its initial values); first loss {losses[0]:.4f}; K4 "
                f"{launches['cls_cli_msgpack']['fused_block_infer']} in the eval batch, "
                f"nothing in the step")
        numbers.update(cls_loaded=report["loaded"], cls_total=report["total"],
                       cls_loss=losses[0])
        free_card(torch)

        # The semseg CLI from the .msgpack at 512 px: one step and one eval batch.
        seg = os.path.join(root, "seg")
        nyu = dict(semseg_classes=SEMSEG_CLASSES, ignore_patches=True, mask_valid=True,
                   smooth=True)
        write_random_tree(os.path.join(seg, "train"), LOADER_SEG_BATCH, FT_HW, **nyu)
        write_random_tree(os.path.join(seg, "val"), LOADER_SEG_BATCH, FT_HW, seed=1, **nyu)
        reset_launch_counts()
        run = seg_cli.main(seg_cli.get_args([
            "-c", os.path.join(HERE, FT_YAML), "--finetune", msgpack, "--batch_size",
            str(LOADER_SEG_BATCH), "--warmup_epochs", "0", "--epochs", "1", "--num_workers",
            "0", "--data_path", os.path.join(seg, "train"), "--eval_data_path",
            os.path.join(seg, "val"), "--output_dir", ""]))
        launches["semseg_cli_msgpack"] = launch_counts()
        losses, mious = check_run("[20] semseg CLI", run, 1, 1, LOADER_SEG_BATCH)
        expect_launches("[20] semseg CLI from the .msgpack (a step and an eval batch)",
                        launches["semseg_cli_msgpack"], short_attention_fwd=12,
                        short_attention_bwd=12, fused_ln_mlp_res_fwd=8, fused_ln_mlp_res_bwd=4,
                        fused_block_infer=12)
        report = run["finetune"]
        if not 0 < report["loaded"] < report["total"] or any(
                p[0].startswith("output_adapters") for p in report["paths"]):
            raise AssertionError(f"[20] semseg start: loaded {report['loaded']}/"
                                 f"{report['total']}")
        log(20, f"semseg CLI --finetune checkpoint-0.msgpack (NYU recipe, 512 px, batch "
                f"{LOADER_SEG_BATCH}): loaded {report['loaded']}/{report['total']} tensors "
                f"by _load_flax_trunk's rule; loss {losses[0]:.4f}, mIoU {mious[0]:.4f}; K2 "
                f"12 + 12 and K3b 4 + 4 in the step, K4 12 and K3b fwd 4 in the eval batch")
        numbers.update(semseg_loaded=report["loaded"], semseg_total=report["total"],
                       semseg_loss=losses[0])
        free_card(torch)

        # One pretraining epoch over a tree of the new formats, one over a
        # TIFF tree (depth in both byte orders, palette semseg), and one over
        # a TIFF tree whose rgb files are the codecs of item 11h.
        fixtures = [os.path.join(JPEG_FIXTURES, n) for n in os.listdir(JPEG_FIXTURES)
                    if n.startswith("tree_")]
        fixtures += [os.path.join(folder, n)
                     for folder in (IMAGE_FIXTURES, WEBP_FIXTURES, JPEG2000_FIXTURES)
                     for n in os.listdir(folder) if n.startswith("tree_")]
        codec_trees = sorted(os.path.join(TIFF_CODECS_FIXTURES, n)
                             for n in os.listdir(TIFF_CODECS_FIXTURES) if n.startswith("tree_"))
        for key, what, fmt, rgb_files in (
                ("pretrain_new_formats", "the new formats", "png",
                 sorted(p for p in fixtures if not p.endswith(".tif"))),
                ("pretrain_tiff", "TIFF", "tiff",
                 sorted(p for p in fixtures if p.endswith(".tif"))),
                ("pretrain_tiff_codecs", "the TIFF codecs of item 11h", "tiff", codec_trees)):
            tree = os.path.join(root, key)
            write_random_tree(tree, LOADER_SAMPLES, LOADER_HW, smooth=True, rgb_files=rgb_files,
                              fmt=fmt)
            launches[key], numbers[f"{key}_losses"] = pretrain_epoch(pt_cli, tree, what,
                                                                     rgb_files)
            free_card(torch)

        return launches, numbers
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_card(torch)


# Phase 21, a JAX-layout resume at full width: the pretraining CLI
# (CLI_YAML with the uncertainty balancer, synthetic batches of
# TRAIN_BATCH, RESUME_STEPS steps an epoch) and the semseg CLI over the
# NYUv2 fixture's class-mapped tree (FT_YAML at NYU_BATCH: one step an
# epoch and an eval batch). Run P trains two epochs and saves a .pth; run M
# saves epoch 0 as the JAX package's checkpoint-0.msgpack (--ckpt_backend
# msgpack) and is stopped right after that save, as a preemption would
# stop it, and its relaunch auto-resumes epoch 1 from the file. The file's
# tree must be the JAX layout of tests/fixtures/jax_state/, and M's epoch
# 1 (metrics, evaluation, final parameters and optimizer state) bit-equal
# to P's: the fp32 trees copy exactly and the kernels are deterministic.
RESUME_STEPS = 2
JAX_STATE_FIXTURES = os.path.join(HERE, "tests", "fixtures", "jax_state")


class _Preempted(Exception):
    """Stops run M after its epoch-0 save."""


def state_leaves(tree, path=()):
    """{"a/b": [shape, dtype]} of a tree flax_msgpack read ([None, "int"]
    for an int), as tests/fixtures/jax_state/make_manifests.py writes them."""
    from multimae_tpu_torch.utils.flax_msgpack import _NAMES

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(state_leaves(v, path + (k,)))
        return out
    if type(tree) is int:
        return {"/".join(path): [None, "int"]}
    return {"/".join(path): [list(tree.shape), _NAMES[tree.dtype]]}


def same_saves(a, b):
    """Raise unless two .pth saves hold the same tensors and counters, bit
    for bit: the model, the balancer, every optimizer state tensor."""
    import torch

    x, y = (torch.load(p, map_location="cpu", weights_only=True) for p in (a, b))
    pairs = [(f"model.{k}", v, y["model"][k]) for k, v in x["model"].items()]
    pairs += [(f"loss_balancer.{k}", v, y["loss_balancer"][k])
              for k, v in (x["loss_balancer"] or {}).items()]
    pairs += [(f"optimizer.{i}.{k}", v, y["optimizer"]["state"][i][k])
              for i, per in x["optimizer"]["state"].items() for k, v in per.items()]
    differ = [n for n, u, v in pairs if not torch.equal(u, v)]
    if differ or set(x["model"]) != set(y["model"]) or (x["step"], x["updates"]) != (
            y["step"], y["updates"]):
        raise AssertionError(f"{a} and {b} differ: {differ[:8]} of {len(pairs)} tensors, "
                             f"step/updates {x['step'], x['updates']} / "
                             f"{y['step'], y['updates']}")
    return len(pairs)


def run_launches(expect, steps, evals):
    """{kernel: launches} of `steps` steps and `evals` eval batches."""
    out = {k: v * steps for k, v in expect["step"].items()}
    for k, v in expect["eval"].items():
        out[k] = out.get(k, 0) + v * evals
    return out


def resume_pair(cli, what, base, root, manifest, expect):
    """Phase 21's runs P and M of one CLI (`base`: its flags for two
    epochs); returns the relaunch's launches and the numbers."""
    from multimae_tpu_torch.train import checkpoint as ckpt_lib
    from multimae_tpu_torch.utils.flax_msgpack import read_msgpack

    p_dir, m_dir = os.path.join(root, "p"), os.path.join(root, "m")
    reset_launch_counts()
    first = cli.main(cli.get_args(base + ["--output_dir", p_dir]))
    expect_launches(f"[21] {what} run P", launch_counts(),
                    **run_launches(expect, len(first["steps"]), len(first.get("evals", []))))
    free_card(sys.modules["torch"])

    save, timed = ckpt_lib.save_checkpoint, {}

    def save_then_stop(*args, **kwargs):
        t0 = time.perf_counter()
        path = save(*args, **kwargs)
        if kwargs.get("tag") is None:
            timed["write_s"] = time.perf_counter() - t0
            raise _Preempted(path)
        return path

    ckpt_lib.save_checkpoint = save_then_stop
    try:
        cli.main(cli.get_args(base + ["--output_dir", m_dir, "--ckpt_backend", "msgpack",
                                      "--save_ckpt_freq", "1"]))
        raise AssertionError(f"[21] {what} run M went past its epoch-0 save")
    except _Preempted as stop:
        msgpack = str(stop)
    finally:
        ckpt_lib.save_checkpoint = save
    free_card(sys.modules["torch"])
    with open(manifest) as f:
        want = json.load(f)
    got = state_leaves({k: v for k, v in read_msgpack(msgpack).items() if k != "extras"})
    if got != want:
        bad = sorted(k for k in set(got) | set(want) if got.get(k) != want.get(k))
        raise AssertionError(f"[21] {msgpack}: {len(bad)} leaves differ from "
                             f"{os.path.basename(manifest)}: {bad[:6]}")

    tee = _Tee(sys.stdout)
    reset_launch_counts()
    with contextlib.redirect_stdout(tee):
        again = cli.main(cli.get_args(base + ["--output_dir", m_dir]))
    launches = launch_counts()
    free_card(sys.modules["torch"])
    printed = "".join(tee.parts)
    p_steps = [r["metrics"] for r in first["steps"] if r["epoch"] == 1]
    m_steps = [r["metrics"] for r in again["steps"]]
    p_evals = [{k: e[k] for k in ("mIoU", "images")} for e in first.get("evals", [])
               if e["epoch"] == 1]
    m_evals = [{k: e[k] for k in ("mIoU", "images")} for e in again.get("evals", [])]
    if (again["start_epoch"], again["resumed_from"], again.get("resume_bit_equal"),
            expect["printed"] in printed) != (1, msgpack, True, True):
        raise AssertionError(f"[21] {what} relaunch: start epoch {again['start_epoch']}, from "
                             f"{again['resumed_from']}, bit-equal {again.get('resume_bit_equal')}"
                             f", {expect['printed']!r} printed: {expect['printed'] in printed}")
    if m_steps != p_steps or m_evals != p_evals or not p_steps:
        raise AssertionError(f"[21] {what}: epoch 1 resumed {m_steps} {m_evals}; run P "
                             f"{p_steps} {p_evals}")
    expect_launches(f"[21] {what} relaunch", launches,
                    **run_launches(expect, len(m_steps), len(m_evals)))
    tensors = same_saves(os.path.join(p_dir, "checkpoint-1.pth"),
                         os.path.join(m_dir, "checkpoint-1.pth"))
    mib = os.path.getsize(msgpack) / 2**20
    log(21, f"{what}: checkpoint-0.msgpack ({mib:.1f} MiB, {len(got)} leaves as "
            f"{os.path.basename(manifest)} holds them) written in {timed['write_s']:.2f} s, "
            f"read, mapped and loaded in {again['load_s']:.2f} s; epoch 1 resumed from it "
            "bit-equal to run P's: losses " + ", ".join(f"{m['loss']:.6f}" for m in m_steps)
            + ", grad norms " + ", ".join(f"{m['grad_norm']:.6f}" for m in m_steps)
            + (f", mIoU {m_evals[0]['mIoU']:.6f}" if m_evals else "")
            + f", and the {tensors} tensors of the epoch-1 saves (the parameters and the "
            f"optimizer state); relaunch launches {launches}")
    return launches, {"msgpack_mib": mib, "write_s": timed["write_s"],
                      "load_s": again["load_s"], "losses": [m["loss"] for m in m_steps],
                      "tensors_bit_equal": tensors}


def jax_resume_slice(torch, dev, card):
    """Phase 21; returns ({path: {kernel: launches}}, numbers)."""
    import shutil

    from multimae_tpu_torch.cli import run_finetuning_semseg as seg_cli
    from multimae_tpu_torch.cli import run_pretraining_multimae as pt_cli
    from multimae_tpu_torch.tools import prepare_nyuv2

    root = os.path.join(HERE, "build", "chip_smoke_resume")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    launches, numbers = {}, {}
    try:
        base = ["-c", os.path.join(HERE, CLI_YAML), "--task_balancer", "uncertainty",
                "--synthetic_data", "--synthetic_steps_per_epoch", str(RESUME_STEPS),
                "--batch_size", str(TRAIN_BATCH), "--warmup_epochs", "0", "--num_workers", "0",
                "--epochs", "2", "--save_ckpt_freq", "2"]
        launches["jax_resume_pretrain"], numbers["pretrain"] = resume_pair(
            pt_cli, f"pretraining CLI (MultiMAE-B, batch {TRAIN_BATCH})", base,
            os.path.join(root, "pretrain"),
            os.path.join(JAX_STATE_FIXTURES, "pretrain_multimae_b.json"),
            {"step": {"fused_decoder_fwd": 4, "fused_decoder_bwd": 4}, "eval": {},
             "printed": "checkpoint-0.msgpack holds no data position the port reads"})

        tree = os.path.join(root, "nyu")
        prepare_nyuv2.prepare(os.path.join(NYU_FIXTURE, "nyu_depth_v2_labeled.mat"),
                              os.path.join(NYU_FIXTURE, "splits.mat"), tree, verbose=False,
                              class_mapping_path=os.path.join(NYU_FIXTURE, "classMapping40.mat"))
        base = ["-c", os.path.join(HERE, FT_YAML), "--finetune", "", "--batch_size",
                str(NYU_BATCH), "--warmup_epochs", "0", "--num_workers", "0",
                "--data_path", os.path.join(tree, "train"),
                "--eval_data_path", os.path.join(tree, "test"), "--epochs", "2",
                "--save_ckpt_freq", "2"]
        launches["jax_resume_semseg"], numbers["semseg"] = resume_pair(
            seg_cli, f"semseg CLI (NYU fixture, MultiViT-B at 512 px, batch {NYU_BATCH})",
            base, os.path.join(root, "semseg"),
            os.path.join(JAX_STATE_FIXTURES, "semseg_nyu_multivit_b.json"),
            {"step": {"short_attention_fwd": 12, "short_attention_bwd": 12,
                      "fused_ln_mlp_res_fwd": 4, "fused_ln_mlp_res_bwd": 4},
             "eval": {"fused_block_infer": 12, "fused_ln_mlp_res_fwd": 4},
             "printed": "data iterator state restored"})
        log(21, f"card {card}")
        return launches, numbers
    finally:
        shutil.rmtree(root, ignore_errors=True)
        free_card(torch)


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
        again = fused_block.fused_block_infer(x, w4, heads)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError("K4: two runs on the same inputs differ")
        ms, plain_ms = ab_ms(torch, lambda: fused_block.fused_block_infer(x, w4, heads),
                             lambda: fused_block.block_infer_ref(x, w4, heads))
        split = kernel_split(torch, lambda: fused_block.fused_block_infer(x, w4, heads))
    flops, weights = block_work(b, n, d, hidden)
    k4_bound = bound(flops, 2 * (2 * b * n * d + weights))
    log(3, f"K4 bf16 ({b},{n},{d}) max abs {err:.3e}, rel RMS {rel:.3e}, bit-equal over two "
           f"runs; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {k4_bound[0]:.4f} ms "
           f"({k4_bound[1]})")
    log_split(3, f"K4 ({b},{n},{d}) by kernel", split)
    library = k4_library(torch, fused_block, torch.Generator().manual_seed(3), dev, card)
    kernels.append({
        "name": "fused_block_infer", "route": "cuda",
        "source": "multimae_tpu_torch/csrc/fused_block_infer.cu",
        "replaces": "multimae_tpu/ops/fused_block_pallas.py:253",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": k4_bound[0], "bound_by": k4_bound[1],
        "library_ms": (None if library[f"{b},{n},{d}"]["refused"]
                       else library[f"{b},{n},{d}"]["library_ms"]), "library": library,
        "stages_ms": split})

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
          "replaces": "multimae_tpu/ops/fused_decoder_pallas.py:737", "library_ms": None}
    k1_flops, k1_weights = decoder_work(b, nq, nc, dd, 4 * dd, depth)
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "fp32_")):
        size = 2 if dtype == torch.bfloat16 else 4
        k1_bound = bound(k1_flops, size * (b * (2 * nq + nc) * dd + k1_weights),
                         BF16_PEAK if size == 2 else FP32_PEAK)
        k1.update({f"{tag}bound_ms": k1_bound[0], f"{tag}bound_by": k1_bound[1]})
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
    # ... and at the training slice's batch, which phase 7 launches it at
    bb, btag = TRAIN_BATCH, f"b{TRAIN_BATCH}_"
    flops, weights = decoder_work(bb, nq, nc, dd, 4 * dd, depth)
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "fp32_")):
        size = 2 if dtype == torch.bfloat16 else 4
        k1_bound = bound(flops, size * (bb * (2 * nq + nc) * dd + weights),
                         BF16_PEAK if size == 2 else FP32_PEAK)
        q = torch.randn((bb, nq, dd), generator=gen).to(dev, dtype)
        c = torch.randn((bb, nc, dd), generator=gen).to(dev, dtype)
        with torch.inference_mode():
            out = fused_decoder.fused_decoder_core(q, c, w1, hh, depth)
            again = fused_decoder.fused_decoder_core(q, c, w1, hh, depth)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"K1 fwd {dtype} B={bb}: two runs on the same inputs differ")
            ref = fused_decoder.decoder_core_ref(q, c, w1, hh, depth)
            err, rel = assert_matches_twin(out, ref, f"K1 fused_decoder_fwd {dtype} B={bb}")
            del out, again, ref
            ms, plain_ms = ab_ms(
                torch, lambda: fused_decoder.fused_decoder_core(q, c, w1, hh, depth),
                lambda: fused_decoder.decoder_core_ref(q, c, w1, hh, depth), iters=5)
            split = kernel_split(torch, lambda: fused_decoder.fused_decoder_core(
                q, c, w1, hh, depth))
        log(4, f"K1 {dtype} ({bb},{nq},{nc},{dd}) max abs {err:.3e}, rel RMS {rel:.3e}, "
               f"bit-equal over two runs; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
               f"{k1_bound[0]:.4f} ms")
        log_split(4, f"K1 fwd {dtype} B={bb} by kernel", split)
        k1.update({f"{btag}{tag}max_abs_err": err, f"{btag}{tag}ms": ms,
                   f"{btag}{tag}plain_ms": plain_ms, f"{btag}{tag}bound_ms": k1_bound[0],
                   f"{btag}{tag}bound_by": k1_bound[1], f"{btag}{tag}stages_ms": split})
        del q, c
        free_card(torch)
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
           "replaces": "multimae_tpu/ops/fused_decoder_pallas.py:763", "library_ms": None}
    names = ["dq", "dc"] + ["d" + f for f in fused_decoder.DecoderCoreWeights._fields]
    for bb, btag in ((b, ""), (TRAIN_BATCH, f"b{TRAIN_BATCH}_")):
        flops, weights = decoder_work(bb, nq, nc, dd, 4 * dd, depth)
        for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "fp32_")):
            # The VJP recomputes the forward and then does twice its
            # products (dX and dW): 3x the forward's operations. In: q, c,
            # g and the weights in dtype; out: dq, dc, fp32 weight grads.
            size = 2 if dtype == torch.bfloat16 else 4
            k1b_bound = bound(3 * flops, size * (bb * (3 * nq + 2 * nc) * dd + weights)
                              + 4 * weights, BF16_PEAK if size == 2 else FP32_PEAK)
            k1b.update({f"{btag}{tag}bound_ms": k1b_bound[0],
                        f"{btag}{tag}bound_by": k1b_bound[1]})
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
                   f"{worst_rel:.3e} ({worst}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                   f"bound {k1b_bound[0]:.4f} ms")
            log(6, "rel RMS per output: " + ", ".join(f"{n} {e[1]:.2e}" for e, n in errs))
            k1b.update({f"{btag}{tag}max_abs_err": err, f"{btag}{tag}ms": ms,
                        f"{btag}{tag}plain_ms": plain_ms})
            if bb == TRAIN_BATCH:  # where one launch's time goes
                split = kernel_split(torch, bwd)
                log_split(6, f"K1 bwd {dtype} B={bb} by kernel", split)
                k1b[f"{btag}{tag}stages_ms"] = split
    kernels.append(k1b)

    # 7. the training slice
    step_launches = train_slice(torch, dev)
    for k in kernels:
        if k["name"] == "fused_decoder_bwd":
            k["launches"] = step_launches["fused_decoder_bwd"]
        else:
            k["step_launches"] = step_launches[k["name"]]
    del model, results, batches, kern, plain
    free_card(torch)

    # 8. K2 and 9. K3b and K3a against their twins
    kernels += short_attention_phase(torch, dev)
    kernels += fused_mlp_phase(torch, dev)

    # 10. K4 at the fine-tune's eval shape, its attention step on K2
    b, n = SEMSEG_BATCH, 2049
    x = torch.randn((b, n, d), generator=gen).to(dev, torch.bfloat16)
    with torch.inference_mode():
        out = fused_block.fused_block_infer(x, w4, heads)
        torch.cuda.synchronize()
        err, rel = assert_matches_twin(out, fused_block.block_infer_ref(x, w4, heads),
                                       f"K4 fused_block_infer at {n} tokens")
        ms, plain_ms = ab_ms(torch, lambda: fused_block.fused_block_infer(x, w4, heads),
                             lambda: fused_block.block_infer_ref(x, w4, heads), iters=10)
        split = kernel_split(torch, lambda: fused_block.fused_block_infer(x, w4, heads))
    flops, weights = block_work(b, n, d, hidden)
    k4_bound = bound(flops, 2 * (2 * b * n * d + weights))
    log(10, f"K4 bf16 ({b},{n},{d}) (attention on the K2 forward) max abs {err:.3e}, rel RMS "
            f"{rel:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {k4_bound[0]:.4f} ms "
            f"({k4_bound[1]})")
    log_split(10, f"K4 ({b},{n},{d}) by kernel", split)
    kernels[0].update({"semseg_max_abs_err": err, "semseg_ms": ms, "semseg_plain_ms": plain_ms,
                       "semseg_bound_ms": k4_bound[0], "semseg_bound_by": k4_bound[1],
                       "semseg_stages_ms": split})
    del x, out
    free_card(torch)

    # 11. the fine-tune slice
    step_launches, eval_launches = semseg_slice(torch, dev)
    for k in kernels:
        name = k.get("served_by", k["name"])
        if name in ("short_attention_fwd", "short_attention_bwd", "fused_ln_mlp_res_fwd",
                    "fused_ln_mlp_res_bwd", "fused_mlp_fwd", "fused_mlp_bwd"):
            k["launches"] = step_launches[name]
        k["semseg_step_launches"] = step_launches[name]
        k["semseg_eval_launches"] = eval_launches[name]

    free_card(torch)

    # 12. the pretraining CLI from a dataset folder
    pretrain = os.path.join(HERE, "build", "chip_smoke_pretrain", "checkpoint-1.pth")
    try:
        cli_launches, cli_numbers = cli_slice(torch, dev, pretrain)
        for k in kernels:
            if k["name"] in ("fused_decoder_fwd", "fused_decoder_bwd"):
                k["cli_launches"] = cli_launches[k["name"]]
        free_card(torch)
        jpeg_ms, jpeg_rates = jpeg_fixture_check(card)
        jpeg_launches, jpeg_numbers = jpeg_cli_slice(card)
        for k in kernels:
            if k["name"] in ("fused_decoder_fwd", "fused_decoder_bwd"):
                k["jpeg_cli_launches"] = jpeg_launches[k["name"]]
        cli_numbers.update(jpeg_numbers)
        cli_numbers.update(jpeg_decode_ms_per_file=jpeg_ms,
                           jpeg_files_per_s_threads={str(k): v for k, v in jpeg_rates.items()})
        log(12, "numbers: " + json.dumps(cli_numbers))
        free_card(torch)

        # 13. the semantic segmentation fine-tune CLI: K4 at the Segmenter's
        # eval shapes first, then the CLI runs
        for n in (1025, 1174):
            err, rel, ms, plain_ms, k4_bound = k4_at(torch, fused_block, w4, n, gen, dev)
            log(13, f"K4 bf16 ({SEMSEG_BATCH},{n},768) (attention on the K2 forward) max abs "
                    f"{err:.3e}, rel RMS {rel:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                    f"ms, bound {k4_bound[0]:.4f} ms ({k4_bound[1]})")
            kernels[0].update({f"n{n}_max_abs_err": err, f"n{n}_ms": ms,
                               f"n{n}_plain_ms": plain_ms, f"n{n}_bound_ms": k4_bound[0]})
        free_card(torch)
        per_step, per_eval, ft_numbers = ft_cli_slice(torch, dev, pretrain)
        log(13, "numbers: " + json.dumps(ft_numbers))

        # 14. the classification fine-tune CLI: K4 at its eval shape and K2
        # against the module path at its 197 keys first, then the CLI runs
        err, rel, ms, plain_ms, k4_bound = k4_at(torch, fused_block, w4, 197, gen, dev,
                                                 b=CLS_BATCH)
        log(14, f"K4 bf16 ({CLS_BATCH},197,768) max abs {err:.3e}, rel RMS {rel:.3e}, bit-equal "
                f"over two runs; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{k4_bound[0]:.4f} ms ({k4_bound[1]}; card {card})")
        kernels[0].update({"cls_max_abs_err": err, "cls_ms": ms, "cls_plain_ms": plain_ms,
                           "cls_bound_ms": k4_bound[0], "cls_bound_by": k4_bound[1]})
        free_card(torch)
        k2 = next(k for k in kernels if k["name"] == "short_attention_fwd")
        k2["cls_module_path"] = cls_attention_phase(torch, dev, card)
        cls_step, cls_eval, cls_numbers = cls_cli_slice(torch, dev, pretrain, card)
        log(14, "numbers: " + json.dumps(cls_numbers))

        # 15. the depth fine-tune CLI (fp32: no kernel on its path)
        depth_step, depth_eval, depth_numbers = depth_cli_slice(torch, dev, pretrain, card)
        log(15, "numbers: " + json.dumps(depth_numbers))

        # 16. the Taskonomy fine-tune CLI: K2 and K4 at its shapes first
        k2f, k2b, k4t = taskonomy_attention_and_block(torch, fused_block, w4, gen, dev, card)
        for name, extra in (("short_attention_fwd", k2f), ("short_attention_bwd", k2b),
                            ("fused_block_infer", k4t)):
            next(k for k in kernels if k["name"] == name).update(extra)
        tk_step, tk_eval, tk_numbers = taskonomy_cli_slice(torch, dev, pretrain, card)
        log(16, "numbers: " + json.dumps(tk_numbers))

        # 17. the demo and the tools: K4 at ViT-L's width, K2 at 16 heads and
        # K3b at bench_infer's rows first, then the runs
        tool_extra, tool_launches, _ = tools_slice(torch, dev, pretrain, gen, card)
    finally:
        import shutil

        shutil.rmtree(os.path.dirname(pretrain), ignore_errors=True)
    for k in kernels:
        name = k.get("served_by", k["name"])
        k["ft_cli_launches"] = per_step[name]
        k["ft_cli_eval_launches"] = per_eval[name]
        k["cls_cli_launches"] = cls_step[name]
        k["cls_cli_eval_launches"] = cls_eval[name]
        k["dpt_semseg_cli_launches"] = ft_numbers["dpt_step_launches"][name]
        k["dpt_semseg_cli_eval_launches"] = ft_numbers["dpt_eval_launches"][name]
        k["depth_cli_launches"] = depth_step[name]
        k["depth_cli_eval_launches"] = depth_eval[name]
        k["taskonomy_cli_launches"] = tk_step[name]
        k["taskonomy_cli_eval_launches"] = tk_eval[name]
        k.update(tool_extra.get(k["name"], {}))
        k["tools_launches"] = {run: n[name] for run, n in tool_launches.items() if n[name]}
    tools_path = ("fused_block_infer", "fused_decoder_fwd", "fused_decoder_bwd",
                  "short_attention_fwd", "short_attention_bwd", "fused_ln_mlp_res_fwd",
                  "fused_ln_mlp_res_bwd")
    idle = [n for n in tools_path if not any(r[n] for r in tool_launches.values())]
    if idle:
        raise AssertionError(f"phase 17 launched no {idle}")

    # 18. the parallel paths: K2 at TP's local heads, TP 2, PP 2 x 4, FSDP
    free_card(torch)
    par_extra, par_launches, par_numbers = parallel_slice(torch, dev, card)
    log(18, "numbers: " + json.dumps(par_numbers))
    for k in kernels:
        name = k.get("served_by", k["name"])
        k.update(par_extra.get(k["name"], {}))
        for path, counts in par_launches.items():
            k[f"{path}_launches"] = counts[name]

    # 19. the last modules: the NYUv2 fixture, prepare_nyuv2 and the semseg
    # CLI over its tree; the decoder variants and --approx_gelu; the
    # AutoAugment policies, AugMix and the nearest and Lanczos resizes
    free_card(torch)
    last_launches, last_numbers = last_modules_slice(torch, dev, card)
    log(19, "numbers: " + json.dumps(last_numbers))
    for k in kernels:
        name = k.get("served_by", k["name"])
        for path, counts in last_launches.items():
            k[f"{path}_launches"] = counts[name]

    # 20. the last loaders: a JAX .msgpack starts the demo, the cls and the
    # semseg CLIs; a pretraining epoch over the new image formats
    free_card(torch)
    loader_launches, loader_numbers = loaders_slice(torch, dev, card)
    log(20, "numbers: " + json.dumps(loader_numbers))
    for k in kernels:
        name = k.get("served_by", k["name"])
        for path, counts in loader_launches.items():
            k[f"{path}_launches"] = counts[name]

    # 21. a JAX-layout resume at full width: the pretraining and semseg
    # CLIs save epoch 0 as the JAX package's .msgpack and resume epoch 1
    # from it, bit-equal to an uninterrupted run
    free_card(torch)
    resume_launches, resume_numbers = jax_resume_slice(torch, dev, card)
    log(21, "numbers: " + json.dumps(resume_numbers))
    for k in kernels:
        name = k.get("served_by", k["name"])
        for path, counts in resume_launches.items():
            k[f"{path}_launches"] = counts[name]

    log_phase_times()
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except BaseException:
        if PHASE_SPAN:
            log_phase_times()
        raise
