"""GPipe bubble against the microbatch count (counterpart of
tools/bench_pp_bubble.py).

The schedule of parallel/pp.py runs M + S - 1 ticks for M microbatches
over S stages, so the idle ("bubble") share of each stage is
(S - 1) / (M + S - 1). This tool takes pretraining steps of the tiny
MultiMAE's width at ViT-L's depth (24 encoder blocks) as an S-stage
pipeline, one process per stage, sweeping --micros, and prints the
measured ms per step beside the analytic bubble, and the ms per step with
the bubble ticks taken out (x M / (M + S - 1)): what a schedule without
the bubble would take at the same cost per tick.

    python -m multimae_tpu_torch.tools.bench_pp_bubble [--stage 4] [--depth 24] \\
        [--batch 32] [--micros 1,2,4,8,16] [--iters 8] [--device cuda|cpu]

Each stage takes a card of its own over NCCL, and fewer cards than
stages is refused (exit code 2). On a machine with fewer cards, --device
cpu runs the stages as CPU processes over gloo.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import time


def _worker(rank: int, args, port: int) -> None:
    import torch
    import torch.distributed as dist

    from multimae_tpu_torch.cli import factory
    from multimae_tpu_torch.parallel import mesh as mesh_lib
    from multimae_tpu_torch.train.optim_factory import create_optimizer
    from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step
    from multimae_tpu_torch.train.schedules import cosine_scheduler
    from multimae_tpu_torch.train.task_balancing import build_balancer
    from multimae_tpu_torch.train.train_state import TrainState

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    torch.set_num_threads(1)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=args.stage, rank=rank)
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    mesh = mesh_lib.create_pp_mesh(stage=args.stage, device=device.type)
    model = factory.build_pretrain_model(
        model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
        decoder_num_heads=4, decoder_return_patches=True, depth=args.depth, device=device)
    tasks = ("rgb", "depth", "semseg", "norm_rgb")
    balancer = build_balancer("none", tasks).to(device)
    optimizer = create_optimizer(model, balancer, filter_bias_and_bn=False)
    state = TrainState(model, balancer, optimizer, cosine_scheduler(1e-4, 0.0, 1, 1000))
    step = make_pretrain_train_step(model, balancer, factory.build_pretrain_losses(
        ("rgb", "depth", "semseg")), num_encoded_tokens=24)
    batch = factory.make_synthetic_batch(args.batch, input_size=64, seed=0, device=device)
    generator = torch.Generator(device=device)
    s = args.stage
    if rank == 0:
        print(f"# stage={s} depth={args.depth} batch={args.batch} (data 1), tiny width, "
              f"{args.device} processes over {dist.get_backend()}")
        print("| M | ticks M+S-1 | analytic bubble | ms/step | ms/step x M/(M+S-1) |")
        print("|---|---|---|---|---|")
    for m in [int(v) for v in args.micros.split(",")]:
        mesh_lib.layout_model(model, mesh, n_micro=m)
        generator.manual_seed(0)
        step(state, batch, generator=generator)  # warm-up
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            generator.manual_seed(0)
            step(state, batch, generator=generator)
        if cuda:
            torch.cuda.synchronize(device)
        dist.barrier()
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        if rank == 0:
            bubble = (s - 1) / (m + s - 1)
            print(f"| {m} | {m + s - 1} | {bubble:.3f} | {ms:.1f} | {ms * m / (m + s - 1):.1f} |",
                  flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", type=int, default=4)
    ap.add_argument("--depth", type=int, default=24)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--micros", default="1,2,4,8,16")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if args.device == "cuda":
        cards = torch.cuda.device_count()
        if cards < args.stage:
            print(f"bench_pp_bubble: on the card (--device cuda) it gives each of the {args.stage} stages a card "
                  f"of its own, and {cards} card(s) are visible; run it with --device cpu "
                  f"(one gloo process per stage)", file=sys.stderr)
            return 2
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    mp.spawn(_worker, args=(args, port), nprocs=args.stage, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
