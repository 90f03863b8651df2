"""Worker body for tests/test_torch_dist.py: one rank of a 2-process gloo
group on the CPU. MODE=launcher checks initialize_distributed and the
process helpers under the launcher's variables the test set; MODE=step
takes one pretraining step on this rank's half of the batch, saves the
result to OUT/rank{r}.pt, then resumes from a coordinated auto-load;
MODE=semseg runs the semseg CLI's --eval with the JSON argv in ARGV and
one fine-tune step on this rank's half of a batch, and saves both to
OUT/semseg{r}.pt; MODE=depth takes one depth fine-tune step (the DPT head,
berhu against mask_valid) on this rank's half of a batch and saves it to
OUT/depth{r}.pt."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from multimae_tpu_torch.parallel import dist as dist_lib  # noqa: E402


def launcher():
    assert dist_lib.initialize_distributed("cpu")
    rank, world = dist_lib.process_index(), dist_lib.world_size()
    assert (rank, world) == (int(os.environ["EXPECT_RANK"]), 2), (rank, world)
    assert dist.get_backend() == "gloo"
    assert dist_lib.is_main_process() == (rank == 0)
    assert dist_lib.local_batch_slice(8) == slice(4 * rank, 4 * rank + 4)
    t = torch.tensor([rank + 1.0])
    dist.all_reduce(t)
    assert float(t) == 3.0
    from multimae_tpu_torch.utils.logger import MetricLogger

    logger = MetricLogger()
    logger.update(loss=float(rank + 1))
    logger.synchronize_between_processes()
    assert (logger.loss.count, logger.loss.total) == (2, 3.0)
    assert dist_lib.initialize_distributed("cpu")  # a second call keeps the group
    dist_lib.barrier()


def step():
    from test_torch_dist import build, fixed_masks, global_batch

    from multimae_tpu_torch.train import checkpoint as ckpt

    assert dist_lib.initialize_distributed("cpu")
    rank = dist_lib.process_index()
    state, step_fn = build()
    sl = dist_lib.local_batch_slice(4)
    local = {k: v[sl] for k, v in global_batch().items()}
    masks = {k: v[sl] for k, v in fixed_masks().items()}
    metrics = step_fn(state, local, task_masks=masks)
    out = os.environ["OUT"]
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "model": state.model.state_dict(), "balancer": state.balancer.state_dict(),
                "grads": {n: p.grad for n, p in state.model.named_parameters()}},
               os.path.join(out, f"rank{rank}.pt"))

    # Coordinated auto-resume: rank 0 writes two saves and damages the
    # newest; every rank resumes from the older one.
    saves = os.path.join(out, "saves")
    ckpt.save_checkpoint(saves, 0, state)
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    step_fn(state, local, task_masks=masks)
    newest = ckpt.save_checkpoint(saves, 1, state)
    if rank == 0:
        with open(newest, "r+b") as f:
            f.truncate(100)
    dist_lib.barrier()
    fresh, _ = build(seed=9)
    start, _ = ckpt.auto_load_checkpoint(saves, fresh)
    assert start == 1, start
    assert all(torch.equal(v, saved[k]) for k, v in fresh.model.state_dict().items())
    dist_lib.barrier()


def semseg():
    import json

    from test_torch_dist import semseg_batch, semseg_trainer

    from multimae_tpu_torch.cli import run_finetuning_semseg as cli

    assert dist_lib.initialize_distributed("cpu")
    rank = dist_lib.process_index()
    summary = cli.main(cli.get_args(json.loads(os.environ["ARGV"])))
    assert dist.is_initialized()  # main leaves a group it did not create
    state, step_fn = semseg_trainer()
    sl = dist_lib.local_batch_slice(4)
    metrics = step_fn(state, {k: v[sl] for k, v in semseg_batch().items()})
    torch.save({"eval": summary["evals"][0],
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {n: p.grad for n, p in state.model.named_parameters()}},
               os.path.join(os.environ["OUT"], f"semseg{rank}.pt"))
    dist_lib.barrier()


def cls():
    import json

    from test_torch_dist import cls_batch, cls_trainer

    from multimae_tpu_torch.cli import run_finetuning_cls as cli

    assert dist_lib.initialize_distributed("cpu")
    rank = dist_lib.process_index()
    summary = cli.main(cli.get_args(json.loads(os.environ["ARGV"])))
    assert dist.is_initialized()  # main leaves a group it did not create
    state, step_fn = cls_trainer()
    sl = dist_lib.local_batch_slice(4)
    metrics = step_fn(state, {k: v[sl] for k, v in cls_batch().items()})
    torch.save({"eval": summary["evals"][0],
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {n: p.grad for n, p in state.model.named_parameters()}},
               os.path.join(os.environ["OUT"], f"cls{rank}.pt"))
    dist_lib.barrier()


def depth():
    from test_torch_dist import depth_batch, depth_trainer

    assert dist_lib.initialize_distributed("cpu")
    rank = dist_lib.process_index()
    state, step_fn = depth_trainer()
    sl = dist_lib.local_batch_slice(4)
    metrics = step_fn(state, {k: v[sl] for k, v in depth_batch().items()})
    torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {n: p.grad for n, p in state.model.named_parameters()}},
               os.path.join(os.environ["OUT"], f"depth{rank}.pt"))
    dist_lib.barrier()


if __name__ == "__main__":
    {"launcher": launcher, "step": step, "semseg": semseg, "cls": cls,
     "depth": depth}[os.environ["MODE"]]()
    dist.destroy_process_group()
    print(f"DIST_OK {os.environ.get('EXPECT_RANK', '')}", flush=True)
