"""Data parallelism in the port (multimae_tpu_torch/parallel/dist.py and
the pretraining step under torch.distributed), with two real gloo
processes on the CPU, as tests/test_multiprocess.py runs the JAX
package's (worker body: tests/_torch_dist_worker.py).

* `initialize_distributed` under each launcher's variables (env://,
  OpenMPI as the reference's --dist_on_itp sets it, SLURM): rank, world
  size, backend, the process helpers and the metric logger's sum.
* A 2-process step over 2 x 2 samples equals the 1-process step over the
  same 4 samples, the JAX step's result (the loss of the global batch),
  with fixed masks that leave rank 0 one sample with an empty RGB mask
  and rank 1 one with an empty depth mask, so the ranks' counts of
  non-empty samples differ and a mean of per-rank losses would be wrong.
  Losses, weighted losses and the grad norm within 1e-5 relative; every
  gradient within 1e-6 of its tensor's largest (measured: 3e-7, the
  order of the fp32 sums); the updated parameters within 1e-6 absolute
  wherever |gradient| >= 1e-6. Where a gradient is within a hundred times
  of Adam's eps (1e-8), AdamW's first update lr * g / (|g| + eps) turns
  those last-bit differences into up to ~1e-5 (measured 2.3e-6 at a
  gradient of 1.6e-8): there the parameters must differ by exactly the
  difference of that update computed from the two runs' gradients,
  within 1e-6.
* Coordinated auto-resume: rank 0 damages the newest save; both ranks
  resume from the one before.
* The semseg fine-tune CLI's --eval in two processes over 7 validation
  records: as under the JAX sharding, the ranks read the first 6 in two
  blocks of 3 and the summed confusion matrix is the one process's over
  those 6 (the same mIoU, every pixel counted once); and the fine-tune
  step over 2 x 2 samples equals the 1-process step over the 4: loss and
  grad norm within 1e-5 relative, every gradient within 1e-6 of its
  tensor's largest.
* The same for the cls fine-tune CLI's --eval over 7 JPEG records (the
  top-1/5 summed over the ranks equal the one process's over the first 6)
  and its step (mixed soft targets) over 2 x 2 samples.
* The depth fine-tune step (the DPT head, berhu against mask_valid) over 2
  x 2 samples equals the 1-process step over the 4, with the largest error
  in rank 0's half: berhu's threshold is all-reduced as a max.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimae_tpu_torch.cli import factory
from multimae_tpu_torch.train.optim_factory import create_optimizer
from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step
from multimae_tpu_torch.train.schedules import cosine_scheduler
from multimae_tpu_torch.train.task_balancing import build_balancer
from multimae_tpu_torch.train.train_state import TrainState

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_worker.py")
TASKS = ("rgb", "depth", "semseg", "norm_rgb")
K = 24


def build(seed=0):
    """The tiny MultiMAE's training state and step (uncertainty balancer
    with non-zero log-variances, AdamW, clip 1.0)."""
    model = factory.build_pretrain_model(
        model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
        decoder_num_heads=4, decoder_depth=2, decoder_return_patches=True,
        pos_emb_grads=True, seed=seed, device="cpu")
    balancer = build_balancer("uncertainty", TASKS)
    with torch.no_grad():
        balancer.log_vars.copy_(torch.tensor([0.1, -0.2, 0.3, 0.05]))
    opt = create_optimizer(model, balancer, opt_betas=(0.9, 0.95), filter_bias_and_bn=False)
    state = TrainState(model, balancer, opt, cosine_scheduler(1e-3, 0.0, 1, 4),
                       cosine_scheduler(0.05, 0.05, 1, 4))
    step = make_pretrain_train_step(model, balancer, factory.build_pretrain_losses(
        ("rgb", "depth", "semseg")), num_encoded_tokens=K, clip_grad=1.0)
    return state, step


def global_batch():
    return factory.make_synthetic_batch(4, input_size=64, seed=1, device="cpu")


def fixed_masks():
    """24 of 48 tokens visible per sample; sample 0 sees all of RGB (its
    RGB mask is empty), sample 3 all of depth."""
    rng = np.random.default_rng(3)
    masks = np.ones((4, 48), np.int64)
    for i in range(4):
        if i == 0:
            keep = np.r_[np.arange(16), 16 + rng.permutation(32)[:8]]
        elif i == 3:
            keep = np.r_[16 + np.arange(16), rng.permutation(np.r_[0:16, 32:48])[:8]]
        else:
            keep = rng.permutation(48)[:K]
        masks[i, keep] = 0
    return {t: torch.from_numpy(masks[:, 16 * j:16 * (j + 1)])
            for j, t in enumerate(("rgb", "depth", "semseg"))}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SLURM_", "OMPI_", "MASTER_")) and k not in (
               "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _run_pair(envs, timeout=240):
    procs = [subprocess.Popen([sys.executable, WORKER], env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for e in envs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DIST_OK" in out, f"rank {rank}:\n{out}"


LAUNCHERS = {
    "env": lambda r: {"RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": str(r)},
    "openmpi": lambda r: {"OMPI_COMM_WORLD_RANK": str(r), "OMPI_COMM_WORLD_SIZE": "2",
                          "OMPI_COMM_WORLD_LOCAL_RANK": str(r)},
    "slurm": lambda r: {"SLURM_PROCID": str(r), "SLURM_NTASKS": "2", "SLURM_LOCALID": str(r)},
}


@pytest.mark.parametrize("launcher", sorted(LAUNCHERS))
def test_initialize_distributed_under_each_launcher(launcher):
    port = _free_port()
    _run_pair([dict(_clean_env(), MODE="launcher", EXPECT_RANK=str(r), MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(port), **LAUNCHERS[launcher](r)) for r in range(2)])


def test_single_process_needs_no_group(monkeypatch):
    from multimae_tpu_torch.parallel import dist as dist_lib

    for k in ("RANK", "WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "SLURM_PROCID"):
        monkeypatch.delenv(k, raising=False)
    assert not dist_lib.initialize_distributed("cpu")
    monkeypatch.setenv("SLURM_PROCID", "0")
    monkeypatch.setenv("SLURM_NTASKS", "1")
    assert not dist_lib.initialize_distributed("cpu")
    assert (dist_lib.world_size(), dist_lib.process_index()) == (1, 0)
    assert dist_lib.local_batch_slice(8) == slice(0, 8)


def test_two_process_step_equals_the_global_batch_step(tmp_path):
    state, step = build()
    metrics = {k: float(v) for k, v in step(state, global_batch(), task_masks=fixed_masks()).items()}
    masks = fixed_masks()
    assert int(masks["rgb"][0].sum()) == 0 and int(masks["depth"][3].sum()) == 0

    port = _free_port()
    env = dict(_clean_env(), MODE="step", OUT=str(tmp_path), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2",
               PYTHONPATH=os.path.dirname(WORKER) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    _run_pair([dict(env, RANK=str(r), LOCAL_RANK=str(r)) for r in range(2)])
    for r in range(2):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
        keys = ["loss", "grad_norm"] + [f"{t}_loss" for t in TASKS] + [
            f"{t}_loss_weighted" for t in TASKS]
        for k in keys:
            rel = abs(got["metrics"][k] - metrics[k]) / max(abs(metrics[k]), 1e-30)
            assert rel <= 1e-5, (r, k, got["metrics"][k], metrics[k])
        lr = float(state.lr_values[0])
        for k, p in state.model.named_parameters():
            g1, g2 = p.grad.double(), got["grads"][k].double()
            assert float((g2 - g1).abs().max()) <= 1e-6 * float(g1.abs().max()), (r, k)
            diff = (got["model"][k].double() - p.detach().double())
            if k.endswith("pos_emb"):  # frozen: no update on either side
                assert float(diff.abs().max()) == 0.0, k
                continue
            # AdamW's first update is lr * g / (|g| + eps): where |g| is
            # near eps, the gradients' last-bit differences move it.
            sensitive = g1.abs() < 1e-6
            assert float(torch.where(sensitive, 0.0, diff).abs().max()) <= 1e-6, (r, k)
            adam = lr * (g2 / (g2.abs() + 1e-8) - g1 / (g1.abs() + 1e-8))
            assert float((diff + adam).abs().max()) <= 1e-6, (r, k)
        assert float((got["balancer"]["log_vars"] - state.balancer.log_vars.detach()).abs().max()) <= 1e-6


def semseg_trainer():
    """The tiny MultiViT's fine-tune state and step (drop_path off)."""
    return factory.build_semseg_trainer(
        batch_size=4, model="multivit_tiny", input_size=64, decoder_dim=256,
        decoder_depth=2, drop_path_encoder=0.0, fp16=False, device="cpu")


def semseg_batch():
    return factory.make_synthetic_semseg_batch(4, input_size=64, seed=5, device="cpu")


def test_two_process_semseg_eval_and_step(tmp_path):
    from multimae_tpu_torch.cli import run_finetuning_semseg as cli
    from multimae_tpu_torch.data.dataset_folder import write_random_tree

    val, six = tmp_path / "val7", tmp_path / "val6"
    write_random_tree(str(val), 7, (48, 64), semseg_classes=40, ignore_patches=True)
    shutil.copytree(val, six)
    for task in ("rgb", "depth", "semseg"):  # the 7th record in the sorted walk
        os.remove(six / task / "c1" / "i0005.png")
    argv = ["-c", "cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml",
            "--device", "cpu", "--model", "multivit_tiny", "--input_size", "64",
            "--decoder_dim", "256", "--decoder_depth", "2", "--no_fp16", "--num_workers", "0",
            "--no_mask_valid", "--finetune", "", "--eval", "--batch_size", "2"]
    repo = os.path.dirname(os.path.dirname(WORKER))
    port = _free_port()
    env = dict(_clean_env(), MODE="semseg", OUT=str(tmp_path), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2", ARGV=json.dumps(
                   argv + ["--data_path", str(val), "--eval_data_path", str(val)]),
               PYTHONPATH=os.path.dirname(WORKER) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        _run_pair([dict(env, RANK=str(r), LOCAL_RANK=str(r)) for r in range(2)])
        one = cli.main(cli.get_args(argv + ["--batch_size", "4", "--data_path", str(six),
                                            "--eval_data_path", str(six)]))["evals"][0]
    finally:
        os.chdir(cwd)
    state, step = semseg_trainer()
    metrics = {k: float(v) for k, v in step(state, semseg_batch()).items()}
    for r in range(2):
        got = torch.load(tmp_path / f"semseg{r}.pt", weights_only=True)
        ev = got["eval"]
        assert (ev["images"], ev["batches"]) == (3, 2), ev  # a full batch of 2 and one of 1
        assert ev["pixels"] == one["pixels"] and one["images"] == 6
        for k in ("mIoU", "aAcc", "mAcc"):
            assert ev[k] == one[k], (k, ev[k], one[k])
        for k in ("loss", "grad_norm"):
            assert abs(got["metrics"][k] - metrics[k]) <= 1e-5 * abs(metrics[k]), (r, k)
        for k, p in state.model.named_parameters():
            g = got["grads"][k].double() - p.grad.double()
            assert float(g.abs().max()) <= 1e-6 * float(p.grad.abs().max()), (r, k)


def cls_trainer():
    """The tiny MultiViT's cls fine-tune state and step (drop_path off)."""
    return factory.build_cls_trainer(batch_size=4, model="multivit_tiny", input_size=32,
                                     nb_classes=10, drop_path=0.0, dtype=torch.float32,
                                     device="cpu")


def cls_batch():
    return factory.make_synthetic_cls_batch(4, input_size=32, nb_classes=10, seed=5,
                                            device="cpu")


def test_two_process_cls_eval_and_step(tmp_path):
    import glob

    from multimae_tpu_torch.cli import run_finetuning_cls as cli
    from multimae_tpu_torch.data.dataset_folder import write_imagenet_tree

    repo = os.path.dirname(os.path.dirname(WORKER))
    photos = sorted(glob.glob(os.path.join(repo, "tests", "fixtures", "jpeg", "photo_*.jpg")))
    _, val = write_imagenet_tree(str(tmp_path / "t7"), photos, 0, 7, 2)
    _, six = write_imagenet_tree(str(tmp_path / "t6"), photos, 0, 7, 2)
    os.remove(os.path.join(six, "c1", "i00005.jpg"))  # the 7th record in the sorted walk
    argv = ["-c", "cfgs/finetune/cls/ft_in1k_100e_multimae-b.yaml", "--device", "cpu",
            "--model", "multivit_tiny", "--input_size", "32", "--dtype", "float32",
            "--data_set", "image_folder", "--nb_classes", "2", "--num_workers", "0",
            "--finetune", "", "--eval", "--batch_size", "2"]
    port = _free_port()
    env = dict(_clean_env(), MODE="cls", OUT=str(tmp_path), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2", ARGV=json.dumps(
                   argv + ["--data_path", val, "--eval_data_path", val]),
               PYTHONPATH=os.path.dirname(WORKER) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cwd = os.getcwd()
    os.chdir(repo)
    try:
        _run_pair([dict(env, RANK=str(r), LOCAL_RANK=str(r)) for r in range(2)])
        one = cli.main(cli.get_args(argv + ["--batch_size", "4", "--data_path", six,
                                            "--eval_data_path", six]))["evals"][0]
    finally:
        os.chdir(cwd)
    state, step = cls_trainer()
    metrics = {k: float(v) for k, v in step(state, cls_batch()).items()}
    for r in range(2):
        got = torch.load(tmp_path / f"cls{r}.pt", weights_only=True)
        ev = got["eval"]
        assert (ev["images"], ev["batches"]) == (6, 2), ev  # the sum; a batch of 2 and one of 1
        assert one["images"] == 6 and (ev["acc1"], ev["acc5"]) == (one["acc1"], one["acc5"])
        for k in ("loss", "grad_norm"):
            assert abs(got["metrics"][k] - metrics[k]) <= 1e-5 * abs(metrics[k]), (r, k)
        for k, p in state.model.named_parameters():
            g = got["grads"][k].double() - p.grad.double()
            assert float(g.abs().max()) <= 1e-6 * float(p.grad.abs().max()), (r, k)


def depth_trainer():
    """The tiny MultiViT's depth fine-tune state and step (the DPT head,
    berhu against mask_valid, fp32)."""
    return factory.build_depth_trainer(batch_size=4, model="multivit_tiny", input_size=32,
                                       device="cpu")


def depth_batch():
    """A batch whose largest error lies in rank 0's half: berhu's threshold
    is 0.2 of the global batch's largest |diff|, which rank 1 does not see
    without the all-reduce."""
    b = factory.make_synthetic_regression_batch(4, input_size=32, seed=5, device="cpu")
    b["target"][0, 3:6, 3:6] += 40.0
    return b


def test_two_process_depth_step_equals_the_global_batch_step(tmp_path):
    """Each rank's loss and grad norm within 1e-5 of the single-process
    step's; every gradient within 2e-6 of its largest element (read: 1.04e-6,
    a 3x3 conv of the coarsest fusion block, whose 1 x 1 maps leave its
    weight gradient a sum over the batch taken in another order)."""
    port = _free_port()
    env = dict(_clean_env(), MODE="depth", OUT=str(tmp_path), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), WORLD_SIZE="2",
               PYTHONPATH=os.path.dirname(WORKER) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    _run_pair([dict(env, RANK=str(r), LOCAL_RANK=str(r)) for r in range(2)])
    state, step = depth_trainer()
    metrics = {k: float(v) for k, v in step(state, depth_batch()).items()}
    target = depth_batch()["target"].abs()
    assert float(target[:2].max()) > 10 * float(target[2:].max())  # c comes from rank 0
    for r in range(2):
        got = torch.load(tmp_path / f"depth{r}.pt", weights_only=True)
        for k in ("loss", "grad_norm"):
            assert abs(got["metrics"][k] - metrics[k]) <= 1e-5 * abs(metrics[k]), (r, k)
        for k, p in state.model.named_parameters():
            g = got["grads"][k].double() - p.grad.double()
            assert float(g.abs().max()) <= 2e-6 * float(p.grad.abs().max()), (r, k)
