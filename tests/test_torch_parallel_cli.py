"""The scaling flags through the port's CLIs, with four real gloo processes
on the CPU (worker: tests/_torch_parallel_worker.py), and the meshes those
processes see.

* The pretraining CLI with --fsdp --model_parallel 2 (data 2 x model 2,
  global batch 2 x 4 / 2) for 2 steps saves checkpoint-0.pth; one process
  without the flags resumes from it with parameters bit-equal to the save
  and trains on.
* The semseg CLI with --model_parallel 2 trains a synthetic epoch.
* The meshes from 4 processes on 2 "hosts" (GROUP_RANK 1, 0, 1, 0 by
  rank): a hybrid mesh groups the ranks host by host, as the JAX package
  groups devices by slice; every rank's axis ranks, groups and data rank.
* bench_pp_bubble: 2 CPU stages (--device cpu) print the table; on the
  card, its default, fewer cards than stages exits 2 with the reason.
"""

import json
import subprocess
import sys

import pytest
import torch

import _torch_parallel as P

HOSTS = [1, 0, 1, 0]
TINY = ["--device", "cpu", "--model", "pretrain_multimae_tiny", "--input_size", "64",
        "--num_encoded_tokens", "24", "--decoder_dim", "64", "--decoder_num_heads", "4",
        "--dtype", "float32", "--batch_size", "2", "--warmup_epochs", "0", "--blr", "1e-3",
        "--synthetic_data", "--synthetic_steps_per_epoch", "2", "--save_ckpt_freq", "1",
        "--num_workers", "0"]
SEMSEG = ["-c", "cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml",
          "--device", "cpu", "--model", "multivit_tiny", "--input_size", "64",
          "--decoder_dim", "256", "--decoder_depth", "2", "--no_fp16", "--num_workers", "0",
          "--finetune", "", "--synthetic_data", "--synthetic_steps_per_epoch", "2",
          "--epochs", "1", "--batch_size", "2", "--warmup_epochs", "0", "--model_parallel", "2"]


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    argv = TINY + ["--epochs", "1", "--output_dir", str(out / "run"), "--fsdp",
                   "--model_parallel", "2"]
    semseg = SEMSEG + ["--output_dir", str(out / "semseg")]
    procs = P.start(4, per_rank=lambda r: {"GROUP_RANK": str(HOSTS[r])}, MODE="meshes,cli",
                    OUT=out, ARGV=json.dumps(argv), ARGV_SEMSEG=json.dumps(semseg))
    return out, P.finish(procs)


def test_fsdp_tp_cli_run_resumes_in_one_process(four):
    from multimae_tpu_torch.cli import run_pretraining_multimae as cli

    out, logs = four
    assert "global batch 4" in logs[0] and "mesh DeviceMesh" in logs[0]
    losses = torch.load(out / "cli.pt", weights_only=True)["pretrain"]["losses"]
    assert len(losses) == 2 and all(torch.isfinite(torch.tensor(losses)))
    saved = torch.load(out / "run" / "checkpoint-0.pth", weights_only=False)
    assert saved["updates"] == 2 and saved["model"]["encoder.0.attn.qkv.weight"].shape == (192, 64)
    summary = cli.main(cli.get_args(TINY + ["--epochs", "2", "--output_dir", str(out / "run")]))
    assert summary["start_epoch"] == 1 and summary["resume_bit_equal"] is True
    assert len(summary["steps"]) == 2


def test_semseg_cli_under_model_parallel(four):
    out, logs = four
    losses = torch.load(out / "cli.pt", weights_only=True)["semseg"]["losses"]
    assert len(losses) == 2 and all(torch.isfinite(torch.tensor(losses)))
    assert "mesh DeviceMesh" in logs[0]


def _views(out):
    return [torch.load(out / f"mesh{r}.pt", weights_only=False) for r in range(4)]


def test_meshes_from_four_processes(four):
    out, _ = four
    views = _views(out)
    # flat (data 2, model 2) and pipeline (data 2, stage 2): model/stage innermost
    for name, inner in (("flat", "model"), ("pp", "stage")):
        for r, v in enumerate(views):
            m = v[name]
            assert m["mesh"] == [[0, 1], [2, 3]]
            assert m["axes"][inner] == (r % 2, 2, [r - r % 2, r - r % 2 + 1])
            assert m["axes"]["data"] == (r // 2, 2, [r % 2, r % 2 + 2])
            assert m["data"] == (r // 2, 2)


def test_hybrid_mesh_groups_by_host(four):
    """Hosts 1, 0, 1, 0 by rank: host 0 holds ranks 1 and 3, host 1 ranks 0
    and 2; "dcn" runs across hosts, "data" inside one."""
    out, _ = four
    views = _views(out)
    for r, v in enumerate(views):
        m = v["hybrid"]
        assert m["names"] == ("dcn", "data", "model")
        assert m["mesh"] == [[[1], [3]], [[0], [2]]]
        dcn, data = HOSTS[r], {1: 0, 3: 1, 0: 0, 2: 1}[r]
        assert m["axes"]["dcn"][:2] == (dcn, 2) and m["axes"]["data"][:2] == (data, 2)
        assert m["data"] == (2 * dcn + data, 4)
        same_host = [q for q in range(4) if HOSTS[q] == HOSTS[r]]
        assert sorted(m["axes"]["data"][2]) == same_host
        t = v["hybrid_tp"]  # dcn 2 x data 1 x model 2: TP inside one host
        assert sorted(t["axes"]["model"][2]) == same_host and t["data"] == (dcn, 2)


def test_bench_pp_bubble():
    env = P.clean_env()
    run = subprocess.run([sys.executable, "-m", "multimae_tpu_torch.tools.bench_pp_bubble",
                          "--device", "cpu", "--stage", "2", "--depth", "4", "--batch", "4",
                          "--micros", "1,2", "--iters", "1"], cwd=P.REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    rows = [line for line in run.stdout.splitlines() if line.startswith("| 1 |")
            or line.startswith("| 2 |")]
    assert [r.split("|")[3].strip() for r in rows] == ["0.500", "0.333"], run.stdout
    if torch.cuda.device_count() < 2:  # the card by default: one per stage
        run = subprocess.run([sys.executable, "-m", "multimae_tpu_torch.tools.bench_pp_bubble",
                              "--stage", "2"], cwd=P.REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert run.returncode == 2 and "card of its own" in run.stderr
