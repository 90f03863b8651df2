"""The port's depth and Taskonomy fine-tune CLIs on the CPU
(multimae_tpu_torch/cli/run_finetuning_depth.py and
run_finetuning_taskonomy.py):

* get_args against the JAX CLIs' on every depth and Taskonomy YAML (the
  device's default aside: the card against the TPU);
* tiny runs (multivit_tiny, 32 px, batch 2) from a pretraining .pth over
  written trees, a NYUv2-shaped MultiTaskImageFolder tree (rgb, 16-bit
  depth, mask_valid) and a Taskonomy-layout tree with its CSV splits:
  run A trains 2 epochs with an evaluation each, saves checkpoint-0, -1
  and -best.pth and stores the best delta_1 / L1 in each; run B (--epochs
  3 at LR 0) auto-resumes at epoch 2 with bit-equal parameters, evaluates
  to run A's epoch-1 metrics, keeps the best metric and leaves
  checkpoint-best.pth as it was (the JAX CLIs restart from 0 and infinity
  and would rewrite it); an --eval run of checkpoint-1.pth gives run A's
  epoch-1 metrics;
* without --device the CLIs ask for the card, and a .msgpack --finetune
  exits naming it (--ckpt_backend orbax: tests/test_torch_orbax.py); --synthetic_data steps on the JAX CLIs'
  example batch; cli/factory.py's two recipes are their YAMLs;
* the shared loop (cli/finetune_loop.py) turns TF32 off only for an fp32
  run on the card, and gives both flags back as they were.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from multimae_tpu.cli import run_finetuning_depth as jdepth
from multimae_tpu.cli import run_finetuning_taskonomy as jtaskonomy
from multimae_tpu_torch.cli import factory
from multimae_tpu_torch.cli import run_finetuning_depth as depth_cli
from multimae_tpu_torch.cli import run_finetuning_taskonomy as taskonomy_cli
from multimae_tpu_torch.cli.finetune_loop import exact_fp32
from multimae_tpu_torch.data.dataset_folder import write_random_tree
from multimae_tpu_torch.data.taskonomy import write_taskonomy_tree

REPO = Path(__file__).resolve().parents[1]
DEPTH_YAMLS = sorted(str(p) for p in (REPO / "cfgs/finetune/depth").glob("*.yaml"))
TASKONOMY_YAMLS = sorted(str(p) for p in (REPO / "cfgs/finetune/taskonomy").glob("*/*.yaml"))
CLIS = {"depth": (depth_cli, jdepth), "taskonomy": (taskonomy_cli, jtaskonomy)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread while a test runs: the DPT head's many small CPU
    convolutions make torch's thread pool spin when several test processes
    share the cores (six such processes took 25x longer at 8 threads each
    than at 1)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("path", [("depth", p) for p in DEPTH_YAMLS]
                         + [("taskonomy", p) for p in TASKONOMY_YAMLS],
                         ids=lambda p: Path(p[1]).stem)
def test_get_args_matches_jax(path):
    kind, yaml = path
    port, ref = CLIS[kind]
    extra = ["--output_dir", "x", "--epochs", "3"]
    got, want = vars(port.get_args(["-c", yaml] + extra)), vars(ref.get_args(["-c", yaml] + extra))
    assert got.pop("device") == "cuda" and want.pop("device") == "tpu"
    assert got == want


@pytest.fixture(scope="module")
def pretrain_pth(tmp_path_factory):
    """A tiny 64-px pretraining save of the port's, as the CLIs start from."""
    model = factory.build_pretrain_model(model_name="pretrain_multimae_tiny", input_size=64,
                                         decoder_dim=64, decoder_num_heads=4, device="cpu")
    path = str(tmp_path_factory.mktemp("pretrain") / "checkpoint-9.pth")
    torch.save({"model": model.state_dict(), "epoch": 9}, path)
    return path


def tiny_runs(kind, root, pretrain):
    """Run A (2 epochs), run B (--epochs 3 at LR 0) and an --eval run."""
    cli = CLIS[kind][0]
    out = root / "out"
    if kind == "depth":
        nyu = dict(semseg_classes=40, mask_valid=True, smooth=True)
        write_random_tree(str(root / "train"), 4, (48, 64), **nyu)
        write_random_tree(str(root / "val"), 3, (48, 64), seed=1, **nyu)
        data = ["-c", DEPTH_YAMLS[1], "--data_path", str(root / "train"),
                "--eval_data_path", str(root / "val")]
    else:
        write_taskonomy_tree(str(root), ["rgb", "depth_zbuffer", "mask_valid"],
                             {"train": 4, "val": 3}, hw=(40, 40))
        data = ["-c", TASKONOMY_YAMLS[3], "--data_path", str(root), "--no_fp16"]
    base = data + ["--device", "cpu", "--model", "multivit_tiny", "--input_size", "32",
                   "--batch_size", "2", "--num_workers", "0", "--finetune", pretrain,
                   "--warmup_epochs", "0", "--eval_freq", "1", "--save_ckpt_freq", "1",
                   "--output_dir", str(out)]
    first = cli.main(cli.get_args(base + ["--epochs", "2"]))
    best = out / "checkpoint-best.pth"
    stamp = (os.stat(best).st_mtime_ns, os.stat(best).st_size)
    second = cli.main(cli.get_args(base + ["--epochs", "3", "--lr", "0", "--min_lr", "0"]))
    evaluated = cli.main(cli.get_args(base + ["--eval", "--resume",
                                              str(out / "checkpoint-1.pth")]))
    return out, first, second, evaluated, stamp


@pytest.mark.parametrize("kind", ["depth", "taskonomy"])
def test_tiny_cli_runs_train_save_resume_and_evaluate(kind, tmp_path, pretrain_pth):
    out, first, second, evaluated, stamp = tiny_runs(kind, tmp_path, pretrain_pth)
    key, better = ("delta_1", max) if kind == "depth" else ("l1", min)
    assert first["finetune"]["missing"] and all(
        k.startswith(f"output_adapters.{'depth' if kind == 'depth' else 'depth_zbuffer'}.")
        for k in first["finetune"]["missing"])
    losses = [r["metrics"]["loss"] for r in first["steps"]]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert [e["images"] for e in first["evals"]] == [3, 3]
    values = [e[key] for e in first["evals"]]
    assert all(np.isfinite(values)) and first[f"best_{key}"] == better(values)
    assert {"checkpoint-0.pth", "checkpoint-1.pth", "checkpoint-best.pth",
            "log.txt"} <= set(os.listdir(out))
    saved = torch.load(out / "checkpoint-1.pth", weights_only=False)
    assert saved[f"best_{key}"] == better(values)

    assert (second["start_epoch"], second["resume_bit_equal"]) == (2, True)
    assert second["resumed_from"] == str(out / "checkpoint-1.pth")
    assert second["evals"][0][key] == values[1]
    assert second[f"best_{key}"] == better(values)
    best = out / "checkpoint-best.pth"
    assert (os.stat(best).st_mtime_ns, os.stat(best).st_size) == stamp

    assert evaluated["steps"] == [] and evaluated["evals"][0][key] == values[1]
    assert evaluated["evals"][0]["images"] == 3


@pytest.mark.parametrize("kind", ["depth", "taskonomy"])
def test_the_card_is_asked_for_by_default(kind):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    cli = CLIS[kind][0]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(cli.get_args(["--synthetic_data"]))


UNPORTED = {
    "msgpack_finetune": (["--finetune", "w.msgpack"], "msgpack"),
}


@pytest.mark.parametrize("kind", ["depth", "taskonomy"])
@pytest.mark.parametrize("flag", sorted(UNPORTED))
def test_unported_flags_exit_naming_their_item(flag, kind):
    cli = CLIS[kind][0]
    argv, words = UNPORTED[flag]
    with pytest.raises(SystemExit, match=words):
        cli.main(cli.get_args(["--synthetic_data", "--device", "cpu"] + argv))


@pytest.mark.parametrize("kind", ["depth", "taskonomy"])
def test_synthetic_run_steps(kind):
    """--synthetic_data: the JAX CLIs' example batch, the steps, no eval."""
    cli = CLIS[kind][0]
    summary = cli.main(cli.get_args([
        "--synthetic_data", "--device", "cpu", "--model", "multivit_tiny", "--input_size", "32",
        "--batch_size", "2", "--epochs", "1", "--synthetic_steps_per_epoch", "2",
        "--warmup_epochs", "0", "--no_auto_resume"] + (["--no_fp16"] if kind != "depth" else [])))
    assert len(summary["steps"]) == 2 and not summary["evals"]
    assert all(np.isfinite(r["metrics"]["loss"]) for r in summary["steps"])


@pytest.mark.parametrize("kind", ["depth", "taskonomy"])
def test_factory_recipes_are_their_yamls(kind):
    """cli/factory.py's DEPTH_RECIPE and TASKONOMY_RECIPE (the card tests'
    and chip runs' trainers) hold what the YAMLs and the CLIs' defaults
    give."""
    cli = CLIS[kind][0]
    a = cli.get_args(["-c", DEPTH_YAMLS[1] if kind == "depth" else TASKONOMY_YAMLS[3]])
    r = factory.DEPTH_RECIPE if kind == "depth" else factory.TASKONOMY_RECIPE
    assert (r["model"], r["input_size"], r["patch_size"], r["output_adapter"],
            r["drop_path_encoder"], r["epochs"], r["lr"], r["min_lr"], r["weight_decay"],
            tuple(r["opt_betas"]), r["layer_decay"], r["clip_grad"]) == (
        a.model, a.input_size, a.patch_size, a.output_adapter, a.drop_path_encoder, a.epochs,
        a.lr, a.min_lr, a.weight_decay, tuple(a.opt_betas), a.layer_decay, a.clip_grad)
    assert r["task"] == a.out_domains and a.in_domains == "rgb" and a.use_mask_valid
    if kind == "depth":
        assert (r["loss"], r["dtype"]) == (a.loss, torch.float32)
    else:
        assert (r["loss"], r["dtype"], a.fp16) == ("l1", torch.bfloat16, True)


@pytest.mark.parametrize("device,dtype,off", [("cuda", torch.float32, True),
                                              ("cuda", torch.bfloat16, False),
                                              ("cpu", torch.float32, False)])
def test_exact_fp32_turns_tf32_off_for_the_run_and_back(device, dtype, off):
    """Only the flags are touched, so the CPU can hold them."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with exact_fp32(torch.device(device), dtype):
            inside = [f.allow_tf32 for f in flags]
        after = [f.allow_tf32 for f in flags]
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    assert inside == [not off, not off] and after == [True, True]
