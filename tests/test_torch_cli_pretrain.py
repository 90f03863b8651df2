"""The port's pretraining CLI (multimae_tpu_torch/cli/run_pretraining_multimae.py)
against the JAX package's, and the pieces it adds.

* `get_args` with -c equals the JAX `get_args` on every shared flag for
  both pretrain YAMLs (and with flags over a YAML), `--device` aside
  (the port's default is the card).
* The flat-YAML reader equals `yaml.safe_load` on all 32 files in cfgs/.
* Flags whose function is not ported raise, naming ROADMAP.md.
* The step's recipe flags against the JAX step: tests/test_torch_step_flags.py.
* A 2-epoch tiny CLI run on the CPU from a PIL-written tree writes
  checkpoint-*.pth and log.txt, and a relaunch auto-resumes after them.
The CLI's first step on the card is in tests/test_torch_kernels.py.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from multimae_tpu.cli import factory as jfactory
from multimae_tpu.cli import run_pretraining_multimae as jcli
from multimae_tpu_torch.cli import factory as tfactory
from multimae_tpu_torch.cli import run_pretraining_multimae as tcli
from multimae_tpu_torch.train.optim_factory import create_optimizer
from multimae_tpu_torch.utils.config import load_flat_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRETRAIN_YAMLS = sorted(glob.glob(os.path.join(REPO, "cfgs", "pretrain", "*.yaml")))
ALL_YAMLS = sorted(glob.glob(os.path.join(REPO, "cfgs", "**", "*.yaml"), recursive=True))
TINY = dict(model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
            decoder_num_heads=4, decoder_depth=1)


def _shared(a, b):
    va, vb = vars(a), vars(b)
    return {k: (va[k], vb[k]) for k in set(va) & set(vb) if k != "device"}


@pytest.mark.parametrize("extra", [[], ["--batch_size", "32", "--epochs", "3", "--blr", "2e-4",
                                        "--no_extra_norm_pix_loss", "--in_domains", "rgb"]])
@pytest.mark.parametrize("cfg", PRETRAIN_YAMLS, ids=os.path.basename)
def test_get_args_matches_jax(cfg, extra):
    ours, theirs = tcli.get_args(["-c", cfg] + extra), jcli.get_args(["-c", cfg] + extra)
    assert set(vars(theirs)) <= set(vars(ours))
    assert all(x == y and type(x) is type(y) for x, y in _shared(ours, theirs).values())
    assert ours.device == "cuda" and ours.standardize_depth is True


def test_get_args_defaults_match_jax():
    assert all(x == y for x, y in _shared(tcli.get_args([]), jcli.get_args([])).values())


@pytest.mark.parametrize("cfg", ALL_YAMLS, ids=lambda p: os.path.relpath(p, REPO))
def test_flat_yaml_matches_safe_load(cfg):
    with open(cfg) as f:
        ref = yaml.safe_load(f)
    got = load_flat_yaml(cfg)
    assert got == ref and all(type(got[k]) is type(ref[k]) for k in ref)


def test_flat_yaml_refuses_what_it_does_not_read(tmp_path):
    for text in ("a:\n  b: 1\n", "a: [1, 2]\n", "a: 0x10\n", "just text\n"):
        path = tmp_path / "x.yaml"
        path.write_text(text)
        with pytest.raises(ValueError):
            load_flat_yaml(str(path))


@pytest.mark.parametrize("flags,item", [
    (["--approx_gelu"], "item 12"), (["--ckpt_backend", "orbax"], "item 10"),
])
def test_unported_flags_raise(flags, item):
    with pytest.raises(SystemExit, match=f"ROADMAP.md queue 1 {item}"):
        tcli.main(tcli.get_args(["--device", "cpu", "--synthetic_data"] + flags))


def test_other_optimizers_raise():
    """SGD and Adam are ported (item 14); a name the JAX factory does not
    know raises as it does there."""
    model = tfactory.build_pretrain_model(**TINY, device="cpu")
    assert type(create_optimizer(model, opt="sgd")).__name__ == "TraceSGD"
    with pytest.raises(ValueError, match="Invalid optimizer lamb"):
        create_optimizer(model, opt="lamb")


def test_cli_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(tcli.get_args(["--synthetic_data", "--model", "pretrain_multimae_tiny"]))


# ---------------------------------------------------------- the CLI run --

@pytest.fixture(scope="module")
def pil_tree(tmp_path_factory):
    """8 aligned samples in 2 classes at 72 x 88, written with PIL."""
    root = str(tmp_path_factory.mktemp("cli_tree"))
    rng = np.random.default_rng(0)
    for i in range(8):
        cls = f"c{i % 2}"
        for t in ("rgb", "depth", "semseg"):
            os.makedirs(f"{root}/{t}/{cls}", exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (72, 88, 3), dtype=np.uint8), "RGB").save(
            f"{root}/rgb/{cls}/i{i}.png")
        Image.fromarray(rng.integers(0, 60000, (72, 88), dtype=np.uint16)).save(
            f"{root}/depth/{cls}/i{i}.png")
        Image.fromarray(rng.integers(0, 133, (72, 88), dtype=np.uint8), "L").convert("P").save(
            f"{root}/semseg/{cls}/i{i}.png")
    return root


TINY_CLI = ["-c", os.path.join(REPO, "cfgs/pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml"),
            "--model", "pretrain_multimae_tiny", "--input_size", "64",
            "--num_encoded_tokens", "24", "--decoder_dim", "64", "--decoder_num_heads", "4",
            "--batch_size", "4", "--warmup_epochs", "0", "--num_workers", "0",
            "--save_ckpt_freq", "1", "--task_balancer", "uncertainty", "--dtype", "float32"]


def test_cli_trains_saves_and_auto_resumes(pil_tree, tmp_path):
    out = str(tmp_path / "out")
    args = TINY_CLI + ["--data_path", pil_tree, "--output_dir", out, "--device", "cpu"]
    first = tcli.main(tcli.get_args(args + ["--epochs", "2"]))
    assert first["start_epoch"] == 0 and len(first["steps"]) == 4
    assert all(np.isfinite(r["metrics"]["loss"]) for r in first["steps"])
    assert sorted(os.listdir(out)) == ["args.json", "checkpoint-0.pth", "checkpoint-1.pth",
                                       "log.txt"]
    saved = torch.load(f"{out}/checkpoint-1.pth", weights_only=True)
    assert saved["epoch"] == 1 and (saved["step"], saved["updates"]) == (4, 4)
    assert saved["data_iter_state"] == {"seed": 0, "epoch": 1, "batch": 2}
    assert saved["args"]["opt_betas"] == [0.9, 0.95]

    again = tcli.main(tcli.get_args(args + ["--epochs", "3"]))
    assert again["start_epoch"] == 2 and again["resumed_from"].endswith("checkpoint-1.pth")
    assert again["resume_bit_equal"] and [e["epoch"] for e in again["epochs"]] == [2]
    with open(f"{out}/log.txt") as f:
        lines = [json.loads(line) for line in f]
    assert [line["epoch"] for line in lines] == [0, 1, 2]
