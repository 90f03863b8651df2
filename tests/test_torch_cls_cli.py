"""The port's classification fine-tune CLI
(multimae_tpu_torch/cli/run_finetuning_cls.py) on the CPU at tiny sizes.

* get_args against the JAX CLI's on both cls YAMLs; an orbax
  --finetune exits with the JAX CLI's reason (it open()s the file;
  --ckpt_backend orbax and an orbax --resume: tests/test_torch_orbax.py);
  the card is asked for by default.
* A JAX-layout .msgpack of a pretraining save starts a synthetic run by the
  JAX CLI's rule: the encoder loads, the head does not.
* A 1-epoch run over a tiny ImageNet-layout tree of the JPEG fixtures
  (multivit_tiny at 32 px, 4 classes, the recipe's RandAugment, mixup and
  cutmix, the EMA on), started from a pretraining .pth (the head's keys
  missing, the decoders' unexpected, the encoder loaded): finite losses,
  checkpoint-0.pth and checkpoint-best.pth with the EMA and the best
  top-1; then an auto-resume to epoch 1 at LR 0 keeps checkpoint-best
  (the JAX CLI would overwrite it with its first evaluation), and --eval
  gives the same top-1 over every validation image.
* The same over a written `cifar-100-python` pickle, and with the EMA in
  host memory; a pickle that asks for anything but numpy arrays is
  refused.
"""

import glob
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from multimae_tpu.cli import run_finetuning_cls as jcli
from multimae_tpu_torch.cli import factory
from multimae_tpu_torch.cli import run_finetuning_cls as tcli
from multimae_tpu_torch.data.dataset_folder import CIFAR100, write_cifar100, write_imagenet_tree
from multimae_tpu_torch.utils.convert import state_dict_to_jax_params
from multimae_tpu_torch.utils.flax_msgpack import msgpack_serialize


def proj_shapes_of_sd(sd):
    return {k.split(".")[1]: tuple(v.shape[1:]) for k, v in sd.items()
            if k.startswith("input_adapters.") and k.endswith(".proj.weight") and v.dim() == 4}

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(glob.glob(str(REPO / "cfgs" / "finetune" / "cls" / "*.yaml")))
PHOTOS = sorted(glob.glob(str(REPO / "tests" / "fixtures" / "jpeg" / "photo_*.jpg")))


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: Path(p).stem)
def test_get_args_matches_jax(path):
    extra = ["--output_dir", "x", "--epochs", "3"]
    got, ref = vars(tcli.get_args(["-c", path] + extra)), vars(jcli.get_args(["-c", path] + extra))
    assert got.pop("device") == "cuda" and ref.pop("device") == "tpu"
    assert got == ref


UNPORTED = {
    "orbax_finetune": (["--finetune", "checkpoint-3.orbax"],
                       r"open\(\) as one flax msgpack file, so an orbax directory"),
}


@pytest.mark.parametrize("flag", sorted(UNPORTED))
def test_unported_flags_exit_naming_their_item(flag):
    argv, words = UNPORTED[flag]
    with pytest.raises(SystemExit, match=words):
        tcli.main(tcli.get_args(["--synthetic_data", "--device", "cpu"] + argv))


def test_the_card_is_asked_for_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(tcli.get_args(["--synthetic_data"]))


TINY = ["-c", str(REPO / "cfgs" / "finetune" / "cls" / "ft_in1k_100e_multimae-b.yaml"),
        "--device", "cpu", "--model", "multivit_tiny", "--input_size", "32",
        "--batch_size", "4", "--warmup_epochs", "0", "--num_workers", "0",
        "--save_ckpt_freq", "1", "--dtype", "float32", "--finetune", ""]


@pytest.fixture(scope="module")
def pretrain_pth(tmp_path_factory):
    """A tiny rgb-depth-semseg pretraining save, as the pretraining CLI writes."""
    model = factory.build_pretrain_model(model_name="pretrain_multimae_tiny", input_size=32,
                                         decoder_dim=64, decoder_num_heads=4, device="cpu")
    path = tmp_path_factory.mktemp("pretrain") / "checkpoint-0.pth"
    torch.save({"model": model.state_dict(), "epoch": 0}, path)
    return str(path), model.state_dict()


@pytest.fixture(scope="module")
def jpeg_run(tmp_path_factory, pretrain_pth):
    root = tmp_path_factory.mktemp("cls")
    train, val = write_imagenet_tree(str(root / "tree"), PHOTOS, 16, 6, 4)
    out = str(root / "out")
    argv = TINY + ["--data_set", "image_folder", "--nb_classes", "4", "--data_path", train,
                   "--eval_data_path", val, "--output_dir", out, "--model_ema",
                   "--finetune", pretrain_pth[0]]
    first = tcli.main(tcli.get_args(argv + ["--epochs", "1"]))
    first["files"] = sorted(os.listdir(out))
    best = torch.load(os.path.join(out, "checkpoint-best.pth"), weights_only=True)
    resumed = tcli.main(tcli.get_args(argv + ["--epochs", "2", "--blr", "0", "--min_lr", "0"]))
    evaluated = tcli.main(tcli.get_args(argv + ["--eval"]))
    return argv, out, first, best, resumed, evaluated


def test_msgpack_start_loads_the_trunk(pretrain_pth, tmp_path, capsys):
    """A JAX-layout .msgpack of the pretraining weights (the port's inverse
    converter and writer) starts a synthetic run: the encoder loads, the
    head keeps its initial weights."""
    params, _ = state_dict_to_jax_params(pretrain_pth[1], proj_shapes_of_sd(pretrain_pth[1]))
    path = tmp_path / "checkpoint-0.msgpack"
    path.write_bytes(msgpack_serialize({"params": {"model": params}, "step": 0, "epoch": 0}))
    out = tcli.main(tcli.get_args(TINY + [
        "--synthetic_data", "--synthetic_steps_per_epoch", "1", "--epochs", "1",
        "--nb_classes", "4", "--finetune", str(path), "--output_dir", str(tmp_path / "out"),
        "--blr", "0", "--min_lr", "0", "--weight_decay", "0"]))
    report = out["finetune"]
    assert 0 < report["loaded"] < report["total"]
    assert f"[finetune] loaded {report['loaded']}/{report['total']} tensors" in \
        capsys.readouterr().out
    assert not any(p[0] == "output_adapters_cls" for p in report["paths"])
    saved = torch.load(tmp_path / "out" / "checkpoint-0.pth", weights_only=True)["model"]
    for key in ("encoder.1.mlp.fc2.weight", "input_adapters.rgb.proj.weight"):
        assert torch.equal(saved[key], pretrain_pth[1][key]), key


def test_cli_trains_saves_and_evaluates(jpeg_run, pretrain_pth):
    _, out, first, best, _, _ = jpeg_run
    assert len(first["steps"]) == 4
    assert all(np.isfinite(s["metrics"]["loss"]) for s in first["steps"])
    assert first["files"] == ["args.json", "checkpoint-0.pth", "checkpoint-best.pth", "log.txt"]
    (ev,) = first["evals"]
    assert ev["images"] == 6 and ev["batches"] == 2  # the partial batch of 2 counted
    assert 0.0 <= ev["acc1"] <= ev["acc5"] <= 100.0
    assert best["best_acc1"] == ev["acc1"] and best["epoch"] == 0
    assert set(best["ema_params"]) == {n for n, _ in first_model_params()}
    report = first["finetune"]
    assert sorted(report["missing"]) == ["output_adapters.cls.head.bias",
                                         "output_adapters.cls.head.weight",
                                         "output_adapters.cls.norm.bias",
                                         "output_adapters.cls.norm.weight"]
    assert all(k.startswith(("output_adapters.", "input_adapters.depth.",
                             "input_adapters.semseg.")) for k in report["unexpected"])
    saved = torch.load(os.path.join(out, "checkpoint-0.pth"), weights_only=True)
    assert saved["best_acc1"] == ev["acc1"] and saved["data_iter_state"]["batch"] == 4


def first_model_params():
    model = factory.build_cls_model(model="multivit_tiny", input_size=32, nb_classes=4)
    return list(model.named_parameters())


def test_resume_keeps_the_best_top1(jpeg_run):
    argv, out, first, best, resumed, _ = jpeg_run
    assert resumed["resumed_from"].endswith("checkpoint-0.pth") and resumed["start_epoch"] == 1
    assert resumed["resume_bit_equal"]
    (ev,) = resumed["evals"]
    assert ev["acc1"] == first["evals"][0]["acc1"]  # LR 0: the weights did not move
    after = torch.load(os.path.join(out, "checkpoint-best.pth"), weights_only=True)
    assert after["epoch"] == 0 and resumed["best_acc1"] == best["best_acc1"]
    assert os.path.exists(os.path.join(out, "checkpoint-1.pth"))


def test_eval_flag_reports_top1_over_every_image(jpeg_run):
    _, _, _, _, resumed, evaluated = jpeg_run
    (ev,) = evaluated["evals"]
    assert ev["images"] == 6 and ev["acc1"] == resumed["evals"][0]["acc1"]
    assert evaluated["steps"] == []


@pytest.fixture(scope="module")
def cifar_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cifar"))
    rng = np.random.default_rng(0)
    write_cifar100(root, rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8),
                   rng.integers(0, 100, 8), train=True)
    write_cifar100(root, rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8),
                   rng.integers(0, 100, 4), train=False)
    return root


def test_cifar_reads_the_pickle_layout(cifar_root):
    ds = CIFAR100(cifar_root, train=False)
    img, target = ds[3]
    assert len(ds) == 4 and img.shape == (32, 32, 3) and img.dtype == np.uint8
    with open(os.path.join(cifar_root, "cifar-100-python", "test"), "rb") as f:
        entry = pickle.load(f, encoding="bytes")
    np.testing.assert_array_equal(img.transpose(2, 0, 1).reshape(-1), entry[b"data"][3])
    assert target == entry[b"fine_labels"][3]


def test_cifar_run_with_the_ema_on_the_host(cifar_root, tmp_path):
    out = str(tmp_path / "out")
    summary = tcli.main(tcli.get_args(TINY + [
        "--data_set", "CIFAR", "--nb_classes", "100", "--data_path", cifar_root,
        "--output_dir", out, "--epochs", "1", "--model_ema", "--model_ema_force_cpu",
        "--update_freq", "2"]))
    assert len(summary["steps"]) == 2 and summary["evals"][0]["images"] == 4
    saved = torch.load(os.path.join(out, "checkpoint-0.pth"), weights_only=True)
    assert saved["updates"] == 1 and saved["mini_step"] == 0
    ema = saved["ema_params"]
    assert ema["output_adapters.cls.head.weight"].dtype == torch.float32
    assert not torch.equal(ema["output_adapters.cls.head.weight"],
                           saved["model"]["output_adapters.cls.head.weight"])
    with pytest.raises(SystemExit, match="100 classes"):
        tcli.main(tcli.get_args(TINY + ["--data_set", "CIFAR", "--nb_classes", "10",
                                        "--data_path", cifar_root]))


def test_cifar_pickle_refuses_other_objects(tmp_path):
    folder = tmp_path / "cifar-100-python"
    folder.mkdir()
    with open(folder / "train", "wb") as f:
        pickle.dump({b"data": os.getcwd, b"fine_labels": []}, f, protocol=2)
    with pytest.raises(pickle.UnpicklingError, match="not allowed"):
        CIFAR100(str(tmp_path), train=True)
