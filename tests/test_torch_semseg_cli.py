"""The port's semantic segmentation fine-tune CLI and what it brings
(multimae_tpu_torch/cli/run_finetuning_semseg.py, the Segmenter head, the
semseg input adapter's void row, utils/torch_compat.py, the reference
.pth resume, the one-pass eval loader), against the JAX package on the
CPU at tiny sizes.

* The Segmenter head over rgb + pseudo_semseg (the semseg input adapter
  with COCO's 133 classes and a zero void row, class maps that use it) in
  the tiny MultiViT, fp32, from the JAX model's converted parameters: the
  preds within 5e-4 of the largest |pred|; two CLI steps' loss and grad
  norm within 1e-4 relative; the first step's gradients within 2e-5 of
  each tensor's largest |gradient|, or twice the spread between the JAX
  package's own jitted and eager gradients where that is larger (1.9e-5
  for this model: the fp32 LayerNorm over the classes amplifies the last
  bits).
* The fine-tune start: a 64-px pretraining .pth written by the JAX
  exporter loads into a 128-px model through JAX `load_pretrained_torch`
  and the port's `load_pretrained` with the same missing and unexpected
  keys and the same tensors (the resized pos-embs within 1e-6, the void
  row zero), and the two models give the same preds within 5e-4. The
  bicubic pos-emb resize against JAX interpolate_2d at 14 -> 32 and
  14 -> 8.
* A reference training .pth (argparse.Namespace args, no step) resumes
  to the weights and epoch the JAX package restores; the optimizer starts
  fresh.
* get_args against the JAX CLI's on all ten semseg YAMLs; an orbax
  --finetune exits with the JAX CLI's reason (`_load_flax_trunk` open()s
  the file; --ckpt_backend orbax and an orbax --resume:
  tests/test_torch_orbax.py); the card is asked for by
  default; a tiny one-epoch run with --output_adapter dpt (the DPT semseg
  head) trains and evaluates.
* A tiny 2-epoch CLI run from a written NYU-shaped tree on the CPU:
  finite losses, checkpoint-best.pth and two saves, an mIoU over all six
  validation images (the partial batch of two included), every
  non-ignored pixel counted; then the auto-resume at epoch 2.
* The confusion matrix against JAX with void-class preds, and the
  interpolate_class_emb variant of the semseg input adapter against JAX.
"""

import argparse
import glob
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.cli import run_finetuning_semseg as jcli
from multimae_tpu.models.input_adapters import SemSegInputAdapter as JSemSeg
from multimae_tpu.ops.resize import interpolate_2d as jinterp
from multimae_tpu.cli import factory as jfactory
from multimae_tpu.train import checkpoint as jckpt
from multimae_tpu.train import finetune_step as jfs
from multimae_tpu.train.optim_factory import LayerDecayValueAssigner as JLDVA
from multimae_tpu.train.optim_factory import create_optimizer as jcreate
from multimae_tpu.train.schedules import as_optax_schedule, cosine_scheduler as jcosine
from multimae_tpu.train.train_state import TrainState as JTrainState
from multimae_tpu.utils import metrics as jmetrics
from multimae_tpu.utils.torch_compat import params_to_state_dict
from multimae_tpu_torch.cli import run_finetuning_semseg as tcli
from multimae_tpu_torch.data.dataset_folder import MultiTaskImageFolder, write_random_tree
from multimae_tpu_torch.data.semseg_transforms import DataAugmentationForSemSeg, SimpleTransform
from multimae_tpu_torch.models.input_adapters import SemSegInputAdapter
from multimae_tpu_torch.train import checkpoint as ckpt
from multimae_tpu_torch.train.finetune_step import make_dense_eval_step, make_dense_train_step
from multimae_tpu_torch.train.optim_factory import LayerDecayValueAssigner, create_optimizer
from multimae_tpu_torch.train.train_state import TrainState
from multimae_tpu_torch.utils import metrics
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict, state_dict_to_jax_params
from multimae_tpu_torch.utils.flax_msgpack import msgpack_serialize
from multimae_tpu_torch.utils.torch_compat import adapt_tensor, load_pretrained

REPO = Path(__file__).resolve().parents[1]
YAMLS = sorted(glob.glob(str(REPO / "cfgs/finetune/semseg/*/*.yaml")))
NYU = str(REPO / "cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml")
B, S, CLASSES = 2, 64, 7
SEG_PROJ = {"rgb": (3, 16, 16), "semseg": (64, 4, 4)}
SEGMENTER = ["--model", "multivit_tiny", "--in_domains", "rgb-pseudo_semseg",
             "--input_size", str(S), "--num_classes", str(CLASSES), "--drop_path_encoder", "0",
             "--output_adapter", "segmenter", "--decoder_dim", "96", "--decoder_depth", "2",
             "--drop_path_decoder", "0", "--no_fp16"]
LAYER_VALUES = [0.75 ** (2 + 1 - i) for i in range(2 + 2)]
LR = jcosine(1e-3, 1e-5, epochs=1, niter_per_ep=4)
WD = jcosine(0.05, 0.1, epochs=1, niter_per_ep=4)


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def segmenter_batch(seed=1):
    """rgb, a pseudo_semseg class map as prepare_batch gives it (ids past
    COCO's 133 classes on the void row) and a target with ignored pixels."""
    rng = np.random.default_rng(seed)
    semseg = rng.integers(0, 140, (B, S // 4, S // 4))
    target = rng.integers(0, CLASSES, (B, S, S))
    target[rng.random(target.shape) < 0.05] = 255
    b = tcli.prepare_batch({"rgb": torch.from_numpy(rng.standard_normal((B, S, S, 3)).astype(
        np.float32)), "pseudo_semseg": torch.from_numpy(semseg),
        "semseg": torch.from_numpy(target)}, ["rgb", "semseg"], torch.device("cpu"))
    assert int((b["semseg"] == 133).sum()) > 0
    return {k: v.numpy() for k, v in b.items()}


def jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i" else v)
            for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


@pytest.fixture(scope="module")
def segmenter():
    jargs = jcli.get_args(SEGMENTER)
    jmodel, domains, n = jcli.build_semseg_model(jargs, jnp.float32)
    assert tuple(domains) == ("rgb", "semseg") and n == CLASSES
    b = jax_batch(segmenter_batch())
    inputs = {k: v for k, v in b.items() if k != "target"}
    params = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, inputs)["params"])()
    return jmodel, numpy_tree(params)


def port_segmenter(params):
    model, domains, n = tcli.build_model_from_args(tcli.get_args(SEGMENTER), torch.float32)
    sd = jax_params_to_state_dict(params, SEG_PROJ)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model, domains


def test_segmenter_forward_matches_jax(segmenter):
    jmodel, params = segmenter
    b = segmenter_batch()
    ref = np.asarray(jmodel.apply({"params": jax_tree(params)}, jax_batch(b),
                                  train=False)["semseg"])
    model, domains = port_segmenter(params)
    assert model.input_adapters["semseg"].class_emb.weight.shape == (134, 64)
    pred = make_dense_eval_step(model, "semseg", domains)(torch_batch(b))
    assert tuple(pred.shape) == (B, S, S, CLASSES) and pred.dtype == torch.float32
    np.testing.assert_allclose(pred.numpy(), ref, rtol=0, atol=5e-4 * np.abs(ref).max())


def port_state(model):
    for name, p in model.named_parameters():
        if name.endswith("pos_emb"):  # the JAX gradient norm counts them
            p.requires_grad_(True)
    opt = create_optimizer(model, opt_betas=(0.9, 0.999), filter_bias_and_bn=True,
                           layer_decay_assigner=LayerDecayValueAssigner(LAYER_VALUES))
    return TrainState(model, None, opt, LR, WD)


def test_segmenter_steps_match_jax(segmenter):
    jmodel, params = segmenter
    b = segmenter_batch()
    tx = jcreate(params, opt="adamw", lr_schedule=as_optax_schedule(LR),
                 wd_schedule=as_optax_schedule(WD), opt_betas=(0.9, 0.999),
                 layer_decay_assigner=JLDVA(LAYER_VALUES), filter_bias_and_bn=True)
    jstate = JTrainState.create(params=jax_tree(params), tx=tx)
    jstep = jax.jit(jfs.make_dense_train_step(jmodel, "semseg", jcli.seg_cross_entropy,
                                              in_domains=("rgb", "semseg")))
    model, domains = port_segmenter(params)
    state = port_state(model)
    step = make_dense_train_step(model, "semseg", tcli.seg_cross_entropy_parts,
                                 in_domains=domains)
    for _ in range(2):
        jstate, jm = jstep(jstate, jax_batch(b), jax.random.PRNGKey(0))
        tm = step(state, torch_batch(b))
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k


def test_segmenter_first_step_gradients_match_jax(segmenter):
    """Within 2e-5 of each tensor's largest |gradient|, or twice the JAX
    package's own spread where that is larger: its jitted and eager
    gradients of this model differ by up to 1.9e-5 of a tensor's largest
    (the fp32 LayerNorm over the classes' cosine similarities amplifies
    the last bits), and the port's by up to 2.9e-5."""
    jmodel, params = segmenter
    b = segmenter_batch()
    jb = jax_batch(b)

    def loss_fn(p):
        pred = jmodel.apply({"params": p}, {d: jb[d] for d in ("rgb", "semseg")},
                            train=True)["semseg"]
        return jcli.seg_cross_entropy(pred.astype(jnp.float32), jb["target"])

    jgrads = jax_params_to_state_dict(numpy_tree(jax.jit(jax.grad(loss_fn))(jax_tree(params))),
                                      SEG_PROJ)
    eager = jax_params_to_state_dict(numpy_tree(jax.grad(loss_fn)(jax_tree(params))), SEG_PROJ)
    spread = max(np.abs(v - eager[k]).max() / np.abs(v).max() for k, v in jgrads.items())
    bound = max(2e-5, 2 * spread)
    assert bound <= 5e-5, spread
    model, domains = port_segmenter(params)
    state = port_state(model)
    make_dense_train_step(model, "semseg", tcli.seg_cross_entropy_parts, in_domains=domains)(
        state, torch_batch(b))
    named = dict(model.named_parameters())
    assert set(jgrads) == set(named)
    assert float(named["input_adapters.semseg.class_emb.weight"].grad[133].abs().max()) == 0.0
    for k, v in jgrads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), v, rtol=0,
                                   atol=bound * np.abs(v).max(), err_msg=k)


# ------------------------------------------------------- the fine-tune start --

PRETRAIN = dict(model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
                decoder_num_heads=4, decoder_depth=2)
FINETUNE = ["--model", "multivit_tiny", "--in_domains", "rgb-depth-pseudo_semseg",
            "--input_size", "128", "--num_classes", str(CLASSES), "--decoder_dim", "256",
            "--decoder_depth", "2", "--no_fp16"]


@pytest.fixture(scope="module")
def pretrain_pth(tmp_path_factory):
    jmodel = jfactory.build_pretrain_model(**PRETRAIN)
    batch = jfactory.make_synthetic_batch(2, input_size=64, seed=1)
    params = jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(5), "masking": jax.random.PRNGKey(1)},
        batch, num_encoded_tokens=24)["params"])()
    sd = params_to_state_dict(numpy_tree(params), proj_shapes={
        "rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)})
    path = str(tmp_path_factory.mktemp("pretrain") / "checkpoint-9.pth")
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                "epoch": 9}, path)
    return path


def finetune_batch():
    rng = np.random.default_rng(4)
    return {"rgb": rng.standard_normal((2, 128, 128, 3)).astype(np.float32),
            "depth": rng.standard_normal((2, 128, 128, 1)).astype(np.float32),
            "semseg": rng.integers(0, 134, (2, 32, 32)),
            "target": rng.integers(0, CLASSES, (2, 128, 128))}


def test_finetune_start_loads_what_jax_loads(pretrain_pth):
    jmodel, _, _ = jcli.build_semseg_model(jcli.get_args(FINETUNE), jnp.float32)
    b = finetune_batch()
    inputs = {k: v for k, v in jax_batch(b).items() if k != "target"}
    template = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, inputs)["params"])()
    jparams, jreport = jckpt.load_pretrained_torch(pretrain_pth, template, head_type="semseg")
    ref = jax_params_to_state_dict(numpy_tree(jparams), {
        "rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)})

    model, domains, _ = tcli.build_model_from_args(tcli.get_args(FINETUNE), torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    report = load_pretrained(model, pretrain_pth)
    for k in ("missing", "unexpected", "ignored"):
        assert sorted(report[k]) == sorted(jreport[k]), k
    assert report["missing"] and all(k.startswith("output_adapters.semseg.")
                                     for k in report["missing"])
    assert any(k.startswith("output_adapters.rgb.") for k in report["unexpected"])
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k in report["missing"]:
            continue
        if k.endswith("pos_emb"):
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert got["input_adapters.rgb.pos_emb"].shape == (1, 64, 8, 8)
    void = got["input_adapters.semseg.class_emb.weight"]
    assert void.shape == (134, 64) and not void[133].any()

    # The head is not in the .pth: give the port the JAX model's, then the preds.
    model.load_state_dict({k: torch.from_numpy(ref[k]) for k in report["missing"]},
                          strict=False)
    jpred = np.asarray(jmodel.apply({"params": jparams}, inputs, train=False)["semseg"])
    pred = make_dense_eval_step(model, "semseg", domains)(torch_batch(b)).numpy()
    np.testing.assert_allclose(pred, jpred, rtol=0, atol=5e-4 * np.abs(jpred).max())


@pytest.mark.parametrize("size", [32, 8])
def test_pos_emb_resize_matches_jax(size):
    src = np.random.default_rng(size).standard_normal((1, 48, 14, 14)).astype(np.float32)
    got = adapt_tensor("input_adapters.rgb.pos_emb", torch.from_numpy(src),
                       torch.zeros(1, 48, size, size)).numpy()
    ref = np.asarray(jinterp(jnp.asarray(src.transpose(0, 2, 3, 1)), (size, size),
                             mode="bicubic", align_corners=False)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_shape_mismatch_raises():
    with pytest.raises(ValueError, match="source"):
        adapt_tensor("encoder.0.mlp.fc1.weight", torch.zeros(3, 4), torch.zeros(3, 5))


def test_reference_training_pth_resumes_to_the_jax_weights_and_epoch(tmp_path):
    """A reference training checkpoint: the model, an optimizer state the
    port cannot use, the epoch and argparse.Namespace args; no step."""
    args = tcli.get_args(FINETUNE[:-1] + ["--no_fp16"])
    src, _, _ = tcli.build_model_from_args(args, torch.float32)
    src.init_weights(torch.Generator().manual_seed(7))
    path = str(tmp_path / "checkpoint-4.pth")
    torch.save({"model": src.state_dict(), "optimizer": {"state": {}, "param_groups": []},
                "epoch": 4, "scaler": {"scale": 1.0},
                "args": argparse.Namespace(lr=1e-4, model="multivit_tiny")}, path)
    with pytest.raises(Exception):  # the plain weights-only unpickler refuses it
        torch.load(path, weights_only=True)

    model, _, _ = tcli.build_model_from_args(args, torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    state = TrainState(model, None, create_optimizer(model), np.zeros(4, np.float32))
    epoch, payload = ckpt.load_checkpoint(path, state)
    assert (epoch, payload, state.step, state.updates) == (4, {}, 0, 0)
    assert not state.optimizer.state

    jmodel, _, _ = jcli.build_semseg_model(jcli.get_args(FINETUNE), jnp.float32)
    inputs = {k: v for k, v in jax_batch(finetune_batch()).items() if k != "target"}
    template = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, inputs)["params"])()
    tx = jcreate(template, opt="adamw", lr_schedule=as_optax_schedule(np.zeros(4)))
    jstate, jepoch = jckpt.load_checkpoint(path, JTrainState.create(params=template, tx=tx))
    assert jepoch == epoch
    ref = jax_params_to_state_dict(numpy_tree(jstate.params), {
        "rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)})
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)


# ------------------------------------------------------------------- the CLI --

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


def test_msgpack_start_loads_what_load_flax_trunk_loads(tmp_path, pretrain_pth, capsys):
    """A JAX-layout .msgpack of the pretraining weights (the port's inverse
    converter and writer) starts a synthetic step by `_load_flax_trunk`'s
    rule, with its N/M: every output adapter skipped."""
    sd = torch.load(pretrain_pth, weights_only=True)["model"]
    params, _ = state_dict_to_jax_params(sd, {"rgb": (3, 16, 16), "depth": (1, 16, 16),
                                              "semseg": (64, 4, 4)})
    path = tmp_path / "checkpoint-9.msgpack"
    path.write_bytes(msgpack_serialize({"params": {"model": params}, "step": 9, "epoch": 9}))
    jmodel, _, _ = jcli.build_semseg_model(jcli.get_args(FINETUNE), jnp.float32)
    inputs = {k: v for k, v in jax_batch(finetune_batch()).items() if k != "target"}
    template = jax.eval_shape(lambda: jmodel.init({"params": jax.random.PRNGKey(0)}, inputs)
                              )["params"]
    jcli._load_flax_trunk(str(path), jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                                                  template))
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    out = tcli.main(tcli.get_args(FINETUNE + [
        "--device", "cpu", "--synthetic_data", "--synthetic_steps_per_epoch", "1",
        "--epochs", "1", "--batch_size", "1", "--finetune", str(path),
        "--output_dir", str(tmp_path / "out")]))
    assert jline in capsys.readouterr().out
    report = out["finetune"]
    assert jline == f"[finetune] loaded {report['loaded']}/{report['total']} tensors"
    assert report["loaded"] > 0 and not any(p[0].startswith("output_adapters")
                                            for p in report["paths"])


def test_tiny_dpt_run_trains_and_evaluates(tmp_path, pretrain_pth):
    """--output_adapter dpt: the DPT semseg head over the tiny encoder's
    every layer, one epoch from a pretraining .pth and its evaluation, on
    one intra-op thread (the head's many small CPU convolutions make
    torch's thread pool spin when several test processes share the cores)."""
    nyu = dict(semseg_classes=40, ignore_patches=True, mask_valid=True)
    write_random_tree(str(tmp_path / "train"), 4, (48, 64), **nyu)
    write_random_tree(str(tmp_path / "val"), 2, (48, 64), seed=1, **nyu)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        summary = tcli.main(tcli.get_args([
            "-c", NYU, "--device", "cpu", "--model", "multivit_tiny", "--input_size", "32",
            "--output_adapter", "dpt", "--no_fp16", "--num_workers", "0", "--batch_size", "2",
            "--epochs", "1", "--finetune", pretrain_pth, "--data_path", str(tmp_path / "train"),
            "--eval_data_path", str(tmp_path / "val"), "--output_dir", str(tmp_path / "out")]))
    finally:
        torch.set_num_threads(threads)
    losses = [r["metrics"]["loss"] for r in summary["steps"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert [e["images"] for e in summary["evals"]] == [2]
    assert 0.0 <= summary["evals"][0]["mIoU"] <= 1.0
    missing = summary["finetune"]["missing"]
    assert missing and all(k.startswith("output_adapters.semseg.") for k in missing)
    assert any(".scratch.refinenet1." in k for k in missing)
    assert not any(".refinenet4.resConfUnit1." in k for k in missing)
    assert (tmp_path / "out" / "checkpoint-0.pth").exists()


def test_the_card_is_asked_for_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(tcli.get_args(["--synthetic_data"]))


def test_confusion_matrix_with_void_preds_matches_jax():
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 6, (2, 30, 40))  # 5 is the void class of 5 classes
    label = rng.integers(0, 5, (2, 30, 40))
    label[rng.random(label.shape) < 0.1] = 255
    got = metrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), 5)
    ref = np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(label), 5))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_interpolated_class_embedding_matches_jax():
    kw = dict(num_classes=10, stride_level=4, patch_size_full=16, image_size=64,
              dim_class_emb=16, interpolate_class_emb=True, emb_padding_idx=10)
    jad = JSemSeg(dim_tokens=32, **kw)
    x = np.random.default_rng(5).integers(0, 11, (2, 16, 16))
    jparams = numpy_tree(jad.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    ref = np.asarray(jad.apply({"params": jax_tree(jparams)}, jnp.asarray(x)))
    port = SemSegInputAdapter(dim_tokens=32, **kw)
    sd = jax_params_to_state_dict({"input_adapters_semseg": jparams},
                                  {"semseg": (16, 1, 1)})
    port.load_state_dict({k[len("input_adapters.semseg."):]: torch.from_numpy(v)
                          for k, v in sd.items()}, strict=True)
    got = port(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 16, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory, pretrain_pth):
    """Two epochs of the NYU recipe on the tiny model from a written tree,
    then a relaunch with --epochs 3."""
    root = tmp_path_factory.mktemp("semseg_cli")
    nyu = dict(semseg_classes=40, ignore_patches=True, mask_valid=True)
    write_random_tree(str(root / "train"), 16, (48, 64), **nyu)
    write_random_tree(str(root / "val"), 6, (48, 64), seed=1, **nyu)
    base = ["-c", NYU, "--device", "cpu", "--model", "multivit_tiny", "--input_size", "64",
            "--decoder_dim", "256", "--decoder_depth", "2", "--no_fp16", "--num_workers", "0",
            "--data_path", str(root / "train"), "--eval_data_path", str(root / "val"),
            "--finetune", pretrain_pth, "--output_dir", str(root / "out"),
            "--save_ckpt_freq", "1"]
    first = tcli.main(tcli.get_args(base + ["--epochs", "2"]))
    second = tcli.main(tcli.get_args(base + ["--epochs", "3"]))
    return root, first, second


def test_tiny_cli_run_trains_evaluates_and_saves(tiny_run):
    root, first, _ = tiny_run
    losses = [r["metrics"]["loss"] for r in first["steps"]]
    assert len(losses) == 8 and all(np.isfinite(losses))
    assert [e["images"] for e in first["evals"]] == [6, 6]
    assert all(0.0 <= e["mIoU"] <= 1.0 and e["batches"] == 2 for e in first["evals"])
    dataset = MultiTaskImageFolder(str(root / "val"), ["depth", "mask_valid", "rgb", "semseg"])
    transform = DataAugmentationForSemSeg(SimpleTransform(False, 64), seg_num_classes=40)
    valid = sum(int((transform(dataset.load_raw(i)[0])["semseg"] != 255).sum())
                for i in range(len(dataset)))
    assert all(e["pixels"] == valid for e in first["evals"])
    out = root / "out"
    assert {"checkpoint-0.pth", "checkpoint-1.pth", "checkpoint-best.pth", "log.txt"} <= set(
        os.listdir(out))
    assert len((out / "log.txt").read_text().splitlines()) >= 2
    assert first["finetune"]["missing"] and first["start_epoch"] == 0


def test_tiny_cli_run_auto_resumes(tiny_run):
    root, first, second = tiny_run
    assert second["start_epoch"] == 2 and second["resume_bit_equal"]
    assert second["resumed_from"] == str(root / "out" / "checkpoint-1.pth")
    assert [s["epoch"] for s in second["steps"]] == [2] * 4
    assert len(second["evals"]) == 1 and np.isfinite(second["steps"][0]["metrics"]["loss"])
