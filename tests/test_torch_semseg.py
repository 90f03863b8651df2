"""The port's semantic segmentation fine-tune against the JAX package's.

The tiny MultiViT (dim 64, 2 blocks) with RGB + depth at 64 px (16 + 16
tokens + 1 global) and the ConvNeXt head (embed 256 = 16 sub-pixels of 16
channels, 2 blocks, 7 classes), fp32, takes the JAX model's parameters
through the port's converter:

* the forward matches within 5e-4 of the largest |pred|;
* two make_dense_train_step steps (drop_path 0, layer decay 0.75, AdamW
  (0.9, 0.999), cosine LR and WD schedules) match the JAX step: loss and
  grad norm within 1e-4 relative; the first step's gradients within 2e-5
  of each tensor's largest |gradient|; the updated parameters as in
  tests/test_torch_train_step.py (every element within 2.5e-3, the median
  within 2e-6, at most 0.5% of the elements, or two, beyond it: Adam
  divides each gradient by its own RMS, so an element whose gradient is
  as small as the frameworks' ~1e-7 difference moves by up to lr);
* the converter gives what the JAX exporter gives, key for key, and the
  layer-decay groups hold what JAX `build_param_labels` puts in them.

Small cases pin drop_path, the confusion matrix and mIoU (ignore index
255, absent classes), the 512-px sin-cos grid of the input adapters, and
the trainer's recipe values against the YAML they come from; a scan of
every file of the port and of chip_smoke.py finds no import of JAX or of
the JAX package.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.cli import run_finetuning_semseg as jcli
from multimae_tpu.models.input_adapters import PatchedInputAdapter as JPatched
from multimae_tpu.train import finetune_step as jfs
from multimae_tpu.train.optim_factory import LayerDecayValueAssigner as JLDVA
from multimae_tpu.train.optim_factory import build_param_labels, create_optimizer as jcreate
from multimae_tpu.train.schedules import as_optax_schedule, cosine_scheduler as jcosine
from multimae_tpu.train.train_state import TrainState as JTrainState
from multimae_tpu.utils import metrics as jmetrics
from multimae_tpu.utils.torch_compat import params_to_state_dict
from multimae_tpu_torch.cli import factory
from multimae_tpu_torch.cli.run_finetuning_semseg import (
    build_semseg_model, seg_cross_entropy_parts)
from multimae_tpu_torch.models.input_adapters import PatchedInputAdapter
from multimae_tpu_torch.models.vit import drop_path
from multimae_tpu_torch.train.finetune_step import make_dense_eval_step, make_dense_train_step
from multimae_tpu_torch.train.optim_factory import (
    LayerDecayValueAssigner,
    build_param_groups,
    create_optimizer,
)
from multimae_tpu_torch.train.train_state import TrainState
from multimae_tpu_torch.utils import metrics
from multimae_tpu_torch.utils.convert import flax_path_to_torch_key, jax_params_to_state_dict

YAML = "cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml"
PROJ_SHAPES = {"rgb": (3, 16, 16), "depth": (1, 16, 16)}
DOMAINS = ("rgb", "depth")
B, S, CLASSES = 2, 64, 7
TINY = dict(model="multivit_tiny", in_domains=DOMAINS, input_size=S, num_classes=CLASSES,
            drop_path_encoder=0.0, decoder_dim=256, decoder_depth=2)
LAYER_VALUES = [0.75 ** (2 + 1 - i) for i in range(2 + 2)]
BETAS = (0.9, 0.999)
LR = jcosine(1e-3, 1e-5, epochs=1, niter_per_ep=4)
WD = jcosine(0.05, 0.1, epochs=1, niter_per_ep=4)


def jax_args():
    return jcli.get_args([
        "--model", "multivit_tiny", "--in_domains", "rgb-depth", "--input_size", str(S),
        "--num_classes", str(CLASSES), "--drop_path_encoder", "0", "--decoder_dim", "256",
        "--decoder_depth", "2", "--output_adapter", "convnext", "--no_fp16"])


def batch_np(seed=1):
    b = factory.make_synthetic_semseg_batch(B, input_size=S, num_classes=CLASSES, seed=seed,
                                            device="cpu")
    return {k: v.numpy() for k, v in b.items()}


def jax_batch(b):
    return {k: jnp.asarray(v.astype(np.int32) if k == "target" else v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def jax_model():
    model, in_domains, _ = jcli.build_semseg_model(jax_args(), jnp.float32)
    assert tuple(in_domains) == DOMAINS
    inputs = {k: v for k, v in jax_batch(batch_np()).items() if k != "target"}
    params = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0)}, inputs)["params"])()
    return model, numpy_tree(params)


def port_model(params):
    model = build_semseg_model(**TINY)
    sd = jax_params_to_state_dict(params, PROJ_SHAPES)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model


def test_forward_matches_jax(jax_model):
    jmodel, params = jax_model
    b = batch_np()
    ref = np.asarray(jmodel.apply({"params": params}, jax_batch(b), train=False)["semseg"])
    model = port_model(params)
    pred = make_dense_eval_step(model, "semseg", DOMAINS)(torch_batch(b))
    assert tuple(pred.shape) == (B, S, S, CLASSES)
    np.testing.assert_allclose(pred.numpy(), ref, rtol=0, atol=5e-4 * np.abs(ref).max())


def jax_optimizer(params):
    return jcreate(params, opt="adamw", lr_schedule=as_optax_schedule(LR),
                   wd_schedule=as_optax_schedule(WD), opt_betas=BETAS,
                   layer_decay_assigner=JLDVA(LAYER_VALUES), filter_bias_and_bn=True)


@pytest.fixture(scope="module")
def jax_run(jax_model):
    jmodel, params = jax_model
    state = JTrainState.create(params=params, tx=jax_optimizer(params))
    step = jax.jit(jfs.make_dense_train_step(jmodel, "semseg", jcli.seg_cross_entropy,
                                             in_domains=DOMAINS))
    batch = jax_batch(batch_np())
    history = []
    for _ in range(2):
        state, m = step(state, batch, jax.random.PRNGKey(0))
        history.append({k: float(v) for k, v in m.items()})
    return history, numpy_tree(state.params)


def port_state(params):
    model = port_model(params)
    for name, p in model.named_parameters():
        if name.endswith("pos_emb"):  # the JAX gradient norm counts them
            p.requires_grad_(True)
    opt = create_optimizer(model, opt_betas=BETAS, filter_bias_and_bn=True,
                           layer_decay_assigner=LayerDecayValueAssigner(LAYER_VALUES))
    state = TrainState(model, None, opt, LR, WD)
    return state, make_dense_train_step(model, "semseg", seg_cross_entropy_parts,
                                        in_domains=DOMAINS)


@pytest.fixture(scope="module")
def port_run(jax_model):
    state, step = port_state(jax_model[1])
    batch = torch_batch(batch_np())
    history = [{k: float(v) for k, v in step(state, batch).items()} for _ in range(2)]
    return state, history


@pytest.mark.parametrize("i", [0, 1])
def test_step_metrics_match_jax(jax_run, port_run, i):
    jm, tm = jax_run[0][i], port_run[1][i]
    assert tm["skipped"] == jm["skipped"] == 0.0
    for k in ("loss", "grad_norm"):
        assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, tm[k], jm[k])


def test_first_step_gradients_match_jax(jax_model):
    jmodel, params = jax_model
    b = batch_np()
    jb = jax_batch(b)

    def loss_fn(p):
        pred = jmodel.apply({"params": p}, {d: jb[d] for d in DOMAINS}, train=True)["semseg"]
        return jcli.seg_cross_entropy(pred.astype(jnp.float32), jb["target"])

    jgrads = jax_params_to_state_dict(numpy_tree(jax.jit(jax.grad(loss_fn))(params)),
                                      PROJ_SHAPES)
    state, step = port_state(params)
    step(state, torch_batch(b))
    named = dict(state.model.named_parameters())
    assert set(jgrads) == set(named)
    for k, v in jgrads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), v, rtol=0,
                                   atol=2e-5 * np.abs(v).max(), err_msg=k)


def test_updated_params_match_jax(jax_model, jax_run, port_run):
    init = jax_params_to_state_dict(jax_model[1], PROJ_SHAPES)
    ref = jax_params_to_state_dict(jax_run[1], PROJ_SHAPES)
    state = port_run[0]
    got = {k: v.detach().numpy() for k, v in state.model.state_dict().items()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.endswith("pos_emb"):  # frozen on both sides
            np.testing.assert_array_equal(got[k], init[k], err_msg=k)
            np.testing.assert_array_equal(v, init[k], err_msg=k)
            continue
        d = np.abs(got[k] - v)
        if k.endswith("attn.qkv.bias"):  # the key part's exact gradient is 0
            d = np.delete(d, np.arange(v.shape[0])[v.shape[0] // 3:2 * v.shape[0] // 3])
        assert d.max() <= 2.5e-3, (k, d.max())
        assert np.median(d) <= 2e-6, (k, np.median(d))
        assert np.sum(d > 2e-6) <= max(2, d.size // 200), (k, np.sum(d > 2e-6), d.size)
    assert (state.step, state.updates) == (2, 2)


def test_converter_matches_jax_exporter(jax_model):
    params = jax_model[1]
    ref = params_to_state_dict(params, head_type="semseg", proj_shapes=PROJ_SHAPES)
    got = jax_params_to_state_dict(params, PROJ_SHAPES)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["output_adapters.semseg.blocks.1.dwconv.weight"].shape == (16, 1, 7, 7)
    assert got["output_adapters.semseg.final_layer.weight"].shape == (CLASSES, 16, 1, 1)


def test_layer_decay_groups_match_jax(jax_model):
    params = jax_model[1]
    lr_scales, wd_flags, jgroups = build_param_labels(
        params, layer_decay_assigner=JLDVA(LAYER_VALUES), filter_bias_and_bn=True)
    expect_groups = {g: sorted(flax_path_to_torch_key(tuple(n.split("."))) for n in names)
                     for g, names in jgroups.items() if g != "frozen"}
    expect = {}
    for (path, lr), wd in zip(jax.tree_util.tree_leaves_with_path(lr_scales),
                              jax.tree.leaves(wd_flags)):
        expect[flax_path_to_torch_key(tuple(p.key for p in path))] = (float(lr), float(wd))
    groups, frozen = build_param_groups(port_model(params), filter_bias_and_bn=True,
                                        layer_decay_assigner=LayerDecayValueAssigner(LAYER_VALUES))
    assert {g["group"]: sorted(g["names"]) for g in groups} == expect_groups
    assert sorted(frozen) == sorted(flax_path_to_torch_key(tuple(n.split(".")))
                                    for n in jgroups["frozen"])
    for g in groups:
        for n in g["names"]:
            assert (g["lr_scale"], g["wd_flag"]) == pytest.approx(expect[n]), n
    scales = {g["group"]: g["lr_scale"] for g in groups}
    assert scales["layer_0_no_decay"] == pytest.approx(0.75 ** 3)  # adapters, tokens
    assert scales["layer_3_decay"] == 1.0                         # the head


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_drop_path_keep_rate_and_scale(rate):
    x = torch.ones(20000, 3, 2)
    gen = torch.Generator().manual_seed(0)
    out = drop_path(x, rate, True, gen)
    kept = out[:, 0, 0] != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.015
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / (1 - rate)))
    assert torch.equal(out[~kept], torch.zeros_like(out[~kept]))
    assert (out == out[:, :1, :1]).all(), "one draw per sample"
    again = drop_path(x, rate, True, torch.Generator().manual_seed(0))
    assert torch.equal(out, again), "the draws come from the generator alone"
    assert drop_path(x, rate, False, None) is x and drop_path(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="Generator"):
        drop_path(x, rate, True, None)


def test_confusion_matrix_and_miou_match_jax():
    rng = np.random.default_rng(7)
    pred = rng.integers(0, 6, (3, 40, 50))
    label = rng.integers(0, 5, (3, 40, 50))  # classes 5-7 absent from the labels
    label[rng.random(label.shape) < 0.1] = 255
    cm = metrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), 8)
    jcm = np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(label), 8))
    np.testing.assert_array_equal(cm.numpy(), jcm)
    assert int(cm.sum()) == int((label != 255).sum())
    got, ref = metrics.miou_from_confusion(cm), jmetrics.miou_from_confusion(jcm)
    for k in ("aAcc", "mIoU", "mAcc"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12), k
    np.testing.assert_array_equal(got["IoU"], ref["IoU"])  # NaN where absent
    assert np.isnan(got["IoU"][6:]).all()


def test_input_adapter_builds_the_512_px_grid():
    adapter = PatchedInputAdapter(num_channels=3, stride_level=1, patch_size_full=16,
                                  dim_tokens=64, image_size=512)
    jad = JPatched(num_channels=3, stride_level=1, patch_size_full=16, dim_tokens=64,
                   image_size=512)
    jparams = jad.init(jax.random.PRNGKey(0), jnp.zeros((1, 512, 512, 3)))["params"]
    assert tuple(adapter.pos_emb.shape) == (1, 64, 32, 32)
    np.testing.assert_allclose(adapter.pos_emb.numpy(),
                               np.asarray(jparams["pos_emb"]).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-6)


def test_trainer_recipe_matches_the_yaml():
    args = jcli.get_args(["-c", YAML])
    r = factory.SEMSEG_RECIPE
    assert r["model"] == args.model
    assert "-".join(r["in_domains"]) == args.in_domains
    assert "-".join(r["decoder_main_tasks"]) == args.decoder_main_tasks
    for key in ("input_size", "patch_size", "num_classes", "drop_path_encoder",
                "output_adapter", "decoder_dim", "decoder_depth", "decoder_preds_per_patch",
                "epochs", "lr", "min_lr", "weight_decay", "layer_decay", "clip_grad", "fp16"):
        assert r[key] == getattr(args, key), key
    assert tuple(r["opt_betas"]) == tuple(args.opt_betas)
    assert not args.seg_use_void_label and args.opt == "adamw"


def test_tiny_trainer_steps_and_its_batch():
    b = factory.make_synthetic_semseg_batch(2, input_size=64, num_classes=40, seed=3,
                                            device="cpu")
    t = b["target"]
    assert t.dtype == torch.int64 and set(t.unique().tolist()) <= set(range(40)) | {255}
    assert 0.03 < float((t == 255).float().mean()) < 0.07
    assert abs(float(b["depth"].mean())) < 0.1
    state, step = factory.build_semseg_trainer(
        batch_size=2, model="multivit_tiny", input_size=64, decoder_dim=256, decoder_depth=2,
        fp16=False, device="cpu")
    assert state.model.encoder[-1].drop_path_rate == pytest.approx(0.1)
    gen = torch.Generator().manual_seed(0)
    history = [step(state, b, generator=gen) for _ in range(3)]
    assert all(h["skipped"] == 0.0 and np.isfinite(float(h["loss"])) for h in history)
    assert float(history[-1]["loss"]) < float(history[0]["loss"])
    lrs = {g["group"]: g["lr"] for g in state.optimizer.param_groups}
    assert lrs["layer_0_decay"] == pytest.approx(lrs["layer_3_decay"] * 0.75 ** 3)


REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(REPO))
                    for p in (REPO / "multimae_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax(path):
    """The port and chip_smoke.py import neither JAX nor the JAX package,
    nor PIL, cv2, PyYAML, grain, orbax, tensorstore, zarr, zstandard, h5py,
    msgpack, ml_dtypes or a TIFF library (tifffile, libtiff, imageio), at
    any depth of the file (function-level imports included). wandb stays
    allowed, imported lazily where asked for."""
    tree = ast.parse((REPO / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module and n.level == 0]
    bad = {n for n in names if n.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                                   "multimae_tpu", "PIL", "cv2", "yaml",
                                                   "grain", "orbax", "tensorstore", "zarr",
                                                   "zstandard", "h5py", "msgpack",
                                                   "ml_dtypes", "tifffile", "libtiff",
                                                   "imageio")}
    assert not bad, bad
