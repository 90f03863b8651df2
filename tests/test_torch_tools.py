"""The port's tools (multimae_tpu_torch/tools/) and utilities
(utils/model_utils.py, utils/log_images.py) against the JAX package's
tools/ and utilities.

* Builders: every model the benches and the profiler build, at ViT-B and
  with --large at ViT-L, has the state_dict keys and shapes of the JAX
  tool's model (params_to_state_dict of jax.eval_shape of its init; the
  port's on the meta device: neither side computes).
* A tiny step: bench_finetune.build_train_step at tiny width (dim 64, 2
  blocks, fp32, drop_path 0) from the port's initial weights, which the
  JAX package's state_dict_to_params hands the JAX model: the first loss
  and grad norm within 1e-4 relative of the JAX make_dense_train_step /
  make_cls_train_step built as the JAX tool builds it.
* The converters equal the JAX tools' numpy functions and round-trip; the
  model utilities equal the JAX ones on the same model; log_images hands
  wandb.Image the JAX module's arrays (a stub wandb in sys.modules).
* profile_step's by-module table on a CPU profile, the tools' flags,
  defaults and JSON line names, and a tiny run of each bench's main.
"""

import argparse
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.bench_finetune as jbf
from multimae_tpu.cli.factory import build_pretrain_model as jax_build_pretrain_model
from multimae_tpu.models import ConvNeXtAdapter as JConvNeXt
from multimae_tpu.models import LinearOutputAdapter as JLinear
from multimae_tpu.models import PatchedInputAdapter as JPatched
from multimae_tpu.models.registry import create_model as jax_create_model
from multimae_tpu.utils import log_images as jlog
from multimae_tpu.utils import model_utils as jmu
from multimae_tpu.utils.torch_compat import params_to_state_dict, state_dict_to_params
from multimae_tpu_torch.models.multimae import MultiMAE
from multimae_tpu_torch.ops import attention
from multimae_tpu_torch.tools import bench_finetune as bf
from multimae_tpu_torch.tools import bench_infer as bi
from multimae_tpu_torch.tools import multimae2vit_converter as m2v
from multimae_tpu_torch.tools import profile_step as ps
from multimae_tpu_torch.tools import vit2multimae_converter as v2m
from multimae_tpu_torch.utils import log_images, model_utils
from multimae_tpu_torch.utils.convert import flax_path_to_torch_key, jax_params_to_state_dict
from tools.multimae2vit_converter import multimae_to_vit, multimae_to_vitmultimae
from tools.vit2multimae_converter import vit_to_multimae

PROJ_SHAPES = {"rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)}


def shapes_of(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


def jax_state_shapes(model, inputs, **init_kw):
    """{torch key: shape} of the JAX model's parameters, traced, not computed."""
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "masking": jax.random.PRNGKey(2)}
    abstract = jax.eval_shape(lambda x: model.init(rngs, x, **init_kw)["params"], inputs)
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), abstract)
    return shapes_of(params_to_state_dict(zeros, proj_shapes=PROJ_SHAPES))


def spec(b, s, channels=(("rgb", 3),)):
    return {t: jax.ShapeDtypeStruct((b, s, s, c), jnp.float32) for t, c in channels}


# The JAX bench_infer builds its models inline (tools/bench_infer.py:33-48, :79-96).
def jax_infer_cls(arch):
    return jax_create_model(
        arch, input_adapters={"rgb": lambda **kw: JPatched(
            num_channels=3, stride_level=1, patch_size_full=16, image_size=224, **kw)},
        output_adapters={"cls": lambda **kw: JLinear(num_classes=1000, use_mean_pooling=True,
                                                     **kw)}, dtype=jnp.bfloat16)


def jax_infer_semseg(arch):
    return jax_create_model(
        arch, input_adapters={t: (lambda c: lambda **kw: JPatched(
            num_channels=c, stride_level=1, patch_size_full=16, image_size=512, **kw))(c)
            for t, c in (("rgb", 3), ("depth", 1))},
        output_adapters={"semseg": lambda **kw: JConvNeXt(
            num_classes=150, preds_per_patch=16, depth=4, embed_dim=6144, patch_size=16,
            main_tasks=("rgb",), **kw)}, dtype=jnp.bfloat16)


def ft_args(task, large):
    return bf.get_args(["--task", task, "--device", "cpu"] + (["--large"] if large else []))


def case_infer_cls(large, monkeypatch):
    arch = "multivit_large" if large else "multivit_base"
    with torch.device("meta"):
        port = bi.build_cls(arch)
    return port, jax_state_shapes(jax_infer_cls(arch), spec(2, 224), train=False)


def case_infer_semseg(large, monkeypatch):
    arch = "multivit_large" if large else "multivit_base"
    with torch.device("meta"):
        port = bi.build_semseg(arch)
    return port, jax_state_shapes(jax_infer_semseg(arch),
                                  spec(2, 512, (("rgb", 3), ("depth", 1))), train=False)


def finetune_case(task):
    def case(large, monkeypatch):
        args = ft_args(task, large)
        with torch.device("meta"):
            port = bf.BUILDERS[task](args, torch.bfloat16)
        jbuild = {"semseg": jbf.build, "depth": jbf.build_depth, "cls": jbf.build_cls,
                  "taskonomy": jbf.build_taskonomy}[task]
        channels = (("rgb", 3), ("depth", 1)) if task == "semseg" else (("rgb", 3),)
        return port, jax_state_shapes(jbuild(args, jnp.bfloat16),
                                      spec(2, args.input_size, channels), train=False)
    return case


def case_pretrain(large, monkeypatch):
    """profile_step --mode pretrain: the JAX tool's model (tools/profile_step.py:45-50)."""
    monkeypatch.setattr(MultiMAE, "init_weights", lambda self, generator: self)
    args = ps.get_args(["--mode", "pretrain", "--batch", "2", "--device", "cpu"]
                       + (["--large"] if large else []))
    _, state, _ = ps.build(args, torch.device("meta"))
    jmodel = jax_build_pretrain_model(
        model_name="pretrain_multimae_large" if large else "pretrain_multimae_base",
        dtype=jnp.bfloat16, fp32_output_adapters=("semseg",), decoder_return_patches=True)
    inputs = dict(spec(2, 224, (("rgb", 3), ("depth", 1))),
                  semseg=jax.ShapeDtypeStruct((2, 56, 56), jnp.int32))
    return state.model, jax_state_shapes(jmodel, inputs, num_encoded_tokens=98)


CASES = {"bench_infer cls": case_infer_cls, "bench_infer semseg": case_infer_semseg,
         **{f"bench_finetune {t}": finetune_case(t) for t in ("semseg", "depth", "cls",
                                                              "taskonomy")},
         "profile_step pretrain": case_pretrain}


@pytest.mark.parametrize("large", [False, True], ids=["vitb", "vitl"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_builder_state_dict_matches_the_jax_tool(name, large, monkeypatch):
    port, expected = CASES[name](large, monkeypatch)
    assert shapes_of(port.state_dict()) == expected
    width = 1024 if large else 768
    assert port.global_tokens.shape[-1] == width and len(port.encoder) == (24 if large else 12)


# ------------------------------------------------------------ a tiny step --

TINY_HOOKS = (0, 0, 1, 1)


@pytest.fixture
def tiny(monkeypatch):
    """Both tools' trunks at tiny width, drop_path 0 on both sides."""
    trunk = lambda args: ("multivit_tiny", 2, TINY_HOOKS)  # noqa: E731
    monkeypatch.setattr(jbf, "_trunk", trunk)
    monkeypatch.setattr(bf, "_trunk", trunk)
    import multimae_tpu.models.registry as jreg

    jcreate = jreg.create_model
    monkeypatch.setattr(jreg, "create_model",
                        lambda name, **kw: jcreate(name, **dict(kw, drop_path_rate=0.0)))
    pcreate = bf.create_model
    monkeypatch.setattr(bf, "create_model",
                        lambda name, **kw: pcreate(name, **dict(kw, drop_path_rate=0.0)))


def jax_params_of(port, jmodel, inputs, **init_kw):
    """The JAX model's parameters holding the port model's weights, through
    the JAX package's importer (state_dict_to_params) into a template that
    jax.eval_shape traces: nothing compiles, unlike a jitted init."""
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "masking": jax.random.PRNGKey(2)}
    abstract = jax.eval_shape(lambda: jmodel.init(rngs, inputs, **init_kw)["params"])
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), abstract)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    params, _ = state_dict_to_params(sd, template, strict=True, verbose=False)
    return jax.tree.map(np.array, params)


def jax_first_step(args, params, batch):
    """The JAX tool's build_train_step (tools/bench_finetune.py:163-241) on
    the given parameters and batch, fp32, one device: (loss, grad norm)."""
    from multimae_tpu.cli.run_finetuning_semseg import seg_cross_entropy
    from multimae_tpu.train.cross_entropy import soft_target_cross_entropy
    from multimae_tpu.train.finetune_step import make_cls_train_step, make_dense_train_step
    from multimae_tpu.train.optim_factory import LayerDecayValueAssigner, create_optimizer
    from multimae_tpu.train.regression_losses import masked_berhu_loss, masked_l1_loss
    from multimae_tpu.train.schedules import as_optax_schedule, cosine_scheduler
    from multimae_tpu.train.train_state import TrainState

    model = {"semseg": jbf.build, "depth": jbf.build_depth, "cls": jbf.build_cls,
             "taskonomy": jbf.build_taskonomy}[args.task](args, jnp.float32)
    lr = as_optax_schedule(cosine_scheduler(1e-4, 0.0, epochs=64, niter_per_ep=100,
                                            warmup_epochs=1))
    assigner = None
    if args.task == "cls":
        depth = jbf._trunk(args)[1]
        assigner = LayerDecayValueAssigner([0.65 ** (depth + 1 - i) for i in range(depth + 2)])
    tx = create_optimizer(params, opt="adamw", lr_schedule=lr, weight_decay=0.05,
                          opt_betas=(0.9, 0.999), filter_bias_and_bn=True,
                          layer_decay_assigner=assigner)
    state = TrainState.create(params=params, tx=tx)
    if args.task == "cls":
        step = make_cls_train_step(model, soft_target_cross_entropy)
    else:
        task, loss, domains = {
            "taskonomy": ("normal", masked_l1_loss, ("rgb",)),
            "depth": ("depth", lambda p, t, **kw: masked_berhu_loss(p, t), ("rgb",)),
            "semseg": ("semseg", seg_cross_entropy, ("rgb", "depth"))}[args.task]
        step = make_dense_train_step(model, task, loss, in_domains=domains,
                                     needs_target_kwargs=(args.task == "taskonomy"))
    _, metrics = jax.jit(step)(state, batch, jax.random.PRNGKey(2))
    return float(metrics["loss"]), float(metrics["grad_norm"])


@pytest.mark.parametrize("task", ["semseg", "depth", "cls", "taskonomy"])
def test_tiny_step_matches_the_jax_tool(tiny, task):
    args = bf.get_args(["--task", task, "--batch", "2", "--input_size", "64", "--num_classes",
                        "7", "--device", "cpu"])
    if task == "cls":
        args.num_classes = 7
    batch = {k: v.numpy() for k, v in bf.make_batch(args).items()}
    jbatch = {k: jnp.asarray(v.astype(np.int32) if k == "target" and task == "semseg" else v)
              for k, v in batch.items()}
    jmodel = {"semseg": jbf.build, "depth": jbf.build_depth, "cls": jbf.build_cls,
              "taskonomy": jbf.build_taskonomy}[task](args, jnp.float32)
    inputs = {k: v[:2] for k, v in jbatch.items() if k not in ("target", "mask_valid")}
    port = bf.BUILDERS[task](args, torch.float32)
    port.init_weights(torch.Generator().manual_seed(0))
    params = jax_params_of(port, jmodel, inputs, train=False)
    step, state, tbatch = bf.build_train_step(args, "cpu", model=port)
    metrics = step(state, tbatch, generator=torch.Generator().manual_seed(0))
    loss, norm = jax_first_step(args, params, jbatch)
    assert float(metrics["loss"]) == pytest.approx(loss, rel=1e-4)
    assert float(metrics["grad_norm"]) == pytest.approx(norm, rel=1e-4)


# ------------------------------------------------------------ converters --


def fake_vit(depth=2, dim=32, grid=4):
    rng = np.random.default_rng(0)
    sd = {"cls_token": rng.standard_normal((1, 1, dim)).astype(np.float32),
          "pos_embed": rng.standard_normal((1, grid * grid + 1, dim)).astype(np.float32),
          "patch_embed.proj.weight": rng.standard_normal((dim, 3, 16, 16)).astype(np.float32),
          "patch_embed.proj.bias": rng.standard_normal((dim,)).astype(np.float32),
          "norm.weight": rng.standard_normal((dim,)).astype(np.float32)}
    for i in range(depth):
        sd[f"blocks.{i}.attn.qkv.weight"] = rng.standard_normal((3 * dim, dim)).astype(
            np.float32)
    return sd


def assert_same(port, ref):
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), ref[k], err_msg=k)


def torch_sd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def test_converters_equal_the_jax_tools():
    vit = fake_vit()
    mm = v2m.vit_to_multimae(torch_sd(vit))
    assert_same(mm, vit_to_multimae(vit))
    mm_np = {k: v.numpy() for k, v in mm.items()}
    assert_same(m2v.multimae_to_vit(mm), multimae_to_vit(mm_np))
    assert_same(m2v.multimae_to_vitmultimae(mm), multimae_to_vitmultimae(mm_np))


def test_converter_clis_round_trip(tmp_path):
    """vit -> multimae -> vit -> multimae through the files: the second
    MultiMAE state equals the first (the cls pos-emb row went into the
    global token)."""
    paths = [str(tmp_path / f"{i}.pth") for i in range(4)]
    torch.save({"model": torch_sd(fake_vit())}, paths[0])
    v2m.main(["--vit_ckpt_path", paths[0], "--multimae_ckpt_path", paths[1]])
    m2v.main(["--multimae_ckpt_path", paths[1], "--vit_ckpt_path", paths[2]])
    v2m.main(["--vit_ckpt_path", paths[2], "--multimae_ckpt_path", paths[3]])
    first, again = (torch.load(p, weights_only=True)["model"] for p in (paths[1], paths[3]))
    assert sorted(first) == sorted(again)
    for k in first:
        torch.testing.assert_close(again[k], first[k], rtol=0, atol=0)
    back = torch.load(paths[2], weights_only=True)["model"]
    assert float(back["pos_embed"][:, 0].abs().max()) == 0.0


# -------------------------------------------------------- model utilities --


@pytest.fixture(scope="module")
def tiny_multivit():
    """The tiny MultiViT with the cls head in both packages, same weights."""
    jmodel = jax_create_model(
        "multivit_tiny", input_adapters={"rgb": lambda **kw: JPatched(
            num_channels=3, stride_level=1, patch_size_full=16, image_size=32, **kw)},
        output_adapters={"cls": lambda **kw: JLinear(num_classes=5, **kw)})
    x = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    params = jax.tree.map(np.array, jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, {"rgb": jnp.asarray(x)}, train=False)["params"])())
    port = bi.create_model(
        "multivit_tiny", input_adapters={"rgb": lambda **kw: bi.PatchedInputAdapter(
            num_channels=3, stride_level=1, patch_size_full=16, image_size=32, **kw)},
        output_adapters={"cls": lambda **kw: bi.LinearOutputAdapter(num_classes=5, **kw)})
    sd = jax_params_to_state_dict(params, PROJ_SHAPES)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jmodel, params, port.eval(), x


def jax_names(names):
    return {flax_path_to_torch_key(tuple(n.split("."))) for n in names}


@pytest.mark.parametrize("prefixes", [(["encoder"], ["encoder"]),
                                      (["input_adapters_rgb", "global"],
                                       ["input_adapters.rgb", "global"]),
                                      (["encoder_1", "output"], ["encoder.1", "output"])])
def test_match_submodules_and_counts_match_jax(tiny_multivit, prefixes):
    _, params, port, _ = tiny_multivit
    jpre, ppre = prefixes
    assert model_utils.match_submodules(port, ppre) == jax_names(
        jmu.match_submodules(params, jpre))
    assert model_utils.count_parameters(port, ppre) == jmu.count_parameters(params, jpre)


def test_freeze_predicate_matches_jax(tiny_multivit):
    _, params, port, _ = tiny_multivit
    import flax

    jfrozen = jmu.freeze_predicate(["encoder_0"])
    pfrozen = model_utils.freeze_predicate(["encoder.0"])
    flat = flax.traverse_util.flatten_dict(params)
    for learnable in (False, True):
        expect = {flax_path_to_torch_key(p) for p, v in flat.items()
                  if jfrozen(p, v, learnable_pos_emb=learnable)}
        got = {n for n, p in port.named_parameters() if pfrozen(n, p, learnable)}
        assert got == expect and got


@pytest.mark.parametrize("shape", [(2, 7, 5), (3, 4, 4, 6)])
def test_channel_statistics_match_jax(shape):
    a = np.random.default_rng(1).standard_normal(shape).astype(np.float32) + 0.3
    t = torch.from_numpy(a)
    assert model_utils.avg_sq_ch_mean(t) == pytest.approx(jmu.avg_sq_ch_mean(jnp.asarray(a)),
                                                          rel=1e-5)
    assert model_utils.avg_ch_var(t) == pytest.approx(jmu.avg_ch_var(jnp.asarray(a)), rel=1e-5)


def test_spp_stats_match_jax(tiny_multivit):
    jmodel, params, port, x = tiny_multivit
    fns = [jmu.avg_sq_ch_mean, jmu.avg_ch_var]
    ref = jmu.extract_spp_stats(jmodel, {"params": params}, {"rgb": jnp.asarray(x)},
                                ["encoder_?", "encoder_?"], fns, train=False)
    got = model_utils.extract_spp_stats(port, {"rgb": torch.from_numpy(x)},
                                        ["encoder.?", "encoder.?"],
                                        [model_utils.avg_sq_ch_mean, model_utils.avg_ch_var])
    for name in ("avg_sq_ch_mean", "avg_ch_var"):
        assert [n.replace(".", "_") for n, _ in got[name]] == [n for n, _ in ref[name]]
        np.testing.assert_allclose([v for _, v in got[name]], [v for _, v in ref[name]],
                                   rtol=1e-4)
    with pytest.raises(ValueError, match="lengths"):
        model_utils.extract_spp_stats(port, {"rgb": torch.from_numpy(x)}, ["a"], [])


# ------------------------------------------------------------- log_images --


@pytest.fixture
def stub_wandb(monkeypatch):
    calls = []
    mod = types.ModuleType("wandb")
    mod.Image = lambda data, **kw: ("Image", np.array(data), kw)
    mod.log = lambda panels, step=None: calls.append((panels, step))
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return calls


def assert_panels_equal(got, ref):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert_panels_equal(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert_panels_equal(g, r)
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def test_log_images_hand_wandb_the_jax_arrays(stub_wandb):
    rng = np.random.default_rng(4)
    rgb = rng.standard_normal((10, 8, 8, 3)).astype(np.float32)
    pred = rng.integers(0, 5, (10, 8, 8))
    gt = rng.integers(0, 6, (10, 8, 8))
    gt[0, :2] = 255
    jlog.log_semseg_wandb(rgb, pred, gt, class_names=["a", "b"], prefix="v/", step=3)
    log_images.log_semseg_wandb(torch.from_numpy(rgb), torch.from_numpy(pred),
                                torch.from_numpy(gt), class_names=["a", "b"], prefix="v/",
                                step=3)
    inputs = {"rgb": rgb[:5], "depth": rng.standard_normal((5, 8, 8, 1)).astype(np.float32)}
    preds = {"depth": rng.standard_normal((5, 8, 8, 1)).astype(np.float32),
             "normal": rng.standard_normal((5, 8, 8, 3)).astype(np.float32)}
    gts = {"depth": rng.standard_normal((5, 8, 8)).astype(np.float32)}
    jlog.log_taskonomy_wandb(inputs, preds, gts, prefix="t/", step=4)
    log_images.log_taskonomy_wandb(inputs, {k: torch.from_numpy(v) for k, v in preds.items()},
                                   gts, prefix="t/", step=4)
    assert len(stub_wandb) == 4
    assert_panels_equal(stub_wandb[1], stub_wandb[0])
    assert_panels_equal(stub_wandb[3], stub_wandb[2])
    np.testing.assert_array_equal(log_images.inv_norm(rgb[0]), jlog.inv_norm(rgb[0]))


def test_log_images_skip_without_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises ImportError
    assert log_images.log_semseg_wandb(np.zeros((1, 2, 2, 3)), np.zeros((1, 2, 2), int),
                                       np.zeros((1, 2, 2), int)) is None


# ------------------------------------------------ the profiler and the CLIs --


def test_profile_step_charges_cpu_time_to_modules(tiny):
    args = argparse.Namespace(task="semseg", batch=2, input_size=64, num_classes=7, steps=0,
                              large=False)
    step, state, batch = bf.build_train_step(args, "cpu")
    prof, ms = ps.profile_steps(step, state, batch, 2, 1, torch.device("cpu"))
    out = ps.report(prof, 2, ms, 2, torch.device("cpu"), 10)
    table = out["by_module"]
    for part in ("encoder", "encoder (backward)", "input_adapters.rgb",
                 "input_adapters.depth", "output_adapters.semseg",
                 "output_adapters.semseg (backward)", "optimizer"):
        assert table.get(part, 0.0) > 0.0, (part, table)
    assert out["by_kernel"] == {}
    # the hooks are gone after the window
    assert all(not m._forward_hooks and not m._forward_pre_hooks
               for _, m in ps.model_parts(state.model))


@pytest.mark.parametrize("task,batch,large_batch,size", [("semseg", 16, 4, 512),
                                                         ("depth", 32, 16, 256),
                                                         ("cls", 128, 64, 224),
                                                         ("taskonomy", 32, 16, 384)])
def test_bench_finetune_defaults_and_names(task, batch, large_batch, size):
    args = bf.get_args(["--task", task])
    assert (args.batch, args.input_size, args.device, args.steps) == (batch, size, "cuda", 10)
    assert bf.get_args(["--task", task, "--large"]).batch == large_batch
    assert bf.metric_name(args, "throughput_kernels") == (
        f"finetune_{task}_{size}px_throughput_kernels")
    assert bf.metric_name(bf.get_args(["--task", task, "--large"]), "kernel_speedup") == (
        f"finetune_{task}_{size}px_large_kernel_speedup")


@pytest.mark.parametrize("mode,large,batch", [("pretrain", False, 128), ("pretrain", True, 64),
                                              ("finetune512", False, 16), ("cls", False, 128),
                                              ("depth256", False, 32),
                                              ("taskonomy384", False, 32)])
def test_profile_step_defaults(mode, large, batch):
    args = ps.get_args(["--mode", mode] + (["--large"] if large else []))
    assert (args.batch, args.steps, args.warmup, args.device) == (batch, 5, 3, "cuda")


def test_module_engine_restores_the_gate():
    floor = attention.SHORT_KERNEL_MIN_KV
    with pytest.raises(RuntimeError):
        with bf.module_engine():
            assert attention.SHORT_KERNEL_MIN_KV > 10 ** 8
            raise RuntimeError
    assert attention.SHORT_KERNEL_MIN_KV == floor


def test_bench_finetune_main_prints_its_lines(tiny, capsys):
    rates = bf.main(["--task", "semseg", "--batch", "1", "--input_size", "64", "--steps", "1",
                     "--num_classes", "7", "--device", "cpu"], warmup=0)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [d["metric"] for d in lines] == [
        "finetune_semseg_64px_throughput_kernels", "finetune_semseg_64px_throughput_module",
        "finetune_semseg_64px_kernel_speedup"]
    assert lines[0]["unit"] == "samples/sec/chip" and lines[0]["batch"] == 1
    assert set(rates) == {"kernels", "module"} and all(r["value"] > 0 for r in rates.values())


def test_bench_finetune_ratio_compares_one_batch(monkeypatch, capsys):
    """Where the module leg ran out of memory at the default batch, the
    kernels leg runs again at the batch the module leg ran, and the ratio
    line names both legs' batches."""
    calls = []

    def measure(args, label, device, warmup):
        calls.append((label, args.batch))
        batch = args.batch // 2 if label == "module" and args.batch > 8 else args.batch
        return {"metric": bf.metric_name(args, f"throughput_{label}"),
                "value": float(batch * (3 if label == "kernels" else 1)), "batch": batch}

    monkeypatch.setattr(bf, "measure", measure)
    rates = bf.main(["--task", "semseg", "--device", "cpu"])
    assert calls == [("kernels", 16), ("module", 16), ("kernels", 8)]
    assert rates["kernels"]["batch"] == rates["module"]["batch"] == 8
    ratio = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert ratio == {"metric": "finetune_semseg_512px_kernel_speedup", "value": 3.0,
                     "unit": "x", "batch_kernels": 8, "batch_module": 8}
    assert bf.speedup_line(bf.get_args(["--device", "cpu"]), {"batch": 16, "value": 1.0},
                           {"batch": 8, "value": 1.0}) is None


def test_bench_infer_names_and_tiny_runs(capsys):
    assert json.loads(bi.metric_line("infer_cls224_vitb", 12.345)) == {
        "metric": "infer_cls224_vitb", "value": 12.3, "unit": "images/sec/chip"}
    assert bi.bench_cls(1, steps=1, arch="multivit_tiny", device="cpu") > 0
    assert bi.bench_semseg(1, steps=1, arch="multivit_tiny", device="cpu") > 0


@pytest.mark.parametrize("main", [bi.main, bf.main, ps.main])
def test_tools_default_to_the_card(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main([])
