"""The port's DPT head and the all-layers encoder against the JAX package
(multimae_tpu_torch/models/conv_utils.py, models/output_adapters.py
`DPTOutputAdapter`, models/multimae.py, utils/convert.py), fp32 on the
CPU at tiny sizes, from the JAX modules' parameters carried across by the
port's converter and loaded with strict=True:

* ResidualConvUnit and FeatureFusionBlock (with and without a residual),
  with and without BatchNorm, in eval and in training (flax's batch
  statistics, E[x^2] - E[x]^2, and its running averages with momentum
  0.99): outputs within 5e-4 of the largest |output|, running statistics
  within 1e-6;
* the tiny MultiViT with the DPT regression and semseg heads, BatchNorm on
  and off: preds within 5e-4; with BatchNorm, the training forward of the
  regression head and the updated running statistics too;
* the converter: the JAX parameter tree has no refinenet4.resConfUnit1
  (flax creates a submodule's parameters at its first call), so neither
  does the port, and the transposed convs' kernels are a pure axis
  permutation of flax's;
* a reference-layout DPT .pth (its aliased scratch.layer_rn and
  act_postprocess keys and the never-called refinenet4.resConfUnit1
  included) starts the port as it starts the JAX model: the same missing,
  unexpected and ignored keys, the same preds within 5e-4;
* MultiViT's `return_all_layers` (every block's tokens) and MultiMAE's
  `encode_only` (tokens, masks, ids_keep, ids_restore, input_info) equal
  what the JAX models return;
* `dpt_hooks`: the reference's (2, 5, 8, 11) from 12 blocks on.
"""

import functools

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.models import DPTOutputAdapter as JDPT
from multimae_tpu.models import PatchedInputAdapter as JPatched
from multimae_tpu.models.conv_utils import FeatureFusionBlock as JFFB
from multimae_tpu.models.conv_utils import ResidualConvUnit as JRCU
from multimae_tpu.models.registry import create_model as jcreate
from multimae_tpu_torch.models import DPTOutputAdapter, PatchedInputAdapter
from multimae_tpu_torch.models.conv_utils import FeatureFusionBlock, ResidualConvUnit
from multimae_tpu_torch.models.output_adapters import DPT_HOOKS, dpt_hooks
from multimae_tpu_torch.models.registry import create_model
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict

S = 64
PROJ = {"rgb": (3, 16, 16), "depth": (1, 16, 16)}
DPT_KW = dict(main_tasks=("rgb",), hooks=(0, 1, 0, 1), layer_dims=(16, 24, 32, 40),
              feature_dim=32)


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


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def load(module, params, batch_stats=None, head_type="regression"):
    sd = jax_params_to_state_dict(params, PROJ, head_type=head_type, batch_stats=batch_stats)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           strict=True)
    return module


def close(got, ref, rel=5e-4):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


def stats_tree(module):
    return {n: b.detach().numpy() for n, b in module.named_buffers()
            if n.endswith(("running_mean", "running_var"))}


# ------------------------------------------------------------ conv units --

@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
@pytest.mark.parametrize("unit", ["rcu", "ffb", "ffb_top"])
def test_conv_units_match_jax(unit, use_bn, train):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    res = rng.standard_normal((2, 6, 8, 16)).astype(np.float32)
    args = (jnp.asarray(x),) if unit != "ffb" else (jnp.asarray(x), jnp.asarray(res))
    jmod = JRCU(16, use_bn=use_bn) if unit == "rcu" else JFFB(16, use_bn=use_bn)
    variables = numpy_tree(jmod.init(jax.random.PRNGKey(1), *args))
    if use_bn:  # running statistics away from their (0, 1) start
        variables["batch_stats"] = jax.tree.map(
            lambda v: (v + rng.uniform(0.1, 0.5, v.shape)).astype(np.float32),
            variables["batch_stats"])
    if train and use_bn:
        ref, updated = jmod.apply(variables, *args, train=True, mutable=["batch_stats"])
    else:
        ref, updated = jmod.apply(variables, *args, train=train), None
    port = (ResidualConvUnit(16, use_bn) if unit == "rcu"
            else FeatureFusionBlock(16, use_bn, with_residual=unit == "ffb"))
    load(port, variables["params"], variables.get("batch_stats"))
    port.train(train)
    with torch.no_grad():
        got = port(*[torch.from_numpy(a) for a in ([x] if unit != "ffb" else [x, res])])
    close(got.numpy(), np.asarray(ref))
    if updated is not None:
        want = jax_params_to_state_dict({}, batch_stats=numpy_tree(updated["batch_stats"]))
        for k, v in stats_tree(port).items():
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=k)


# ------------------------------------------------------------- the heads --

def dpt_models(head_type, use_bn, in_domains=("rgb",)):
    kw = dict(DPT_KW, num_classes=3 if head_type == "regression" else 5, use_bn=use_bn,
              head_type=head_type)
    chans = {"rgb": 3, "depth": 1}
    jm = jcreate("multivit_tiny", input_adapters={
        d: functools.partial(JPatched, num_channels=chans[d], stride_level=1,
                             patch_size_full=16, image_size=S) for d in in_domains},
        output_adapters={"out": functools.partial(JDPT, **kw)})
    tm = create_model("multivit_tiny", input_adapters={
        d: functools.partial(PatchedInputAdapter, num_channels=chans[d], stride_level=1,
                             patch_size_full=16, image_size=S) for d in in_domains},
        output_adapters={"out": functools.partial(DPTOutputAdapter, **kw)})
    return jm, tm


def inputs(in_domains=("rgb",), seed=0):
    rng = np.random.default_rng(seed)
    return {d: rng.standard_normal((2, S, S, {"rgb": 3, "depth": 1}[d])).astype(np.float32)
            for d in in_domains}


@pytest.mark.parametrize("use_bn", [False, True], ids=["plain", "bn"])
@pytest.mark.parametrize("head_type", ["regression", "semseg"])
def test_dpt_heads_match_jax(head_type, use_bn):
    jm, tm = dpt_models(head_type, use_bn)
    x = inputs()
    variables = numpy_tree(jm.init({"params": jax.random.PRNGKey(0)},
                                   {k: jnp.asarray(v) for k, v in x.items()}))
    ref = np.asarray(jm.apply(variables, {k: jnp.asarray(v) for k, v in x.items()},
                              train=False)["out"])
    load(tm, variables["params"], variables.get("batch_stats"), head_type).eval()
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in x.items()})["out"].numpy()
    assert got.shape == ref.shape == (2, S, S, 3 if head_type == "regression" else 5)
    close(got, ref)


def test_dpt_training_forward_with_batchnorm_matches_jax():
    jm, tm = dpt_models("regression", True)
    x = {k: jnp.asarray(v) for k, v in inputs(seed=3).items()}
    variables = numpy_tree(jm.init({"params": jax.random.PRNGKey(2)}, x))
    ref, updated = jm.apply(variables, x, train=True, mutable=["batch_stats"])
    load(tm, variables["params"], variables["batch_stats"]).train()
    with torch.no_grad():
        got = tm({k: torch.from_numpy(np.array(v)) for k, v in x.items()})["out"].numpy()
    close(got, np.asarray(ref["out"]))
    want = jax_params_to_state_dict({}, batch_stats=numpy_tree(updated["batch_stats"]))
    stats = stats_tree(tm)
    assert set(stats) == {k for k in want if not k.endswith("num_batches_tracked")}
    for k, v in stats.items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=k)


def test_converter_keys_and_deconv_layout():
    jm, tm = dpt_models("regression", False)
    x = {k: jnp.asarray(v) for k, v in inputs().items()}
    params = numpy_tree(jm.init({"params": jax.random.PRNGKey(0)}, x)["params"])
    flat = flax.traverse_util.flatten_dict(params, sep="/")
    assert not any("refinenet4/resConfUnit1" in k for k in flat)
    sd = jax_params_to_state_dict(params, PROJ)
    assert set(sd) == set(tm.state_dict())
    assert not any("refinenet4.resConfUnit1" in k for k in sd)
    for i in (1, 2):
        kernel = flat[f"output_adapters_out/act_{i}_postprocess_deconv/kernel"]  # (kh, kw, O, I)
        np.testing.assert_array_equal(sd[f"output_adapters.out.act_{i}_postprocess.1.weight"],
                                      kernel.transpose(3, 2, 0, 1))


def test_dpt_head_refuses_a_single_layer_and_too_few_layers():
    _, tm = dpt_models("regression", False)
    head = tm.output_adapters["out"]
    info = {"image_size": (S, S), "tasks": {"rgb": {"start_idx": 0, "end_idx": 16}}}
    with pytest.raises(TypeError, match="every encoder layer"):
        head(torch.zeros(2, 17, 64), info)
    head.hooks = (0, 1, 2, 3)
    with pytest.raises(ValueError, match="need 4 encoder layers"):
        head([torch.zeros(2, 17, 64)] * 2, info)


def test_dpt_hooks():
    assert dpt_hooks(12) == dpt_hooks(24) == DPT_HOOKS == (2, 5, 8, 11)
    assert dpt_hooks(2) == (0, 0, 0, 1) and dpt_hooks(4) == (0, 1, 2, 3)


# ------------------------------------------------- the all-layers encoder --

def test_return_all_layers_matches_jax():
    domains = ("rgb", "depth")
    jm = jcreate("multivit_tiny", input_adapters={
        d: functools.partial(JPatched, num_channels=c, stride_level=1, patch_size_full=16,
                             image_size=S) for d, c in (("rgb", 3), ("depth", 1))},
        output_adapters=None)
    tm = create_model("multivit_tiny", input_adapters={
        d: functools.partial(PatchedInputAdapter, num_channels=c, stride_level=1,
                             patch_size_full=16, image_size=S) for d, c in (("rgb", 3), ("depth", 1))},
        output_adapters=None)
    x = inputs(domains)
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    params = numpy_tree(jm.init({"params": jax.random.PRNGKey(4)}, jx)["params"])
    load(tm, params)
    tm.eval()
    ref = jm.apply({"params": params}, jx, return_all_layers=True)
    with torch.no_grad():
        tx = {k: torch.from_numpy(v) for k, v in x.items()}
        got = tm(tx, return_all_layers=True)
        last = tm(tx)
    assert isinstance(got, list) and len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert tuple(g.shape) == (2, 33, 64)
        close(g.numpy(), np.asarray(r))
    assert torch.equal(last, got[-1])


def test_encode_only_matches_jax():
    from multimae_tpu.models import SpatialOutputAdapter as JSpatial
    from multimae_tpu_torch.models import SpatialOutputAdapter

    def adapters(patched, spatial):
        ins = {"rgb": functools.partial(patched, num_channels=3, stride_level=1,
                                        patch_size_full=16, image_size=S)}
        outs = {"rgb": functools.partial(spatial, num_channels=3, stride_level=1,
                                         patch_size_full=16, image_size=S, dim_tokens=32,
                                         depth=1, num_heads=2, task="rgb",
                                         context_tasks=("rgb",))}
        return ins, outs

    jins, jouts = adapters(JPatched, JSpatial)
    jm = jcreate("pretrain_multimae_tiny", input_adapters=jins, output_adapters=jouts)
    tins, touts = adapters(PatchedInputAdapter, SpatialOutputAdapter)
    tm = create_model("pretrain_multimae_tiny", input_adapters=tins, output_adapters=touts)
    x = inputs()
    rng = np.random.default_rng(5)
    masks = np.zeros((2, 16), np.int32)
    for b in range(2):
        masks[b, rng.permutation(16)[:10]] = 1  # 6 visible tokens per sample
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    params = numpy_tree(jm.init({"params": jax.random.PRNGKey(6),
                                 "masking": jax.random.PRNGKey(0)}, jx,
                                num_encoded_tokens=6)["params"])
    load(tm, params)
    tm.eval()
    ref = jm.apply({"params": params}, jx, task_masks={"rgb": jnp.asarray(masks)},
                   num_encoded_tokens=6, encode_only=True)
    with torch.no_grad():
        got = tm({k: torch.from_numpy(v) for k, v in x.items()},
                 task_masks={"rgb": torch.from_numpy(masks).long()}, num_encoded_tokens=6,
                 encode_only=True)
    tokens, task_masks, ids_keep, ids_restore, info = got
    assert tuple(tokens.shape) == (2, 7, 64)
    close(tokens.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(task_masks["rgb"].numpy(), np.asarray(ref[1]["rgb"]))
    np.testing.assert_array_equal(ids_keep.numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(ids_restore.numpy(), np.asarray(ref[3]))
    assert info == jax.tree.map(lambda v: v, ref[4])


def test_reference_dpt_pth_loads_as_in_jax(tmp_path):
    """A reference-layout DPT .pth, with the reference model's aliased keys
    (scratch.layer_rn.N, act_postprocess.N) and its never-called
    refinenet4.resConfUnit1: the port's `load_pretrained` and the JAX
    `load_pretrained_torch` report the same missing, unexpected and ignored
    keys, and the two models give the same preds within 5e-4."""
    from multimae_tpu.train.checkpoint import load_pretrained_torch
    from multimae_tpu_torch.utils.torch_compat import load_pretrained

    jm, src = dpt_models("regression", False)
    src.init_weights(torch.Generator().manual_seed(3))
    sd = dict(src.state_dict())
    head = "output_adapters.out."
    for i in range(4):
        for leaf in ("weight",):
            sd[f"{head}scratch.layer_rn.{i}.{leaf}"] = sd[f"{head}scratch.layer{i + 1}_rn.{leaf}"]
        for k in [k for k in sd if k.startswith(f"{head}act_{i + 1}_postprocess.")]:
            sd[k.replace(f"act_{i + 1}_postprocess.", f"act_postprocess.{i}.")] = sd[k]
    for conv in ("conv1", "conv2"):
        for leaf in ("weight", "bias"):
            sd[f"{head}scratch.refinenet4.resConfUnit1.{conv}.{leaf}"] = torch.zeros(32, 32, 3, 3) \
                if leaf == "weight" else torch.zeros(32)
    path = str(tmp_path / "dpt.pth")
    torch.save({"model": sd}, path)

    x = {k: jnp.asarray(v) for k, v in inputs(seed=4).items()}
    template = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)}, x)["params"])()
    jparams, jreport = load_pretrained_torch(path, template)
    _, port = dpt_models("regression", False)
    port.init_weights(torch.Generator().manual_seed(0))
    report = load_pretrained(port, path)
    for k in ("missing", "unexpected", "ignored"):
        assert sorted(report[k]) == sorted(jreport[k]), k
    assert not report["missing"] and not report["unexpected"] and len(report["ignored"]) == 22
    ref = np.asarray(jm.apply({"params": jparams}, x, train=False)["out"])
    port.eval()
    with torch.no_grad():
        got = port({k: torch.from_numpy(np.array(v)) for k, v in x.items()})["out"].numpy()
    close(got, ref)
