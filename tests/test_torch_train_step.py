"""The port's pretraining step against the JAX package's.

The tiny MultiMAE (dim 64, 2 blocks; 64 px, 16 tokens per modality, 24
of 48 visible; decoders dim 64, depth 2, return_patches) runs two fp32
steps on each side from the same parameters (JAX export ->
jax_train_params_to_state_dicts -> strict load) with the same fixed
masks, uncertainty balancer, AdamW (betas 0.9/0.95, flat decay group,
balancer LR scale 2), cosine LR and WD schedules and clip. The JAX
decoders run their custom VJP in "ref" mode (`_core_fwd`/`_core_bwd`,
the Pallas kernels' math); its step's bisect `standardize_depth` is
patched to method="sort" here, in the test.

Tolerances: losses, weighted losses and the grad norm within 1e-4
relative; the first step's gradients within 2e-5 of each tensor's
largest |gradient| (measured: 1e-5). The differences are the GELU
(tanh-basis polynomial in the JAX decoder kernel math, erf here), the
LayerNorm variance and summation order. Updated parameters, tensor by
tensor: the frozen pos-embs unchanged; every element within 2.5e-3; the
median within 2e-6 and at most 0.5% of the elements (or two) beyond it
(measured: medians <= 2e-8, at most one element of 64). Adam divides
each gradient element by its own RMS, so where an element's gradient is
as small as the ~1e-7 absolute difference between the two frameworks'
gradients its update can change by up to its bound of about lr = 1e-3
per step. The key part of the attention biases has an exact gradient of
0, so all of it is such noise: it is held to the 2.5e-3 bound alone.

Small cases pin the schedules, the param groups, skip, clip, the
balancer's zero-loss rule, the patch-space losses and standardize_depth.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.cli import factory as jfactory
from multimae_tpu.models.criterion import (
    MaskedCrossEntropyLoss as JCE,
    MaskedL1Loss as JL1,
    MaskedMSELoss as JMSE,
)
from multimae_tpu.ops import fused_decoder_pallas as fdp
from multimae_tpu.train import pretrain_step as jps
from multimae_tpu.train.optim_factory import build_param_labels, create_optimizer as jcreate
from multimae_tpu.train.schedules import as_optax_schedule, cosine_scheduler as jcosine
from multimae_tpu.train.task_balancing import build_balancer as jbuild_balancer
from multimae_tpu.train.train_state import TrainState as JTrainState
from multimae_tpu_torch.cli import factory as tfactory
from multimae_tpu_torch.models import criterion as tcrit
from multimae_tpu_torch.train.optim_factory import build_param_groups, create_optimizer
from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step, standardize_depth
from multimae_tpu_torch.train.schedules import cosine_scheduler
from multimae_tpu_torch.train.task_balancing import build_balancer
from multimae_tpu_torch.train.train_state import TrainState
from multimae_tpu_torch.utils.convert import (
    flax_path_to_torch_key,
    jax_params_to_state_dict,
    jax_train_params_to_state_dicts,
)

PROJ_SHAPES = {"rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)}
TINY = dict(model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
            decoder_num_heads=4, decoder_depth=2, decoder_return_patches=True)
TASKS = ("rgb", "depth", "semseg", "norm_rgb")
B, K = 2, 24
BETAS = (0.9, 0.95)
BAL_LR_SCALE = 2.0
CLIP = 1.0
LR = jcosine(1e-3, 1e-5, epochs=1, niter_per_ep=4)
WD = jcosine(0.04, 0.4, epochs=1, niter_per_ep=4)
LOG_VARS = np.array([0.1, -0.2, 0.3, 0.05], np.float32)


def fixed_masks(batch, tasks=("rgb", "depth", "semseg"), seed=3):
    """K of the 16 * len(tasks) tokens visible per sample."""
    rng = np.random.default_rng(seed)
    masks = np.ones((batch, 16 * len(tasks)), np.int32)
    for i in range(batch):
        masks[i, rng.permutation(masks.shape[1])[:K]] = 0
    return {t: masks[:, 16 * j:16 * (j + 1)] for j, t in enumerate(tasks)}


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def jax_run():
    """Initial params, per-step metrics and final params of two JAX steps."""
    model = jfactory.build_pretrain_model(**TINY)
    batch = jfactory.make_synthetic_batch(B, input_size=64, seed=1)
    mparams = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        batch, num_encoded_tokens=K)["params"])()
    balancer = jbuild_balancer("uncertainty", TASKS)
    params = {"model": mparams, "balancer": {"log_vars": jnp.asarray(LOG_VARS)}}
    tx = jcreate(params, opt="adamw", lr_schedule=as_optax_schedule(LR),
                 wd_schedule=as_optax_schedule(WD), opt_betas=BETAS,
                 filter_bias_and_bn=False, balancer_lr_scale=BAL_LR_SCALE)
    state = JTrainState.create(params=params, tx=tx)
    step = jps.make_pretrain_train_step(
        model, balancer, jfactory.build_pretrain_losses(("rgb", "depth", "semseg")),
        num_encoded_tokens=K, clip_grad=CLIP)
    masks = {t: jnp.asarray(m) for t, m in fixed_masks(B).items()}
    metrics = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, "standardize_depth",
                   functools.partial(jps.standardize_depth, method="sort"))
        fdp.set_force_mode("ref")
        try:
            jstep = jax.jit(step)
            for _ in range(2):
                state, m = jstep(state, batch, jax.random.PRNGKey(0), masks)
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            fdp.set_force_mode(None)
    return numpy_tree(params), metrics, numpy_tree(state.params)


def port_state(params0, **step_kw):
    """The port's model, balancer, TrainState and step from JAX params."""
    model = tfactory.build_pretrain_model(**TINY, pos_emb_grads=True, device="cpu")
    balancer = build_balancer("uncertainty", TASKS)
    sds = jax_train_params_to_state_dicts(params0, PROJ_SHAPES)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sds["model"].items()},
                          strict=True)
    balancer.load_state_dict({k: torch.from_numpy(v) for k, v in sds["balancer"].items()},
                             strict=True)
    opt = create_optimizer(model, balancer, opt_betas=BETAS, filter_bias_and_bn=False,
                           balancer_lr_scale=BAL_LR_SCALE)
    state = TrainState(model, balancer, opt, LR, WD)
    step = make_pretrain_train_step(
        model, balancer, tfactory.build_pretrain_losses(("rgb", "depth", "semseg")),
        num_encoded_tokens=K, **step_kw)
    return state, step


def port_batch():
    return tfactory.make_synthetic_batch(B, input_size=64, seed=1, device="cpu")


def torch_masks():
    return {t: torch.from_numpy(m) for t, m in fixed_masks(B).items()}


@pytest.fixture(scope="module")
def port_run(jax_run):
    params0, _, _ = jax_run
    state, step = port_state(params0, clip_grad=CLIP)
    metrics = [{k: float(v) for k, v in step(state, port_batch(), task_masks=torch_masks()).items()}
               for _ in range(2)]
    return state, metrics


@pytest.mark.parametrize("i", [0, 1])
def test_step_metrics_match_jax(jax_run, port_run, i):
    jm, tm = jax_run[1][i], port_run[1][i]
    keys = {"loss", "grad_norm"} | {f"{t}_loss" for t in TASKS} | {
        f"{t}_loss_weighted" for t in TASKS}
    assert keys <= set(tm) and keys <= set(jm)
    assert tm["skipped"] == jm["skipped"] == 0.0
    for k in keys:
        assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, tm[k], jm[k])


def key_bias_slice(name, n):
    """The key part of an attention in-projection bias of n elements, or
    None. Its exact gradient is 0 (a bias on every key adds the same
    logit to a whole softmax row), so both sides update it from rounding
    noise alone."""
    if name.endswith("attn.qkv.bias"):
        return slice(n // 3, 2 * n // 3)
    if name.endswith("decoder.kv.bias"):
        return slice(0, n // 2)
    return None


def test_updated_params_match_jax(jax_run, port_run):
    params0, _, final = jax_run
    state, _ = port_run
    ref = jax_params_to_state_dict(final["model"], PROJ_SHAPES)
    init = jax_params_to_state_dict(params0["model"], PROJ_SHAPES)
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    assert set(got) == set(ref)
    for k, v in ref.items():
        if k.endswith("pos_emb"):  # frozen on both sides
            np.testing.assert_array_equal(got[k], init[k], err_msg=k)
            np.testing.assert_array_equal(v, init[k], err_msg=k)
            continue
        d = np.abs(got[k] - v)
        assert d.max() <= 2.5e-3, (k, d.max())
        key = key_bias_slice(k, v.shape[0])
        if key is not None:
            d = np.delete(d, np.arange(v.shape[0])[key])
        assert np.median(d) <= 2e-6, (k, np.median(d))
        assert np.sum(d > 2e-6) <= max(2, d.size // 200), (k, np.sum(d > 2e-6), d.size)
    np.testing.assert_allclose(state.balancer.log_vars.detach().numpy(),
                               final["balancer"]["log_vars"], rtol=0, atol=2e-6)
    assert (state.step, state.updates) == (2, 2)


def test_first_step_gradients_match_jax(jax_run):
    """The port step's unclipped gradients (left in .grad) against
    jax.grad of the JAX step's loss on the same parameters and masks."""
    params0 = jax_run[0]
    model = jfactory.build_pretrain_model(**TINY)
    balancer = jbuild_balancer("uncertainty", TASKS)
    batch = jfactory.make_synthetic_batch(B, input_size=64, seed=1)
    masks = {t: jnp.asarray(m) for t, m in fixed_masks(B).items()}
    losses = jfactory.build_pretrain_losses(("rgb", "depth", "semseg"))

    def loss_fn(p):
        tasks = dict(batch)
        tasks["depth"] = jps.standardize_depth(tasks["depth"], method="sort")
        preds, m = model.apply({"params": p["model"]}, tasks, train=True,
                               num_encoded_tokens=K, task_masks=masks)
        tasks["norm_rgb"], m = tasks["rgb"], dict(m, norm_rgb=m["rgb"])
        task_losses = {t: losses[t](pr.astype(jnp.float32), tasks[t], mask=m[t])
                       for t, pr in preds.items()}
        return sum(balancer.apply({"params": p["balancer"]}, task_losses).values())

    fdp.set_force_mode("ref")
    try:
        jgrads = numpy_tree(jax.jit(jax.grad(loss_fn))(params0))
    finally:
        fdp.set_force_mode(None)
    state, step = port_state(params0)
    step(state, port_batch(), task_masks=torch_masks())
    named = dict(state.model.named_parameters())
    ref = jax_params_to_state_dict(jgrads["model"], PROJ_SHAPES)
    assert set(ref) == set(named)
    for k, v in ref.items():
        np.testing.assert_allclose(named[k].grad.numpy(), v, rtol=0,
                                   atol=2e-5 * np.abs(v).max(), err_msg=k)
    np.testing.assert_allclose(state.balancer.log_vars.grad.numpy(),
                               jgrads["balancer"]["log_vars"], rtol=0, atol=1e-6)


# ------------------------------------------------------------- schedules --


@pytest.mark.parametrize("args", [
    (1e-3, 1e-6, 3, 7, 1, 0.0, -1),
    (5e-4, 0.0, 2, 5, 0, 0.0, 3),
    (0.04, 0.4, 4, 3, 0, 0.0, -1),
    (1.5e-4, 1e-6, 1600, 2, 40, 1e-7, -1),
])
def test_cosine_scheduler_equals_jax(args):
    np.testing.assert_array_equal(cosine_scheduler(*args), jcosine(*args))


# ---------------------------------------------------------- param groups --


@pytest.mark.parametrize("filter_bias_and_bn", [False, True])
def test_param_groups_match_jax(jax_run, filter_bias_and_bn):
    params0 = jax_run[0]
    lr_scales, wd_flags, jgroups = build_param_labels(
        params0, filter_bias_and_bn=filter_bias_and_bn, balancer_lr_scale=BAL_LR_SCALE)
    expect, frozen = {}, set()
    for (path, lr), wd in zip(jax.tree_util.tree_leaves_with_path(lr_scales),
                              jax.tree.leaves(wd_flags)):
        keys = tuple(p.key for p in path)
        name = ("balancer." + keys[-1] if keys[0] == "balancer"
                else flax_path_to_torch_key(keys[1:]))
        if ".".join(keys) in jgroups.get("frozen", ()):
            frozen.add(name)
        else:
            expect[name] = (float(lr), float(wd))

    model = tfactory.build_pretrain_model(**TINY, device="cpu")
    balancer = build_balancer("uncertainty", TASKS)
    groups, port_frozen = build_param_groups(
        model, balancer, filter_bias_and_bn=filter_bias_and_bn,
        balancer_lr_scale=BAL_LR_SCALE)
    got = {n: (g["lr_scale"], g["wd_flag"]) for g in groups for n in g["names"]}
    assert set(port_frozen) == frozen and all(n.endswith("pos_emb") for n in frozen)
    assert got == expect
    assert got["balancer.log_vars"] == (BAL_LR_SCALE, 0.0 if filter_bias_and_bn else 1.0)
    flat = {"output_adapters.rgb.mask_token", "global_tokens", "encoder.0.norm1.weight",
            "encoder.0.attn.qkv.bias", "output_adapters.rgb.task_embeddings.rgb"}
    for n in flat:
        assert got[n] == (1.0, 0.0 if filter_bias_and_bn else 1.0), n


# ------------------------------------------------------------ skip, clip --


@pytest.mark.parametrize("cause", ["threshold", "nonfinite"])
def test_skipped_step_leaves_params_and_optimizer_state(jax_run, cause):
    state, step = port_state(jax_run[0])
    step(state, port_batch(), task_masks=torch_masks())
    params = [p.detach().clone() for p in state.parameters()]
    opt_state = copy.deepcopy(state.optimizer.state_dict())
    batch = port_batch()
    if cause == "threshold":
        skip_step = make_pretrain_train_step(
            state.model, state.balancer,
            tfactory.build_pretrain_losses(("rgb", "depth", "semseg")),
            num_encoded_tokens=K, skip_grad=1e-12)
    else:
        skip_step = step
        batch["rgb"][0, 0, 0, 0] = float("nan")
    metrics = skip_step(state, batch, task_masks=torch_masks())
    assert metrics["skipped"] == 1.0
    assert all(torch.equal(a, b) for a, b in zip(params, state.parameters()))
    after = state.optimizer.state_dict()["state"]
    for i, s in opt_state["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(after[i][k]), torch.as_tensor(v)), (i, k)
    assert (state.step, state.updates) == (2, 1)
    step(state, port_batch(), task_masks=torch_masks())
    lrs = {g["group"]: g["lr"] for g in state.optimizer.param_groups}
    assert lrs["flat_decay"] == float(LR[1]), "the schedule is indexed by updates"
    assert lrs["balancer"] == float(LR[1]) * BAL_LR_SCALE
    assert (state.step, state.updates) == (3, 2)


@pytest.mark.parametrize("clip", [1e-3, 1e6])
def test_clip_scales_grads_to_the_limit(jax_run, clip):
    state, step = port_state(jax_run[0], clip_grad=clip)
    metrics = step(state, port_batch(), task_masks=torch_masks())
    norm = float(metrics["grad_norm"])
    clipped = float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                   for p in state.parameters() if p.grad is not None)))
    assert norm > 1e-3
    expect = norm * min(1.0, clip / (norm + 1e-6))
    assert abs(clipped - expect) <= 1e-5 * expect, (clipped, expect)


# -------------------------------------------------------------- balancer --


@pytest.mark.parametrize("losses", [(1.5, 0.7, 2.0, 0.3), (1.5, 0.0, 2.0, 0.0),
                                    (0.0, 0.0, 0.0, 0.0)])
def test_uncertainty_balancer_matches_jax(losses):
    jbal = jbuild_balancer("uncertainty", TASKS)
    lv = jnp.asarray(LOG_VARS)

    def total(lv_):
        out = jbal.apply({"params": {"log_vars": lv_}},
                         {t: jnp.float32(v) for t, v in zip(TASKS, losses)})
        return sum(out.values()), out

    (_, jout), jgrad = jax.value_and_grad(total, has_aux=True)(lv)
    tbal = build_balancer("uncertainty", TASKS)
    with torch.no_grad():
        tbal.log_vars.copy_(torch.from_numpy(LOG_VARS))
    tout = tbal({t: torch.tensor(v) for t, v in zip(TASKS, losses)})
    sum(tout.values()).backward()
    for t, v in zip(TASKS, losses):
        assert abs(float(tout[t].detach()) - float(jout[t])) <= 1e-6
        if v == 0.0:
            assert float(tout[t].detach()) == 0.0
    np.testing.assert_allclose(tbal.log_vars.grad.numpy(), np.asarray(jgrad), atol=1e-6)


# ------------------------------------------------------- patch-space losses --


def unpatchify(x, hw, channels, p):
    b = x.shape[0]
    h, w = hw
    x = x.reshape(b, h // p, w // p, channels, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h, w, channels)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("kind", ["mse", "l1", "ce", "norm_mse"])
def test_patch_losses_equal_pixel_losses_and_jax(kind, masked):
    rng = np.random.default_rng(11)
    b, hw = 2, (64, 64)
    mask = (rng.random((b, 16)) < 0.6).astype(np.int64)
    mask[1] = 0  # a sample with nothing masked
    if kind == "ce":
        p, c = 4, 5
        patches = rng.standard_normal((b, 16, c * p * p)).astype(np.float32)
        target = rng.integers(0, c, (b, 16, 16))
        tl, jl = tcrit.MaskedCrossEntropyLoss(16, 4), JCE(16, 4)
        hw_c = (16, 16)
    else:
        p, c = 16, 3 if kind != "l1" else 1
        patches = rng.standard_normal((b, 16, c * p * p)).astype(np.float32)
        target = rng.standard_normal((b, 64, 64, c)).astype(np.float32)
        cls_t, cls_j = {"mse": (tcrit.MaskedMSELoss, JMSE), "norm_mse": (tcrit.MaskedMSELoss, JMSE),
                        "l1": (tcrit.MaskedL1Loss, JL1)}[kind]
        tl, jl = cls_t(16, 1, norm_pix=kind == "norm_mse"), cls_j(16, 1, norm_pix=kind == "norm_mse")
        hw_c = hw
    tm = torch.from_numpy(mask) if masked else None
    jm = jnp.asarray(mask) if masked else None
    tpatch = torch.from_numpy(patches)
    patch_loss = float(tl(tpatch, torch.from_numpy(target), mask=tm))
    pixel_loss = float(tl(unpatchify(tpatch, hw_c, c, p), torch.from_numpy(target), mask=tm))
    jax_loss = float(jl(jnp.asarray(patches), jnp.asarray(target), mask=jm))
    assert abs(patch_loss - pixel_loss) <= 1e-5 * abs(pixel_loss)
    assert abs(patch_loss - jax_loss) <= 1e-5 * abs(jax_loss)


# ------------------------------------------------------ standardize_depth --


@pytest.mark.parametrize("shape,seed", [((2, 8, 8, 1), 1), ((3, 64, 64, 1), 2),
                                        ((1, 10, 6, 1), 3)])
def test_standardize_depth_matches_jax_sort(shape, seed):
    d = (np.random.default_rng(seed).standard_normal(shape) * 5 + 7).astype(np.float32)
    ref = np.asarray(jps.standardize_depth(jnp.asarray(d), method="sort"))
    out = standardize_depth(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
