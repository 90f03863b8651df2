"""Resuming a JAX training state in the port (multimae_tpu_torch/utils/jax_state.py,
train/checkpoint.py), against the JAX package on the CPU at tiny sizes.

* Each optimizer (adamw, adam, sgd, nesterov, momentum) on the tiny
  pretraining model of tests/test_torch_train_step.py (fp32, uncertainty
  balancer, flat decay group, clip 1): the JAX package takes a step, then
  one that its skip_grad skips, and saves with its own save_checkpoint.
  The port's load maps every leaf bit for bit (the parameters and moments
  against the JAX package's own converter; the counts: step 2, one
  update), and the port's state written back holds the JAX leaves, the
  frozen pos-embs' moments aside. Both then take the next step on the same
  batch and masks: losses and the grad norm within 1e-4 relative; the
  parameters by test_torch_train_step.py's bars for updated parameters
  (each element within 2.5e-3, the median within 2e-6, at most 0.5% of the
  elements beyond it; the attention keys' bias, whose exact gradient is 0,
  held to the 2.5e-3 alone); the balancer within 2e-6; the moments within
  2e-5 of each tensor's largest |value| (their gradient term's bar).
* The cls state under --update_freq 2 (optax.MultiSteps), saved at
  mini_step 1 with a device EMA and with a host EMA (extras), maps to
  mini_step, grad_accum and the EMA; the next two steps match.
* The inverse: the port's --ckpt_backend msgpack save is restored by the
  JAX package's load_checkpoint with no leaf left at its template value,
  and the JAX package's next step from it matches the port's.
* Auto-resume over .pth and .msgpack saves: the newest epoch first, the
  .pth first at one epoch; a damaged newest .msgpack falls back one save
  (orbax saves among them: tests/test_torch_orbax.py).

The JAX step is the package's `make_pretrain_train_step` up to its
`apply_gradients`, compiled once for every optimizer (the state's
apply_gradients records the clipped gradients and the skip flag), then
the JAX TrainState's own apply_gradients with them: the step's two
halves as the package runs them, with one compile of the model in place
of one per optimizer.
"""

import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimae_tpu.cli import factory as jfactory
from multimae_tpu.cli import run_finetuning_cls as jcls
from multimae_tpu.ops import fused_decoder_pallas as fdp
from multimae_tpu.train import checkpoint as jckpt
from multimae_tpu.train import cross_entropy as jce
from multimae_tpu.train import finetune_step as jfs
from multimae_tpu.train import pretrain_step as jps
from multimae_tpu.train.optim_factory import LayerDecayValueAssigner as JLDVA
from multimae_tpu.train.optim_factory import create_optimizer as jcreate
from multimae_tpu.train.schedules import as_optax_schedule
from multimae_tpu.train.task_balancing import build_balancer as jbuild_balancer
from multimae_tpu.train.train_state import HostEMA as JHostEMA
from multimae_tpu.train.train_state import TrainState as JTrainState
from multimae_tpu_torch.cli import factory as tfactory
from multimae_tpu_torch.cli.factory import build_cls_model
from multimae_tpu_torch.train import checkpoint as ckpt
from multimae_tpu_torch.train import cross_entropy as tce
from multimae_tpu_torch.train.finetune_step import make_cls_train_step
from multimae_tpu_torch.train.optim_factory import LayerDecayValueAssigner, create_optimizer
from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step
from multimae_tpu_torch.train.task_balancing import build_balancer
from multimae_tpu_torch.train.train_state import HostEMA, TrainState
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict
from multimae_tpu_torch.utils.flax_msgpack import read_msgpack
from multimae_tpu_torch.utils.jax_state import port_state_to_jax
from test_torch_train_step import (B, BAL_LR_SCALE, BETAS, CLIP, K, LOG_VARS, LR, PROJ_SHAPES,
                                   TASKS, TINY, WD, fixed_masks, key_bias_slice, numpy_tree)

OPTS = ["adamw", "adam", "sgd", "nesterov", "momentum"]


class _Capture(JTrainState):
    """A JAX TrainState whose apply_gradients keeps its arguments: the
    clipped gradients in `params`, the skip flag in `opt_state`."""

    def apply_gradients(self, grads, skip_update=None, ema_decay=None):
        return self.replace(params=grads, opt_state=skip_update)


@pytest.fixture(scope="module")
def jax_pretrain():
    """(params0, step): step(state, skip_grad) -> (state, metrics) runs the
    JAX pretraining step on the synthetic batch with the fixed masks."""
    model = jfactory.build_pretrain_model(**TINY)
    batch = jfactory.make_synthetic_batch(B, input_size=64, seed=1)
    params = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        batch, num_encoded_tokens=K)["params"])()
    params0 = {"model": numpy_tree(params), "balancer": {"log_vars": LOG_VARS}}
    masks = {t: jnp.asarray(m) for t, m in fixed_masks(B).items()}
    balancer = jbuild_balancer("uncertainty", TASKS)
    no_tx = optax.identity()

    @jax.jit
    def grads(params, step, skip_grad):
        capture = _Capture(step=step, params=params, opt_state=None, tx=no_tx)
        train_step = jps.make_pretrain_train_step(
            model, balancer, jfactory.build_pretrain_losses(("rgb", "depth", "semseg")),
            num_encoded_tokens=K, clip_grad=CLIP, skip_grad=skip_grad)
        out, metrics = train_step(capture, batch, jax.random.PRNGKey(0), masks)
        return out.params, out.opt_state, metrics

    def step(state, skip_grad=math.inf):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jps, "standardize_depth",
                       functools.partial(jps.standardize_depth, method="sort"))
            fdp.set_force_mode("ref")
            try:
                g, skip, metrics = grads(state.params, state.step, jnp.float32(skip_grad))
            finally:
                fdp.set_force_mode(None)
        return (state.apply_gradients(g, skip_update=skip),
                {k: float(v) for k, v in metrics.items()})

    return params0, step


def jax_tx(params, opt):
    return jcreate(params, opt=opt, lr_schedule=as_optax_schedule(LR),
                   wd_schedule=as_optax_schedule(WD), opt_betas=BETAS,
                   filter_bias_and_bn=False, balancer_lr_scale=BAL_LR_SCALE)


def port_pretrain(opt, seed=5):
    """A port state of another initialisation than the JAX one: the load
    must overwrite all of it."""
    model = tfactory.build_pretrain_model(**TINY, pos_emb_grads=True, seed=seed, device="cpu")
    balancer = build_balancer("uncertainty", TASKS)
    optimizer = create_optimizer(model, balancer, opt=opt, opt_betas=BETAS,
                                 filter_bias_and_bn=False, balancer_lr_scale=BAL_LR_SCALE)
    state = TrainState(model, balancer, optimizer, LR, WD)
    step = make_pretrain_train_step(
        model, balancer, tfactory.build_pretrain_losses(("rgb", "depth", "semseg")),
        num_encoded_tokens=K, clip_grad=CLIP)
    return state, step


def port_step(state, step):
    batch = tfactory.make_synthetic_batch(B, input_size=64, seed=1, device="cpu")
    masks = {t: torch.from_numpy(m) for t, m in fixed_masks(B).items()}
    return {k: float(v) for k, v in step(state, batch, task_masks=masks).items()}


def flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in flat(sub, path + (key,)).items()}
    return {path: tree}


def as_numpy(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_metrics_match(got, ref):
    for k in ["loss", "grad_norm"] + [f"{t}_loss" for t in TASKS]:
        assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), (k, got[k], ref[k])


def assert_params_match(got, ref, init=None):
    """test_torch_train_step.py's bars for parameters after a step; with
    `init`, the frozen pos-embs equal to it on both sides."""
    assert set(got) == set(ref)
    for k, v in ref.items():
        g = as_numpy(got[k])
        if init is not None and k.endswith("pos_emb"):
            np.testing.assert_array_equal(g, init[k], err_msg=k)
            np.testing.assert_array_equal(v, init[k], err_msg=k)
            continue
        d = np.abs(g - v)
        assert d.max() <= 2.5e-3, (k, d.max())
        key = key_bias_slice(k, v.shape[0])
        if key is not None:
            d = np.delete(d, np.arange(v.shape[0])[key])
        assert np.median(d) <= 2e-6, (k, np.median(d))
        assert np.sum(d > 2e-6) <= max(2, d.size // 200), (k, np.sum(d > 2e-6), d.size)


def assert_close_to_largest(got, ref, what):
    for k, v in ref.items():
        np.testing.assert_allclose(as_numpy(got[k]), v, rtol=0,
                                   atol=2e-5 * max(np.abs(v).max(), 1e-30),
                                   err_msg=f"{what} {k}")


def port_moments(state):
    """{kind: {name: tensor}} of the optimizer state, by parameter name."""
    names = state._optimized_names()
    out = {}
    for i, per in state.optimizer.state_dict()["state"].items():
        for kind, v in per.items():
            out.setdefault(kind, {})[names[i]] = v
    return out


def jax_moments(opt_state, opt):
    chain = opt_state[0]
    trees = {"trace": chain.trace} if opt in ("sgd", "nesterov", "momentum") else {
        "exp_avg": chain.mu, "exp_avg_sq": chain.nu}
    out = {}
    for kind, tree in trees.items():
        tree = numpy_tree(tree)
        named = jax_params_to_state_dict(tree["model"], PROJ_SHAPES)
        named.update({f"balancer.{k}": v for k, v in tree["balancer"].items()})
        out["momentum_buffer" if kind == "trace" else kind] = named
    return out


@pytest.mark.parametrize("opt", OPTS)
def test_optimizer_state_maps_and_the_next_step_matches_jax(jax_pretrain, opt, tmp_path):
    params0, jstep = jax_pretrain
    jstate = JTrainState.create(params=jax.tree.map(jnp.asarray, params0),
                                tx=jax_tx(params0, opt))
    jstate, taken = jstep(jstate)
    jstate, skipped = jstep(jstate, skip_grad=1e-12)
    assert (taken["skipped"], skipped["skipped"]) == (0.0, 1.0)
    path = jckpt.save_checkpoint(str(tmp_path), 3, jstate, backend="msgpack")

    state, step = port_pretrain(opt)
    epoch, payload = ckpt.load_checkpoint(path, state)
    assert (epoch, state.step, state.updates) == (3, 2, 1)
    assert payload["data_iter_state"] is None
    # Every leaf bit for bit, against the JAX package's own converter.
    ref = jax_params_to_state_dict(numpy_tree(jstate.params["model"]), PROJ_SHAPES)
    got = state.model.state_dict()
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(state.balancer.log_vars.detach().numpy(),
                                  np.asarray(jstate.params["balancer"]["log_vars"]))
    moments, ref = port_moments(state), jax_moments(jstate.opt_state, opt)
    assert set(moments) - {"step"} == set(ref)
    for kind, named in ref.items():
        assert set(moments[kind]) == {n for n in named if not n.endswith("pos_emb")}
        for n, t in moments[kind].items():
            np.testing.assert_array_equal(t.numpy(), named[n], err_msg=f"{kind} {n}")
    assert all(float(s) == 1.0 for s in moments.get("step", {}).values())
    # And written back: the file's leaves, the frozen pos-embs' moments zero.
    saved, back = flat(read_msgpack(path)), flat(port_state_to_jax(state, 3))
    assert set(saved) == set(back)
    for k, v in saved.items():
        if not torch.is_tensor(v):
            assert back[k] == v, k
            continue
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        if k[0] == "opt_state" and k[-1] == "pos_emb":
            assert not back[k].any() and v.any(), k
        else:
            assert torch.equal(back[k], v), k

    init = {k: v.numpy().copy() for k, v in got.items()}
    jstate, jm = jstep(jstate)
    tm = port_step(state, step)
    assert jm["skipped"] == tm["skipped"] == 0.0 and (state.step, state.updates) == (3, 2)
    assert_metrics_match(tm, jm)
    assert_params_match(state.model.state_dict(),
                        jax_params_to_state_dict(numpy_tree(jstate.params["model"]),
                                                 PROJ_SHAPES), init)
    np.testing.assert_allclose(state.balancer.log_vars.detach().numpy(),
                               np.asarray(jstate.params["balancer"]["log_vars"]),
                               rtol=0, atol=2e-6)
    moments, ref = port_moments(state), jax_moments(jstate.opt_state, opt)
    for kind, named in ref.items():
        assert_close_to_largest(moments[kind], {n: v for n, v in named.items()
                                                if not n.endswith("pos_emb")}, kind)


# --------------------------------------------------------- the cls state --

S, CLASSES, EMA = 32, 10, 0.9
CLS_PROJ = {"rgb": (3, 16, 16)}
LAYER_VALUES = [0.65 ** (2 + 1 - i) for i in range(2 + 2)]


def cls_batch():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, S, S, 3)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, 4)] * 0.9 + 0.01
    return x, y


@pytest.mark.parametrize("where", ["device", "host"])
def test_cls_multisteps_state_with_ema_resumes(where, tmp_path):
    """Under --update_freq 2, saved at mini_step 1 after three steps (one
    update); the next two steps complete an update and start another."""
    jargs = jcls.get_args(["--model", "multivit_tiny", "--input_size", str(S), "--nb_classes",
                           str(CLASSES), "--drop_path", "0", "--dtype", "float32"])
    jmodel = jcls.build_cls_model(jargs, jnp.float32)
    params = jax.jit(lambda: jmodel.init({"params": jax.random.PRNGKey(0)},
                                         {"rgb": jnp.zeros((2, S, S, 3))})["params"])()
    tx = optax.MultiSteps(jcreate(params, opt="adamw", lr_schedule=as_optax_schedule(LR),
                                  wd_schedule=as_optax_schedule(WD), opt_betas=(0.9, 0.999),
                                  layer_decay_assigner=JLDVA(LAYER_VALUES)),
                          every_k_schedule=2)
    device = where == "device"
    jstate = JTrainState.create(params=params, tx=tx, ema_decay=EMA if device else None)
    jhost = None if device else JHostEMA(params, EMA)
    jstep = jax.jit(jfs.make_cls_train_step(jmodel, jce.soft_target_cross_entropy,
                                            ema_decay=EMA if device else None))
    x, y = cls_batch()
    jbatch = {"rgb": jnp.asarray(x), "target": jnp.asarray(y)}

    def jax_steps(jstate, n):
        metrics = []
        for _ in range(n):
            jstate, m = jstep(jstate, jbatch, jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
            if jhost is not None:
                jhost.update(jstate.params)
        return jstate, metrics

    jstate, _ = jax_steps(jstate, 3)
    path = jckpt.save_checkpoint(str(tmp_path), 0, jstate, backend="msgpack",
                                 extras=None if device else {"ema_params": jhost.params})

    model = build_cls_model(model="multivit_tiny", input_size=S, nb_classes=CLASSES,
                            drop_path=0.0)
    for name, p in model.named_parameters():
        if name.endswith("pos_emb"):
            p.requires_grad_(True)
    optimizer = create_optimizer(model, opt="adamw", opt_betas=(0.9, 0.999),
                                 layer_decay_assigner=LayerDecayValueAssigner(LAYER_VALUES))
    state = TrainState(model, None, optimizer, LR, WD, update_freq=2,
                       ema_decay=EMA if device else None)
    host = None if device else HostEMA(model, EMA)
    _, payload = ckpt.load_checkpoint(path, state)
    if host is not None:
        host.load(payload["ema_params"])
    assert (state.step, state.updates, state.mini_step) == (3, 1, 1)
    ema = state.ema if device else host.params
    ref = jax_params_to_state_dict(numpy_tree(jstate.ema_params if device else jhost.params),
                                   CLS_PROJ)
    assert set(ema) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(ema[k].numpy(), v, err_msg=k)
    acc = jax_params_to_state_dict(numpy_tree(jstate.opt_state.acc_grads), CLS_PROJ)
    for n, a in zip(state._optimized_names(), state.grad_accum):
        np.testing.assert_array_equal(a.numpy(), acc[n], err_msg=n)

    init = {k: v.numpy().copy() for k, v in state.model.state_dict().items()}
    jstate, jmetrics = jax_steps(jstate, 2)
    step = make_cls_train_step(model, tce.soft_target_cross_entropy)
    for jm in jmetrics:
        tm = {k: float(v) for k, v in step(state, {"rgb": torch.from_numpy(x),
                                                   "target": torch.from_numpy(y)}).items()}
        if host is not None:
            host.update()
        for k in ("loss", "grad_norm"):
            assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]), (k, tm[k], jm[k])
    assert (state.step, state.updates, state.mini_step) == (5, 2, 1)
    assert int(jstate.opt_state.gradient_step) == 2 and int(jstate.opt_state.mini_step) == 1
    assert_params_match(state.model.state_dict(),
                        jax_params_to_state_dict(numpy_tree(jstate.params), CLS_PROJ), init)
    ema = state.ema if device else host.params
    ref = jax_params_to_state_dict(numpy_tree(jstate.ema_params if device else jhost.params),
                                   CLS_PROJ)
    assert_params_match(ema, ref)


# ------------------------------------------------------------ the inverse --

def test_port_msgpack_resumes_in_jax_and_the_next_steps_match(jax_pretrain, tmp_path):
    params0, jstep = jax_pretrain
    state, step = port_pretrain("adamw")
    sds = {"model": jax_params_to_state_dict(params0["model"], PROJ_SHAPES),
           "balancer": {"log_vars": LOG_VARS}}
    state.model.load_state_dict({k: torch.from_numpy(v) for k, v in sds["model"].items()})
    state.balancer.load_state_dict({"log_vars": torch.from_numpy(LOG_VARS)})
    port_step(state, step)
    path = ckpt.save_checkpoint(str(tmp_path), 4, state, backend="msgpack")
    assert path.endswith("checkpoint-4.msgpack")

    sentinel = 7
    template = JTrainState.create(params=jax.tree.map(jnp.asarray, params0),
                                  tx=jax_tx(params0, "adamw"))
    template = jax.tree.map(lambda a: jnp.full_like(a, sentinel), template)
    jstate, epoch = jckpt.load_checkpoint(path, template)
    assert epoch == 4 and int(jstate.step) == 1
    leaves = jax.tree_util.tree_leaves_with_path((jstate.params, jstate.opt_state))
    assert len(leaves) > 100
    left = [jax.tree_util.keystr(p) for p, v in leaves if np.all(np.asarray(v) == sentinel)]
    assert not left, left[:5]
    assert [int(c) for c in (jstate.opt_state[0].count, jstate.opt_state[1].count,
                             jstate.opt_state[2].count)] == [1, 1, 1]

    init = {k: v.numpy().copy() for k, v in state.model.state_dict().items()}
    jstate, jm = jstep(jstate)
    tm = port_step(state, step)
    assert_metrics_match(tm, jm)
    assert_params_match(state.model.state_dict(),
                        jax_params_to_state_dict(numpy_tree(jstate.params["model"]),
                                                 PROJ_SHAPES), init)
    np.testing.assert_allclose(state.balancer.log_vars.detach().numpy(),
                               np.asarray(jstate.params["balancer"]["log_vars"]),
                               rtol=0, atol=2e-6)


# ----------------------------------------------------------- auto-resume --

def saves(tmp_path, files):
    """A port state, with `files` ({name: steps taken before it}) written in
    order; returns (output dir, {name: the model's state_dict at it})."""
    state, step = port_pretrain("adamw", seed=0)
    out, at, taken = str(tmp_path), {}, 0
    for name, steps in files.items():
        while taken < steps:
            port_step(state, step)
            taken += 1
        epoch, fmt = name.split("-")[1].split(".")
        ckpt.save_checkpoint(out, int(epoch), state, backend=fmt)
        at[name] = {k: v.clone() for k, v in state.model.state_dict().items()}
    return out, at


def damage(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)


@pytest.mark.parametrize("case", ["msgpack_newer", "pth_first_at_one_epoch",
                                  "damaged_msgpack_falls_back"])
def test_auto_resume_over_pth_and_msgpack(case, tmp_path, capsys):
    files, want = {
        "msgpack_newer": ({"checkpoint-0.pth": 1, "checkpoint-1.msgpack": 2},
                          "checkpoint-1.msgpack"),
        "pth_first_at_one_epoch": ({"checkpoint-1.msgpack": 1, "checkpoint-1.pth": 2},
                                   "checkpoint-1.pth"),
        "damaged_msgpack_falls_back": ({"checkpoint-0.pth": 1, "checkpoint-1.msgpack": 2},
                                       "checkpoint-0.pth"),
    }[case]
    out, at = saves(tmp_path, files)
    assert [os.path.basename(p) for p in ckpt.checkpoint_candidates(out)] == sorted(
        files, key=lambda n: (-int(n.split("-")[1].split(".")[0]), not n.endswith(".pth")))
    if case == "damaged_msgpack_falls_back":
        damage(os.path.join(out, "checkpoint-1.msgpack"))
    state, _ = port_pretrain("adamw", seed=9)
    start, payload = ckpt.auto_load_checkpoint(out, state)
    assert payload["path"] == os.path.join(out, want)
    assert start == int(want.split("-")[1].split(".")[0]) + 1
    assert (state.step, state.updates) == (files[want],) * 2
    assert all(torch.equal(v, at[want][k]) for k, v in state.model.state_dict().items())
    if case == "damaged_msgpack_falls_back":
        assert "checkpoint-1.msgpack failed to load" in capsys.readouterr().out

