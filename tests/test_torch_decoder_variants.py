"""Decoders without task queries or cross-attention, and --approx_gelu,
against the JAX package.

The tiny MultiMAE (dim 64, 2 blocks) on RGB and depth in and out (64 px,
16 of 32 tokens visible; decoders dim 64, 2 heads, depth 1,
return_patches) in fp32, built by each package's `build_pretrain_model`
with (use_task_queries, use_xattn) = (False, True), (True, False) under
--approx_gelu (the JAX `set_approx_gelu(True)`, the port's per-model
setting) and (False, False). The port's weights go to the JAX model
through the JAX importer (`state_dict_to_params`, strict), so both sides
hold the same parameters. The port takes two training steps (uncertainty
balancer, AdamW, fixed masks); before each, the JAX model's preds,
per-task losses and every gradient (jax.grad, its decoders in
`fdp.set_force_mode("ref")` where K1's gate admits them) are computed at
the port's parameters. Limits: preds within 5e-4 of their largest
|value|, losses within 5e-4 relative, each gradient within 5e-4 of its
tensor's largest |gradient| (0 where the loss does not reach it: the
encoder under decoders with neither).

Also: K1 runs only where the decoders have cross-attention; the tanh GELU
moves the preds far more than the gap to JAX and stays on the model it was
set on; the converters round-trip strictly without the cross-attention
keys; the pretraining CLI trains with `decoder_use_xattn: false` in a YAML.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.cli import factory as jfactory
from multimae_tpu.models import vit as jvit
from multimae_tpu.ops import fused_decoder_pallas as fdp
from multimae_tpu.train import pretrain_step as jps
from multimae_tpu.train.task_balancing import build_balancer as jbuild_balancer
from multimae_tpu.utils.torch_compat import state_dict_to_params
from multimae_tpu_torch.cli import factory as tfactory
from multimae_tpu_torch.cli import run_pretraining_multimae as tcli
from multimae_tpu_torch.models.vit import Mlp, set_approx_gelu
from multimae_tpu_torch.ops import fused_decoder
from multimae_tpu_torch.train.optim_factory import create_optimizer
from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step, standardize_depth
from multimae_tpu_torch.train.schedules import cosine_scheduler
from multimae_tpu_torch.train.task_balancing import build_balancer
from multimae_tpu_torch.train.train_state import TrainState
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJ_SHAPES = {"rgb": (3, 16, 16), "depth": (1, 16, 16)}
# Decoder heads of width 32, which K1's gate takes in both packages: the
# decoders that have cross-attention run the core (its plain twin on the
# CPU; the JAX ref math), whose GELU stays erf under --approx_gelu.
TINY = dict(model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
            decoder_num_heads=2, decoder_depth=1, decoder_return_patches=True,
            in_domains=("rgb", "depth"), out_domains=("rgb", "depth"),
            extra_norm_pix_loss=False)
TASKS = ("rgb", "depth")
B, K = 2, 16
LOG_VARS = np.array([0.1, -0.2], np.float32)
LIMIT = 5e-4
# --approx_gelu rides on the decoders without cross-attention: their blocks
# then take the module path in both packages, so the tanh GELU runs in the
# encoder and in the decoders (with cross-attention, K1 keeps erf; the card
# test and chip_smoke.py phase 19 hold that case against the plain twins).
# name: (decoder options, approx_gelu)
VARIANTS = {
    "no_task_queries": (dict(decoder_use_task_queries=False), False),
    "no_xattn_approx_gelu": (dict(decoder_use_xattn=False), True),
    "neither": (dict(decoder_use_task_queries=False, decoder_use_xattn=False), False),
}


def fixed_masks(seed=3):
    rng = np.random.default_rng(seed)
    masks = np.ones((B, 32), np.int32)
    for i in range(B):
        masks[i, rng.permutation(32)[:K]] = 0
    return {t: masks[:, 16 * j:16 * (j + 1)] for j, t in enumerate(TASKS)}


def jax_params_of(model, jmodel, batch):
    """The port model's parameters as the JAX model's param tree."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        batch, num_encoded_tokens=K)["params"])
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params, report = state_dict_to_params(sd, template, strict=True, verbose=False)
    assert not report["unexpected"], report
    return params


def jax_loss_and_grads(jmodel, approx):
    """jit(value_and_grad) of the JAX step's loss: (total, (task losses, preds))."""
    balancer = jbuild_balancer("uncertainty", TASKS)
    losses = jfactory.build_pretrain_losses(TASKS, extra_norm_pix_loss=False)
    masks = {t: jnp.asarray(m) for t, m in fixed_masks().items()}

    def loss_fn(p, batch):
        tasks = dict(batch)
        tasks["depth"] = jps.standardize_depth(tasks["depth"], method="sort")
        preds, m = jmodel.apply({"params": p["model"]}, tasks, train=True,
                                num_encoded_tokens=K, task_masks=masks)
        task_losses = {t: losses[t](pr.astype(jnp.float32), tasks[t], mask=m[t])
                       for t, pr in preds.items()}
        weighted = balancer.apply({"params": p["balancer"]}, task_losses)
        return sum(weighted.values()), (task_losses, preds)

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    def run(params, batch):
        fdp.set_force_mode("ref")
        jvit.set_approx_gelu(approx)
        try:
            (_, (task_losses, preds)), grads = fn(params, batch)
            return (jax.tree.map(np.asarray, task_losses), jax.tree.map(np.asarray, preds),
                    jax.tree.map(np.asarray, grads))
        finally:
            jvit.set_approx_gelu(False)
            fdp.set_force_mode(None)

    return run


def port_trainer(**kw):
    model = tfactory.build_pretrain_model(**TINY, pos_emb_grads=True, seed=5, device="cpu",
                                          **kw)
    balancer = build_balancer("uncertainty", TASKS)
    with torch.no_grad():
        balancer.log_vars.copy_(torch.from_numpy(LOG_VARS))
    lr = cosine_scheduler(1e-3, 1e-5, 1, 4)
    opt = create_optimizer(model, balancer, opt_betas=(0.9, 0.95), filter_bias_and_bn=False)
    state = TrainState(model, balancer, opt, lr, cosine_scheduler(0.04, 0.4, 1, 4))
    step = make_pretrain_train_step(
        model, balancer, tfactory.build_pretrain_losses(TASKS, extra_norm_pix_loss=False),
        num_encoded_tokens=K, in_domains=TASKS, extra_norm_pix_loss=False)
    return state, step


def port_preds(model, batch):
    tasks = dict(batch)
    tasks["depth"] = standardize_depth(tasks["depth"])
    with torch.no_grad():
        preds, _ = model(tasks, num_encoded_tokens=K,
                         task_masks={t: torch.from_numpy(m) for t, m in fixed_masks().items()})
    return {t: p.numpy() for t, p in preds.items()}


@functools.lru_cache(maxsize=None)
def run_variant(name):
    """Per step: the port's metrics, preds and gradients, and the JAX ones
    at the same parameters (once per variant in a process)."""
    kw, approx = VARIANTS[name]
    state, step = port_trainer(approx_gelu=approx, **kw)
    jmodel = jfactory.build_pretrain_model(**TINY, **kw)
    jbatch = jfactory.make_synthetic_batch(B, input_size=64, in_domains=TASKS, seed=1)
    batch = tfactory.make_synthetic_batch(B, input_size=64, in_domains=TASKS, seed=1,
                                          device="cpu")
    jrun = jax_loss_and_grads(jmodel, approx)
    masks = {t: torch.from_numpy(m) for t, m in fixed_masks().items()}
    steps = []
    calls = [0]
    core = fused_decoder.fused_decoder_core

    def counted_core(*args, **kw):
        calls[0] += 1
        return core(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(fused_decoder, "fused_decoder_core", counted_core)
    for _ in range(2):
        params = {"model": jax_params_of(state.model, jmodel, jbatch),
                  "balancer": {"log_vars": jnp.asarray(state.balancer.log_vars.detach().numpy())}}
        jlosses, jpreds, jgrads = jrun(params, jbatch)
        preds = port_preds(state.model, batch)
        calls[0] = 0
        metrics = {k: float(v) for k, v in step(state, batch, task_masks=masks).items()}
        grads = {n: p.grad.numpy().copy() for n, p in state.model.named_parameters()}
        steps.append(dict(metrics=metrics, preds=preds, grads=grads, k1=calls[0],
                          jlosses=jlosses, jpreds=jpreds,
                          jgrads=jax_params_to_state_dict(jgrads["model"], PROJ_SHAPES)))
    mp.undo()
    return name, state, steps


@pytest.fixture(params=sorted(VARIANTS))
def variant_run(request):
    return run_variant(request.param)


@pytest.mark.parametrize("i", [0, 1])
def test_preds_and_losses_match_jax(variant_run, i):
    name, _, steps = variant_run
    s = steps[i]
    for t, ref in s["jpreds"].items():
        got = s["preds"][t]
        assert got.shape == ref.shape, t
        np.testing.assert_allclose(got, ref, rtol=0, atol=LIMIT * np.abs(ref).max(),
                                   err_msg=f"{name} step {i} pred {t}")
    for t in TASKS:
        ref = float(s["jlosses"][t])
        assert abs(s["metrics"][f"{t}_loss"] - ref) <= LIMIT * abs(ref), (name, i, t)
    assert s["metrics"]["skipped"] == 0.0


@pytest.mark.parametrize("i", [0, 1])
def test_gradients_match_jax(variant_run, i):
    name, state, steps = variant_run
    s = steps[i]
    assert set(s["jgrads"]) == set(s["grads"])
    for k, ref in s["jgrads"].items():
        np.testing.assert_allclose(s["grads"][k], ref, rtol=0, atol=LIMIT * np.abs(ref).max(),
                                   err_msg=f"{name} step {i} {k}")
    if name == "neither":  # nothing reaches the encoder: jax.grad's zeros
        assert not any(np.any(g) for k, g in s["grads"].items() if k.startswith("encoder."))


def test_k1_runs_only_with_cross_attention(variant_run):
    """The two decoders call the K1 core (here its twin) once per step, or
    never without cross-attention."""
    name, state, steps = variant_run
    xattn = VARIANTS[name][0].get("decoder_use_xattn", True)
    assert all(s["k1"] == (2 if xattn else 0) for s in steps), [s["k1"] for s in steps]
    adapter = state.model.output_adapters["rgb"]
    for sub in ("decoder", "context_norm", "query_norm", "out_norm", "mlp"):
        assert hasattr(adapter, sub) == xattn, sub


def test_approx_gelu_is_the_models_own():
    """The tanh GELU moves the preds ten times further from JAX's than the
    port's tanh preds are; a second model built in the same process keeps
    the exact erf."""
    _, state, steps = run_variant("no_xattn_approx_gelu")
    model = state.model
    erf_model = tfactory.build_pretrain_model(**TINY, pos_emb_grads=True, seed=5, device="cpu",
                                              **VARIANTS["no_xattn_approx_gelu"][0])
    assert all(not m.approx_gelu for m in erf_model.modules() if isinstance(m, Mlp))
    assert all(m.approx_gelu for m in model.modules() if isinstance(m, Mlp))
    erf_model.load_state_dict(model.state_dict())
    batch = tfactory.make_synthetic_batch(B, input_size=64, in_domains=TASKS, seed=1,
                                          device="cpu")
    erf_preds, tanh_preds = port_preds(erf_model, batch), port_preds(model, batch)
    ref = steps[1]["jpreds"]
    for t in ref:
        gap = np.abs(steps[1]["preds"][t] - ref[t]).max()
        erf_gap = np.abs(erf_preds[t] - ref[t]).max()
        assert 10 * gap < erf_gap, (t, gap, erf_gap)
    set_approx_gelu(erf_model, True)
    for t, p in port_preds(erf_model, batch).items():
        np.testing.assert_array_equal(p, tanh_preds[t])


@pytest.mark.parametrize("kw", [VARIANTS["no_xattn_approx_gelu"][0], VARIANTS["neither"][0]])
def test_converters_round_trip_without_xattn_keys(kw):
    model = tfactory.build_pretrain_model(**TINY, seed=2, device="cpu", **kw)
    jmodel = jfactory.build_pretrain_model(**TINY, **kw)
    params = jax_params_of(model, jmodel, jfactory.make_synthetic_batch(
        B, input_size=64, in_domains=TASKS, seed=1))
    sd = jax_params_to_state_dict(params, PROJ_SHAPES)
    assert not any(".decoder." in k or "_norm." in k or ".mlp." in k
                   for k in sd if k.startswith("output_adapters.") and "decoder_transformer"
                   not in k)
    again = tfactory.build_pretrain_model(**TINY, seed=3, device="cpu", **kw)
    again.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                          strict=True)
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_cli_trains_without_xattn_from_a_yaml(tmp_path):
    cfg = tmp_path / "no_xattn.yaml"
    base = open(os.path.join(REPO, "cfgs/pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml"))
    cfg.write_text(base.read() + "\ndecoder_use_xattn: false\n")
    base.close()
    args = tcli.get_args(["-c", str(cfg), "--device", "cpu", "--model", "pretrain_multimae_tiny",
                          "--input_size", "64", "--num_encoded_tokens", "24",
                          "--decoder_dim", "64", "--decoder_num_heads", "4", "--batch_size", "2",
                          "--dtype", "float32", "--synthetic_data",
                          "--synthetic_steps_per_epoch", "2", "--epochs", "1",
                          "--warmup_epochs", "0", "--output_dir", str(tmp_path / "out")])
    assert args.decoder_use_xattn is False and args.decoder_use_task_queries is True
    summary = tcli.main(args)
    losses = [r["metrics"]["loss"] for r in summary["steps"]]
    assert len(losses) == 2 and all(np.isfinite(losses)), losses
    saved = torch.load(tmp_path / "out" / "checkpoint-0.pth", weights_only=False)["model"]
    assert "output_adapters.rgb.decoder_transformer.0.mlp.fc1.weight" in saved
    assert not any(k.startswith("output_adapters.rgb.decoder.") for k in saved)


@pytest.mark.parametrize("flag", [None, "--approx_gelu"])
def test_cli_builds_the_models_gelu(flag, monkeypatch):
    """--approx_gelu reaches the model the CLI builds, and only that model."""
    built = []
    real = tfactory.build_pretrain_model

    def spy(**kw):
        built.append(real(**kw))
        return built[-1]

    monkeypatch.setattr(tfactory, "build_pretrain_model", spy)
    args = tcli.get_args(["--device", "cpu", "--model", "pretrain_multimae_tiny",
                          "--input_size", "64", "--num_encoded_tokens", "24",
                          "--decoder_dim", "64", "--decoder_num_heads", "4", "--batch_size", "2",
                          "--dtype", "float32", "--synthetic_data",
                          "--synthetic_steps_per_epoch", "1", "--epochs", "1",
                          "--warmup_epochs", "0"] + ([flag] if flag else []))
    tcli.main(args)
    mlps = [m for m in built[0].modules() if isinstance(m, Mlp)]
    assert mlps and all(m.approx_gelu == bool(flag) for m in mlps)
    fresh = real(**TINY, device="cpu")
    assert not any(m.approx_gelu for m in fresh.modules() if isinstance(m, Mlp))

