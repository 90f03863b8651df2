"""The port's classification fine-tune against the JAX package's.

The tiny MultiViT (dim 64, 2 blocks, 4 heads) with the rgb adapter at 32
px (4 tokens + 1 global) and the mean-pooling LinearOutputAdapter over
10 classes, fp32, takes the JAX model's parameters through the port's
converter:

* the logits match within 5e-4 of the largest |logit|, with mean pooling
  and with the last (global) token;
* the three losses match within 1e-6; `Mixup` gives the JAX module's
  batch and soft targets exactly for a seed, in every mode;
* the first make_cls_train_step step (mixup's soft targets, layer decay
  0.65, AdamW) matches the JAX step: loss and grad norm within 1e-4
  relative, gradients within 2e-5 of each tensor's largest |gradient|;
* the device EMA after 3 steps (SGD, decay 0.9) within 1e-6 of the JAX
  state's `ema_params`, and HostEMA equal to it; --update_freq 2 over 4
  steps as optax.MultiSteps;
* AdamW, Adam, SGD (Nesterov), nesterov and momentum over 3 updates of
  fixed gradients, with the LR and WD schedules and the layer-decay
  groups, within 1e-6 of the JAX optax chains;
* top-k `accuracy` equal, ties included; the converter equals the JAX
  exporter on the cls head; dropout's keep rate and scale, and the dense
  attention-dropout path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.cli import run_finetuning_cls as jcli
from multimae_tpu.data import mixup as jmixup
from multimae_tpu.train import cross_entropy as jce
from multimae_tpu.train import finetune_step as jfs
from multimae_tpu.train.optim_factory import LayerDecayValueAssigner as JLDVA
from multimae_tpu.train.optim_factory import create_optimizer as jcreate
from multimae_tpu.train.schedules import as_optax_schedule, cosine_scheduler as jcosine
from multimae_tpu.train.train_state import TrainState as JTrainState
from multimae_tpu.utils import metrics as jmetrics
from multimae_tpu.utils.torch_compat import params_to_state_dict
from multimae_tpu_torch.cli.factory import build_cls_model
from multimae_tpu_torch.data.mixup import Mixup
from multimae_tpu_torch.models.vit import Attention, dropout
from multimae_tpu_torch.train import cross_entropy as tce
from multimae_tpu_torch.train.finetune_step import make_cls_eval_step, make_cls_train_step
from multimae_tpu_torch.train.optim_factory import LayerDecayValueAssigner, create_optimizer
from multimae_tpu_torch.train.train_state import HostEMA, TrainState
from multimae_tpu_torch.utils import metrics
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict

B, S, CLASSES = 4, 32, 10
PROJ_SHAPES = {"rgb": (3, 16, 16)}
LAYER_VALUES = [0.65 ** (2 + 1 - i) for i in range(2 + 2)]
LR = jcosine(1e-3, 1e-5, epochs=1, niter_per_ep=4)
WD = jcosine(0.05, 0.1, epochs=1, niter_per_ep=4)


def jax_args(*extra):
    return jcli.get_args(["--model", "multivit_tiny", "--input_size", str(S), "--nb_classes",
                          str(CLASSES), "--drop_path", "0", "--init_scale", "1.0",
                          "--dtype", "float32", *extra])


def port_model(params, mean_pooling=True):
    model = build_cls_model(model="multivit_tiny", input_size=S, nb_classes=CLASSES,
                            init_scale=1.0, drop_path=0.0, use_mean_pooling=mean_pooling)
    sd = jax_params_to_state_dict(params, PROJ_SHAPES)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    for name, p in model.named_parameters():
        if name.endswith("pos_emb"):  # the JAX gradient norm counts them
            p.requires_grad_(True)
    return model


def numpy_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def batch_np(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, S, 3)).astype(np.float32),
            rng.integers(0, CLASSES, B))


@pytest.fixture(scope="module")
def jax_model():
    model = jcli.build_cls_model(jax_args(), jnp.float32)
    params = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                        {"rgb": jnp.zeros((2, S, S, 3))})["params"])()
    return model, numpy_tree(params)


@pytest.fixture(scope="module")
def soft_batch():
    """A batch mixed by JAX's Mixup (cutmix on), with its soft targets."""
    x, y = batch_np()
    xm, ym = jmixup.Mixup(mixup_alpha=0.8, cutmix_alpha=1.0, label_smoothing=0.1,
                          num_classes=CLASSES, seed=3)(x, y)
    return xm, ym


@pytest.mark.parametrize("mean_pooling", [True, False])
def test_logits_match_jax(mean_pooling):
    jmodel = jcli.build_cls_model(
        jax_args(*([] if mean_pooling else ["--no_mean_pooling"])), jnp.float32)
    params = numpy_tree(jmodel.init({"params": jax.random.PRNGKey(1)},
                                    {"rgb": jnp.zeros((2, S, S, 3))})["params"])
    x, _ = batch_np()
    ref = np.asarray(jmodel.apply({"params": params}, {"rgb": jnp.asarray(x)},
                                  train=False)["cls"])
    logits = make_cls_eval_step(port_model(params, mean_pooling))({"rgb": torch.from_numpy(x)})
    assert tuple(logits.shape) == (B, CLASSES)
    np.testing.assert_allclose(logits.numpy(), ref, rtol=0, atol=5e-4 * np.abs(ref).max())


def test_converter_matches_jax_exporter(jax_model):
    params = jax_model[1]
    ref = params_to_state_dict(params, proj_shapes=PROJ_SHAPES)
    got = jax_params_to_state_dict(params, PROJ_SHAPES)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["output_adapters.cls.head.weight"].shape == (CLASSES, 64)
    assert got["output_adapters.cls.norm.weight"].shape == (64,)


@pytest.mark.parametrize("name", ["label_smoothing", "soft_target", "plain"])
def test_losses_match_jax(name, soft_batch):
    rng = np.random.default_rng(7)
    logits = (3 * rng.standard_normal((B, CLASSES))).astype(np.float32)
    y = rng.integers(0, CLASSES, B)
    if name == "label_smoothing":
        ref = jce.label_smoothing_cross_entropy(jnp.asarray(logits), jnp.asarray(y), 0.1)
        got = tce.label_smoothing_cross_entropy(torch.from_numpy(logits), torch.from_numpy(y),
                                                0.1)
    elif name == "soft_target":
        ref = jce.soft_target_cross_entropy(jnp.asarray(logits), jnp.asarray(soft_batch[1]))
        got = tce.soft_target_cross_entropy(torch.from_numpy(logits),
                                            torch.from_numpy(soft_batch[1]))
    else:
        ref = jce.cross_entropy(jnp.asarray(logits), jnp.asarray(y))
        got = tce.cross_entropy(torch.from_numpy(logits), torch.from_numpy(y))
    assert abs(float(got) - float(ref)) <= 1e-6, (float(got), float(ref))


MIXUPS = {
    "batch": dict(mixup_alpha=0.8, cutmix_alpha=1.0),
    "batch_mixup_only": dict(mixup_alpha=0.8, cutmix_alpha=0.0),
    "batch_cutmix_only": dict(mixup_alpha=0.0, cutmix_alpha=1.0),
    "batch_minmax": dict(mixup_alpha=0.8, cutmix_alpha=1.0, cutmix_minmax=(0.2, 0.8)),
    "pair": dict(mixup_alpha=0.8, cutmix_alpha=1.0, mode="pair"),
    "elem": dict(mixup_alpha=0.8, cutmix_alpha=1.0, mode="elem"),
    "elem_minmax": dict(mixup_alpha=0.8, cutmix_alpha=1.0, mode="elem",
                        cutmix_minmax=(0.3, 0.7), prob=0.7),
}


@pytest.mark.parametrize("kind", sorted(MIXUPS))
def test_mixup_equals_jax(kind):
    kw = dict(MIXUPS[kind], label_smoothing=0.1, num_classes=CLASSES, seed=11)
    ref, port = jmixup.Mixup(**kw), Mixup(**kw)
    rng = np.random.default_rng(5)
    for _ in range(6):  # the draws stay aligned batch after batch
        x = rng.standard_normal((6, 16, 12, 3)).astype(np.float32)
        y = rng.integers(0, CLASSES, 6)
        rx, ry = ref(x, y)
        px, py = port(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_array_equal(px.numpy(), rx)
        np.testing.assert_array_equal(py.numpy(), ry)


def jax_state(jmodel, params, opt, ema_decay=None, update_freq=1):
    tx = jcreate(params, opt=opt, lr_schedule=as_optax_schedule(LR),
                 wd_schedule=as_optax_schedule(WD), opt_betas=(0.9, 0.999),
                 layer_decay_assigner=JLDVA(LAYER_VALUES), filter_bias_and_bn=True)
    if update_freq > 1:
        import optax

        tx = optax.MultiSteps(tx, every_k_schedule=update_freq)
    state = JTrainState.create(params=params, tx=tx, ema_decay=ema_decay)
    step = jax.jit(jfs.make_cls_train_step(jmodel, jce.soft_target_cross_entropy,
                                           ema_decay=ema_decay))
    return state, step


def port_state(params, opt, ema_decay=None, update_freq=1):
    model = port_model(params)
    optimizer = create_optimizer(model, opt=opt, opt_betas=(0.9, 0.999),
                                 filter_bias_and_bn=True,
                                 layer_decay_assigner=LayerDecayValueAssigner(LAYER_VALUES))
    state = TrainState(model, None, optimizer, LR, WD, update_freq=update_freq,
                       ema_decay=ema_decay)
    return state, make_cls_train_step(model, tce.soft_target_cross_entropy)


def test_first_step_matches_jax(jax_model, soft_batch):
    jmodel, params = jax_model
    x, y = soft_batch
    jstate, jstep = jax_state(jmodel, params, "adamw")

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, {"rgb": jnp.asarray(x)}, train=True)["cls"]
        return jce.soft_target_cross_entropy(logits, jnp.asarray(y))

    jgrads = jax_params_to_state_dict(numpy_tree(jax.jit(jax.grad(loss_fn))(params)),
                                      PROJ_SHAPES)
    _, jm = jstep(jstate, {"rgb": jnp.asarray(x), "target": jnp.asarray(y)},
                  jax.random.PRNGKey(0))
    state, step = port_state(params, "adamw")
    m = step(state, {"rgb": torch.from_numpy(x), "target": torch.from_numpy(y)})
    for k in ("loss", "grad_norm"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])), k
    named = dict(state.model.named_parameters())
    assert set(jgrads) == set(named)
    for k, v in jgrads.items():
        np.testing.assert_allclose(named[k].grad.numpy(), v, rtol=0,
                                   atol=2e-5 * np.abs(v).max(), err_msg=k)


def run_both(jax_model, soft_batch, opt, steps, **kw):
    jmodel, params = jax_model
    x, y = soft_batch
    jstate, jstep = jax_state(jmodel, params, opt, **kw)
    state, step = port_state(params, opt, **kw)
    for _ in range(steps):
        jstate, _ = jstep(jstate, {"rgb": jnp.asarray(x), "target": jnp.asarray(y)},
                          jax.random.PRNGKey(0))
        step(state, {"rgb": torch.from_numpy(x), "target": torch.from_numpy(y)})
    return jstate, state


def test_ema_after_three_steps_matches_jax(jax_model, soft_batch):
    jstate, state = run_both(jax_model, soft_batch, "sgd", 3, ema_decay=0.9)
    ref = jax_params_to_state_dict(numpy_tree(jstate.ema_params), PROJ_SHAPES)
    assert set(ref) == set(state.ema)
    moved = 0.0
    for k, v in ref.items():
        np.testing.assert_allclose(state.ema[k].numpy(), v, rtol=0, atol=1e-6, err_msg=k)
        moved = max(moved, float(np.abs(v - jax_params_to_state_dict(
            jax_model[1], PROJ_SHAPES)[k]).max()))
    assert moved > 1e-4  # the EMA did move, far past the tolerance


def test_host_ema_equals_the_device_ema(jax_model, soft_batch):
    state, step = port_state(jax_model[1], "sgd", ema_decay=0.9)
    host = HostEMA(state.model, 0.9)
    x, y = soft_batch
    for _ in range(3):
        step(state, {"rgb": torch.from_numpy(x), "target": torch.from_numpy(y)})
        host.update()
    for k, v in state.ema.items():
        torch.testing.assert_close(host.params[k], v, rtol=0, atol=0)
    saved = {k: v.clone() for k, v in host.params.items()}
    other = HostEMA(state.model, 0.9)
    other.load(saved)
    assert all(torch.equal(other.params[k], saved[k]) for k in saved)


def test_skipped_step_leaves_ema_and_params(jax_model, soft_batch):
    state, step = port_state(jax_model[1], "adamw", ema_decay=0.9)
    x, _ = soft_batch
    before = {k: v.clone() for k, v in state.ema.items()}
    bad = np.full((B, CLASSES), np.nan, np.float32)
    m = step(state, {"rgb": torch.from_numpy(x), "target": torch.from_numpy(bad)})
    assert m["skipped"] == 1.0 and (state.step, state.updates) == (1, 0)
    assert all(torch.equal(before[k], state.ema[k]) for k in before)


def test_update_freq_matches_multisteps(jax_model, soft_batch):
    jstate, state = run_both(jax_model, soft_batch, "sgd", 4, update_freq=2)
    ref = jax_params_to_state_dict(numpy_tree(jstate.params), PROJ_SHAPES)
    got = state.model.state_dict()
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, rtol=0, atol=1e-6, err_msg=k)
    assert (state.step, state.updates, state.mini_step) == (4, 2, 0)


@pytest.mark.parametrize("opt", ["adamw", "adam", "sgd", "nesterov", "momentum"])
def test_optimizer_matches_optax(jax_model, opt):
    """Three updates of fixed random gradients through the layer-decay
    groups and the LR and WD schedules."""
    jmodel, params = jax_model
    jstate, _ = jax_state(jmodel, params, opt)
    state, _ = port_state(params, opt)
    rng = np.random.default_rng(2)
    named = dict(state.model.named_parameters())
    for _ in range(3):
        jgrads = jax.tree.map(lambda p: rng.standard_normal(np.shape(p)).astype(np.float32),
                              params)
        for k, g in jax_params_to_state_dict(jgrads, PROJ_SHAPES).items():
            named[k].grad = torch.from_numpy(g)
        state.apply_gradients(False)
        jstate = jstate.apply_gradients(jax.tree.map(jnp.asarray, jgrads))
    ref = jax_params_to_state_dict(numpy_tree(jstate.params), PROJ_SHAPES)
    init = jax_params_to_state_dict(params, PROJ_SHAPES)
    for k, v in ref.items():
        np.testing.assert_allclose(named[k].detach().numpy(), v, rtol=0, atol=1e-6, err_msg=k)
        if not k.endswith("pos_emb"):
            assert np.abs(v - init[k]).max() > 1e-5, k  # every trained tensor moved


def test_accuracy_equals_jax():
    rng = np.random.default_rng(4)
    logits = rng.integers(0, 4, (64, 10)).astype(np.float32)  # many ties
    y = rng.integers(0, 10, 64)
    for topk in [(1, 5), (1, 2, 3)]:
        ref = jmetrics.accuracy(jnp.asarray(logits), jnp.asarray(y), topk=topk)
        got = metrics.accuracy(torch.from_numpy(logits), torch.from_numpy(y), topk=topk)
        assert [float(v) for v in got] == [float(v) for v in ref]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    x = torch.ones(200, 500)
    out = dropout(x, rate, True, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / (1 - rate)))
    assert dropout(x, rate, False, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, rate, True, None)


def test_attention_dropout_path():
    """attn_drop > 0 in training takes the dense path and drops probabilities;
    in eval the module equals one without dropout."""
    torch.manual_seed(0)
    a = Attention(32, 4, attn_drop=0.5)
    plain = Attention(32, 4)
    for m in (a, plain):
        m.qkv.reset_parameters(torch.Generator().manual_seed(1))
        m.proj.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.randn(2, 7, 32)
    a.eval(), plain.eval()
    torch.testing.assert_close(a(x), plain(x), rtol=0, atol=0)
    a.train(), plain.train()
    g = torch.Generator().manual_seed(3)
    dropped = a(x, g)
    assert not torch.allclose(dropped, plain(x))
    again = a(x, torch.Generator().manual_seed(3))
    torch.testing.assert_close(dropped, again, rtol=0, atol=0)
