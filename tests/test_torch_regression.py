"""The port's dense regression pieces against the JAX package on the CPU:
train/regression_losses.py, utils/metrics.py `depth_metrics`, the dense
step with mask_valid (train/finetune_step.py) and the NYU augmentations
(data/regression_transforms.py).

* masked MSE, L1 and berhu, over 3-channel preds with no mask, a 1-channel
  mask broadcast over the channels, a 3-channel mask, and every pixel
  invalid: the loss and its gradient within 1e-6 of the JAX function's
  (relative to the largest); berhu's c / 2 on the invalid pixels stays
  masked out;
* `masked_nyu_metrics` and `depth_metrics` within 1e-6;
* three AdamW steps of the tiny MultiViT with the DPT regression head
  hooking its first block only (so the second block is a parameter set
  the loss never reaches), the berhu loss against mask_valid, layer decay
  and a weight decay large enough to move the unused block: loss and grad
  norm within 1e-4 relative of the JAX `make_dense_train_step`; the
  unused block gets zero gradients and is decayed as in JAX, within 2e-5
  of each tensor's largest value; every other parameter within the
  updated-parameter bounds of tests/test_torch_train_step.py (every
  element within 2.5e-3, the median within 2e-6, at most 0.5% of the
  elements, or two, beyond it; the attention's key bias, whose exact
  gradient is 0, held to the 2.5e-3 alone). A per-tensor 2e-5 of the
  largest value does not hold for Adam: an element whose gradient is as
  small as the two frameworks' difference moves by up to lr (measured
  here: 7.3e-4 of the tensor's largest in one element of 2560, 4.7% of an
  MLP bias's elements beyond it, medians within 8e-6); the batch keeps every
  ReLU input of the DPT head and every valid loss residual (the kinks of
  the gradient) at least 5e-7 of its tensor's largest away from zero in
  all three steps, asserted: nearer, the fp32 rounding of either forward
  decides the branch (seed 7 put one ReLU input at 1.4e-7 of its largest,
  inside that rounding, and the port's fp32 forward took the other side);
* NYUTransform train (colour jitter and ToGray on) and eval through
  DataAugmentationForRegression, native and numpy twin, bit-equal to the
  JAX transform (cv2) under one seeded random.Random.
"""

import functools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.data import regression_transforms as jrt
from multimae_tpu.models import DPTOutputAdapter as JDPT
from multimae_tpu.models import PatchedInputAdapter as JPatched
from multimae_tpu.models.registry import create_model as jcreate
from multimae_tpu.train import finetune_step as jfs
from multimae_tpu.train import regression_losses as jrl
from multimae_tpu.train.optim_factory import LayerDecayValueAssigner as JLDVA
from multimae_tpu.train.optim_factory import create_optimizer as jcreate_opt
from multimae_tpu.train.schedules import as_optax_schedule, cosine_scheduler
from multimae_tpu.train.train_state import TrainState as JTrainState
from multimae_tpu.utils import metrics as jmetrics
from multimae_tpu_torch.data import regression_transforms as rt
from multimae_tpu_torch.models import DPTOutputAdapter, PatchedInputAdapter
from multimae_tpu_torch.models.registry import create_model
from multimae_tpu_torch.train import regression_losses as rl
from multimae_tpu_torch.train.finetune_step import make_dense_train_step
from multimae_tpu_torch.train.optim_factory import LayerDecayValueAssigner, create_optimizer
from multimae_tpu_torch.train.train_state import TrainState
from multimae_tpu_torch.utils import metrics
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict

S = 64
MASKS = ["none", "one_channel", "three_channels", "all_invalid"]


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


def loss_inputs(mask_kind, seed=0):
    rng = np.random.default_rng(seed)
    preds = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    target = rng.standard_normal((2, 8, 10, 3)).astype(np.float32)
    preds[0, 1, 2, 0] += 9.0  # a large error sets berhu's threshold
    mask = {"none": None,
            "one_channel": rng.random((2, 8, 10, 1)) > 0.3,
            "three_channels": rng.random((2, 8, 10, 3)) > 0.3,
            "all_invalid": np.zeros((2, 8, 10, 1), bool)}[mask_kind]
    return preds, target, mask


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("name", ["mse", "l1", "berhu"])
def test_losses_and_gradients_match_jax(name, mask_kind):
    preds, target, mask = loss_inputs(mask_kind)
    jfn = jrl.LOSSES[name]
    jm = None if mask is None else jnp.asarray(mask)
    ref, jgrad = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(target), jm))(
        jnp.asarray(preds))
    tp = torch.from_numpy(preds).requires_grad_()
    tm = None if mask is None else torch.from_numpy(mask)
    parts = rl.LOSS_PARTS[name](tp, torch.from_numpy(target), tm)
    loss = parts[0] / parts[1].clamp_min(1)
    loss.backward()
    assert float(loss) == pytest.approx(float(ref), rel=1e-6, abs=1e-7)
    assert float(getattr(rl, f"masked_{name}_loss")(tp, torch.from_numpy(target), tm)) == \
        float(loss)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(tp.grad.numpy(), jgrad, rtol=0,
                               atol=1e-6 * max(np.abs(jgrad).max(), 1e-30))
    if mask_kind == "all_invalid":
        assert float(loss) == 0.0 and not tp.grad.any()


@pytest.mark.parametrize("mask_kind", ["none", "one_channel"])
def test_metrics_match_jax(mask_kind):
    rng = np.random.default_rng(1)
    preds = rng.standard_normal((2, 12, 9, 1)).astype(np.float32)
    target = (rng.standard_normal((2, 12, 9, 1)) * 0.5).astype(np.float32)
    mask = None if mask_kind == "none" else rng.random((2, 12, 9, 1)) > 0.25
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref = jrl.masked_nyu_metrics(jnp.asarray(preds), jnp.asarray(target), jm)
    got = rl.masked_nyu_metrics(torch.from_numpy(preds), torch.from_numpy(target), tm)
    assert set(got) == set(ref)
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-6, abs=1e-7), k
    depth_p = np.exp(preds).astype(np.float32)  # metric depths in metres
    depth_t = np.exp(target).astype(np.float32)
    ref = jmetrics.depth_metrics(jnp.asarray(depth_p), jnp.asarray(depth_t), jm)
    got = metrics.depth_metrics(torch.from_numpy(depth_p), torch.from_numpy(depth_t), tm)
    assert set(got) == set(ref)
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-6, abs=1e-7), k


# ----------------------------------------------------------- the depth step --

HOOKS = (0, 0, 0, 0)  # encoder block 1 is never reached by the loss
LR = cosine_scheduler(1e-3, 1e-5, epochs=1, niter_per_ep=3)
WD = cosine_scheduler(0.5, 0.4, epochs=1, niter_per_ep=3)
LAYER_VALUES = [0.75 ** (2 + 1 - i) for i in range(2 + 2)]
DPT_KW = dict(num_classes=1, main_tasks=("rgb",), hooks=HOOKS, layer_dims=(16, 24, 32, 40),
              feature_dim=32, head_type="regression")


# A ReLU input or a loss residual within fp32 rounding of its kink leaves
# the gradient to rounding: the two frameworks' fp32 forwards may put it on
# either side (with seed 7, a DPT ReLU input at 1.4e-7 of its tensor's
# largest flipped sign and moved the step-2 loss by 1.6e-4;
# tests/_torch_precision_probe.py measures the margins). Every kink input
# of this batch's three steps stays KINK_MARGIN of its largest away.
KINK_MARGIN = 5e-7


def depth_batch():
    rng = np.random.default_rng(4)
    return {"rgb": rng.standard_normal((2, S, S, 3)).astype(np.float32),
            "target": rng.standard_normal((2, S, S, 1)).astype(np.float32),
            "mask_valid": rng.random((2, S, S, 1)) > 0.2}


def test_depth_steps_match_jax(monkeypatch):
    jm = jcreate("multivit_tiny", input_adapters={"rgb": functools.partial(
        JPatched, num_channels=3, stride_level=1, patch_size_full=16, image_size=S)},
        output_adapters={"depth": functools.partial(JDPT, **DPT_KW)})
    b = depth_batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    params = jax.jit(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                     {"rgb": jb["rgb"]})["params"])()
    params = jax.tree.map(np.array, params)
    tx = jcreate_opt(params, opt="adamw", lr_schedule=as_optax_schedule(LR),
                     wd_schedule=as_optax_schedule(WD), opt_betas=(0.9, 0.999),
                     layer_decay_assigner=JLDVA(LAYER_VALUES), filter_bias_and_bn=True)
    jstate = JTrainState.create(params=jax.tree.map(jnp.asarray, params), tx=tx)
    jstep = jax.jit(jfs.make_dense_train_step(jm, "depth", jrl.masked_berhu_loss,
                                              in_domains=("rgb",), needs_target_kwargs=True))

    model = create_model("multivit_tiny", input_adapters={"rgb": functools.partial(
        PatchedInputAdapter, num_channels=3, stride_level=1, patch_size_full=16,
        image_size=S)}, output_adapters={"depth": functools.partial(DPTOutputAdapter,
                                                                    **DPT_KW)})
    sd = jax_params_to_state_dict(params, {"rgb": (3, 16, 16)})
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    for name, p in model.named_parameters():
        if name.endswith("pos_emb"):
            p.requires_grad_(True)
    opt = create_optimizer(model, opt_betas=(0.9, 0.999), filter_bias_and_bn=True,
                           layer_decay_assigner=LayerDecayValueAssigner(LAYER_VALUES))
    state = TrainState(model, None, opt, LR, WD)
    margins = []

    def margin(x):
        a = x.detach().abs()
        margins.append(float(a.min() / a.max()))

    def relu(x, inplace=False):
        margin(x)
        return torch.relu(x)

    def berhu_parts(preds, target, mask_valid):
        margin((preds - target)[mask_valid.expand_as(preds)])  # the L1 branch's kink
        return rl.masked_berhu_loss_parts(preds, target, mask_valid)

    monkeypatch.setattr(torch.nn.functional, "relu", relu)
    step = make_dense_train_step(model, "depth", berhu_parts, in_domains=("rgb",))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for _ in range(3):
        jstate, jmetrics_ = jstep(jstate, jb, jax.random.PRNGKey(0))
        tm = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jmetrics_[k])) <= 1e-4 * abs(float(jmetrics_[k])), k
    assert len(margins) == 3 * 16 and min(margins) >= KINK_MARGIN, min(margins)
    ref = jax_params_to_state_dict(jax.tree.map(np.asarray, jstate.params), {"rgb": (3, 16, 16)})
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(ref)
    unused = [k for k in got if k.startswith("encoder.1.")]
    assert len(unused) == 12
    for k in unused:
        assert float(model.get_parameter(k).grad.abs().max()) == 0.0, k
        if k.endswith("weight") and got[k].ndim == 2:  # decayed, as in JAX
            assert not np.array_equal(got[k], before[k].numpy()), k
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=2e-5 * np.abs(ref[k]).max(),
                                   err_msg=k)
    for k, v in ref.items():
        if k.endswith("pos_emb"):  # frozen on both sides
            np.testing.assert_array_equal(got[k], before[k].numpy(), err_msg=k)
            continue
        d = np.abs(got[k] - v)
        assert d.max() <= 2.5e-3, (k, d.max())
        if k.endswith("attn.qkv.bias"):  # the key part's exact gradient is 0
            d = np.delete(d, np.arange(v.shape[0])[v.shape[0] // 3:2 * v.shape[0] // 3])
        assert np.median(d) <= 2e-6, (k, np.median(d))
        assert np.sum(d > 2e-6) <= max(2, d.size // 200), (k, np.sum(d > 2e-6), d.size)


# ------------------------------------------------------ the NYU transforms --

def nyu_sample(seed):
    rng = np.random.default_rng(seed)
    h, w = 60, 80
    valid = np.full((h, w), 255, np.uint8)
    valid[rng.integers(0, h // 2):, :rng.integers(1, w)] = 0
    return {"rgb": rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            "depth": rng.integers(500, 9000, (h, w)).astype(np.uint16),
            "mask_valid": valid}


@pytest.mark.parametrize("twin", [False, True], ids=["native", "twin"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_nyu_transform_bit_equal_to_jax(train, twin):
    port = rt.DataAugmentationForRegression(rt.NYUTransform(train, 32, color_aug=True,
                                                            twin=twin))
    ref = jrt.DataAugmentationForRegression(jrt.NYUTransform(train, 32, color_aug=True))
    for seed in range(12):
        sample = nyu_sample(seed)
        got = port(sample, rng=random.Random(seed))
        want = ref(sample, rng=random.Random(seed))
        assert set(got) == set(want) == {"rgb", "depth", "mask_valid"}
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"seed {seed} {k}")
        assert got["rgb"].shape == (32, 32, 3) and got["depth"].shape == (32, 32, 1)
