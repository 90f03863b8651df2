"""The port's checkpoints (multimae_tpu_torch/train/checkpoint.py).

The tiny MultiMAE (dim 64, 64 px) with the uncertainty balancer and AdamW
takes a step on the CPU, then:
* a save followed by a load into a differently initialised state restores
  the model, the balancer, the optimizer (moments and step counts) and the
  counters exactly, and the next step matches bit for bit;
* auto-resume skips a damaged newest save (truncated, not a checkpoint at
  all, a model of other shapes, a save without its optimizer) and resumes
  from the one before; it starts fresh where there is none and raises
  where every save is damaged;
* the `model` entry of the port's checkpoint-{epoch}.pth loads through the
  JAX package's own `load_checkpoint(path.pth, state)` (its
  reference-format warm start) into parameters whose forward matches the
  port's within 5e-4 (fp32, fixed masks; the JAX decoders in "ref" mode,
  the Pallas kernels' math: the GELU and LayerNorm differences of
  tests/test_torch_multimae.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.cli import factory as jfactory
from multimae_tpu.ops import fused_decoder_pallas as fdp
from multimae_tpu.train import checkpoint as jckpt
from multimae_tpu.train.optim_factory import create_optimizer as jcreate
from multimae_tpu.train.schedules import as_optax_schedule
from multimae_tpu.train.task_balancing import build_balancer as jbuild_balancer
from multimae_tpu.train.train_state import TrainState as JTrainState
from multimae_tpu_torch.cli import factory as tfactory
from multimae_tpu_torch.train import checkpoint as ckpt
from multimae_tpu_torch.train.optim_factory import create_optimizer
from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step
from multimae_tpu_torch.train.schedules import cosine_scheduler
from multimae_tpu_torch.train.task_balancing import build_balancer
from multimae_tpu_torch.train.train_state import TrainState

TINY = dict(model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
            decoder_num_heads=4, decoder_depth=2)
TASKS = ("rgb", "depth", "semseg", "norm_rgb")
B, K = 2, 24


def fixed_masks(batch=B, seed=3):
    rng = np.random.default_rng(seed)
    masks = np.ones((batch, 48), np.int64)
    for i in range(batch):
        masks[i, rng.permutation(48)[:K]] = 0
    return {t: torch.from_numpy(masks[:, 16 * j:16 * (j + 1)])
            for j, t in enumerate(("rgb", "depth", "semseg"))}


def make_state(seed=0, decoder_dim=64):
    model = tfactory.build_pretrain_model(**dict(TINY, decoder_dim=decoder_dim),
                                          decoder_return_patches=True, seed=seed, device="cpu")
    balancer = build_balancer("uncertainty", TASKS)
    opt = create_optimizer(model, balancer, opt_betas=(0.9, 0.95), filter_bias_and_bn=False)
    state = TrainState(model, balancer, opt, cosine_scheduler(1e-3, 0.0, 2, 4),
                       cosine_scheduler(0.05, 0.1, 2, 4))
    step = make_pretrain_train_step(model, balancer, tfactory.build_pretrain_losses(
        ("rgb", "depth", "semseg")), num_encoded_tokens=K)
    return state, step


def batch():
    return tfactory.make_synthetic_batch(B, input_size=64, seed=1, device="cpu")


def assert_states_equal(a, b):
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    assert torch.equal(a.balancer.log_vars, b.balancer.log_vars)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert (a.step, a.updates) == (b.step, b.updates)


@pytest.fixture
def trained(tmp_path):
    state, step = make_state()
    step(state, batch(), task_masks=fixed_masks())
    return state, step, str(tmp_path)


def test_save_load_round_trip(trained):
    state, step, out = trained
    path = ckpt.save_checkpoint(out, 3, state, args={"lr": 1e-3, "opt_betas": [0.9, 0.95]},
                                data_iter_state={"seed": 0, "epoch": 3, "batch": 2})
    assert path.endswith("checkpoint-3.pth") and ckpt.latest_checkpoint(out) == path
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert {"model", "optimizer", "epoch", "loss_balancer", "args", "step", "updates",
            "data_iter_state"} <= set(payload)
    other, other_step = make_state(seed=5)
    epoch, loaded = ckpt.load_checkpoint(path, other)
    assert epoch == 3 and loaded["data_iter_state"] == {"seed": 0, "epoch": 3, "batch": 2}
    assert_states_equal(state, other)
    m1 = step(state, batch(), task_masks=fixed_masks(seed=4))
    m2 = other_step(other, batch(), task_masks=fixed_masks(seed=4))
    assert all(torch.equal(torch.as_tensor(m1[k]), torch.as_tensor(m2[k])) for k in m1)
    assert_states_equal(state, other)


def _truncate(path):
    data = open(path, "rb").read()
    open(path, "wb").write(data[:len(data) // 2])


def _garbage(path):
    open(path, "wb").write(b"not a checkpoint")


def _other_shapes(path):
    other, _ = make_state(decoder_dim=32)
    torch.save(dict(other.state_dict(), epoch=1, args={}), path)


def _no_optimizer(path):
    payload = torch.load(path, map_location="cpu", weights_only=True)
    del payload["optimizer"]
    torch.save(payload, path)


@pytest.mark.parametrize("damage", [_truncate, _garbage, _other_shapes, _no_optimizer])
def test_damaged_newest_save_falls_back_one_epoch(trained, damage):
    state, step, out = trained
    ckpt.save_checkpoint(out, 0, state)
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    step(state, batch(), task_masks=fixed_masks(seed=4))
    newest = ckpt.save_checkpoint(out, 1, state)
    damage(newest)
    fresh, _ = make_state(seed=7)
    start, payload = ckpt.auto_load_checkpoint(out, fresh)
    assert start == 1 and payload["epoch"] == 0 and fresh.step == 1
    assert all(torch.equal(v, saved[k]) for k, v in fresh.model.state_dict().items())


def test_every_save_damaged_raises(trained):
    state, _, out = trained
    for e in (0, 1):
        _truncate(ckpt.save_checkpoint(out, e, state))
    with pytest.raises(RuntimeError, match="every checkpoint"):
        ckpt.auto_load_checkpoint(out, make_state()[0])


def test_no_save_starts_fresh(tmp_path):
    state, _ = make_state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    assert ckpt.auto_load_checkpoint(str(tmp_path), state) == (0, {})
    assert all(torch.equal(v, before[k]) for k, v in state.model.state_dict().items())


def test_candidates_newest_epoch_first(tmp_path):
    for e in (2, 10, 1):
        (tmp_path / f"checkpoint-{e}.pth").write_bytes(b"")
    (tmp_path / "checkpoint-3.pth.tmp").write_bytes(b"")
    assert [p.rsplit("/", 1)[1] for p in ckpt.checkpoint_candidates(str(tmp_path))] == [
        "checkpoint-10.pth", "checkpoint-2.pth", "checkpoint-1.pth"]


def test_port_pth_loads_into_the_jax_package(trained):
    """The port's save warm-starts the JAX model (its reference-format
    .pth path) to the same forward."""
    state, _, out = trained
    path = ckpt.save_checkpoint(out, 4, state)
    jmodel = jfactory.build_pretrain_model(**TINY)
    jbatch = jfactory.make_synthetic_batch(B, input_size=64, seed=1)
    init = jax.jit(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(9), "masking": jax.random.PRNGKey(1)},
        jbatch, num_encoded_tokens=K)["params"])()
    params = {"model": init, "balancer": {"log_vars": jnp.zeros(4)}}
    tx = jcreate(params, opt="adamw", lr_schedule=as_optax_schedule(np.full(8, 1e-3)),
                 filter_bias_and_bn=False)
    jstate, epoch = jckpt.load_checkpoint(path, JTrainState.create(params=params, tx=tx))
    assert epoch == 4
    masks = fixed_masks()
    fdp.set_force_mode("ref")
    try:
        jpreds, _ = jax.jit(lambda p, x, m: jmodel.apply(
            {"params": p}, x, task_masks=m, num_encoded_tokens=K))(
                jstate.params["model"], jbatch,
                {t: jnp.asarray(m.numpy()) for t, m in masks.items()})
    finally:
        fdp.set_force_mode(None)
    state.model.eval()
    tmodel = tfactory.build_pretrain_model(**TINY, seed=3, device="cpu").eval()
    tmodel.load_state_dict(state.model.state_dict())
    with torch.no_grad():
        tpreds, _ = tmodel(batch(), num_encoded_tokens=K, task_masks=masks)
    assert set(tpreds) == set(jpreds)
    for t in tpreds:
        err = float(np.abs(np.asarray(jpreds[t]) - tpreds[t].numpy()).max())
        assert err <= 5e-4, (t, err)
