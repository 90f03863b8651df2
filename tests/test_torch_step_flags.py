"""The pretraining step's recipe flags (the JAX step's arguments, its
multimae_tpu/train/pretrain_step.py:92-104) in the port against the JAX
package: `loss_on_unmasked`, no `standardize_depth`, no
`extra_norm_pix_loss`, and `in_domains` a subset of `out_domains`. One
fp32 step of the tiny MultiMAE (decoders of depth 1) from the same
parameters with fixed masks on each side: losses, weighted losses and the
grad norm within 1e-4 relative, the bar of tests/test_torch_train_step.py
(the JAX decoders in "ref" mode, its bisect standardize_depth patched to
method="sort").
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimae_tpu.cli import factory as jfactory
from multimae_tpu.ops import fused_decoder_pallas as fdp
from multimae_tpu.train import pretrain_step as jps
from multimae_tpu.train.optim_factory import create_optimizer as jcreate
from multimae_tpu.train.schedules import as_optax_schedule
from multimae_tpu.train.task_balancing import build_balancer as jbuild_balancer
from multimae_tpu.train.train_state import TrainState as JTrainState
from multimae_tpu_torch.cli import factory as tfactory
from multimae_tpu_torch.train.optim_factory import create_optimizer
from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step
from multimae_tpu_torch.train.task_balancing import build_balancer
from multimae_tpu_torch.train.train_state import TrainState
from multimae_tpu_torch.utils.convert import jax_train_params_to_state_dicts

PROJ_SHAPES = {"rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)}
TINY = dict(model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
            decoder_num_heads=4, decoder_depth=1, decoder_return_patches=True)
B = 2


CASES = {
    "loss_on_unmasked": dict(loss_on_unmasked=True),
    "no_standardize_depth": dict(standardize_depth_flag=False),
    "no_extra_norm_pix_loss": dict(extra_norm_pix_loss=False),
    "in_domains_rgb": dict(in_domains=("rgb",)),
}


def _masks(in_domains, k):
    rng = np.random.default_rng(3)
    n = 16 * len(in_domains)
    masks = np.ones((B, n), np.int32)
    for i in range(B):
        masks[i, rng.permutation(n)[:k]] = 0
    return {t: masks[:, 16 * j:16 * (j + 1)] for j, t in enumerate(in_domains)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_flags_match_jax(case):
    kw = dict(CASES[case])
    in_domains = kw.get("in_domains", ("rgb", "depth", "semseg"))
    extra = kw.get("extra_norm_pix_loss", True)
    k = 8 if len(in_domains) == 1 else 24
    tasks = ("rgb", "depth", "semseg") + (("norm_rgb",) if extra else ())
    model = jfactory.build_pretrain_model(**TINY, in_domains=in_domains, extra_norm_pix_loss=extra)
    batch = jfactory.make_synthetic_batch(B, input_size=64, seed=1)
    mparams = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        {t: v for t, v in batch.items() if t in in_domains}, num_encoded_tokens=k)["params"])()
    log_vars = np.linspace(-0.2, 0.3, len(tasks)).astype(np.float32)
    params = {"model": mparams, "balancer": {"log_vars": jnp.asarray(log_vars)}}
    lr = np.full(4, 1e-3, np.float32)
    tx = jcreate(params, opt="adamw", lr_schedule=as_optax_schedule(lr),
                 opt_betas=(0.9, 0.95), filter_bias_and_bn=False)
    jstep = jps.make_pretrain_train_step(
        model, jbuild_balancer("uncertainty", tasks),
        jfactory.build_pretrain_losses(("rgb", "depth", "semseg"), extra_norm_pix_loss=extra),
        num_encoded_tokens=k, **kw)
    masks = _masks(in_domains, k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, "standardize_depth", functools.partial(jps.standardize_depth,
                                                               method="sort"))
        fdp.set_force_mode("ref")
        try:
            _, jm = jax.jit(jstep)(JTrainState.create(params=params, tx=tx), batch,
                                   jax.random.PRNGKey(0),
                                   {t: jnp.asarray(m) for t, m in masks.items()})
        finally:
            fdp.set_force_mode(None)
    jm = {key: float(v) for key, v in jm.items()}

    tmodel = tfactory.build_pretrain_model(**TINY, in_domains=in_domains,
                                           extra_norm_pix_loss=extra, pos_emb_grads=True,
                                           device="cpu")
    balancer = build_balancer("uncertainty", tasks)
    sds = jax_train_params_to_state_dicts(jax.tree.map(np.asarray, params), PROJ_SHAPES)
    tmodel.load_state_dict({n: torch.from_numpy(np.array(v)) for n, v in sds["model"].items()},
                           strict=True)
    balancer.load_state_dict({n: torch.from_numpy(v) for n, v in sds["balancer"].items()})
    state = TrainState(tmodel, balancer, create_optimizer(
        tmodel, balancer, opt_betas=(0.9, 0.95), filter_bias_and_bn=False), lr)
    step = make_pretrain_train_step(
        tmodel, balancer, tfactory.build_pretrain_losses(("rgb", "depth", "semseg"),
                                                         extra_norm_pix_loss=extra),
        num_encoded_tokens=k, **kw)
    tbatch = tfactory.make_synthetic_batch(B, input_size=64, seed=1, device="cpu")
    tm = step(state, tbatch, task_masks={t: torch.from_numpy(m) for t, m in masks.items()})
    keys = ["loss", "grad_norm"] + [f"{t}_loss{w}" for t in tasks for w in ("", "_weighted")]
    assert set(keys) <= set(tm) and set(keys) <= set(jm)
    for key in keys:
        assert abs(float(tm[key]) - jm[key]) <= 1e-4 * abs(jm[key]), (key, float(tm[key]), jm[key])
