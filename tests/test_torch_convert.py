"""utils/convert.jax_params_to_state_dict against the JAX package's own
exporter (multimae_tpu.utils.torch_compat.params_to_state_dict), a strict
load of the result into the port's model, and the round trip of the JAX
TrainState's {"model", "balancer"} params through the port's modules."""

import jax
import numpy as np
import pytest
import torch

from multimae_tpu.cli import factory as jfactory
from multimae_tpu.utils.torch_compat import params_to_state_dict
from multimae_tpu_torch.cli import factory as tfactory
from multimae_tpu_torch.train.task_balancing import build_balancer
from multimae_tpu_torch.utils.convert import (
    flax_path_to_torch_key,
    jax_params_to_state_dict,
    jax_train_params_to_state_dicts,
)

PROJ_SHAPES = {"rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)}
TINY = dict(model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
            decoder_num_heads=4, decoder_depth=2)


@pytest.fixture(scope="module")
def params():
    model = jfactory.build_pretrain_model(**TINY)
    batch = jfactory.make_synthetic_batch(2, input_size=64)
    p = jax.jit(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)},
        batch, num_encoded_tokens=24)["params"])()
    return jax.tree.map(np.array, p)


def test_matches_the_jax_exporter(params):
    ref = params_to_state_dict(params, proj_shapes=PROJ_SHAPES)
    out = jax_params_to_state_dict(params, PROJ_SHAPES)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_strict_load_into_the_port(params):
    sd = jax_params_to_state_dict(params, PROJ_SHAPES)
    model = tfactory.build_pretrain_model(**TINY, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    loaded = model.state_dict()
    assert set(loaded) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(loaded[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("path,key", [
    (("encoder_3", "norm1", "ln", "scale"), "encoder.3.norm1.weight"),
    (("output_adapters_rgb", "task_embeddings_depth"),
     "output_adapters.rgb.task_embeddings.depth"),
    (("output_adapters_semseg", "decoder_transformer_1", "mlp", "fc2", "kernel"),
     "output_adapters.semseg.decoder_transformer.1.mlp.fc2.weight"),
    (("input_adapters_semseg", "class_emb"), "input_adapters.semseg.class_emb.weight"),
])
def test_key_mapping(path, key):
    assert flax_path_to_torch_key(path) == key


def test_seeded_init_is_reproducible_and_complete():
    a = tfactory.build_pretrain_model(seed=3, **TINY, device="cpu").state_dict()
    b = tfactory.build_pretrain_model(seed=3, **TINY, device="cpu").state_dict()
    c = tfactory.build_pretrain_model(seed=4, **TINY, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.0.attn.qkv.weight"], c["encoder.0.attn.qkv.weight"])
    for k, v in a.items():
        assert torch.isfinite(v).all(), k
        if k.endswith(("qkv.weight", "fc1.weight", "proj.weight", "class_emb.weight",
                       "global_tokens", "task_embeddings.rgb")):
            assert v.abs().sum() > 0, f"{k} left uninitialised"


def test_train_params_round_trip_is_array_equal(params):
    """JAX {"model", "balancer": {"log_vars"}} -> state_dicts -> strict load
    into the port's model and balancer -> their state_dicts, array-equal,
    with the balancer's log_vars the JAX values."""
    tasks = ("rgb", "depth", "semseg", "norm_rgb")
    log_vars = np.array([0.1, -0.2, 0.3, 0.05], np.float32)
    sds = jax_train_params_to_state_dicts({"model": params,
                                           "balancer": {"log_vars": log_vars}}, PROJ_SHAPES)
    np.testing.assert_array_equal(sds["balancer"]["log_vars"], log_vars)
    modules = {"model": tfactory.build_pretrain_model(**TINY, device="cpu"),
               "balancer": build_balancer("uncertainty", tasks)}
    for name, module in modules.items():
        module.load_state_dict({k: torch.from_numpy(v) for k, v in sds[name].items()},
                               strict=True)
        back = module.state_dict()
        assert set(back) == set(sds[name])
        for k, v in sds[name].items():
            assert back[k].numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
