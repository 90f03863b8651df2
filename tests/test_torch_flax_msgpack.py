"""The port's flax msgpack reader and writer
(multimae_tpu_torch/utils/flax_msgpack.py), its inverse converter
(utils/convert.state_dict_to_jax_params) and the JAX-checkpoint starts
(utils/torch_compat.load_flax_start) against flax and the JAX package.

* A tiny MultiMAE checkpoint that `multimae_tpu.train.checkpoint.
  save_checkpoint` wrote, its AdamW opt_state included, reads leaf for leaf
  as flax reads it; so do bf16 leaves, chunked arrays (flax's
  MAX_CHUNK_SIZE made small), complex numbers, numpy scalars, uint64 and
  negative ints. `msgpack_serialize` writes flax's bytes for the same tree.
* The inverse converter gives each tiny model's flax tree (pretraining,
  cls, the ConvNeXt, Segmenter and DPT semseg heads): the JAX model's
  paths and shapes, and jax_params_to_state_dict of it is the state_dict.
* The cls start loads the leaves the JAX cls CLI's rule loads (applied here
  to the flax paths), the semseg start what `_load_flax_trunk` loads, each
  with JAX's N/M; a source leaf of another shape is skipped.
"""

import functools
import os

import flax.serialization as fs
import flax.traverse_util as ftu
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from multimae_tpu.cli import run_finetuning_cls as jcls
from multimae_tpu.cli import run_finetuning_semseg as jseg
from multimae_tpu.cli.factory import build_pretrain_model as jax_build_pretrain_model
from multimae_tpu.train.checkpoint import save_checkpoint
from multimae_tpu.train.train_state import TrainState
from multimae_tpu_torch.cli import run_finetuning_semseg as tseg
from multimae_tpu_torch.cli.factory import build_cls_model, build_pretrain_model
from multimae_tpu_torch.utils import flax_msgpack as fm
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict, state_dict_to_jax_params
from multimae_tpu_torch.utils.torch_compat import load_flax_start, proj_shapes_of

S = 32
DOMAINS = ["rgb", "depth", "semseg"]
SEMSEG = ["-c", "cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml", "--model",
          "multivit_tiny", "--input_size", "64", "--decoder_dim", "96", "--decoder_depth", "2"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The DPT head's 18M parameters initialise in ~1.5 s on one thread,
    several times that with a thread per core beside the suite's other
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_numpy(x):
    """A port leaf as flax gives it back."""
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_numpy(v) for v in x]
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return x


def to_port(x):
    """A flax-side tree as the port writes it: tensors for arrays."""
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_port(v) for v in x]
    if isinstance(x, np.ndarray):
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return x


def assert_same_tree(got, ref, path=""):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            assert_same_tree(got[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same_tree(g, r, f"{path}/{i}")
    elif isinstance(ref, (np.ndarray, np.generic)):
        g = to_numpy(got)
        assert g.dtype == np.asarray(ref).dtype and g.shape == np.shape(ref), path
        np.testing.assert_array_equal(g.view(np.uint8) if g.dtype == ml_dtypes.bfloat16 else g,
                                      np.asarray(ref).view(np.uint8)
                                      if g.dtype == ml_dtypes.bfloat16 else ref, err_msg=path)
    else:
        assert type(got) is type(ref) and got == ref, path


def random_tree(template, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), template)


@pytest.fixture(scope="module")
def pretrain_params():
    model = jax_build_pretrain_model(model_name="pretrain_multimae_tiny", in_domains=DOMAINS,
                                     out_domains=DOMAINS, extra_norm_pix_loss=False,
                                     input_size=S)
    inputs = {"rgb": jnp.zeros((1, S, S, 3)), "depth": jnp.zeros((1, S, S, 1)),
              "semseg": jnp.zeros((1, S // 4, S // 4), jnp.int32)}
    abstract = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)}, inputs,
        num_encoded_tokens=4)["params"])
    return random_tree(abstract, 0)


@pytest.fixture(scope="module")
def jax_checkpoint(pretrain_params, tmp_path_factory):
    """checkpoint-3.msgpack as the JAX pretraining CLI saves it: the
    TrainState's {model, balancer} params, an AdamW opt_state as after one
    step (seeded moments, counts of 1; a jitted real step compiles for
    seconds), step and epoch."""
    params = {"model": pretrain_params, "balancer": {"log_vars": np.zeros(3, np.float32)}}
    state = jax.jit(lambda p: TrainState.create(params=p, tx=optax.adamw(1e-3)))(params)
    rng = np.random.default_rng(2)
    opt_state = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape).astype(a.dtype)
                   if jnp.issubdtype(a.dtype, jnp.floating) else np.ones(a.shape, a.dtype)),
        state.opt_state)
    state = state.replace(step=1, opt_state=opt_state)
    out = tmp_path_factory.mktemp("jax_ckpt")
    return save_checkpoint(str(out), 3, state, backend="msgpack")


def test_reads_a_jax_checkpoint_leaf_for_leaf(jax_checkpoint):
    with open(jax_checkpoint, "rb") as f:
        data = f.read()
    ref = fs.msgpack_restore(data)
    got = fm.read_msgpack(jax_checkpoint)
    assert set(ref) == {"params", "opt_state", "step", "epoch"}
    assert got["step"] == 1 and got["epoch"] == 3
    assert_same_tree(got, ref)
    assert_same_tree(fm.msgpack_restore(data), ref)  # bytes: copied once, then shared


def test_leaves_share_the_file_buffer(jax_checkpoint):
    with open(jax_checkpoint, "rb") as f:
        buf = bytearray(f.read())
    tree = fm.msgpack_restore(buf)
    leaf = tree["params"]["model"]["global_tokens"]
    start = torch.frombuffer(buf, dtype=torch.uint8).data_ptr()
    assert start <= leaf.data_ptr() < start + len(buf)


def odd_tree():
    rng = np.random.default_rng(1)
    return {
        "bf16": np.asarray(rng.standard_normal((5, 3)), ml_dtypes.bfloat16),
        "big": rng.standard_normal((40, 7)).astype(np.float32),
        "nested": {"ints": rng.integers(-9, 9, (11,)).astype(np.int64),
                   "big16": np.asarray(rng.standard_normal(300), ml_dtypes.bfloat16),
                   "empty": np.zeros((0, 4), np.float32), "flags": np.array([True, False])},
        "complex": complex(1.5, -2.0), "scalar_f": np.float32(2.5), "scalar_i": np.int64(-7),
        "step": 12, "neg": -3, "int8": -100, "uint64": 2**64 - 1, "int64": -2**40,
        "float": 0.25, "none": None, "flag": True, "text": "x" * 40, "blob": b"\x01" * 300,
        "list": [1, "a", np.ones(3, np.float16), {"b": 2, "a": 1}],
        "wide": {str(i): i for i in range(20)},
    }


@pytest.mark.parametrize("chunk", [2**30, 64], ids=["whole", "chunked"])
def test_odd_leaves_read_and_write_as_flax(chunk, monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", chunk)
    monkeypatch.setattr(fm, "MAX_CHUNK_SIZE", chunk)
    tree = odd_tree()
    ref = fs.msgpack_serialize(tree)
    assert fm.msgpack_serialize(to_port(tree)) == ref
    assert fm.msgpack_serialize(tree) == ref  # numpy leaves too, bf16 aside
    assert_same_tree(fm.msgpack_restore(ref), fs.msgpack_restore(ref))


def test_writes_what_flax_writes_for_a_checkpoint(jax_checkpoint):
    with open(jax_checkpoint, "rb") as f:
        data = f.read()
    assert fm.msgpack_serialize(fm.msgpack_restore(data)) == data


def test_unknown_dtype_and_damage_raise():
    data = fs.msgpack_serialize({"w": np.zeros(3, ml_dtypes.float8_e4m3fn)})
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        fm.msgpack_restore(data)
    good = fs.msgpack_serialize({"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        fm.msgpack_restore(good[:-1])
    with pytest.raises(TypeError):
        fm.msgpack_serialize({"t": (1, 2)})


@functools.lru_cache(maxsize=None)
def jax_semseg_template(adapter):
    model, _, _ = jseg.build_semseg_model(jseg.get_args(SEMSEG + ["--output_adapter", adapter]),
                                          jnp.float32)
    inputs = {"rgb": jnp.zeros((2, 64, 64, 3)), "depth": jnp.zeros((2, 64, 64, 1))}
    if adapter == "dpt":  # the tiny encoder hooks (0, 0, 0, 1), as the port's does
        model = model.clone(output_adapters={"semseg": functools.partial(
            model.output_adapters["semseg"], hooks=(0, 0, 0, 1))})
    return jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)}, inputs))


def port_semseg(adapter):
    model, _, _ = tseg.build_model_from_args(
        tseg.get_args(SEMSEG + ["--output_adapter", adapter]), torch.float32)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


@functools.lru_cache(maxsize=None)
def jax_cls_template(nb_classes=4):
    args = jcls.get_args(["-c", "cfgs/finetune/cls/ft_in1k_100e_multimae-b.yaml", "--model",
                          "multivit_tiny", "--input_size", str(S), "--nb_classes",
                          str(nb_classes)])
    model = jcls.build_cls_model(args, jnp.float32)
    return jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0)},
                                             {"rgb": jnp.zeros((2, S, S, 3))}))["params"]


def port_cls(nb_classes=4):
    model = build_cls_model(model="multivit_tiny", input_size=S, nb_classes=nb_classes)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def flat_shapes(tree):
    return {k: tuple(np.shape(v)) for k, v in ftu.flatten_dict(tree).items()}


@pytest.mark.parametrize("kind", ["pretrain", "cls", "convnext", "segmenter"])
def test_inverse_converter_gives_the_jax_tree(kind, pretrain_params):
    if kind == "pretrain":
        model = build_pretrain_model(model_name="pretrain_multimae_tiny", in_domains=DOMAINS,
                                     out_domains=DOMAINS, extra_norm_pix_loss=False,
                                     input_size=S, device="cpu")
        ref = pretrain_params
    elif kind == "cls":
        model, ref = port_cls(), jax_cls_template()
    else:
        model, ref = port_semseg(kind), jax_semseg_template(kind)["params"]
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, batch_stats = state_dict_to_jax_params(sd, proj_shapes_of(model))
    assert flat_shapes(params) == flat_shapes(ref) and not batch_stats
    back = jax_params_to_state_dict(params, proj_shapes_of(model))
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_inverse_converter_gives_the_dpt_semseg_tree():
    model = port_semseg("dpt")
    ref = jax_semseg_template("dpt")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, batch_stats = state_dict_to_jax_params(sd, proj_shapes_of(model), "semseg")
    assert flat_shapes(params) == flat_shapes(ref["params"])
    assert flat_shapes(batch_stats) == flat_shapes(ref.get("batch_stats", {}))
    back = jax_params_to_state_dict(params, proj_shapes_of(model), "semseg", batch_stats)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def jax_cls_rule(template, source):
    """run_finetuning_cls.py:348-361 on flax paths: {path: source leaf}."""
    src = source["params"].get("model", source["params"])
    flat_t, flat_s = ftu.flatten_dict(template), ftu.flatten_dict(src)
    return {k: flat_s[k] for k in flat_t
            if k in flat_s and np.shape(flat_s[k]) == np.shape(flat_t[k])}, len(flat_t)


def check_loaded(model, loaded, paths, head_type="regression"):
    """The port model holds exactly `loaded` (flax paths -> arrays) there."""
    assert sorted(paths) == sorted(loaded)
    ref = jax_params_to_state_dict(ftu.unflatten_dict(loaded), proj_shapes_of(model), head_type)
    live = model.state_dict()
    for k, v in ref.items():
        np.testing.assert_array_equal(live[k].numpy(), v, err_msg=k)


def test_cls_start_loads_what_the_jax_rule_loads(jax_checkpoint, capsys):
    source = fs.msgpack_restore(open(jax_checkpoint, "rb").read())
    loaded, total = jax_cls_rule(jax_cls_template(), source)
    model = port_cls()
    report = load_flax_start(model, jax_checkpoint, "merge")
    assert (report["loaded"], report["total"]) == (len(loaded), total)
    assert f"[finetune] loaded {len(loaded)}/{total} tensors" in capsys.readouterr().out
    assert 0 < len(loaded) < total and not any(p[0] == "output_adapters_cls" for p in loaded)
    check_loaded(model, loaded, report["paths"])


def test_cls_start_takes_the_head_and_skips_other_shapes(tmp_path):
    """A cls save of 4 classes started at 4 (head loaded) and at 5 (head
    skipped, as its shape differs)."""
    params = random_tree(jax_cls_template(4), 3)
    path = str(tmp_path / "cls.msgpack")
    with open(path, "wb") as f:
        f.write(fs.msgpack_serialize({"params": params, "step": 1, "epoch": 0}))
    for classes in (4, 5):
        loaded, total = jax_cls_rule(jax_cls_template(classes), {"params": params})
        model = port_cls(classes)
        report = load_flax_start(model, path, "merge")
        assert (report["loaded"], report["total"]) == (len(loaded), total)
        assert (("output_adapters_cls", "head", "kernel") in loaded) == (classes == 4)
        check_loaded(model, loaded, report["paths"])


def test_semseg_start_is_load_flax_trunk(jax_checkpoint, capsys):
    template = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                            jax_semseg_template("convnext")["params"])
    jparams, _ = jseg._load_flax_trunk(jax_checkpoint, template)
    jline = capsys.readouterr().out.strip().splitlines()[-1]
    model = port_semseg("convnext")
    report = load_flax_start(model, jax_checkpoint, "trunk", head_type="semseg")
    assert capsys.readouterr().out.strip().splitlines()[-1] == jline
    source = ftu.flatten_dict(fs.msgpack_restore(open(jax_checkpoint, "rb").read())
                              ["params"]["model"])
    loaded = {p: source[p] for p in report["paths"]}
    flat_j = ftu.flatten_dict(jparams)
    for p, v in loaded.items():
        np.testing.assert_array_equal(np.asarray(flat_j[p]), v, err_msg=str(p))
    n = int(jline.split()[2].split("/")[0])
    assert report["loaded"] == n > 0
    assert not any(p[0].startswith("output_adapters") for p in loaded)
    check_loaded(model, loaded, report["paths"], "semseg")


def test_strict_start_raises_on_a_missing_leaf(jax_checkpoint, tmp_path):
    source = fm.read_msgpack(jax_checkpoint)
    del source["params"]["model"]["global_tokens"]
    model = build_pretrain_model(model_name="pretrain_multimae_tiny", in_domains=DOMAINS,
                                 out_domains=DOMAINS, extra_norm_pix_loss=False, input_size=S,
                                 device="cpu")
    with pytest.raises(KeyError, match="global_tokens"):
        load_flax_start(model, source, "strict")
    # Leaves the model lacks are ignored, as flax's from_state_dict ignores them.
    source = fm.read_msgpack(jax_checkpoint)
    rgb_only = build_pretrain_model(model_name="pretrain_multimae_tiny", in_domains=["rgb"],
                                    out_domains=["rgb"], extra_norm_pix_loss=False,
                                    input_size=S, device="cpu")
    report = load_flax_start(rgb_only, source, "strict")
    assert report["loaded"] == report["total"]
    assert os.path.exists(jax_checkpoint)
