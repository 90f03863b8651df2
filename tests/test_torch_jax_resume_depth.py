"""The depth CLI, through the shared fine-tune loop (cli/finetune_loop.py),
resumes the JAX package's training state after two steps of its CLI's
recipe (build_depth_model, the berhu loss, layer decay, the schedules of
the flags, on the CLIs' synthetic batch; tiny sizes on the CPU) and takes
the next two steps, saving with --ckpt_backend msgpack: each step's loss
and grad norm within 1e-4 relative of the JAX package's next steps, and
the save, restored by the JAX package's load_checkpoint, holds the counts
and parameters within tests/test_torch_train_step.py's bars of the JAX
package's own. A DPT head with BatchNorm (none of the CLIs' has one)
resumes its running statistics from a JAX state's batch_stats, and does
not resume a state without them.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multimae_tpu import models as jmodels
from multimae_tpu.cli import run_finetuning_depth as jdepth
from multimae_tpu.train import checkpoint as jckpt
from multimae_tpu.train.finetune_step import make_dense_train_step
from multimae_tpu.train.regression_losses import LOSSES
from multimae_tpu_torch.cli import run_finetuning_depth as tdepth
from multimae_tpu_torch.models.output_adapters import dpt_hooks
from multimae_tpu_torch.utils.convert import jax_params_to_state_dict
from test_torch_jax_resume import assert_params_match
from test_torch_jax_resume_cli import ARGV, jax_state, one_torch_thread  # noqa: F401


def test_depth_cli_resumes_the_jax_cli_state_and_steps_as_it(tmp_path, capsys):
    """Two JAX steps, the save, then the next two steps on both sides."""
    argv = ARGV["depth"] + ["--epochs", "2", "--synthetic_data", "--synthetic_steps_per_epoch",
                            "2", "--num_workers", "0", "--output_dir", str(tmp_path)]
    args = jdepth.get_args(argv)
    state, _ = jax_state("depth", args)
    with pytest.MonkeyPatch.context() as mp:  # jax_state's hooks
        mp.setattr(jmodels, "DPTOutputAdapter",
                   functools.partial(jmodels.DPTOutputAdapter, hooks=dpt_hooks(2)))
        model = jdepth.build_depth_model(args, jnp.float32)[0]
    step = jax.jit(make_dense_train_step(model, "depth", LOSSES[args.loss], in_domains=("rgb",),
                                         clip_grad=args.clip_grad, needs_target_kwargs=True))
    rng = np.random.default_rng(0)
    s = args.input_size
    batch = {"rgb": rng.standard_normal((2, s, s, 3)).astype(np.float32),
             "target": rng.standard_normal((2, s, s, 1)).astype(np.float32),
             "mask_valid": rng.random((2, s, s, 1)) > 0.2}  # the CLIs' example_batch
    batch = jax.tree.map(jnp.asarray, batch)
    for _ in range(2):
        state, _ = step(state, batch, jax.random.PRNGKey(args.seed + 3))
    jckpt.save_checkpoint(str(tmp_path), 0, state, backend="msgpack")
    jmetrics = []
    for _ in range(2):
        state, m = step(state, batch, jax.random.PRNGKey(args.seed + 3))
        jmetrics.append({k: float(v) for k, v in m.items()})

    run = tdepth.main(tdepth.get_args(argv + ["--device", "cpu", "--ckpt_backend", "msgpack"]))
    out = capsys.readouterr().out
    assert run["start_epoch"] == 1 and "holds no data position" in out
    assert "a .msgpack keeps no best delta_1: it starts at 0.0" in out
    for got, ref in zip([r["metrics"] for r in run["steps"]], jmetrics, strict=True):
        for k in ("loss", "grad_norm"):
            assert abs(got[k] - ref[k]) <= 1e-4 * abs(ref[k]), (k, got[k], ref[k])

    template = jax_state("depth", args)[0]
    saved, epoch = jckpt.load_checkpoint(str(tmp_path / "checkpoint-1.msgpack"), template)
    assert epoch == 1 and int(saved.step) == 4
    assert int(saved.opt_state[0].count) == int(state.opt_state[0].count) == 4
    assert_params_match(*(jax_params_to_state_dict(jax.tree.map(np.asarray, s.params),
                                                   {"rgb": (3, 16, 16)}) for s in (saved, state)))


@pytest.mark.parametrize("saved", ["with_batch_stats", "without"])
def test_batch_stats_resume_the_dpt_batchnorms(saved, tmp_path):
    """None of the CLIs' heads has a BatchNorm (use_bn is False in both
    packages); a DPT semseg head with use_bn takes the running statistics
    of a JAX state's batch_stats, its eval then the JAX eval's within 5e-4
    of the largest |pred|, and they are written back as they came. A JAX
    state without batch_stats, which the JAX eval could not run, does not
    resume."""
    import torch

    from multimae_tpu.train.optim_factory import create_optimizer as jcreate
    from multimae_tpu.train.train_state import TrainState as JTrainState
    from multimae_tpu_torch.train import checkpoint as ckpt
    from multimae_tpu_torch.train.optim_factory import create_optimizer
    from multimae_tpu_torch.train.train_state import TrainState
    from multimae_tpu_torch.utils.jax_state import port_state_to_jax
    from test_torch_dpt import close, dpt_models, inputs

    jm, tm = dpt_models("semseg", True)
    x = {k: jnp.asarray(v) for k, v in inputs(seed=5).items()}
    variables = jm.init({"params": jax.random.PRNGKey(4)}, x)
    stats = jax.tree.map(lambda a: a + 0.25, variables["batch_stats"])  # off (0, 1)
    jstate = JTrainState.create(params=variables["params"], batch_stats=(
        stats if saved == "with_batch_stats" else None),
        tx=jcreate(variables["params"], opt="adamw", lr_schedule=lambda c: 1e-3))
    path = jckpt.save_checkpoint(str(tmp_path), 0, jstate, backend="msgpack")
    state = TrainState(tm, None, create_optimizer(tm), np.full(2, 1e-3))
    if saved == "without":
        with pytest.raises(ValueError, match="batch_stats: leaves differ"):
            ckpt.load_checkpoint(path, state)
        return
    ckpt.load_checkpoint(path, state)
    want = jax_params_to_state_dict({}, batch_stats=jax.tree.map(np.asarray, stats),
                                    head_type="semseg")
    buffers = dict(tm.named_buffers())
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(buffers[k].numpy(), v, err_msg=k)
    ref = jm.apply({"params": variables["params"], "batch_stats": stats}, x, train=False)["out"]
    with torch.no_grad():
        got = tm.eval()({k: torch.from_numpy(np.array(v)) for k, v in x.items()})["out"]
    close(got.numpy(), np.asarray(ref))
    back = port_state_to_jax(state, 0)["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves_with_path(stats),
                    jax.tree_util.tree_leaves_with_path(back)):
        assert a[0] == b[0] and np.array_equal(np.asarray(a[1]), b[1].numpy())
