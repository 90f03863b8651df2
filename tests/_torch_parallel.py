"""Shared parts of the port's parallel tests (tests/test_torch_tp.py,
test_torch_fsdp.py, test_torch_pp.py): one tiny pretraining case on both
sides, the JAX package's parallel steps on the simulated CPU devices that
tests/conftest.py sets, the port's workers (tests/_torch_parallel_worker.py,
real gloo processes), the port's one-process step, and the comparisons.

The case: the tiny MultiMAE of tests/test_torch_train_step.py (dim 64, 4
heads, 64 px, decoders dim 64 depth 2), the port's initial weights
imported into the JAX model (the JAX package's state_dict_to_params) and
exported back to the port's workers; the 4-sample synthetic batch and the fixed masks of
tests/test_torch_dist.py (sample 0 sees all of RGB, sample 3 all of
depth, so the ranks' counts of non-empty samples differ); the uncertainty
balancer with non-zero log-variances, AdamW (0.9, 0.95) over one flat
decay group, the cosine LR from 1e-3 and WD 0.05, clip 1.0. The JAX
decoders run their custom VJP in "ref" mode and its step's
`standardize_depth` is patched to method="sort", as in
tests/test_torch_train_step.py.

Every layout computes one function, the global batch's step, and each
file holds its layouts against one JAX parallel step of their kind, so
that each file traces (~8 s) and compiles (~10 s) one JAX layout:
tests/test_torch_tp.py against jit_tp on data 2 x model 2,
test_torch_fsdp.py against jit_fsdp on dcn 2 x data 2 (HSDP), and
test_torch_pp.py, at depth 4, against jit_pp with S 2 and M 2.

Bars, against the JAX package's step: the loss
within 1e-4 relative, the grad norm within 1e-3, and the updated encoder
weights (qkv, proj, fc1, fc2 of every block: the tensors tensor
parallelism splits) within rtol 5e-4 and atol 2e-5, the JAX tests' own
(tests/test_tp.py:139-160). Against the port's one-process step: every
metric within 1e-5 relative, every gradient within 1e-6 of its tensor's
largest, the updated parameters as tests/test_torch_dist.py holds them.
Where an element's gradient is below 1e-7, within ten times Adam's eps
(1e-8), AdamW's first update lr * g / (|g| + eps) turns the two
frameworks' last-bit differences into up to lr: those elements are held
within 2 lr instead (measured: 1 of 16384 in a fc2 weight under data 2 x
model 2, gradient 2.7e-8, 4.9e-5 apart; tests/test_torch_train_step.py
describes the effect).
Under tensor and pipeline parallelism the gradients are held within 1e-5
of their tensor's largest instead (measured: 3.7e-6 under TP 4 and
3.4e-6 under TP 2, the norm_rgb decoder's q weight, whose largest
gradient is 5e-5; 1.5e-6 under PP 4 x 2): proj and fc2 sum k partial
products, and the pipeline's blocks multiply microbatches, in another
order than the one-process GEMMs, and that rounding reaches every
gradient through the encoder's output.
"""

import contextlib
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_parallel_worker.py")
B, K = 4, 24
CLIP = 1.0
BETAS = (0.9, 0.95)
LOG_VARS = np.array([0.1, -0.2, 0.3, 0.05], np.float32)
PROJ_SHAPES = {"rgb": (3, 16, 16), "depth": (1, 16, 16), "semseg": (64, 4, 4)}
TASKS = ("rgb", "depth", "semseg", "norm_rgb")
KEYS = ["loss", "grad_norm"] + [f"{t}_loss" for t in TASKS] + [
    f"{t}_loss_weighted" for t in TASKS]
SPLIT = ("attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight", "mlp.fc2.weight")


def _schedules():
    from multimae_tpu.train.schedules import cosine_scheduler as jcosine

    return jcosine(1e-3, 0.0, epochs=1, niter_per_ep=4), jcosine(0.05, 0.05, epochs=1,
                                                                 niter_per_ep=4)


def masks_np():
    from test_torch_dist import fixed_masks

    return {k: v.numpy() for k, v in fixed_masks().items()}


@contextlib.contextmanager
def jax_ref_mode():
    """The JAX decoders' "ref" VJP and the sort-based standardize_depth."""
    import pytest

    from multimae_tpu.ops import fused_decoder_pallas as fdp
    from multimae_tpu.train import pretrain_step as jps

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jps, "standardize_depth",
                   functools.partial(jps.standardize_depth, method="sort"))
        fdp.set_force_mode("ref")
        try:
            yield
        finally:
            fdp.set_force_mode(None)


def jax_params_of_port(model, batch, depth=None):
    """The tiny port model's initial weights (seed 0) as the JAX model's
    parameters, through the JAX package's importer (state_dict_to_params)
    into a template that jax.eval_shape traces: nothing compiles, unlike a
    jitted init."""
    import jax

    from multimae_tpu.utils.torch_compat import state_dict_to_params
    from multimae_tpu_torch.cli import factory as tfactory

    port = tfactory.build_pretrain_model(
        model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
        decoder_num_heads=4, decoder_depth=2, decoder_return_patches=True, device="cpu",
        depth=depth)
    abstract = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "masking": jax.random.PRNGKey(1)}, batch,
        num_encoded_tokens=K)["params"])
    template = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), abstract)
    sd = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    params, _ = state_dict_to_params(sd, template, strict=True, verbose=False)
    return jax.tree.map(np.array, params)


class JaxCase:
    """The JAX package's model, step and initial parameters; `case(path)`
    writes what the port's workers load."""

    def __init__(self, depth=None):
        import jax
        import jax.numpy as jnp

        from multimae_tpu.cli import factory as jfactory
        from multimae_tpu.train import pretrain_step as jps
        from multimae_tpu.train.optim_factory import create_optimizer as jcreate
        from multimae_tpu.train.schedules import as_optax_schedule
        from multimae_tpu.train.task_balancing import build_balancer as jbuild_balancer

        model = jfactory.build_pretrain_model(
            model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
            decoder_num_heads=4, decoder_depth=2, decoder_return_patches=True)
        if depth is not None:
            model = model.clone(depth=depth)
        self.batch = jfactory.make_synthetic_batch(B, input_size=64, seed=1)
        self.params = {"model": jax_params_of_port(model, self.batch, depth),
                       "balancer": {"log_vars": LOG_VARS}}
        self.lr, self.wd = _schedules()
        self.tx = jcreate(self.params, opt="adamw", lr_schedule=as_optax_schedule(self.lr),
                          wd_schedule=as_optax_schedule(self.wd), opt_betas=BETAS,
                          filter_bias_and_bn=False)
        step = jps.make_pretrain_train_step(
            model, jbuild_balancer("uncertainty", TASKS),
            jfactory.build_pretrain_losses(("rgb", "depth", "semseg")),
            num_encoded_tokens=K, clip_grad=CLIP)
        masks = {k: jnp.asarray(v) for k, v in masks_np().items()}
        self.step = lambda s, b, r: step(s, b, r, masks)

    def case(self, path, **extra):
        from multimae_tpu_torch.cli import factory as tfactory
        from multimae_tpu_torch.utils.convert import jax_train_params_to_state_dicts

        sds = jax_train_params_to_state_dicts(self.params, PROJ_SHAPES)
        payload = {"model": {k: torch.tensor(v) for k, v in sds["model"].items()},
                   "balancer": {k: torch.tensor(v) for k, v in sds["balancer"].items()},
                   "batch": tfactory.make_synthetic_batch(B, input_size=64, seed=1,
                                                          device="cpu"),
                   "masks": {k: torch.from_numpy(v) for k, v in masks_np().items()},
                   "lr": torch.from_numpy(np.asarray(self.lr, np.float32)),
                   "wd": torch.from_numpy(np.asarray(self.wd, np.float32)),
                   "betas": BETAS, "clip": CLIP, "k": K, **extra}
        torch.save(payload, path)
        return path

    def _lower(self, layout: str, n: int, arg: int):
        """Trace and lower the JAX package's step under `layout` on the first
        n simulated devices ("tp", "hsdp" or "pp"; `arg`: the model axis
        for TP, the microbatches for the pipeline): (lowered, state,
        batch)."""
        import jax
        import jax.numpy as jnp

        from multimae_tpu.parallel import pp as jpp
        from multimae_tpu.parallel.fsdp import jit_fsdp, shard_state_fsdp
        from multimae_tpu.parallel.mesh import (
            create_hybrid_mesh, create_mesh, shard_batch, use_constraint_mesh)
        from multimae_tpu.parallel.tp import jit_tp, shard_state_tp
        from multimae_tpu.train.train_state import TrainState as JTrainState

        devs = jax.devices()[:n]
        state = JTrainState.create(params=jax.tree.map(jnp.array, self.params), tx=self.tx)
        with jax_ref_mode():
            try:
                if layout == "tp":
                    mesh = create_mesh(data=n // arg, model=arg, devices=devs)
                    state = shard_state_tp(state, mesh, min_size=1)
                    fn = jit_tp(self.step, state, mesh, min_size=1)
                elif layout == "hsdp":
                    mesh = create_hybrid_mesh(dcn=2, devices=devs)
                    state = shard_state_fsdp(state, mesh, min_size=1)
                    fn = jit_fsdp(self.step, state, mesh, min_size=1)
                else:  # pipeline
                    mesh = jpp.create_pp_mesh(stage=n, data=1, devices=devs)
                    fn = jpp.jit_pp(self.step, mesh, n_micro=arg)
                batch = shard_batch(self.batch, mesh)
                return fn.lower(state, batch, jax.random.PRNGKey(0)), state, batch
            finally:
                use_constraint_mesh(None)
                jpp.use_pipeline(None)


def run_jax(specs):
    """{name: (metrics per step, the parameters after each step as port
    state_dicts)} of each spec {name: (JaxCase, layout, devices, arg,
    steps)}: traced and lowered one by one (the JAX package's trace-time
    registries are global), compiled together on threads, run in turn."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from multimae_tpu_torch.utils.convert import jax_params_to_state_dict

    lowered = {name: spec[0]._lower(*spec[1:4]) for name, spec in specs.items()}
    with ThreadPoolExecutor(len(specs)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda v: v[0].compile(), lowered.values())))
    out = {}
    for name, (_, state, batch) in lowered.items():
        metrics, params = [], []
        for _ in range(specs[name][4]):
            state, m = compiled[name](state, batch, jax.random.PRNGKey(0))
            metrics.append({k: float(v) for k, v in m.items()})
            now = jax.tree.map(lambda a: np.asarray(jax.device_get(a)), state.params)
            params.append(jax_params_to_state_dict(now["model"], PROJ_SHAPES))
        out[name] = metrics, params
    return out


def one_process(case_path, steps: int = 1):
    """The port's one-process step over the whole batch: (metrics per step,
    the first step's gradients, the parameters after the first step, the
    first LR, the bytes of parameters and moments held)."""
    from _torch_parallel_worker import build_state, held_bytes, make_state

    case = torch.load(case_path, weights_only=True)
    model, balancer, step = build_state(case, case.get("depth"))
    state = make_state(case, model, balancer)
    metrics, grads, params = [], None, None
    for i in range(steps):
        m = step(state, case["batch"], task_masks=case["masks"])
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
            params = {k: v.clone() for k, v in model.state_dict().items()}
    return metrics, grads, params, float(case["lr"][0]), held_bytes(state)


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("SLURM_", "OMPI_", "MASTER_", "GROUP_", "LOCAL_"))
           and k not in ("RANK", "WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = HERE + os.pathsep + REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def start(n: int, per_rank=lambda r: {}, **env):
    """Start n worker ranks of one gloo group, with `env` and per_rank(r)'s
    variables; returns them running."""
    port = free_port()
    base = dict(clean_env(), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(n), **{k: str(v) for k, v in env.items()})
    return [subprocess.Popen([sys.executable, WORKER], cwd=REPO,
                             env=dict(base, RANK=str(r), LOCAL_RANK=str(r), **per_rank(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]


def finish(procs, timeout: int = 300):
    """Wait for the ranks; raise with each rank's output unless all ended
    well."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "DIST_OK" in out, f"rank {rank}:\n{out[-6000:]}"
    return outs


def check_one_process(got, ref, what: str, i: int = 0, grad_tol: float = 1e-6) -> None:
    """A layout's result against the one-process step's (see the module
    docstring): metrics of step i, the first step's gradients (each within
    `grad_tol` of its tensor's largest) and, for one step, the updated
    parameters."""
    metrics, grads, params, lr = ref[:4]
    for k in KEYS:
        a, b = got["metrics"][i][k], metrics[i][k]
        assert abs(a - b) <= 1e-5 * abs(b), (what, k, a, b)
    for k, g1 in grads.items():
        g2 = got["grads"][k].double()
        err = float((g2 - g1.double()).abs().max())
        assert err <= grad_tol * float(g1.abs().max()), (what, k, err, float(g1.abs().max()))
    if len(got["metrics"]) > 1:
        return
    for k, p in params.items():
        diff = got["model"][k].double() - p.double()
        if k.endswith("pos_emb"):  # frozen: never updated
            assert float(diff.abs().max()) == 0.0, (what, k)
            continue
        g1, g2 = grads[k].double(), got["grads"][k].double()
        sensitive = g1.abs() < 1e-6
        assert float(torch.where(sensitive, 0.0, diff).abs().max()) <= 1e-6, (what, k)
        adam = lr * (g2 / (g2.abs() + 1e-8) - g1 / (g1.abs() + 1e-8))
        assert float((diff + adam).abs().max()) <= 1e-6, (what, k)


def check_jax(got, jax_result, ref, what: str, i: int = 0) -> None:
    """A layout's result against the JAX package's parallel step (see the
    module docstring for which): loss, grad norm, and the encoder weights
    after the layout's last step, each element within rtol 5e-4 and atol
    2e-5 where the one-process step's first gradient `ref` is at least
    1e-7, within 2 lr elsewhere."""
    jm, jparams = jax_result[0], jax_result[1][len(got["metrics"]) - 1]
    for k, rel in (("loss", 1e-4), ("grad_norm", 1e-3)):
        a, b = got["metrics"][i][k], jm[i][k]
        assert abs(a - b) <= rel * abs(b), (what, k, a, b)
    names = [k for k in jparams if k.startswith("encoder.") and k.endswith(SPLIT)]
    assert names
    _, grads, _, lr = ref[:4]
    for k in names:
        a, b = got["model"][k].numpy().astype(np.float64), jparams[k].astype(np.float64)
        sensitive = grads[k].abs().numpy() < 1e-7
        bad = (np.abs(a - b) > 2e-5 + 5e-4 * np.abs(b)) & ~sensitive
        assert not bad.any(), (what, k, int(bad.sum()), float(np.abs(a - b)[bad].max()))
        assert float(np.abs(a - b).max()) <= 2 * lr, (what, k)


def load(out, name):
    return torch.load(os.path.join(out, f"{name}.pt"), weights_only=True)
