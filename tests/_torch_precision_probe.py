"""The measurements behind two tests' conditioning, run by hand on the CPU:

    JAX_PLATFORMS=cpu python tests/_torch_precision_probe.py

* tests/test_torch_regression.py::test_depth_steps_match_jax: for the batch
  seeds 0-9, the smallest |input| / max |input| of any ReLU of the port's
  fp32 forward at the test's initial weights; at seed 7, the ReLU input on
  whose sign the fp32 and float64 forwards disagree, and the largest
  per-tensor gradient gap of the JAX fp32 step and of the port's fp32 step
  from the port's float64 one (each relative to the tensor's largest).
* tests/test_torch_dist.py's pretraining step in one process: the norm_rgb
  decoder's q weight gradient in fp32 against float64 (parameters and
  compute dtype), beside the largest such gap over every tensor.
"""

import functools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def to_float64(model):
    """The model's parameters and every module's compute dtype in float64."""
    model.double()
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    return model


def depth_probe():
    import jax
    import jax.numpy as jnp

    import test_torch_regression as R
    from multimae_tpu_torch.utils.convert import jax_params_to_state_dict

    torch.set_num_threads(1)
    jm = R.jcreate("multivit_tiny", input_adapters={"rgb": functools.partial(
        R.JPatched, num_channels=3, stride_level=1, patch_size_full=16, image_size=R.S)},
        output_adapters={"depth": functools.partial(R.JDPT, **R.DPT_KW)})
    rgb0 = jnp.zeros((2, R.S, R.S, 3), jnp.float32)
    params = jax.tree.map(np.array, jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, {"rgb": rgb0})["params"])())

    def batch(seed):
        rng = np.random.default_rng(seed)
        return {"rgb": rng.standard_normal((2, R.S, R.S, 3)).astype(np.float32),
                "target": rng.standard_normal((2, R.S, R.S, 1)).astype(np.float32),
                "mask_valid": rng.random((2, R.S, R.S, 1)) > 0.2}

    def port(b, dtype, record=None):
        model = R.create_model("multivit_tiny", input_adapters={"rgb": functools.partial(
            R.PatchedInputAdapter, num_channels=3, stride_level=1, patch_size_full=16,
            image_size=R.S)}, output_adapters={"depth": functools.partial(
                R.DPTOutputAdapter, **R.DPT_KW)})
        sd = jax_params_to_state_dict(params, {"rgb": (3, 16, 16)})
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        if dtype == torch.float64:
            to_float64(model)
        relu = torch.nn.functional.relu

        def recording(x, inplace=False):
            if record is not None:
                record.append(x.detach().double().clone())
            return relu(x)

        torch.nn.functional.relu = recording
        try:
            preds = model({"rgb": torch.from_numpy(b["rgb"]).to(dtype)})
        finally:
            torch.nn.functional.relu = relu
        loss = R.rl.masked_berhu_loss(preds["depth"], torch.from_numpy(b["target"]).to(dtype),
                                      torch.from_numpy(b["mask_valid"]))
        loss.backward()
        return {k: p.grad.double().numpy() for k, p in model.named_parameters()
                if p.grad is not None}

    for seed in range(10):
        inputs = []
        port(batch(seed), torch.float32, inputs)
        margin = min(float(x.abs().min() / x.abs().max()) for x in inputs)
        print(f"depth step, batch seed {seed}: smallest ReLU input / its largest {margin:.3g}")
    b = batch(7)
    r32, r64 = [], []
    g32 = port(b, torch.float32, r32)
    g64 = port(b, torch.float64, r64)
    for i, (a, c) in enumerate(zip(r32, r64)):
        for j in torch.nonzero((a > 0) != (c > 0)).tolist():
            print(f"seed 7: ReLU {i} input {tuple(j)} is {float(c[tuple(j)]):.4g} in float64 "
                  f"and {float(a[tuple(j)]):.4g} in fp32, of a largest {float(c.abs().max()):.4g}")
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    def jloss(p):
        preds = jm.apply({"params": p}, {"rgb": jb["rgb"]}, train=True,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        return R.jrl.masked_berhu_loss(preds["depth"].astype(jnp.float32), jb["target"],
                                       mask_valid=jb["mask_valid"])

    gj = jax.jit(jax.grad(jloss))(jax.tree.map(jnp.asarray, params))
    gj = jax_params_to_state_dict(jax.tree.map(np.asarray, gj), {"rgb": (3, 16, 16)})
    for name, g in (("JAX fp32", gj), ("port fp32", g32)):
        worst = max((float(np.abs(g[k] - v).max() / (np.abs(v).max() or 1)), k)
                    for k, v in g64.items())
        print(f"seed 7: {name} gradient from the port's float64, worst tensor "
              f"{worst[1]}: {worst[0]:.3g} of its largest")


def dist_probe():
    import test_torch_dist as D

    torch.set_num_threads(1)
    grads = {}
    for dtype in (torch.float32, torch.float64):
        state, step = D.build(dtype=dtype)
        step(state, D.global_batch(), task_masks=D.fixed_masks())
        grads[dtype] = {k: p.grad.double() for k, p in state.model.named_parameters()}
    g32, g64 = grads[torch.float32], grads[torch.float64]
    k = "output_adapters.norm_rgb.decoder.q.weight"
    gap = float((g32[k] - g64[k]).abs().max())
    print(f"pretraining step, one process: {k} fp32 is {gap:.3g} from float64, "
          f"{gap / float(g64[k].abs().max()):.3g} of its largest "
          f"({float(g64[k].abs().max()):.3g})")
    worst = max((float((g32[n] - v).abs().max() / v.abs().max()), n) for n, v in g64.items())
    print(f"pretraining step, one process: worst tensor {worst[1]}: {worst[0]:.3g}")


if __name__ == "__main__":
    depth_probe()
    dist_probe()
