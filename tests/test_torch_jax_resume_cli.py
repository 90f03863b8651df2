"""The CLIs resume a JAX training state on the CPU at tiny sizes (the
depth CLI's, held against the JAX package's next steps, is
tests/test_torch_jax_resume_depth.py).

* Each of the pretraining, cls, semseg and Taskonomy CLIs auto-resumes a
  `checkpoint-2.msgpack` that the JAX package's save_checkpoint wrote of
  the state its own CLI builds for the same flags (model, optax chain,
  MultiSteps and the EMA for cls), after one optimizer update of small
  fixed gradients: it starts at epoch 3, takes finite steps and prints
  that the save's data position is not read.
"""

import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimae_tpu import models as jmodels
from multimae_tpu.cli import factory as jfactory
from multimae_tpu.cli import run_finetuning_cls as jcls
from multimae_tpu.cli import run_finetuning_depth as jdepth
from multimae_tpu.cli import run_finetuning_semseg as jsemseg
from multimae_tpu.cli import run_finetuning_taskonomy as jtaskonomy
from multimae_tpu.cli import run_pretraining_multimae as jpretrain
from multimae_tpu.train import checkpoint as jckpt
from multimae_tpu.train.optim_factory import LayerDecayValueAssigner, create_optimizer
from multimae_tpu.train.schedules import as_optax_schedule, cosine_scheduler
from multimae_tpu.train.task_balancing import build_balancer
from multimae_tpu.train.train_state import HostEMA, TrainState
from multimae_tpu_torch.cli import run_finetuning_cls as tcls
from multimae_tpu_torch.cli import run_finetuning_depth as tdepth
from multimae_tpu_torch.cli import run_finetuning_semseg as tsemseg
from multimae_tpu_torch.cli import run_finetuning_taskonomy as ttaskonomy
from multimae_tpu_torch.cli import run_pretraining_multimae as tpretrain
from multimae_tpu_torch.models.output_adapters import dpt_hooks

REPO = Path(__file__).resolve().parents[1]
CFG = REPO / "cfgs"
TINY = ["--model", "multivit_tiny", "--finetune", "", "--warmup_epochs", "0"]
ARGV = {
    "pretrain": [
        "-c", str(CFG / "pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml"),
        "--model", "pretrain_multimae_tiny", "--input_size", "64", "--num_encoded_tokens",
        "24", "--decoder_dim", "64", "--decoder_num_heads", "4", "--dtype", "float32",
        "--batch_size", "2", "--warmup_epochs", "0"],
    "cls": [
        "-c", str(CFG / "finetune/cls/ft_in1k_100e_multimae-b.yaml"), *TINY,
        "--input_size", "32", "--dtype", "float32", "--batch_size", "2", "--nb_classes", "4",
        "--update_freq", "2", "--model_ema", "--model_ema_force_cpu"],
    "semseg": [
        "-c", str(CFG / "finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml"), *TINY,
        "--input_size", "64", "--decoder_dim", "64", "--decoder_depth", "2", "--no_fp16",
        "--batch_size", "2"],
    "taskonomy": [
        "-c", str(CFG / "finetune/taskonomy/rgb2depth-1k/ft_rgb2depth_multimae-b.yaml"), *TINY,
        "--input_size", "32", "--no_fp16", "--batch_size", "2"],
    "depth": [
        "-c", str(CFG / "finetune/depth/ft_nyu_2000e_multimae-b.yaml"), *TINY,
        "--input_size", "32", "--batch_size", "2"],
}
CLIS = {"pretrain": (jpretrain, tpretrain), "cls": (jcls, tcls), "semseg": (jsemseg, tsemseg),
        "taskonomy": (jtaskonomy, ttaskonomy), "depth": (jdepth, tdepth)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread (tests/test_torch_depth_cli.py: the DPT head's
    small CPU convolutions spin the pool when test processes share cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_state(kind, args):
    """The TrainState (and host EMA) the JAX CLI of `kind` builds for
    `args`, its parameters initialised from args.seed, and its apply step's
    optax arguments: the schedules of 2 steps per epoch."""
    s = args.input_size
    key = jax.random.PRNGKey(args.seed)
    ema = host = None
    if kind == "pretrain":
        domains = args.in_domains.split("-")
        model = jfactory.build_pretrain_model(
            model_name=args.model, in_domains=domains, out_domains=args.out_domains.split("-"),
            patch_size=args.patch_size, input_size=s, decoder_dim=args.decoder_dim,
            decoder_depth=args.decoder_depth, decoder_num_heads=args.decoder_num_heads,
            extra_norm_pix_loss=args.extra_norm_pix_loss,
            num_global_tokens=args.num_global_tokens, decoder_return_patches=True)
        batch = jfactory.make_synthetic_batch(2, input_size=s, in_domains=domains)
        tasks = args.out_domains.split("-") + (["norm_rgb"] if args.extra_norm_pix_loss else [])
        balancer = build_balancer(args.task_balancer, tasks)
        params = {"model": jax.jit(lambda: model.init(
            {"params": key, "masking": key}, batch,
            num_encoded_tokens=args.num_encoded_tokens)["params"])(),
                  "balancer": balancer.init(key, {t: jnp.zeros(()) for t in tasks}).get(
                      "params", {})}
        tx = create_optimizer(params, opt=args.opt, lr_schedule=lambda c: 0.0,
                              filter_bias_and_bn=False)
        return TrainState.create(params=params, tx=tx), None
    if kind == "cls":
        model = jcls.build_cls_model(args, jnp.float32)
        inputs = {"rgb": jnp.zeros((2, s, s, 3))}
        ema = args.model_ema_decay if not args.model_ema_force_cpu else None
    elif kind == "semseg":
        model = jsemseg.build_semseg_model(args, jnp.float32)[0]
        inputs = {"rgb": jnp.zeros((2, s, s, 3)), "depth": jnp.zeros((2, s, s, 1))}
    else:
        # The JAX DPT head hooks blocks 2, 5, 8 and 11, which a 2-block
        # encoder lacks (the JAX CLI stops there); the port hooks the last
        # block of each quarter of it (models/output_adapters.dpt_hooks).
        # The hooks choose layers and hold no parameters.
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jmodels, "DPTOutputAdapter",
                       functools.partial(jmodels.DPTOutputAdapter, hooks=dpt_hooks(2)))
            model = (jdepth.build_depth_model if kind == "depth"
                     else jtaskonomy.build_taskonomy_model)(args, jnp.float32)[0]
        inputs = {"rgb": jnp.zeros((2, s, s, 3))}
    params = jax.jit(lambda: model.init({"params": key}, inputs)["params"])()
    values = [args.layer_decay ** (model.depth + 1 - i) for i in range(model.depth + 2)]
    lr = cosine_scheduler(args.blr if kind == "cls" else args.lr, args.min_lr, args.epochs, 2,
                          warmup_epochs=args.warmup_epochs, warmup_steps=args.warmup_steps)
    wd = cosine_scheduler(args.weight_decay, args.weight_decay if args.weight_decay_end is None
                          else args.weight_decay_end, args.epochs, 2)
    tx = create_optimizer(params, opt=args.opt, lr_schedule=as_optax_schedule(lr),
                          weight_decay=args.weight_decay, wd_schedule=as_optax_schedule(wd),
                          opt_betas=tuple(args.opt_betas or (0.9, 0.999)), opt_eps=args.opt_eps,
                          momentum=args.momentum,
                          layer_decay_assigner=LayerDecayValueAssigner(values),
                          filter_bias_and_bn=True)
    if kind == "cls" and args.update_freq > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=args.update_freq)
    if kind == "cls" and args.model_ema_force_cpu:
        host = HostEMA(params, args.model_ema_decay)
    return TrainState.create(params=params, tx=tx, ema_decay=ema), host


@pytest.mark.parametrize("kind", ["pretrain", "cls", "semseg", "taskonomy"])
def test_cli_resumes_a_jax_written_state(kind, tmp_path, capsys):
    jcli, tcli = CLIS[kind]
    argv = ARGV[kind] + ["--epochs", "4", "--synthetic_data", "--synthetic_steps_per_epoch", "2",
                         "--num_workers", "0", "--output_dir", str(tmp_path)]
    state, host = jax_state(kind, jcli.get_args(argv))
    grads = jax.tree.map(lambda p: jnp.full_like(p, 1e-2), state.params)
    state = state.apply_gradients(grads, ema_decay=0.9 if state.ema_params is not None else None)
    extras = None
    if host is not None:
        host.update(state.params)
        extras = {"ema_params": host.params}
    jckpt.save_checkpoint(str(tmp_path), 2, state, extras=extras, backend="msgpack")

    run = tcli.main(tcli.get_args(argv + ["--device", "cpu"]))
    out = capsys.readouterr().out
    assert run["start_epoch"] == 3 and run["resumed_from"] == str(tmp_path / "checkpoint-2.msgpack")
    assert "checkpoint-2.msgpack holds no data position the port reads" in out
    assert "epoch 3 starts at batch 0 of the port's own permutation" in out
    assert [r["epoch"] for r in run["steps"]] == [3, 3]
    assert all(np.isfinite(list(r["metrics"].values())).all() for r in run["steps"])
    assert os.path.exists(tmp_path / "checkpoint-3.pth")
    assert ("a .msgpack keeps no best" in out) == (kind != "pretrain")
