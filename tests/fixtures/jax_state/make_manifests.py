"""The layout of the JAX package's training state at the two full-width
configurations that chip_smoke.py phase 21 resumes, as the JAX CLIs build
it and multimae_tpu/train/checkpoint.py saves it: every leaf's path,
shape and dtype, from `jax.eval_shape` (no array of full width is made).

    python tests/fixtures/jax_state/make_manifests.py   # rewrites the JSON files

* pretrain_multimae_b.json: the pretraining CLI with
  cfgs/pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml and
  --task_balancer uncertainty (MultiMAE-B, AdamW, the balancer's log_vars);
* semseg_nyu_multivit_b.json: the semseg CLI with
  cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml (MultiViT-B
  at 512 px from RGB and depth, the ConvNeXt head, AdamW with layer decay).

A manifest maps "a/b/c" paths to [shape, dtype]; `step` and `epoch` are
Python ints ([null, "int"]). `{name}.orbax.json` is the tree the orbax
backend stores of the same state (`_save_orbax`): params, opt_state and
`step`, an int32 scalar, with empty subtrees pruned; the epoch is not in it.
"""

import functools
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
CONFIGS = {
    "pretrain_multimae_b": ("pretrain", [
        "-c", os.path.join(REPO, "cfgs/pretrain/multimae-b_98_rgb+-depth-semseg_1600e.yaml"),
        "--task_balancer", "uncertainty"]),
    "semseg_nyu_multivit_b": ("semseg", [
        "-c", os.path.join(REPO, "cfgs/finetune/semseg/nyu/ft_nyu_200e_multimae-b_rgb-depth.yaml")]),
}


@functools.lru_cache(maxsize=None)
def jax_state(name):
    """The JAX CLI's TrainState for CONFIGS[name], its arrays as
    jax.ShapeDtypeStruct."""
    import jax
    import jax.numpy as jnp

    from multimae_tpu.train.optim_factory import LayerDecayValueAssigner, create_optimizer
    from multimae_tpu.train.train_state import TrainState

    kind, argv = CONFIGS[name]
    if kind == "pretrain":
        from multimae_tpu.cli import factory
        from multimae_tpu.cli import run_pretraining_multimae as cli
        from multimae_tpu.train.task_balancing import build_balancer

        args = cli.get_args(argv)
        domains, out = args.in_domains.split("-"), args.out_domains.split("-")
        model = factory.build_pretrain_model(
            model_name=args.model, in_domains=domains, out_domains=out,
            patch_size=args.patch_size, input_size=args.input_size,
            decoder_dim=args.decoder_dim, decoder_depth=args.decoder_depth,
            decoder_num_heads=args.decoder_num_heads,
            decoder_use_task_queries=args.decoder_use_task_queries,
            decoder_use_xattn=args.decoder_use_xattn,
            extra_norm_pix_loss=args.extra_norm_pix_loss,
            num_global_tokens=args.num_global_tokens,
            fp32_output_adapters=[t for t in args.fp32_output_adapters.split("-") if t],
            dtype=jnp.bfloat16, decoder_return_patches=True)
        tasks = out + (["norm_rgb"] if args.extra_norm_pix_loss else [])
        balancer = build_balancer(args.task_balancer, tasks)
        batch = factory.make_synthetic_batch(2, input_size=args.input_size, in_domains=domains)
        key = jax.random.PRNGKey(0)
        params = jax.eval_shape(lambda: {
            "model": model.init({"params": key, "masking": key}, batch,
                                num_encoded_tokens=args.num_encoded_tokens)["params"],
            "balancer": balancer.init(key, {t: jnp.zeros(()) for t in tasks}).get("params", {})})
        tx = create_optimizer(params, opt=args.opt, lr_schedule=lambda c: 0.0,
                              opt_betas=tuple(args.opt_betas), filter_bias_and_bn=False)
    else:
        from multimae_tpu.cli import run_finetuning_semseg as cli

        args = cli.get_args(argv)
        model, in_domains, _ = cli.build_semseg_model(args, jnp.bfloat16)
        s = args.input_size
        inputs = {"rgb": jax.ShapeDtypeStruct((2, s, s, 3), jnp.float32),
                  "depth": jax.ShapeDtypeStruct((2, s, s, 1), jnp.float32)}
        params = jax.eval_shape(lambda x: model.init({"params": jax.random.PRNGKey(0)}, x)[
            "params"], {d: inputs[d] for d in in_domains})
        values = [args.layer_decay ** (model.depth + 1 - i) for i in range(model.depth + 2)]
        tx = create_optimizer(params, opt=args.opt, lr_schedule=lambda c: 0.0,
                              layer_decay_assigner=LayerDecayValueAssigner(values),
                              filter_bias_and_bn=True, learnable_pos_emb=args.learnable_pos_emb)
    return jax.eval_shape(lambda p: TrainState.create(params=p, tx=tx), params)


def jax_payload(name):
    """The payload save_checkpoint writes for CONFIGS[name] (the msgpack
    backend), its arrays as jax.ShapeDtypeStruct."""
    import flax.serialization

    state, to_sd = jax_state(name), flax.serialization.to_state_dict
    return {"params": to_sd(state.params), "opt_state": to_sd(state.opt_state), "step": 0,
            "epoch": 0}


def jax_orbax_tree(name):
    """The tree the orbax backend stores for CONFIGS[name] (`_save_orbax`)."""
    import flax.serialization

    from multimae_tpu.train.checkpoint import _prune_empty

    state, to_sd = jax_state(name), flax.serialization.to_state_dict
    return _prune_empty({"params": to_sd(state.params), "opt_state": to_sd(state.opt_state),
                         "step": state.step})


def manifest(tree, path=()):
    """{"a/b": [shape, dtype]} of a payload whose leaves have .shape and
    .dtype (numpy's dtype names; torch's through flax_msgpack's table) or
    are ints; empty dicts have no leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(manifest(v, path + (k,)))
        return out
    if type(tree) is int:
        return {"/".join(path): [None, "int"]}
    dtype = tree.dtype
    if not isinstance(dtype, str) and hasattr(dtype, "is_floating_point"):  # a torch dtype
        from multimae_tpu_torch.utils.flax_msgpack import _NAMES

        dtype = _NAMES[dtype]
    return {"/".join(path): [list(tree.shape), str(getattr(dtype, "name", dtype))]}


def main():
    sys.path.insert(0, REPO)
    for name in CONFIGS:
        for file, tree in ((f"{name}.json", jax_payload(name)),
                           (f"{name}.orbax.json", jax_orbax_tree(name))):
            leaves = manifest(tree)
            with open(os.path.join(HERE, file), "w") as f:  # a leaf a line
                f.write("{\n" + ",\n".join(f"{json.dumps(k)}: {json.dumps(v)}"
                                            for k, v in sorted(leaves.items())) + "\n}\n")
            print(f"{file}: {len(leaves)} leaves")


if __name__ == "__main__":
    main()
