"""The measurements behind chip_smoke.py phase 21's bit-equal resume and
phase 19's batch, run by hand on a machine with an NVIDIA card (no JAX):

    python3 tests/_torch_determinism_probe.py

* One step of phase 7's pretraining recipe (TRAIN_BATCH, fixed masks) and
  of phase 11's semseg fine-tune (SEMSEG_BATCH, drop_path drawn from a
  seeded generator), each run twice from one state for two steps: how many
  parameter gradients and parameters differ between the two runs, with the
  port's backwards of the class embedding and the bilinear resize (one-hot
  product, adjoint matmuls) and with torch's own (F.embedding,
  F.interpolate), which add with atomics.
* The decoders' first pretraining step at batch 32 against the plain twins
  (chip_smoke.variant_steps at VARIANT_BATCH 32: an over-bound reading is
  printed, not raised), for the default decoders, those without task
  queries and under --approx_gelu; and in each, the first module output of
  the batch-32 forward, in call order, that parts from the same forward on
  the plain twins.
"""

import copy
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

VARIANTS = (("default decoders", {}),
            ("decoders without task queries", {"decoder_use_task_queries": False}),
            ("--approx_gelu", {"approx_gelu": True}))


def differing(state, other):
    ga, gb = dict(state.model.named_parameters()), dict(other.model.named_parameters())
    grads = [n for n, p in ga.items() if p.grad is not None and not torch.equal(p.grad, gb[n].grad)]
    params = [n for n, p in ga.items() if not torch.equal(p, gb[n])]
    return grads, params


def twice(tag, build, run):
    """Two steps from one state, on two copies of it."""
    state, step, other, other_step = build()
    for i in range(2):
        a, b = run(step, state), run(other_step, other)
        grads, params = differing(state, other)
        print(f"[probe] {tag}, step {i}: metrics equal {a == b}; {len(grads)} gradients differ "
              f"{grads[:4]}; {len(params)} parameters differ", flush=True)
    del state, other
    cs.free_card(torch)


def pretraining(dev):
    from multimae_tpu_torch.cli.factory import build_pretrain_losses, build_pretrain_trainer
    from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step

    batch, masks = cs.fixed_mask_batch(torch, dev, cs.TRAIN_BATCH)

    def build():
        state, step = build_pretrain_trainer(batch_size=cs.TRAIN_BATCH, seed=0, device=dev)
        other = copy.deepcopy(state)
        return state, step, other, make_pretrain_train_step(
            other.model, other.balancer, build_pretrain_losses(("rgb", "depth", "semseg")))

    return build, lambda fn, st: {k: float(v) for k, v in fn(st, batch, task_masks=masks).items()}


def semseg(dev):
    from multimae_tpu_torch.cli.factory import build_semseg_trainer, make_synthetic_semseg_batch
    from multimae_tpu_torch.cli.run_finetuning_semseg import seg_cross_entropy_parts
    from multimae_tpu_torch.train.finetune_step import make_dense_train_step

    batch = make_synthetic_semseg_batch(cs.SEMSEG_BATCH, num_classes=cs.SEMSEG_CLASSES, seed=0,
                                        device=dev)

    def build():
        state, step = build_semseg_trainer(batch_size=cs.SEMSEG_BATCH, seed=0, device=dev)
        other = copy.deepcopy(state)
        return state, step, other, make_dense_train_step(
            other.model, "semseg", seg_cross_entropy_parts, in_domains=("rgb", "depth"))

    def run(fn, st):
        gen = torch.Generator(device=dev).manual_seed(st.step)
        return {k: float(v) for k, v in fn(st, batch, generator=gen).items()}

    return build, run


def first_parting(dev, tag, options):
    """The first module output of the batch-32 forward that parts from the
    plain twins' (module hooks, in call order)."""
    from multimae_tpu_torch.cli.factory import build_pretrain_trainer

    state, _ = build_pretrain_trainer(batch_size=32, seed=0, device=dev, **options)
    batch, masks = cs.fixed_mask_batch(torch, dev, 32)

    def record():
        out = []
        hooks = [m.register_forward_hook(
            lambda mod, inp, o, n=n: out.append((n, o.detach().float().clone()))
            if torch.is_tensor(o) else None) for n, m in state.model.named_modules() if n]
        with torch.no_grad():
            state.model(batch, num_encoded_tokens=98, task_masks=masks)
        for h in hooks:
            h.remove()
        return out

    kernels = record()
    with cs.plain_twins():
        plain = record()
    for (n, a), (m, b) in zip(kernels, plain):
        if n != m or not torch.equal(a, b):
            rel = float((a - b).norm() / b.norm().clamp_min(1e-30)) if a.shape == b.shape else None
            print(f"[probe] {tag} at batch 32: the first output to part from the plain twins is "
                  f"{n} {tuple(a.shape)} (twins: {m}), rel {rel}", flush=True)
            break
    else:
        print(f"[probe] {tag} at batch 32: no output parts", flush=True)
    del state, kernels, plain
    cs.free_card(torch)


def main():
    from multimae_tpu_torch.models import input_adapters
    from multimae_tpu_torch.ops import _build, resize

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card visible to torch")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    _build.load()
    for what, parts in (("pretraining", pretraining(dev)), ("semseg", semseg(dev))):
        twice(f"{what}, the port's backwards", *parts)
        embedding, bilinear = input_adapters._Embedding.apply, resize._Bilinear.apply
        input_adapters._Embedding.apply = F.embedding
        resize._Bilinear.apply = lambda x, size, align_corners: F.interpolate(
            x, size=size, mode="bilinear", align_corners=align_corners)
        try:
            twice(f"{what}, torch's backwards", *parts)
        finally:
            input_adapters._Embedding.apply, resize._Bilinear.apply = embedding, bilinear
    cs.VARIANT_BATCH = 32
    for tag, options in VARIANTS:
        try:
            cs.variant_steps(torch, dev, 19, f"{tag} at batch 32", **options)
            print(f"[probe] {tag} at batch 32: within phase 7's bounds", flush=True)
        except AssertionError as e:
            print(f"[probe] {tag} at batch 32: {e}", flush=True)
        cs.free_card(torch)
        first_parting(dev, tag, options)


if __name__ == "__main__":
    main()
