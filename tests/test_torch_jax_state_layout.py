"""The committed layouts of the JAX package's training state at full width
(tests/fixtures/jax_state/*.json, make_manifests.py): MultiMAE-B
pretraining with AdamW and the uncertainty balancer, and the NYU semseg
MultiViT-B, the two states chip_smoke.py phase 21 writes and resumes.

* The JAX package's layout, rebuilt through jax.eval_shape as its CLIs
  build the state for those flags, equals each JSON: every path, shape and
  dtype.
* `port_state_to_jax` of the port's state, built as the port's CLIs build
  it for the same flags on the meta device (nothing of full width
  allocated), gives the same leaves.
* The same for the tree the orbax backend stores (`*.orbax.json`): the
  JAX package's `_save_orbax` tree and utils/orbax_ckpt.orbax_tree of the
  port's payload, empty subtrees pruned and `step` an int32 scalar.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multimae_tpu_torch.cli import run_finetuning_semseg as tsemseg
from multimae_tpu_torch.cli import run_pretraining_multimae as tpretrain
from multimae_tpu_torch.cli.factory import build_pretrain_model
from multimae_tpu_torch.models.multimae import MultiMAE
from multimae_tpu_torch.train.optim_factory import LayerDecayValueAssigner, create_optimizer
from multimae_tpu_torch.train.task_balancing import build_balancer
from multimae_tpu_torch.train.train_state import TrainState
from multimae_tpu_torch.utils.jax_state import port_state_to_jax
from multimae_tpu_torch.utils.orbax_ckpt import orbax_tree

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "jax_state"
sys.path.insert(0, str(FIXTURES))
import make_manifests as mm  # noqa: E402


def committed(name, backend=""):
    return json.loads((FIXTURES / f"{name}{backend}.json").read_text())


@pytest.mark.parametrize("name", sorted(mm.CONFIGS))
def test_manifest_is_the_jax_package_layout(name):
    assert mm.manifest(mm.jax_payload(name)) == committed(name)


@pytest.mark.parametrize("name", sorted(mm.CONFIGS))
def test_orbax_manifest_is_the_jax_package_layout(name):
    assert mm.manifest(mm.jax_orbax_tree(name)) == committed(name, ".orbax")


def port_state(name):
    """The port CLI's TrainState for CONFIGS[name]'s flags, on the meta
    device."""
    kind, argv = mm.CONFIGS[name]
    if kind == "pretrain":
        args = tpretrain.get_args(argv)
        domains, out = args.in_domains.split("-"), args.out_domains.split("-")
        model = build_pretrain_model(
            model_name=args.model, in_domains=domains, out_domains=out,
            patch_size=args.patch_size, input_size=args.input_size,
            decoder_dim=args.decoder_dim, decoder_depth=args.decoder_depth,
            decoder_num_heads=args.decoder_num_heads,
            extra_norm_pix_loss=args.extra_norm_pix_loss,
            num_global_tokens=args.num_global_tokens,
            fp32_output_adapters=[t for t in args.fp32_output_adapters.split("-") if t],
            dtype=torch.bfloat16, decoder_return_patches=True, pos_emb_grads=True,
            device="meta")
        balancer = build_balancer(args.task_balancer,
                                  out + (["norm_rgb"] if args.extra_norm_pix_loss else []))
        optimizer = create_optimizer(model, balancer, opt=args.opt,
                                     opt_betas=tuple(args.opt_betas), filter_bias_and_bn=False)
        return TrainState(model, balancer, optimizer, np.zeros(1))
    args = tsemseg.get_args(argv)
    model = tsemseg.build_model_from_args(args, torch.bfloat16)[0]
    depth = len(model.encoder)
    optimizer = create_optimizer(model, opt=args.opt, filter_bias_and_bn=True,
                                 layer_decay_assigner=LayerDecayValueAssigner(
                                     [args.layer_decay ** (depth + 1 - i)
                                      for i in range(depth + 2)]))
    return TrainState(model, None, optimizer, np.zeros(1))


@pytest.mark.parametrize("name", sorted(mm.CONFIGS))
def test_port_state_writes_the_manifest_layout(name, monkeypatch):
    monkeypatch.setattr(MultiMAE, "init_weights", lambda self, generator=None: None)
    with torch.device("meta"):
        state = port_state(name)
    # (the fixed sin-cos pos-embs of the semseg input adapters are made on
    # the CPU whatever the device: 3 MiB each)
    assert all(p.is_meta for n, p in state.named_parameters() if not n.endswith("pos_emb"))
    payload = port_state_to_jax(state, 0)
    assert mm.manifest(payload) == committed(name)
    assert mm.manifest(orbax_tree(payload)) == committed(name, ".orbax")
