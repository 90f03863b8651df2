"""Worker body for the port's parallel tests (tests/test_torch_tp.py,
test_torch_fsdp.py, test_torch_pp.py, test_torch_parallel_cli.py): one
rank of a gloo group on the CPU. It imports no JAX: the parent writes the
tiny MultiMAE's parameters (the JAX model's, exported), the
global batch, the masks and the schedules to CASE, a torch file.

MODE=layouts runs each layout named in LAYOUTS (comma-separated names of
LAYOUTS below, each with ":<steps>" for more than one step) in turn, on
one process group: builds the model from CASE, applies the layout (mesh,
TP, pipeline, FSDP), takes its steps on this
rank's data-rank slice of the batch, and rank 0 writes OUT/<layout>.pt:
each step's metrics, the first step's gradients and the final parameters
(canonical: gathered from every rank), every rank's bytes of
parameters and optimizer moments, and the encoder blocks each rank held
whole while a block ran (all of them without FSDP).

MODE is a comma-separated list of these, run in turn on one group.
MODE=semseg takes one semseg fine-tune step (the tiny MultiViT with the
ConvNeXt head) under TP over the world and writes OUT/semseg_tp.pt.
MODE=meshes writes each mesh's view from this rank to OUT/mesh<rank>.pt.
MODE=cli runs the pretraining CLI with the JSON argv in ARGV (and the
semseg CLI with ARGV_SEMSEG) and writes the losses to OUT/cli.pt.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from multimae_tpu_torch.cli import factory  # noqa: E402
from multimae_tpu_torch.parallel import dist as dist_lib  # noqa: E402
from multimae_tpu_torch.parallel import fsdp  # noqa: E402
from multimae_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402
from multimae_tpu_torch.train.optim_factory import create_optimizer  # noqa: E402
from multimae_tpu_torch.train.pretrain_step import make_pretrain_train_step  # noqa: E402
from multimae_tpu_torch.train.task_balancing import build_balancer  # noqa: E402
from multimae_tpu_torch.train.train_state import TrainState  # noqa: E402

TINY = dict(model_name="pretrain_multimae_tiny", input_size=64, decoder_dim=64,
            decoder_num_heads=4, decoder_depth=2, decoder_return_patches=True)
TASKS = ("rgb", "depth", "semseg", "norm_rgb")

# name -> (mesh builder, fsdp, pipeline microbatches)
LAYOUTS = {
    "tp2": (lambda: mesh_lib.create_mesh(model=2, device="cpu"), False, 0),
    "tp4": (lambda: mesh_lib.create_mesh(model=4, device="cpu"), False, 0),
    "d2m2": (lambda: mesh_lib.create_mesh(data=2, model=2, device="cpu"), False, 0),
    "fsdp_d2m2": (lambda: mesh_lib.create_mesh(data=2, model=2, device="cpu"), True, 0),
    "fsdp2": (lambda: mesh_lib.create_mesh(device="cpu"), True, 0),
    "hsdp": (lambda: mesh_lib.create_hybrid_mesh(dcn=2, device="cpu"), True, 0),
    "fsdp_dcn2m2": (lambda: mesh_lib.create_hybrid_mesh(dcn=2, model=2, device="cpu"), True, 0),
    "pp_s2m2": (lambda: mesh_lib.create_pp_mesh(stage=2, device="cpu"), False, 2),
    "pp_s2m4": (lambda: mesh_lib.create_pp_mesh(stage=2, device="cpu"), False, 4),
    "pp_s4m2": (lambda: mesh_lib.create_pp_mesh(stage=4, device="cpu"), False, 2),
    "pp_s2m2_fsdp": (lambda: mesh_lib.create_pp_mesh(stage=2, data=2, device="cpu"), True, 2),
}


def build_state(case, depth=None):
    """The port's model, balancer, TrainState and step from the case's
    parameters, before any layout is applied: (model, balancer, step). A
    case with `float64` set holds its parameters and computes in float64."""
    dtype = torch.float64 if case.get("float64") else torch.float32
    model = factory.build_pretrain_model(**TINY, pos_emb_grads=True, device="cpu", depth=depth,
                                         dtype=dtype)
    model.load_state_dict(case["model"], strict=True)
    balancer = build_balancer("uncertainty", TASKS)
    balancer.load_state_dict(case["balancer"], strict=True)
    model.to(dtype)
    balancer.to(dtype)
    step = make_pretrain_train_step(model, balancer, factory.build_pretrain_losses(
        ("rgb", "depth", "semseg")), num_encoded_tokens=case["k"], clip_grad=case["clip"])
    return model, balancer, step


def make_state(case, model, balancer):
    opt = create_optimizer(model, balancer, opt_betas=case["betas"], filter_bias_and_bn=False)
    return TrainState(model, balancer, opt, case["lr"], case["wd"])


def held_bytes(state) -> int:
    """Bytes of parameters and optimizer moments this rank holds."""
    def local(t):
        return t.to_local() if fsdp.is_sharded(t) else t
    n = sum(local(p).numel() * local(p).element_size() for p in state.parameters())
    for per in state.optimizer.state.values():
        for v in per.values():
            if torch.is_tensor(v) and v.dim() > 0:
                n += local(v).numel() * local(v).element_size()
    return n


def layouts():
    assert dist_lib.initialize_distributed("cpu")
    rank = dist.get_rank()
    case = torch.load(os.environ["CASE"], weights_only=True)
    for entry in os.environ["LAYOUTS"].split(","):
        name, _, steps = entry.partition(":")
        steps = int(steps or 1)
        build_mesh, use_fsdp, n_micro = LAYOUTS[name]
        model, balancer, step = build_state(case, case.get("depth"))
        mesh = build_mesh()
        mesh_lib.layout_model(model, mesh, fsdp=use_fsdp, n_micro=n_micro)
        state = make_state(case, model, balancer)
        gathered = set()  # the blocks ever gathered while one of them ran

        def watch(*_):
            gathered.update(i for i, b in enumerate(model.encoder)
                            if not fsdp.is_sharded(b.attn.qkv.weight))

        for blk in model.encoder:
            blk.register_forward_hook(watch)
        sl = dist_lib.local_batch_slice(case["batch"]["rgb"].shape[0], mesh.batch)
        batch = {k: v[sl] for k, v in case["batch"].items()}
        masks = {k: v[sl] for k, v in case["masks"].items()}
        metrics, grads = [], None
        for i in range(steps):
            m = step(state, batch, task_masks=masks)
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grads = {n: state._full(n, p.grad) for n, p in model.named_parameters()}
        sd = state.state_dict()
        held, seen = [None] * dist.get_world_size(), [None] * dist.get_world_size()
        dist.all_gather_object(held, held_bytes(state))
        dist.all_gather_object(seen, sorted(gathered))
        if rank == 0:
            torch.save({"metrics": metrics, "grads": grads, "model": sd["model"],
                        "balancer": sd["loss_balancer"], "held_bytes": held,
                        "gathered": seen},
                       os.path.join(os.environ["OUT"], f"{name}.pt"))
        dist.barrier()


def semseg():
    from test_torch_dist import semseg_batch

    assert dist_lib.initialize_distributed("cpu")
    mesh = mesh_lib.create_mesh(model=dist.get_world_size(), device="cpu")
    state, step = factory.build_semseg_trainer(
        batch_size=4, model="multivit_tiny", input_size=64, decoder_dim=256,
        decoder_depth=2, drop_path_encoder=0.0, fp16=False, device="cpu",
        parallel=lambda model: mesh_lib.layout_model(model, mesh))
    metrics = step(state, semseg_batch())
    grads = {n: state._full(n, p.grad) for n, p in state.model.named_parameters()}
    sd = state.state_dict()
    if dist.get_rank() == 0:
        torch.save({"metrics": {k: float(v) for k, v in metrics.items()}, "grads": grads,
                    "model": sd["model"]}, os.path.join(os.environ["OUT"], "semseg_tp.pt"))
    dist.barrier()


def meshes():
    """Each mesh's view from this rank (its host from GROUP_RANK, which the
    parent sets per rank): axis ranks and sizes, data rank and size, the
    global ranks of each axis group; written to OUT/mesh{rank}.pt."""
    assert dist_lib.initialize_distributed("cpu")
    views = {}
    for name, build in {"flat": lambda: mesh_lib.create_mesh(data=2, model=2, device="cpu"),
                        "hybrid": lambda: mesh_lib.create_hybrid_mesh(device="cpu"),
                        "hybrid_tp": lambda: mesh_lib.create_hybrid_mesh(dcn=2, model=2,
                                                                         device="cpu"),
                        "pp": lambda: mesh_lib.create_pp_mesh(stage=2, device="cpu")}.items():
        m = build()
        views[name] = {"names": m.mesh_dim_names, "mesh": m.mesh.tolist(),
                       "data": (m.batch.rank, m.batch.size),
                       "axes": {a: (mesh_lib.axis_rank(m, a), mesh_lib.axis_size(m, a),
                                    mesh_lib.axis_ranks(m, a)) for a in m.mesh_dim_names}}
    torch.save(views, os.path.join(os.environ["OUT"], f"mesh{dist.get_rank()}.pt"))
    dist.barrier()


def cli():
    """The pretraining CLI with the JSON argv in ARGV, then the semseg CLI
    with the one in ARGV_SEMSEG where given."""
    from multimae_tpu_torch.cli import run_finetuning_semseg as semseg_cli
    from multimae_tpu_torch.cli import run_pretraining_multimae as pretrain

    assert dist_lib.initialize_distributed("cpu")
    out = {"pretrain": pretrain.main(pretrain.get_args(json.loads(os.environ["ARGV"])))}
    if os.environ.get("ARGV_SEMSEG"):
        out["semseg"] = semseg_cli.main(semseg_cli.get_args(json.loads(os.environ["ARGV_SEMSEG"])))
    assert dist.is_initialized()  # main leaves a group it did not create
    if dist.get_rank() == 0:
        torch.save({k: {"losses": [s["metrics"]["loss"] for s in v["steps"]]}
                    for k, v in out.items()}, os.path.join(os.environ["OUT"], "cli.pt"))
    dist.barrier()


if __name__ == "__main__":
    for mode in os.environ["MODE"].split(","):
        {"layouts": layouts, "semseg": semseg, "cli": cli, "meshes": meshes}[mode]()
    dist.destroy_process_group()
    print("DIST_OK", flush=True)
