"""The JAX package's training state <-> the port's TrainState (what
multimae_tpu/train/checkpoint.py writes to `checkpoint-{epoch}.msgpack`,
:154-166, and restores, :339-370).

The JAX payload holds `params`, `opt_state`, `step` and `epoch`, and
`ema_params`, `batch_stats` and `extras` where the state has them.
`create_optimizer` (multimae_tpu/train/optim_factory.py:221-239) builds an
optax.chain, which flax writes by position:

    adamw                    {"0": {count, mu, nu}, "1": {count}, "2": {count}}
    adam                     {"0": {count, mu, nu}, "1": {count}}
    sgd, nesterov, momentum  {"0": {trace}, "1": {count}, "2": {count}}

and under --update_freq k optax.MultiSteps wraps it: {mini_step,
gradient_step, inner_opt_state: <the chain>, acc_grads, skip_state: {}}.
mu, nu, trace and acc_grads are trees shaped like params, which is
{"model", "balancer"} for pretraining and the bare model tree for the
fine-tunes. The port's optimizer (torch's AdamW or Adam, or TraceSGD) and
--update_freq say which layout a state must have.

The mapping goes by name, never by position in the param groups, leaf by
leaf through the converter's transposes and reshapes
(utils/convert.flax_layout):

    params, batch_stats   the model's state_dict; the balancer's params
    mu / nu               AdamW's and Adam's exp_avg / exp_avg_sq
    trace                 TraceSGD's momentum_buffer
    "0".count             each parameter's torch `step` (Adam)
    the chain's counts    TrainState.updates: they move together, and a
                          skipped step freezes them all while `step` still
                          counts (multimae_tpu/train/train_state.py:42-52)
    gradient_step         TrainState.updates under MultiSteps
    mini_step, acc_grads  TrainState.mini_step and grad_accum
    step                  TrainState.step
    ema_params            the device EMA; a host EMA (--model_ema_force_cpu)
                          is extras["ema_params"] (run_finetuning_cls.py:508).
                          Either comes back as "ema_params".

The fixed sin-cos pos-embs are frozen: the JAX chain keeps mu and nu (or a
trace) for them, which their LR scale of 0 never applies
(optim_factory.py:157-159), and the port's optimizer holds no state for
them. Reading drops those leaves; writing gives them zeros, which leaves
the JAX package's next step as it was. A port optimizer that has taken no
step is written as optax's fresh state: zero moments and counts of 0.

None of the JAX CLIs' models has a BatchNorm (the DPT heads' use_bn is
False in both packages), and their states carry no batch_stats
(run_finetuning_depth.py:310). A model with BatchNorm layers takes its
running statistics from `batch_stats` and cannot resume a state without
them: the JAX package's eval could not run on such a state either.

The port keeps its loader position in extras[PORT_LOADER_KEY], which the
JAX CLIs do not read: they hand extras["data_iter_state"] to grain
(multimae_tpu/cli/run_pretraining_multimae.py:374-380).

An orbax save (utils/orbax_ckpt.py) holds the same tree with its empty
subtrees pruned: MultiSteps's skip_state, and the balancer's subtrees of
params and of the moments where the balancer has no parameters. Reading
takes a pruned subtree for an empty one, so a leaf the live state has is
still wanted; writing keeps them, and orbax_ckpt prunes what it stores.

Every key and shape is checked against the live state before anything is
returned; a state of another layout, model or optimizer raises ValueError
naming what differs. Tensors stay torch tensors (views of the file's buffer
where no transpose is needed), so a state on the meta device converts
without allocating.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from multimae_tpu_torch.train.optim_factory import TraceSGD
from multimae_tpu_torch.utils.convert import flax_layout

PORT_LOADER_KEY = "port_loader_state"

# The transforms of each optimizer's chain, by position.
_CHAINS = {"adamw": ("adam", "count", "count"), "adam": ("adam", "count"),
           "trace": ("trace", "count", "count")}
_SLOT_KEYS = {"adam": {"count", "mu", "nu"}, "count": {"count"}, "trace": {"trace"}}
_MULTISTEPS = {"mini_step", "gradient_step", "inner_opt_state", "acc_grads", "skip_state"}


def optimizer_kind(optimizer: torch.optim.Optimizer) -> str:
    """The optax chain the port's optimizer stands for: "adamw", "adam" or
    "trace" (sgd, nesterov and momentum)."""
    if isinstance(optimizer, torch.optim.AdamW):
        return "adamw"
    if isinstance(optimizer, torch.optim.Adam):
        return "adam"
    if isinstance(optimizer, TraceSGD):
        return "trace"
    raise ValueError(f"{type(optimizer).__name__} has no optax counterpart")


def _head_type(model: torch.nn.Module) -> str:
    """The DPT head's kind, which names its flax scopes ("regression" where
    the model has no DPT head: the names do not depend on it then)."""
    kinds = {getattr(m, "head_type", None) for m in model.modules()} - {None}
    return "semseg" if "semseg" in kinds else "regression"


def _to_flax(t: torch.Tensor, op: str) -> torch.Tensor:
    """convert._NUMPY_OPS on a torch tensor (a view where it can be)."""
    if op == "T":
        return t.t()
    if op == "pos_emb":
        return t.permute(0, 2, 3, 1)
    if op == "conv":
        return t.permute(2, 3, 1, 0)
    if op == "patch":
        return t.permute(2, 3, 1, 0).reshape(-1, t.shape[0])
    return t


def _from_flax(a: torch.Tensor, op: str, shape: Tuple[int, ...]) -> torch.Tensor:
    """The inverse of `_to_flax` for a tensor of `shape`."""
    if op == "T":
        return a.t()
    if op == "pos_emb":
        return a.permute(0, 3, 1, 2)
    if op == "conv":
        return a.permute(3, 2, 0, 1)
    if op == "patch":
        o, c, ph, pw = shape
        return a.reshape(ph, pw, c, o).permute(3, 2, 0, 1)
    return a


def _flatten(tree: Any, path: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """{path: leaf} of a nested dict; empty dicts have no leaf."""
    if not isinstance(tree, Mapping):
        return {path: tree}
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        out.update(_flatten(v, path + (k,)))
    return out


def _put(tree: Dict[str, Any], path: Tuple[str, ...], leaf: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


class _Layout:
    """Where each parameter and buffer of a state lives in the JAX trees."""

    def __init__(self, state):
        shapes = state.canonical_shapes()
        self.nested = state.balancer is not None
        prefix = ("model",) if self.nested else ()
        # name -> (collection, path in a params-shaped tree, op, canonical shape)
        self.where: Dict[str, Tuple[str, Tuple[str, ...], str, Tuple[int, ...]]] = {
            k: (coll, (prefix if coll == "params" else ()) + path, op, tuple(shapes[k]))
            for k, (coll, path, op) in flax_layout(shapes, _head_type(state.model)).items()}
        self.model_params = [n for n, _ in state.model.named_parameters()]
        self.params = list(self.model_params)  # and the balancer's, as balancer.<name>
        if self.nested:
            for n, p in state.balancer.named_parameters():
                self.where[f"balancer.{n}"] = ("params", ("balancer", n), "", tuple(p.shape))
                self.params.append(f"balancer.{n}")
        self.buffers = [k for k, w in self.where.items() if w[0] == "batch_stats"]
        self.counters = [k for k in shapes if k not in self.where]  # num_batches_tracked

    def paths(self, names: List[str]) -> set:
        return {self.where[n][1] for n in names}

    def read(self, tree: Any, names: List[str], what: str) -> Dict[str, torch.Tensor]:
        """{name: tensor in the port's layout} of a tree shaped like the JAX
        params (or batch_stats); raises unless its leaves are exactly those
        of `names`, each of its shape."""
        flat = _flatten(tree if isinstance(tree, Mapping) else {})
        want = self.paths(names)
        if set(flat) != want:
            missing = sorted("/".join(p) for p in want - set(flat))
            extra = sorted("/".join(p) for p in set(flat) - want)
            raise ValueError(f"{what}: leaves differ from the live state's (missing "
                             f"{missing[:5]}, unexpected {extra[:5]})")
        out = {}
        for n in names:
            _, path, op, shape = self.where[n]
            leaf = flat[path]
            expect = tuple(_to_flax(torch.empty(shape, device="meta"), op).shape)
            if not torch.is_tensor(leaf) or tuple(leaf.shape) != expect:
                raise ValueError(f"{what}/{'/'.join(path)}: saved "
                                 f"{tuple(getattr(leaf, 'shape', ())) or leaf!r}, live {expect}")
            out[n] = _from_flax(leaf, op, shape).contiguous()
        return out

    def write(self, named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
        """The params-shaped tree of {name: tensor in the port's layout};
        pretraining's balancer subtree stays, empty or not."""
        tree: Dict[str, Any] = {"model": {}, "balancer": {}} if self.nested else {}
        for n, t in named.items():
            _, path, op, _ = self.where[n]
            _put(tree, path, _to_flax(t, op).contiguous())
        return tree


def _count(x: Any, what: str) -> int:
    if torch.is_tensor(x) and x.dim() == 0 and not x.is_floating_point():
        return int(x)
    if type(x) is int:
        return x
    raise ValueError(f"{what}: {x!r} is not a count")


def _chain(opt_state: Any, kind: str, update_freq: int) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the chain's slots, MultiSteps's state or {}), checked against the
    live optimizer's layout."""
    if not isinstance(opt_state, Mapping):
        raise ValueError(f"opt_state holds a {type(opt_state).__name__}")
    # (an orbax save prunes MultiSteps's empty skip_state, as it prunes every
    # empty subtree: multimae_tpu/train/checkpoint.py _prune_empty)
    multi = set(opt_state) in (_MULTISTEPS, _MULTISTEPS - {"skip_state"})
    if multi != (update_freq > 1):
        raise ValueError(
            f"opt_state is {'optax.MultiSteps' if multi else 'a bare chain'}'s, and this run "
            f"has --update_freq {update_freq}: resume with the --update_freq of the save")
    chain = opt_state["inner_opt_state"] if multi else opt_state
    slots = _CHAINS[kind]
    if not isinstance(chain, Mapping) or set(chain) != {str(i) for i in range(len(slots))} or any(
            not isinstance(chain[str(i)], Mapping) or set(chain[str(i)]) != _SLOT_KEYS[s]
            for i, s in enumerate(slots)):
        layout = {k: sorted(v) if isinstance(v, Mapping) else v for k, v in chain.items()} \
            if isinstance(chain, Mapping) else chain
        raise ValueError(f"opt_state holds the chain {layout}, not the {kind} chain of this "
                         f"run's optimizer")
    return chain, (opt_state if multi else {})


def jax_state_to_port(payload: Mapping[str, Any], state) -> Dict[str, Any]:
    """The tree `flax_msgpack.read_msgpack` gives for a JAX training
    checkpoint -> TrainState.state_dict()'s layout (canonical tensors, on
    the CPU), with `epoch`, `ema_params` where the save has a device or a
    host EMA, and `data_iter_state` where the port wrote its loader position
    (None otherwise). The optimizer's layout follows the live state's
    optimizer and update_freq."""
    missing = {"params", "opt_state", "step", "epoch"} - set(payload)
    if missing:
        raise ValueError(f"the JAX state lacks {sorted(missing)}")
    layout = _Layout(state)
    kind = optimizer_kind(state.optimizer)
    params = layout.read(payload["params"], layout.params, "params")
    model = {n: params[n] for n in layout.model_params}
    model.update(layout.read(payload.get("batch_stats"), layout.buffers, "batch_stats"))
    model.update({k: torch.zeros((), dtype=torch.int64) for k in layout.counters})

    chain, multi = _chain(payload["opt_state"], kind, state.update_freq)
    counts = [_count(chain[str(i)]["count"], f"opt_state/{i}/count")
              for i, s in enumerate(_CHAINS[kind]) if s != "trace"]
    if multi:
        counts.append(_count(multi["gradient_step"], "opt_state/gradient_step"))
    if len(set(counts)) != 1:
        raise ValueError(f"the optax counts differ ({counts}); they move together")
    updates = counts[0]
    names = state._optimized_names()
    if kind == "trace":
        trace = layout.read(chain["0"]["trace"], layout.params, "opt_state/0/trace")
        per = {i: {"momentum_buffer": trace[n]} for i, n in enumerate(names)}
    else:
        mu = layout.read(chain["0"]["mu"], layout.params, "opt_state/0/mu")
        nu = layout.read(chain["0"]["nu"], layout.params, "opt_state/0/nu")
        per = {i: {"step": torch.tensor(float(updates)), "exp_avg": mu[n],
                   "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    out: Dict[str, Any] = {
        "model": model,
        "loss_balancer": None if state.balancer is None else {
            n[len("balancer."):]: t for n, t in params.items() if n.startswith("balancer.")},
        "optimizer": {"state": per,
                      "param_groups": state.optimizer.state_dict()["param_groups"]},
        "step": _count(payload["step"], "step"), "updates": updates,
        "epoch": _count(payload["epoch"], "epoch")}
    if multi:
        acc = layout.read(multi["acc_grads"], layout.params, "opt_state/acc_grads")
        out["mini_step"] = _count(multi["mini_step"], "opt_state/mini_step")
        out["grad_accum"] = [acc[n] for n in names]
    extras = payload.get("extras") or {}
    ema = payload.get("ema_params", extras.get("ema_params"))
    if ema is not None:
        ema = layout.read(ema, layout.params, "ema_params")
        out["ema_params"] = {n: ema[n] for n in layout.model_params}
    position = extras.get(PORT_LOADER_KEY)
    out["data_iter_state"] = None if position is None else {
        k: _count(v, f"extras/{PORT_LOADER_KEY}/{k}") for k, v in position.items()}
    return out


def port_state_to_jax(state, epoch: int, extras: Optional[Dict[str, Any]] = None, *,
                      host_ema: Optional[Mapping[str, torch.Tensor]] = None,
                      tensors: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The JAX payload of `state` (multimae_tpu/train/checkpoint.py:154-166):
    params, opt_state, step and epoch, ema_params for a device EMA,
    batch_stats for a model with BatchNorm, and `extras` (plain values; a
    host EMA `host_ema`, {name: canonical tensor}, as extras["ema_params"])
    where there are any. `tensors` is state.state_dict() where the caller
    has it (every rank gathers it under FSDP and TP)."""
    tensors = state.state_dict() if tensors is None else tensors
    layout = _Layout(state)
    kind = optimizer_kind(state.optimizer)
    live = {n: p for n, p in state.named_parameters()}

    def zeros(n):
        p = live[n]
        return torch.zeros(layout.where[n][3], dtype=p.dtype, device=p.device)

    model = tensors["model"]
    named = {n: (model[n] if n in model else tensors["loss_balancer"][n[len("balancer."):]])
             for n in layout.params}
    params = layout.write(named)
    updates = int(tensors["updates"])
    names = state._optimized_names()
    saved = {names[int(i)]: s for i, s in tensors["optimizer"]["state"].items()}
    for n, s in saved.items():
        if "step" in s and int(s["step"]) != updates:
            raise ValueError(f"{n}: torch step {int(s['step'])}, {updates} updates; optax keeps "
                             "one count")

    def moments(key):
        return layout.write({n: saved[n][key] if n in saved else zeros(n)
                             for n in layout.params})

    count = torch.tensor(updates, dtype=torch.int32)
    chain: Dict[str, Any] = {str(i): {"count": count} for i, s in enumerate(_CHAINS[kind])}
    if kind == "trace":
        chain["0"] = {"trace": moments("momentum_buffer")}
    else:
        chain["0"].update(mu=moments("exp_avg"), nu=moments("exp_avg_sq"))
    opt_state = chain
    if state.update_freq > 1:
        acc = tensors.get("grad_accum")
        acc = dict(zip(names, acc)) if acc is not None else {}
        opt_state = {"mini_step": torch.tensor(int(tensors["mini_step"]), dtype=torch.int32),
                     "gradient_step": count, "inner_opt_state": chain,
                     "acc_grads": layout.write({n: acc[n] if n in acc else zeros(n)
                                                for n in layout.params}),
                     "skip_state": {}}
    payload: Dict[str, Any] = {"params": params, "opt_state": opt_state,
                               "step": int(tensors["step"]), "epoch": int(epoch)}
    if tensors.get("ema_params") is not None:
        payload["ema_params"] = layout.write({**named, **tensors["ema_params"]})
    if layout.buffers:
        batch_stats: Dict[str, Any] = {}
        for n in layout.buffers:
            _put(batch_stats, layout.where[n][1], model[n])
        payload["batch_stats"] = batch_stats
    extras = dict(extras or {})
    if host_ema is not None:
        extras["ema_params"] = layout.write(dict(host_ema))
    if extras:
        payload["extras"] = extras
    return payload

