"""JAX (flax) MultiMAE parameters -> the port's state_dict, in numpy only.

Repeats the key and layout rules of the JAX package's exporter
(multimae_tpu/utils/torch_compat.py `flax_path_to_torch_key` :85-106 and
`params_to_state_dict` :270-319) for the pretraining model, the
semantic segmentation fine-tune model (ConvNeXt head), the
classification model (the LinearOutputAdapter's `output_adapters_cls`
`norm` and `head` become `output_adapters.cls.norm.*` and
`output_adapters.cls.head.*`, the reference's keys) and the DPT models
(depth, Taskonomy, DPT semseg), so that
`model.load_state_dict(torch_state_dict(...), strict=True)` loads
weights trained with either package:

  * the `ln` scope of the LayerNorm wrapper is dropped;
  * `<prefix>_<name>` scopes become `<prefix>.<name>` (`blocks_i` too);
  * Dense `kernel` (in, out) becomes `weight` (out, in); `scale` -> `weight`;
  * Conv `kernel` (kh, kw, in, out) becomes `weight` (out, in, kh, kw): the
    depthwise (7, 7, 1, C) -> (C, 1, 7, 7), the 1x1 (1, 1, C, K) -> (K, C, 1, 1);
  * `pos_emb` (1, h, w, D) becomes (1, D, h, w);
  * the patchify Dense kernel (ph*pw*C, D) becomes the Conv2d weight
    (D, C, ph, pw), given proj_shapes={task: (C, ph, pw)};
  * `class_emb` becomes `class_emb.weight` (nn.Embedding);
  * the DPT head's flax names become the reference's nn.Sequential and
    `scratch` names (JAX :43-72, the semseg head's with
    head_type="semseg"), and a transposed conv's kernel (kh, kw, O, I)
    (flax's transpose_kernel=True layout) becomes (I, O, kh, kw), the
    inverse of the JAX importer's permutation (:144-149) with no flip;
  * a BatchNorm's `scale` becomes `weight`, and its flax batch_stats
    (`mean`, `var`), given as `batch_stats`, become `running_mean` and
    `running_var` with a `num_batches_tracked` of 0.

The JAX TrainState's params tree {"model": ..., "balancer": {"log_vars"}}
maps to the port's model and balancer state_dicts with
`jax_train_params_to_state_dicts`. `state_dict_to_jax_params` is the
inverse: the port's state_dict -> the flax params (and batch_stats) tree
the JAX model holds, as the JAX importer (multimae_tpu/utils/torch_compat.py
`state_dict_to_params` :207) fills a template, but with no template: the
flax names come from the same rules read backwards.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np

_PREFIXES = (
    ("input_adapters_", "input_adapters."),
    ("output_adapters_", "output_adapters."),
    ("encoder_", "encoder."),
    ("decoder_transformer_", "decoder_transformer."),
    ("task_embeddings_", "task_embeddings."),
    ("blocks_", "blocks."),
)

_LEAF_RENAMES = {"kernel": "weight", "scale": "weight",
                 "class_emb": "class_emb.weight", "mean": "running_mean",
                 "var": "running_var"}

# The DPT head's scopes (JAX torch_compat.py:43-72; reference
# output_adapters.py:625-645, :661-715).
_DPT_RENAMES = {
    "act_1_postprocess_conv": "act_1_postprocess.0",
    "act_1_postprocess_deconv": "act_1_postprocess.1",
    "act_2_postprocess_conv": "act_2_postprocess.0",
    "act_2_postprocess_deconv": "act_2_postprocess.1",
    "act_3_postprocess_conv": "act_3_postprocess.0",
    "act_4_postprocess_conv": "act_4_postprocess.0",
    "act_4_postprocess_downconv": "act_4_postprocess.1",
    **{f"layer{i}_rn": f"scratch.layer{i}_rn" for i in range(1, 5)},
    **{f"refinenet{i}": f"scratch.refinenet{i}" for i in range(1, 5)},
    "head_conv1": "head.0", "head_conv2": "head.2", "head_conv3": "head.4",
}
_DPT_SEMSEG_HEAD_RENAMES = {"head_conv1": "head.0", "head_bn": "head.1", "head_conv2": "head.4"}


def _flatten(tree: Mapping[str, Any], path: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, path + (k,))
        else:
            yield path + (k,), v


def flax_path_to_torch_key(path: Tuple[str, ...], head_type: str = "regression") -> str:
    dpt = dict(_DPT_RENAMES, **(_DPT_SEMSEG_HEAD_RENAMES if head_type == "semseg" else {}))
    parts = []
    for comp in path:
        if comp == "ln":
            continue
        for ours, theirs in _PREFIXES:
            if comp.startswith(ours):
                comp = theirs + comp[len(ours):]
                break
        else:
            comp = dpt.get(comp, comp)
        parts.append(comp)
    parts[-1] = _LEAF_RENAMES.get(parts[-1], parts[-1])
    return ".".join(parts)


def jax_params_to_state_dict(
    params: Mapping[str, Any],
    proj_shapes: Optional[Dict[str, Tuple[int, int, int]]] = None,
    head_type: str = "regression",
    batch_stats: Optional[Mapping[str, Any]] = None,
) -> Dict[str, np.ndarray]:
    """Nested dict of numpy arrays (the flax params, and the flax
    batch_stats of a model with BatchNorm) -> {torch key: array}.
    `head_type` names a DPT head's kind ("semseg" or "regression")."""
    out: Dict[str, np.ndarray] = {}
    for path, leaf in _flatten(batch_stats or {}):
        out[flax_path_to_torch_key(path, head_type)] = np.ascontiguousarray(np.asarray(leaf))
        counter = flax_path_to_torch_key(path[:-1] + ("num_batches_tracked",), head_type)
        out[counter] = np.zeros((), np.int64)
    for path, leaf in _flatten(params):
        arr = np.asarray(leaf)
        name = path[-1]
        if name == "pos_emb" and arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        elif name == "kernel" and arr.ndim == 2:
            task = path[0][len("input_adapters_"):]
            if (proj_shapes and path[-2] == "proj"
                    and path[0].startswith("input_adapters_")
                    and task in proj_shapes):
                c, ph, pw = proj_shapes[task]
                arr = arr.reshape(ph, pw, c, arr.shape[1]).transpose(3, 2, 0, 1)
            else:
                arr = arr.T
        elif name == "kernel" and arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # deconv (kh, kw, O, I) -> (I, O, kh, kw) too
        out[flax_path_to_torch_key(path, head_type)] = np.ascontiguousarray(arr)
    return out


def jax_train_params_to_state_dicts(
    params: Mapping[str, Any],
    proj_shapes: Optional[Dict[str, Tuple[int, int, int]]] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """The JAX TrainState's {"model": ..., "balancer": ...} params ->
    {"model": model state_dict, "balancer": balancer state_dict}."""
    return {"model": jax_params_to_state_dict(params["model"], proj_shapes),
            "balancer": {k: np.ascontiguousarray(np.asarray(v))
                         for k, v in params.get("balancer", {}).items()}}


_SCOPES = tuple(ours[:-1] for ours, _ in _PREFIXES)  # "input_adapters", "blocks", ...
# LayerNorms that are plain flax LayerNorms (no `ln` wrapper scope): the
# Segmenter's mask_norm (JAX output_adapters.py).
_PLAIN_NORMS = ("mask_norm",)


def _torch_parts_to_flax(parts, head_type: str):
    """The module path of a torch key (leaf excluded) -> flax scopes."""
    dpt = dict(_DPT_RENAMES)
    if head_type == "semseg":  # its head has no head_conv3: head.4 is head_conv2
        dpt = {k: v for k, v in dpt.items() if not k.startswith("head_")}
        dpt.update(_DPT_SEMSEG_HEAD_RENAMES)
    inverse = {theirs: ours for ours, theirs in dpt.items()}
    out, i = [], 0
    while i < len(parts):
        two = ".".join(parts[i:i + 2])
        if parts[i] in _SCOPES and i + 1 < len(parts):
            out.append(f"{parts[i]}_{parts[i + 1]}")
            i += 2
        elif two in inverse and len(parts[i:i + 2]) == 2:
            out.append(inverse[two])
            i += 2
        else:
            out.append(inverse.get(parts[i], parts[i]))
            i += 1
    return out


# How a torch tensor becomes its flax leaf (`flax_layout`'s ops): "" as it is,
# "T" the Dense transpose, "pos_emb" (1, D, h, w) -> (1, h, w, D), "conv"
# (O, I, kh, kw) -> (kh, kw, I, O) (deconvs too), "patch" the conv then the
# patchify Dense's (ph*pw*C, D).
_NUMPY_OPS = {
    "": lambda a: a,
    "T": lambda a: a.T,
    "pos_emb": lambda a: a.transpose(0, 2, 3, 1),
    "conv": lambda a: a.transpose(2, 3, 1, 0),
    "patch": lambda a: a.transpose(2, 3, 1, 0).reshape(-1, a.shape[0]),
}


def flax_layout(shapes: Mapping[str, Tuple[int, ...]], head_type: str = "regression"
                ) -> Dict[str, Tuple[str, Tuple[str, ...], str]]:
    """{torch key: (collection, flax path, op)} for a state_dict's keys and
    shapes: the collection "params" or "batch_stats", the path of the flax
    leaf, and the op of `_NUMPY_OPS` that turns the tensor into it. The
    names and shapes alone decide it; BatchNorm counters
    (`num_batches_tracked`) have no flax leaf and are left out."""
    modules = {k.rsplit(".", 1)[0] for k in shapes if k.endswith(".running_mean")}
    out: Dict[str, Tuple[str, Tuple[str, ...], str]] = {}
    for key, shape in shapes.items():
        module, _, leaf = key.rpartition(".")
        parts = module.split(".") if module else []
        if leaf == "num_batches_tracked":
            continue
        ndim = len(shape)
        scopes = _torch_parts_to_flax(parts, head_type)
        collection, op = "params", ""
        if parts and parts[-1] in _SCOPES:  # task_embeddings.<task>: a leaf
            scopes, leaf = _torch_parts_to_flax(parts[:-1], head_type), f"{parts[-1]}_{leaf}"
        elif leaf == "weight" and parts and parts[-1] == "class_emb":
            scopes, leaf = _torch_parts_to_flax(parts[:-1], head_type), "class_emb"
        elif leaf in ("running_mean", "running_var"):
            collection, leaf = "batch_stats", leaf[len("running_"):]
        elif leaf == "pos_emb" and ndim == 4:
            op = "pos_emb"
        elif leaf == "weight" and ndim == 4:
            op = ("patch" if scopes and scopes[0].startswith("input_adapters_")
                  and scopes[-1] == "proj" else "conv")
            leaf = "kernel"
        elif leaf == "weight" and ndim == 2:
            op, leaf = "T", "kernel"
        elif leaf in ("weight", "bias") and module not in modules and (
                leaf == "weight" and ndim == 1
                or len(shapes.get(f"{module}.weight", ())) == 1):
            if parts[-1] not in _PLAIN_NORMS:
                scopes = scopes + ["ln"]
            leaf = "scale" if leaf == "weight" else leaf
        elif leaf == "weight" and ndim == 1:  # BatchNorm
            leaf = "scale"
        out[key] = (collection, tuple(scopes) + (leaf,), op)
    return out


def state_dict_to_jax_params(
    state_dict: Mapping[str, Any],
    proj_shapes: Optional[Dict[str, Tuple[int, int, int]]] = None,
    head_type: str = "regression",
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's {torch key: array} -> (params, batch_stats), nested dicts
    of numpy arrays in the JAX model's flax layout (`flax_layout`): the
    inverse of `jax_params_to_state_dict` (jax_params_to_state_dict(params,
    proj_shapes, head_type, batch_stats) gives `state_dict` back). An input
    adapter's 4-D patch-embedding weight becomes the flax Dense kernel
    (ph*pw*C, D) whether or not `proj_shapes` is given; BatchNorm counters
    (`num_batches_tracked`) have no flax leaf and are dropped."""
    arrays = {k: np.asarray(v.detach().cpu() if hasattr(v, "detach") else v)
              for k, v in state_dict.items()}
    trees: Dict[str, Dict[str, Any]] = {"params": {}, "batch_stats": {}}
    for key, (collection, path, op) in flax_layout(
            {k: a.shape for k, a in arrays.items()}, head_type).items():
        node = trees[collection]
        for s in path[:-1]:
            node = node.setdefault(s, {})
        node[path[-1]] = np.ascontiguousarray(_NUMPY_OPS[op](arrays[key]))
    return trees["params"], trees["batch_stats"]
