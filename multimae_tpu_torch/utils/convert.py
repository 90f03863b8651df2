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
`jax_train_params_to_state_dicts`.
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
