"""multimae_tpu_torch: the MultiMAE system in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The package mirrors the layout of `multimae_tpu` (models/, ops/, cli/,
utils/) and is held against it by the tests in tests/test_torch_*.py.
It imports torch only, never jax, flax or multimae_tpu.

The slice ported so far is the masked-reconstruction forward of the
pretraining model (MultiMAE ViT-B at 224 px, RGB + depth + semseg in,
four SpatialOutputAdapter decoders out) and its pixel-space losses.
"""

from multimae_tpu_torch.models.registry import create_model, list_models

__all__ = ["create_model", "list_models"]
