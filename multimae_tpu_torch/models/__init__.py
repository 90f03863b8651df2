"""Models of the port: registry entries, adapters, ViT blocks, losses."""

from multimae_tpu_torch.models.criterion import (
    MaskedCrossEntropyLoss,
    MaskedL1Loss,
    MaskedMSELoss,
)
from multimae_tpu_torch.models.input_adapters import PatchedInputAdapter, SemSegInputAdapter
from multimae_tpu_torch.models.conv_utils import ConvNeXtBlock
from multimae_tpu_torch.models.multimae import MultiMAE, MultiViT
from multimae_tpu_torch.models.output_adapters import (
    ConvNeXtAdapter,
    DPTOutputAdapter,
    LinearOutputAdapter,
    SegmenterMaskTransformerAdapter,
    SpatialOutputAdapter,
)
from multimae_tpu_torch.models.registry import create_model, list_models

__all__ = [
    "ConvNeXtAdapter", "ConvNeXtBlock", "DPTOutputAdapter", "LinearOutputAdapter", "MaskedCrossEntropyLoss",
    "MaskedL1Loss", "MaskedMSELoss", "MultiMAE", "MultiViT", "PatchedInputAdapter",
    "SegmenterMaskTransformerAdapter", "SemSegInputAdapter", "SpatialOutputAdapter",
    "create_model", "list_models",
]
