"""Model layer: functional adapters over torch modules, and the in-tree
transformer models."""

from distkeras_tpu_torch.models.adapter import (
    FunctionalModel,
    ModelAdapter,
    TorchModel,
    TrainedModel,
    as_adapter,
)
from distkeras_tpu_torch.models.convert import params_from_flax
from distkeras_tpu_torch.models.transformer import (
    TransformerClassifier,
    TransformerEncoderBlock,
    TransformerLM,
)

__all__ = [
    "FunctionalModel",
    "ModelAdapter",
    "TorchModel",
    "TrainedModel",
    "as_adapter",
    "params_from_flax",
    "TransformerClassifier",
    "TransformerEncoderBlock",
    "TransformerLM",
]
