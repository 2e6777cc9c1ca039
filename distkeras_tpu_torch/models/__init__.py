"""Model layer: functional adapters over torch modules, the in-tree
transformer models with KV-cached greedy decoding, and the model zoo of the
paper's training suite."""

from distkeras_tpu_torch.models.adapter import (
    FunctionalModel,
    ModelAdapter,
    TorchModel,
    TrainedModel,
    as_adapter,
)
from distkeras_tpu_torch.models.convert import params_from_flax, variables_from_flax
from distkeras_tpu_torch.models.generate import greedy_generate
from distkeras_tpu_torch.models.transformer import (
    KVCache,
    TransformerClassifier,
    TransformerEncoderBlock,
    TransformerLM,
)
from distkeras_tpu_torch.models.zoo import CIFARCNN, MLP, MNISTCNN, ResNet20, TextCNN

__all__ = [
    "FunctionalModel",
    "ModelAdapter",
    "TorchModel",
    "TrainedModel",
    "as_adapter",
    "params_from_flax",
    "variables_from_flax",
    "greedy_generate",
    "KVCache",
    "TransformerClassifier",
    "TransformerEncoderBlock",
    "TransformerLM",
    "MLP",
    "MNISTCNN",
    "CIFARCNN",
    "ResNet20",
    "TextCNN",
]
