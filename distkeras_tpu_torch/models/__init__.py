"""Model layer: functional adapters over torch modules (HuggingFace
``transformers`` models among them), the in-tree transformer models with
KV-cached greedy decoding, their pipeline-staged forms (a GPT-2 checkpoint
converted into one), the mixture-of-experts classifier with its
expert-parallel placement, and the model zoo of the paper's training
suite."""

from distkeras_tpu_torch.models.adapter import (
    FunctionalModel,
    ModelAdapter,
    TorchModel,
    TrainedModel,
    as_adapter,
)
from distkeras_tpu_torch.models.convert import params_from_flax, variables_from_flax
from distkeras_tpu_torch.models.generate import greedy_generate
from distkeras_tpu_torch.models.hf import HuggingFaceModel
from distkeras_tpu_torch.models.hf_staged import (
    PretrainedStagedLM,
    gpt2_state_to_staged,
    gpt2_to_staged,
)
from distkeras_tpu_torch.models.moe import (
    MoEEncoderBlock,
    MoEFeedForward,
    MoETransformerClassifier,
    expert_partition,
)
from distkeras_tpu_torch.models.staged import StagedLM, StagedTransformer, stack_block_params
from distkeras_tpu_torch.models.transformer import (
    KVCache,
    TransformerClassifier,
    TransformerEncoderBlock,
    TransformerLM,
    packed_positions,
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
    "HuggingFaceModel",
    "PretrainedStagedLM",
    "gpt2_state_to_staged",
    "gpt2_to_staged",
    "MoEEncoderBlock",
    "MoEFeedForward",
    "MoETransformerClassifier",
    "expert_partition",
    "KVCache",
    "TransformerClassifier",
    "TransformerEncoderBlock",
    "TransformerLM",
    "StagedTransformer",
    "StagedLM",
    "stack_block_params",
    "packed_positions",
    "MLP",
    "MNISTCNN",
    "CIFARCNN",
    "ResNet20",
    "TextCNN",
]
