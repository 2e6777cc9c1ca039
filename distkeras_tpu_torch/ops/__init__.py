"""Compute ops: losses, metrics, the optimizer registry, and hand-written
CUDA kernels for the framework's hot ops, each with its plain PyTorch
version beside it.

A kernel wrapper launches its kernel for CUDA tensors and runs the plain
version for CPU tensors, the role the Pallas interpreter plays in the JAX
package's CPU tests.  Kernels are built from ``distkeras_tpu_torch/csrc``
at first use (:mod:`distkeras_tpu_torch.ops._build`).
"""

from distkeras_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from distkeras_tpu_torch.ops.losses import get_loss
from distkeras_tpu_torch.ops.metrics import accuracy, get_metric, token_accuracy
from distkeras_tpu_torch.ops.optimizers import get_optimizer

__all__ = [
    "accuracy",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_plain",
    "get_loss",
    "get_metric",
    "get_optimizer",
    "token_accuracy",
]
