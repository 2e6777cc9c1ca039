"""Hand-written CUDA kernels for the framework's hot ops, each with its plain
PyTorch version beside it.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors, the role the Pallas interpreter plays in the JAX package's
CPU tests.  Kernels are built from ``distkeras_tpu_torch/csrc`` at first use
(:mod:`distkeras_tpu_torch.ops._build`).
"""

from distkeras_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_fwd,
    flash_attention_plain,
)

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_plain"]
