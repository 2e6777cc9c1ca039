"""Matrix products at a chosen precision.

``float32``: IEEE float32 products, TF32 off (what the reference runs).
``tf32``: the same with TF32 on (the control of a float32 program).
``fp8``: both operands rounded to float8 e4m3 with one scale a tensor
(its largest magnitude to 448), then multiplied in float32 (the control of
a bfloat16 program).  The rounding passes gradients straight through, so
the backward multiplies by the rounded operands.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("float32", "tf32", "fp8")
_E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    if x.numel() == 0:
        return x
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = amax / _E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


class Products:
    """``mm`` and ``linear`` at one precision; use inside :func:`products`."""

    def __init__(self, mode: str):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} is not one of {MODES}")
        self.mode = mode

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.mode == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self._operand(a), self._operand(b))

    def linear(self, x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
        return F.linear(self._operand(x), self._operand(weight), bias)


@contextlib.contextmanager
def products(mode: str = "float32"):
    """:class:`Products` of ``mode``, with torch's TF32 switches set for it
    (and restored after)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield Products(mode)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
