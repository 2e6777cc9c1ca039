"""The model zoo of the paper's training suite: ``MLP``, ``MNISTCNN``,
``CIFARCNN``, ``ResNet20`` and ``TextCNN``.

The port of :mod:`distkeras_tpu.models.zoo`.  Each model takes the inputs
the JAX model takes, in the JAX model's layout: images as NHWC
``[batch, height, width, channels]`` (or flat HWC vectors ``[batch, h*w*c]``
from the DataFrame path), token ids as ``[batch, seq]``; and emits logits.
Inside, the convolutions run channels-first, as torch's convolutions want
them: the NHWC input is permuted (a view, which cuDNN reads as
channels-last), pooled through NHWC views, and permuted back to NHWC before
each flatten, so a flattened row is in the JAX model's HWC order and a
Dense kernel carries over with a plain transpose
(:func:`distkeras_tpu_torch.models.convert.variables_from_flax`).

flax's numerics are kept where they differ from torch's defaults:

* ``SAME`` convolutions pad as XLA does, the odd element on the high side:
  a stride-2 3x3 conv over an even size pads ``(0, 1)``, a width-4 kernel
  ``(1, 2)``.
* Each layer computes in the dtype flax promotes its inputs and parameters
  to: under bf16 compute the convolutions run in bf16, while ``MLP``'s
  hidden layers, which the JAX model builds with ``dtype=float32``, run in
  f32 on the bf16-rounded values.
* :class:`BatchNorm` is flax's ``nn.BatchNorm(momentum=0.9)``: batch
  statistics in f32 even for bf16 inputs, the variance as
  ``E[x²] − E[x]²`` clipped at 0 (biased), the running averages updated as
  ``0.9·old + 0.1·batch`` in training.  The running averages are buffers,
  so they travel as the engine's model state.
* Weights are drawn from flax's initialisers: lecun-normal kernels, zero
  biases, normal embeddings with std ``1/sqrt(dim)``, BatchNorm at
  identity.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distkeras_tpu_torch.models.transformer import (
    _dropout,
    _lecun_normal_,
    _normal_,
    _take_fill,
)
from distkeras_tpu_torch.ops.pooling import max_pool, same_padding

__all__ = ["BatchNorm", "CIFARCNN", "Conv", "MLP", "MNISTCNN", "ResNet20", "TextCNN"]


def _promoted(*tensors) -> torch.dtype:
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return dtype


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype] = None):
    """flax ``nn.Dense``: input, kernel and bias promoted to one dtype
    (``dtype`` when the layer fixes one) before the product."""
    dtype = dtype or _promoted(x, layer.weight, layer.bias)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def _to_channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


def _pool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max pool, stride 2, of a channels-first map, through the NHWC
    reshape path of :func:`max_pool`."""
    return _to_channels_first(max_pool(_to_channels_last(x), (2, 2), strides=(2, 2)))


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten a channels-first map in the JAX model's NHWC order."""
    return _to_channels_last(x).reshape(x.shape[0], -1)


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``SAME`` padding, over channels-first inputs
    ``[batch, in_features, *spatial]``: weight ``[features, in_features,
    *kernel_size]`` (flax's kernel is ``[*kernel_size, in, out]``)."""

    def __init__(self, in_features: int, features: int, kernel_size: Sequence[int],
                 strides: int = 1, use_bias: bool = True):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        self.strides = int(strides)
        self.weight = nn.Parameter(torch.empty(features, in_features, *self.kernel_size))
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(features))
        else:
            self.register_parameter("bias", None)

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        fan_in = self.weight.shape[1] * math.prod(self.kernel_size)
        _lecun_normal_(self.weight, fan_in, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tensors = (x, self.weight) + ((self.bias,) if self.bias is not None else ())
        dtype = _promoted(*tensors)
        weight = self.weight.to(dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        pads = [same_padding(s, k, self.strides)
                for s, k in zip(x.shape[2:], self.kernel_size)]
        x = x.to(dtype)
        if all(lo == hi for lo, hi in pads):
            padding = [lo for lo, _ in pads]
        else:
            x = F.pad(x, [p for pair in reversed(pads) for p in pair])
            padding = 0
        conv = F.conv1d if len(self.kernel_size) == 1 else F.conv2d
        return conv(x, weight, bias, self.strides, padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over dim 1 of a
    channels-first input.  ``weight``/``bias`` are flax's
    ``scale``/``bias``; the buffers ``running_mean``/``running_var`` its
    ``batch_stats`` ``mean``/``var``, which a training call updates in
    place."""

    def __init__(self, features: int, momentum: float = 0.9, epsilon: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        del generator
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # at least f32
        if training:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = xf.mean(dim=dims)
            var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.epsilon) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(_promoted(x, self.weight, self.bias))


class _ZooModel(nn.Module):
    """Shared initialisation: every layer drawn as flax draws it."""

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every weight as the JAX package's flax initialisers do.
        ``generator`` (a CPU ``torch.Generator``) makes the draw
        reproducible."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, module.in_features, generator)
                module.bias.zero_()
            elif isinstance(module, (Conv, BatchNorm)):
                module.reset_parameters(generator)
            elif isinstance(module, nn.Embedding):
                _normal_(module.weight, math.sqrt(1.0 / module.embedding_dim), generator)


class MLP(_ZooModel):
    """The MNIST MLP (JAX ``zoo.py:23``): Dense + ReLU layers of
    ``features`` and a logits head.  ``in_features`` is the flattened input
    width (flax infers it from the first input)."""

    def __init__(self, features: Sequence[int] = (500, 250, 125), num_classes: int = 10,
                 dropout: float = 0.0, in_features: int = 784,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        widths = (in_features, *features)
        self.hidden = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths, widths[1:]))
        self.head = nn.Linear(widths[-1], num_classes)
        self.reset_parameters(generator)

    def forward(self, x, training: bool = False, generator=None):
        x = x.reshape(x.shape[0], -1)
        for layer in self.hidden:
            # the JAX model fixes these layers' dtype to float32
            x = F.relu(_dense(layer, x, torch.float32))
            x = _dropout(x, self.dropout, training, generator)
        return _dense(self.head, x)


class MNISTCNN(_ZooModel):
    """Small convnet for 28x28x1 inputs (JAX ``zoo.py:41``)."""

    def __init__(self, num_classes: int = 10, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList([Conv(1, 32, (3, 3)), Conv(32, 64, (3, 3))])
        self.fc = nn.Linear(7 * 7 * 64, 128)
        self.head = nn.Linear(128, num_classes)
        self.reset_parameters(generator)

    def forward(self, x, training: bool = False, generator=None):
        if x.dim() == 2:  # flat 784 vectors from the DataFrame path
            x = x.reshape(x.shape[0], 28, 28, 1)
        x = _to_channels_first(x)
        for conv in self.convs:
            x = _pool2x2(F.relu(conv(x)))
        x = F.relu(_dense(self.fc, _flatten_hwc(x)))
        return _dense(self.head, x)


class CIFARCNN(_ZooModel):
    """The CIFAR-10 CNN of the paper's headline configuration (JAX
    ``zoo.py:59``): two blocks of two 3x3 convs and a 2x2 pool (64, then
    128 channels), Dense 256, logits."""

    def __init__(self, num_classes: int = 10, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.convs = nn.ModuleList([Conv(3, 64, (3, 3)), Conv(64, 64, (3, 3)),
                                    Conv(64, 128, (3, 3)), Conv(128, 128, (3, 3))])
        self.fc = nn.Linear(8 * 8 * 128, 256)
        self.head = nn.Linear(256, num_classes)
        self.reset_parameters(generator)

    def forward(self, x, training: bool = False, generator=None):
        if x.dim() == 2:  # flat HWC vectors from the DataFrame path
            x = x.reshape(x.shape[0], 32, 32, 3)
        x = _to_channels_first(x)
        for i in (0, 2):
            x = F.relu(self.convs[i + 1](F.relu(self.convs[i](x))))
            x = _pool2x2(x)
        x = F.relu(_dense(self.fc, _flatten_hwc(x)))
        return _dense(self.head, x)


class _ResBlock(nn.Module):
    """Two 3x3 convs with BatchNorm and a residual; a strided 1x1
    projection where the shape changes (JAX ``zoo.py:77``)."""

    def __init__(self, in_features: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = Conv(in_features, filters, (3, 3), strides, use_bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv(filters, filters, (3, 3), use_bias=False)
        self.bn2 = BatchNorm(filters)
        self.proj = (Conv(in_features, filters, (1, 1), strides, use_bias=False)
                     if in_features != filters or strides != 1 else None)

    def forward(self, x, training: bool = False):
        y = F.relu(self.bn1(self.conv1(x), training))
        y = self.bn2(self.conv2(y), training)
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + y)


class ResNet20(_ZooModel):
    """ResNet-20 for CIFAR-10 (JAX ``zoo.py:93``): a 3x3 stem, nine
    residual blocks (16, 32, 64 channels, stride 2 at each widening), a
    global mean pool and a logits head.  Its BatchNorm running statistics
    are buffers: the model state the engine averages at each commit."""

    _BLOCKS = ((16, 1), (16, 1), (16, 1), (32, 2), (32, 1), (32, 1), (64, 2), (64, 1), (64, 1))

    def __init__(self, num_classes: int = 10, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stem = Conv(3, 16, (3, 3), use_bias=False)
        self.stem_bn = BatchNorm(16)
        widths = [16] + [f for f, _ in self._BLOCKS]
        self.blocks = nn.ModuleList(
            _ResBlock(cin, f, s) for cin, (f, s) in zip(widths, self._BLOCKS))
        self.head = nn.Linear(64, num_classes)
        self.reset_parameters(generator)

    def forward(self, x, training: bool = False, generator=None):
        if x.dim() == 2:
            x = x.reshape(x.shape[0], 32, 32, 3)
        x = F.relu(self.stem_bn(self.stem(_to_channels_first(x)), training))
        for block in self.blocks:
            x = block(x, training)
        return _dense(self.head, x.mean(dim=(2, 3)))


class TextCNN(_ZooModel):
    """The IMDB text CNN (Kim 2014; JAX ``zoo.py:115``) over int token ids
    ``[batch, seq]``: an embedding, one ``SAME`` 1-D conv per kernel size,
    each max-pooled over time, concatenated into a logits head."""

    def __init__(self, vocab_size: int = 20000, embed_dim: int = 128,
                 kernel_sizes: Sequence[int] = (3, 4, 5), filters: int = 128,
                 num_classes: int = 2, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.embed = nn.Embedding(vocab_size, embed_dim)
        self.convs = nn.ModuleList(Conv(embed_dim, filters, (k,)) for k in kernel_sizes)
        self.head = nn.Linear(filters * len(kernel_sizes), num_classes)
        self.reset_parameters(generator)

    def forward(self, x, training: bool = False, generator=None):
        x = _take_fill(self.embed, x.long())  # [b, seq, embed]
        x = _to_channels_first(x)
        # the max over time splits a tie's gradient evenly, as jnp.max does
        x = torch.cat([F.relu(conv(x)).amax(dim=2) for conv in self.convs], dim=-1)
        x = _dropout(x, self.dropout, training, generator)
        return _dense(self.head, x)
