"""Layers shared by the vision models: flax's ``nn.Conv`` and ``nn.Dense``.

Both hold their weights in fp32 and compute in ``dtype``, casting input,
weight and bias to it first, as flax's ``promote_dtype`` does. Images
enter a model as ``[B, H, W, C]``, as in the reference; a model permutes
them to ``[B, C, H, W]`` views in ``torch.channels_last`` memory order
(no copy), which is cuDNN's fast layout for bf16, and every conv weight
is held in that order too.

``padding="SAME"`` follows ``lax.padtype_to_pads``: along each spatial
axis the total padding is ``max((ceil(n / s) - 1) * s + k - n, 0)``, of
which ``total // 2`` goes before and the rest after. At stride 2 on an
even input that is asymmetric (a 3x3 conv pads (0, 1), the 7x7 stem on
224 pads (2, 3)); torch's symmetric ``padding=k // 2`` would give the
same output size over windows shifted by one.

Fresh weights follow flax's initialisers: ``lecun_normal`` (a normal
truncated at two standard deviations, scaled so that the kept part has
variance 1 / fan_in) for conv and Dense kernels, zeros for biases.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# The standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's correction).
_TRUNCATED_STD = 0.87962566103423978


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(before, after) padding of one spatial axis under ``"SAME"``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: Sequence[int], stride: Sequence[int],
             value: float = 0.0) -> torch.Tensor:
    """``x`` [B, C, H, W] padded by the ``"SAME"`` rule (``F.pad`` keeps
    its memory order)."""
    (top, bottom), (left, right) = (
        same_pads(n, k, s) for n, k, s in zip(x.shape[2:], kernel, stride))
    if not (top or bottom or left or right):
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv(features, kernel_size, strides, padding, use_bias,
    dtype)`` on ``[B, C, H, W]``: ``weight`` [out, in, kh, kw] (fp32,
    channels-last), ``bias`` [out] when ``bias``."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, padding: str = "SAME", bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be SAME or VALID, got {padding}")
        self.kernel, self.stride = (kernel, kernel), (stride, stride)
        self.padding, self.dtype = padding, dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features, kernel, kernel, device=device).to(
                memory_format=torch.channels_last))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.to(self.dtype)
        if self.padding == "SAME":
            x = pad_same(x, self.kernel, self.stride)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.weight.to(self.dtype), bias, self.stride)


class Dense(nn.Module):
    """flax ``nn.Dense(features, use_bias, dtype)``: ``weight`` [out, in]
    and ``bias`` [out] in fp32, computed in ``dtype``."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32, bias: bool = True,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(features, device=device))
                     if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


def generator_for(device: torch.device,
                  generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or one seeded 0 on ``device``."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return generator


def reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every Conv and Dense weight of ``model`` from ``generator``,
    in registration order."""
    for m in model.modules():
        if isinstance(m, (Conv, Dense)):
            m.reset_parameters(generator)
