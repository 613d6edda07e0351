"""ResNet v1.5, the model of the bench's headline leg.

Counterpart of ``horovod_tpu/models/resnet.py:26-111``: bottleneck and
basic blocks with the stride in the 3x3 conv, conv weights in fp32
computed in ``dtype`` (bf16 by default), BatchNorm with fp32 statistics
and an fp32 head. Images enter as ``[B, H, W, C]``; the convolutions run
on channels-last views (``models/layers.py``). Training and evaluation
are ``model.train()`` and ``model.eval()`` (the reference's ``train``
argument).

Submodules carry the flax module names (``conv_init``, ``bn_init``,
``BottleneckBlock_3``, ``Conv_1``, ``BatchNorm_2``, ``conv_proj``,
``norm_proj``, ``head``), so that a state-dict key is the flax path of the
same weight; ``params_from_flax`` (``models/carry.py``) maps a flax
``{"params", "batch_stats"}`` tree onto it.

BatchNorm is flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, not
``nn.BatchNorm2d``: statistics in fp32 as E[x^2] - E[x]^2 clipped at 0,
the running averages weight the old value by ``momentum`` and take the
biased variance, the output is in ``dtype``. With ``axis_name`` the
training statistics are averaged over that mesh axis (one allreduce of
the stacked ``[2, C]`` mean and mean square per norm, as the reference's
``pmean``), and the backward averages their gradient over it too.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch import spmd
from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models.layers import (
    Conv, Dense, generator_for, pad_same, reset_parameters,
)

_DIMS = (0, 2, 3)   # the reduced axes of [B, C, H, W]


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    return t.view(1, -1, 1, 1)


def _pmean(stats: torch.Tensor, axis: str) -> torch.Tensor:
    """The mean of ``stats`` over the mesh axis, in place."""
    return spmd.allreduce_(stats, spmd.Average, axis)


def _pmean_grad(grad: torch.Tensor, axis: str) -> torch.Tensor:
    """The backward of :func:`_pmean`: the cotangent of an axis mean is
    the axis mean of the cotangents."""
    return spmd.allreduce_(grad, spmd.Average, axis)


class _BatchNormTrain(torch.autograd.Function):
    """Training-mode BatchNorm over [B, C, H, W] with batch statistics,
    averaged over ``axis`` when it is not None. Returns the output in
    ``x.dtype`` and the fp32 mean and (biased) variance used, the latter
    two for the running averages only.

    Saves ``x`` in its own dtype, the mean and 1/std: the backward
    recomputes x - mean rather than holding an fp32 copy of it."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float, axis: Optional[str]):
        xf = x.float()
        stats = torch.stack([xf.mean(_DIMS), (xf * xf).mean(_DIMS)])
        if axis is not None:
            stats = _pmean(stats, axis)
        mean, mean_sq = stats
        spread = mean_sq - mean * mean
        var = spread.clamp_min(0.0)
        rstd = torch.rsqrt(var + eps)
        y = x - _per_channel(mean)
        y = y.mul_(_per_channel(rstd * scale)).add_(_per_channel(bias))
        ctx.save_for_backward(x, mean, rstd, scale, spread > 0)
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, rstd, scale, unclipped = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        xc = x - _per_channel(mean)                  # fp32
        dyf = dy.float()
        dbias = dyf.sum(_DIMS)
        dscale = (dyf * xc).sum(_DIMS) * rstd
        # y = (x - mean) * rstd * scale + bias, var = mean_sq - mean^2:
        # the gradients of this rank's loss with respect to the mean and
        # the mean square that every rank used.
        dvar = (-0.5 * scale * rstd * rstd * dscale) * unclipped
        dstats = torch.stack([-scale * rstd * dbias - 2.0 * mean * dvar,
                              dvar])
        if ctx.axis is not None:
            dstats = _pmean_grad(dstats, ctx.axis)
        dmean, dmean_sq = dstats
        # d/dx of x's own mean (1/n) and mean square (2x/n), written
        # around x - mean so that a large mean does not cancel.
        k1 = rstd * scale
        c1 = 2.0 * dmean_sq / n
        c0 = (dmean + 2.0 * mean * dmean_sq) / n
        dx = xc.mul_(_per_channel(c1)).add_(_per_channel(c0))
        dx = dx.addcmul_(dyf, _per_channel(k1))
        return dx.to(x.dtype), dscale, dbias, None, None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channels of [B, C, H, W]: ``scale``
    and ``bias`` fp32 parameters, ``mean`` and ``var`` fp32 running
    averages. ``axis_name`` averages the training statistics over that
    mesh axis (through ``horovod_tpu_torch.spmd``)."""

    def __init__(self, features: int, dtype: torch.dtype,
                 axis_name: Optional[str] = None, momentum: float = 0.9,
                 eps: float = 1e-5, scale_init: float = 1.0, device=None):
        super().__init__()
        self.dtype, self.axis_name = dtype, axis_name
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.full((features,), scale_init,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))

    def forward(self, x):
        if not self.training:
            mul = torch.rsqrt(self.var + self.eps) * self.scale
            y = (x - _per_channel(self.mean)) * _per_channel(mul)
            return (y + _per_channel(self.bias)).to(self.dtype)
        y, mean, var = _BatchNormTrain.apply(
            x.to(self.dtype), self.scale, self.bias, self.eps,
            self.axis_name)
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_(m * self.mean + (1 - m) * mean)
            self.var.copy_(m * self.var + (1 - m) * var)
        return y


class BottleneckBlock(nn.Module):
    """1x1, 3x3 (with the stride), 1x1 at 4x ``filters``; a projection
    of the residual where the shape changes. The last norm starts at
    scale 0, so a fresh block is the identity."""

    expansion = 4

    def __init__(self, in_features: int, filters: int, stride: int,
                 dtype, axis_name, device=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device)
        norm = partial(BatchNorm, dtype=dtype, axis_name=axis_name,
                       device=device)
        out = filters * 4
        self.Conv_0 = conv(in_features, filters, 1)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3, stride)
        self.BatchNorm_1 = norm(filters)
        self.Conv_2 = conv(filters, out, 1)
        self.BatchNorm_2 = norm(out, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        if in_features != out or stride != 1:
            self.conv_proj = conv(in_features, out, 1, stride)
            self.norm_proj = norm(out)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)), inplace=True)
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)), inplace=True)
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(y.add_(residual), inplace=True)


class BasicBlock(nn.Module):
    """Two 3x3 convs (the first with the stride); a projection of the
    residual where the shape changes. The last norm starts at scale 0."""

    expansion = 1

    def __init__(self, in_features: int, filters: int, stride: int,
                 dtype, axis_name, device=None):
        super().__init__()
        conv = partial(Conv, dtype=dtype, device=device)
        norm = partial(BatchNorm, dtype=dtype, axis_name=axis_name,
                       device=device)
        self.Conv_0 = conv(in_features, filters, 3, stride)
        self.BatchNorm_0 = norm(filters)
        self.Conv_1 = conv(filters, filters, 3)
        self.BatchNorm_1 = norm(filters, scale_init=0.0)
        self.conv_proj = self.norm_proj = None
        if in_features != filters or stride != 1:
            self.conv_proj = conv(in_features, filters, 1, stride)
            self.norm_proj = norm(filters)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)), inplace=True)
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x
        if self.conv_proj is not None:
            residual = self.norm_proj(self.conv_proj(x))
        return F.relu(y.add_(residual), inplace=True)


class ResNet(nn.Module):
    """images [B, H, W, C] -> logits [B, num_classes] fp32.

    ``device`` defaults to CUDA and must be given as ``"cpu"`` to build
    the model on the CPU. Weights are drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when omitted) by flax's
    initialisers."""

    def __init__(self, stage_sizes: Sequence[int], block_cls,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16,
                 axis_name: Optional[str] = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.conv_init = Conv(3, num_filters, 7, 2, dtype=dtype,
                              device=device)
        self.bn_init = BatchNorm(num_filters, dtype, axis_name,
                                 device=device)
        self.block_names = []
        features = num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2 ** i
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block_cls(features, filters, stride,
                                                dtype, axis_name, device))
                self.block_names.append(name)
                features = filters * block_cls.expansion
        self.head = Dense(features, num_classes, torch.float32,
                          device=device)
        reset_parameters(self, generator_for(device, generator))

    def forward(self, images):
        x = images.to(self.dtype).permute(0, 3, 1, 2)   # channels-last view
        x = F.relu(self.bn_init(self.conv_init(x)), inplace=True)
        x = F.max_pool2d(pad_same(x, (3, 3), (2, 2), float("-inf")), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.head(x.mean(dim=(2, 3)).float())


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3],
                   block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3],
                    block_cls=BottleneckBlock)
