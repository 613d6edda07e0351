"""Small MNIST convnet, the model of the end-to-end examples.

Counterpart of ``horovod_tpu/models/mnist.py:16-33``: two 3x3 convs with
bias (flax's default ``"SAME"`` padding, so (1, 1) at stride 1), a 2x2
max-pool (``"VALID"``), Dense(128) and an fp32 head. The features are
flattened in the reference's [H, W, C] order, so that carried Dense
weights line up. Submodules carry the flax names (``Conv_0``,
``Conv_1``, ``Dense_0``, ``Dense_1``) for ``params_from_flax``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models.layers import (
    Conv, Dense, generator_for, reset_parameters,
)


class MnistConvNet(nn.Module):
    """images [B, 28, 28, 1] -> logits [B, num_classes] fp32. ``device``
    defaults to CUDA (``"cpu"`` must be asked for); weights come from
    ``generator`` (seed 0 when omitted) by flax's initialisers."""

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.Conv_0 = Conv(1, 32, 3, bias=True, dtype=dtype, device=device)
        self.Conv_1 = Conv(32, 64, 3, bias=True, dtype=dtype, device=device)
        self.Dense_0 = Dense(14 * 14 * 64, 128, dtype, device=device)
        self.Dense_1 = Dense(128, num_classes, torch.float32, device=device)
        reset_parameters(self, generator_for(device, generator))

    def forward(self, images):
        x = images.to(self.dtype).permute(0, 3, 1, 2)   # channels-last view
        x = F.relu(self.Conv_0(x))
        x = F.relu(self.Conv_1(x))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # [H, W, C]
        return self.Dense_1(F.relu(self.Dense_0(x)))
