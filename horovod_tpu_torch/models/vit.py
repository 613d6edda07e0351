"""Vision Transformer, the second vision family beside ResNet.

Counterpart of ``horovod_tpu/models/vit.py``: a ``"VALID"`` strided conv
cuts the image into patches, a learned fp32 position embedding (cast to
``dtype``) is added, pre-norm encoder blocks follow, and the head pools
by the mean over patches (no CLS token) into an fp32 Dense.

The numerics are flax's: LayerNorm with eps 1e-6 and a bias, tanh GELU,
and ``nn.MultiHeadDotProductAttention``: q, k and v from Dense layers
with bias into ``[heads, head_dim]``, the query divided by
sqrt(head_dim) (rounded to ``dtype``), logits, softmax and the weighted
sum all in ``dtype`` (flax's ``force_fp32_for_softmax=False``), and the
output projection from ``[heads, head_dim]``. The attention is plain
einsum and softmax, as in the reference, where it reaches no Pallas
kernel. Submodules carry the flax names (``patch_embed``, ``pos_embed``,
``blocks.L`` for ``block_L``, ``ln1``, ``attn.query``/``key``/``value``/
``out``, ``ln2``, ``up``, ``down``, ``ln_f``, ``head``) for
``params_from_flax``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models.layers import (
    Conv, Dense, generator_for, reset_parameters,
)
from horovod_tpu_torch.models.transformer import LayerNorm


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16


class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads, dtype)`` as
    self-attention without a mask."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        d, dt = cfg.embed_dim, cfg.dtype
        self.heads = cfg.num_heads
        # flax divides by sqrt(head_dim) computed in fp32, cast to dtype.
        root = torch.tensor(math.sqrt(d // self.heads), dtype=torch.float32)
        self.depth = float(root.to(dt))
        self.query = Dense(d, d, dt, device=device)
        self.key = Dense(d, d, dt, device=device)
        self.value = Dense(d, d, dt, device=device)
        self.out = Dense(d, d, dt, device=device)

    def forward(self, x):
        b, s, d = x.shape
        heads = (b, s, self.heads, d // self.heads)
        q, k, v = (f(x).view(heads)
                   for f in (self.query, self.key, self.value))
        logits = torch.einsum("bqhd,bkhd->bhqk", q / self.depth, k)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(b, s, d))


class EncoderBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        d, dt = cfg.embed_dim, cfg.dtype
        self.ln1 = LayerNorm(d, dt, device, bias=True)
        self.attn = MultiHeadAttention(cfg, device)
        self.ln2 = LayerNorm(d, dt, device, bias=True)
        self.up = Dense(d, cfg.mlp_ratio * d, dt, device=device)
        self.down = Dense(cfg.mlp_ratio * d, d, dt, device=device)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        y = F.gelu(self.up(self.ln2(x)), approximate="tanh")
        return x + self.down(y)


class ViT(nn.Module):
    """images [B, H, W, 3] -> logits [B, num_classes] fp32. ``device``
    defaults to CUDA (``"cpu"`` must be asked for); weights come from
    ``generator`` (seed 0 when omitted) by flax's initialisers, the
    position embedding from a normal of std 0.02."""

    def __init__(self, cfg: ViTConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dtype = cfg, cfg.dtype
        d, p = cfg.embed_dim, cfg.patch_size
        patches = (cfg.image_size // p) ** 2
        self.patch_embed = Conv(3, d, p, p, "VALID", bias=True,
                                dtype=cfg.dtype, device=device)
        self.pos_embed = nn.Parameter(torch.empty(1, patches, d,
                                                  device=device))
        self.blocks = nn.ModuleList(EncoderBlock(cfg, device)
                                    for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(d, cfg.dtype, device, bias=True)
        self.head = Dense(d, cfg.num_classes, torch.float32, device=device)
        generator = generator_for(device, generator)
        reset_parameters(self, generator)
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, images):
        cfg = self.cfg
        x = self.patch_embed(images.to(cfg.dtype).permute(0, 3, 1, 2))
        b, d = x.shape[:2]
        x = x.permute(0, 2, 3, 1).reshape(b, -1, d)   # [B, h*w, D]
        x = x + self.pos_embed.to(cfg.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x).mean(dim=1)
        return self.head(x.float())


def ViT_S16(device=None, generator=None, **kw) -> ViT:
    return ViT(ViTConfig(embed_dim=384, num_layers=12, num_heads=6, **kw),
               device, generator)


def ViT_B16(device=None, generator=None, **kw) -> ViT:
    return ViT(ViTConfig(**kw), device, generator)
