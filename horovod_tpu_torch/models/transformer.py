"""Decoder-only Transformer LM, the model of the training step.

Counterpart of ``horovod_tpu/models/transformer.py`` (dense parts,
:29-333): the same pre-norm blocks, rotary embeddings, tanh-GELU MLP at
4x width and chunked next-token loss, with parameters held in fp32 and
computed in ``cfg.dtype`` (bf16 by default). Attention goes through
``best_attention``, which takes the hand-written flash kernels
(``horovod_tpu_torch/parallel/flash_attention.py``) for causal attention
on CUDA tensors. The mixture-of-experts MLP (reference :128-225) is not
ported yet.

The numerics follow flax's defaults where torch's differ: LayerNorm has
eps 1e-6, no bias, an fp32 scale and fp32 statistics; GELU is the tanh
approximation; RoPE rotates the two halves of the head dim with fp32
angles. ``models.params_from_flax`` maps a flax parameter tree onto this
module's state dict, so one set of weights drives both models.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.common.basics import resolve_device
from horovod_tpu_torch.models.layers import Dense
from horovod_tpu_torch.parallel.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    num_heads: int = 12
    head_dim: int = 64
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    rope_theta: float = 10000.0
    # attention_fn(q, k, v, causal) -> out; None = best_attention.
    attention_fn: Optional[Callable] = None

    @property
    def embed_dim(self) -> int:
        return self.num_heads * self.head_dim


def apply_rope(x, positions, theta: float = 10000.0):
    """Rotary embeddings. x: [B, S, H, D]; positions: [B, S]."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs            # [B,S,half]
    cos = torch.cos(angles)[:, :, None, :]                   # [B,S,1,half]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def causal_attention(q, k, v, causal: bool = True):
    """Plain attention with fp32 logits and softmax. q, k, v:
    [B, S, H, D]."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(d)
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def best_attention(q, k, v, causal: bool = True):
    """Default attention: the flash kernels for causal attention on CUDA
    tensors (no [S, S] logits in device memory), dense attention
    otherwise. Both compute the same function."""
    if causal and q.is_cuda:
        return flash_attention(q, k, v, causal=True)
    return causal_attention(q, k, v, causal)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(use_bias=bias, param_dtype=float32)``: fp32
    statistics (E[x^2] - E[x]^2, clamped at 0), eps 1e-6, an fp32 scale
    and, with ``bias``, an fp32 bias; output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None,
                 eps: float = 1e-6, bias: bool = False):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = (nn.Parameter(torch.zeros(dim, device=device))
                     if bias else None)
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        if self.bias is not None:
            y = y + self.bias
        return y.to(self.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.embed_dim, cfg.num_heads * cfg.head_dim
        dense = partial(Dense, dtype=cfg.dtype, bias=False, device=device)
        self.q, self.k, self.v = dense(d, hd), dense(d, hd), dense(d, hd)
        self.o = dense(hd, d)

    def forward(self, x, positions):
        cfg = self.cfg
        b, s, _ = x.shape
        heads = (b, s, cfg.num_heads, cfg.head_dim)
        q, k, v = (f(x).view(heads) for f in (self.q, self.k, self.v))
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        attn = cfg.attention_fn or best_attention
        out = attn(q, k, v, True)
        return self.o(out.reshape(b, s, -1))


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        hidden = cfg.mlp_ratio * cfg.embed_dim
        dense = partial(Dense, dtype=cfg.dtype, bias=False, device=device)
        self.up = dense(cfg.embed_dim, hidden)
        self.down = dense(hidden, cfg.embed_dim)

    def forward(self, x):
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.ln1 = LayerNorm(cfg.embed_dim, cfg.dtype, device)
        self.attn = Attention(cfg, device)
        self.ln2 = LayerNorm(cfg.embed_dim, cfg.dtype, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x, positions):
        x = x + self.attn(self.ln1(x), positions)
        return x + self.mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """tokens [B, S] -> logits [B, S, vocab] fp32, or with
    ``return_hidden=True`` the hidden states [B, S, D] after ln_f in
    ``cfg.dtype``, the input of :func:`lm_loss_from_hidden`.

    ``device`` defaults to CUDA and must be given as ``"cpu"`` to build
    the model on the CPU. Weights are drawn from ``generator`` (a
    ``torch.Generator`` on ``device``; seed 0 when omitted): normals
    clipped at two standard deviations, of std 1/sqrt(fan_in) for the
    projections and the head,
    std 1/sqrt(D) for the embedding, ones for the norm scales."""

    def __init__(self, cfg: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        d = cfg.embed_dim
        self.embed = nn.Embedding(cfg.vocab_size, d, device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, device) for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(d, cfg.dtype, device)
        self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False,
                                 device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
                continue
            fan_in = p.shape[1]   # Dense, Linear [out, in]; Embedding [V, D]
            std = 1.0 / math.sqrt(fan_in)
            noise = torch.randn(p.shape, generator=generator,
                                device=p.device)
            p.copy_(noise.clamp_(-2.0, 2.0).mul_(std))

    def forward(self, tokens, positions=None, return_hidden: bool = False):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
            positions = positions[None].expand(tokens.shape)
        x = self.embed(tokens).to(cfg.dtype)
        for block in self.blocks:
            x = block(x, positions)
        x = self.ln_f(x)
        if return_hidden:
            return x
        return F.linear(x.float(), self.lm_head.weight)


def lm_loss(logits, tokens):
    """Next-token cross-entropy, mean over all predicted positions."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = logp.gather(-1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean()


def _chunk_ll(h, head_kernel, t):
    logp = torch.log_softmax(h.float() @ head_kernel, dim=-1)
    return logp.gather(-1, t[..., None].long()).sum()


def lm_loss_from_hidden(hidden, head_kernel, tokens, chunk: int = 1024):
    """Chunked next-token cross-entropy from hidden states: the same
    value as ``lm_loss(logits, tokens)`` without the [B, S, vocab] fp32
    logits. Each chunk of ``chunk`` positions (all batch rows) computes
    its logits and log-softmax under ``torch.utils.checkpoint``, so the
    backward recomputes them and peak logits memory is B x chunk x
    vocab. The last chunk holds the remainder; the sum is divided by
    B x (S - 1).

    hidden: [B, S, D] from ``model(tokens, return_hidden=True)``;
    head_kernel: [D, vocab] fp32, i.e. ``model.lm_head.weight.t()``."""
    targets = tokens[:, 1:]
    hid = hidden[:, :-1]
    b, s, _ = hid.shape
    chunk = min(chunk, s)
    total = hid.new_zeros((), dtype=torch.float32)
    for start in range(0, s, chunk):
        total = total + checkpoint(
            _chunk_ll, hid[:, start:start + chunk], head_kernel,
            targets[:, start:start + chunk], use_reentrant=False)
    return -total / (b * s)
