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
angles. :func:`params_from_flax` maps a flax parameter tree onto this
module's state dict, so one set of weights drives both models.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.common.basics import resolve_device
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
    """flax ``nn.LayerNorm(use_bias=False, param_dtype=float32)``: fp32
    statistics (E[x^2] - E[x]^2, clamped at 0), eps 1e-6, output in
    ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None,
                 eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return y.to(self.dtype)


def _linear(x, weight, dtype):
    """flax Dense with ``dtype``: input and fp32 kernel both cast."""
    return F.linear(x.to(dtype), weight.to(dtype))


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.embed_dim, cfg.num_heads * cfg.head_dim
        self.q = nn.Linear(d, hd, bias=False, device=device)
        self.k = nn.Linear(d, hd, bias=False, device=device)
        self.v = nn.Linear(d, hd, bias=False, device=device)
        self.o = nn.Linear(hd, d, bias=False, device=device)

    def forward(self, x, positions):
        cfg = self.cfg
        b, s, _ = x.shape
        heads = (b, s, cfg.num_heads, cfg.head_dim)
        q = _linear(x, self.q.weight, cfg.dtype).view(heads)
        k = _linear(x, self.k.weight, cfg.dtype).view(heads)
        v = _linear(x, self.v.weight, cfg.dtype).view(heads)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        attn = cfg.attention_fn or best_attention
        out = attn(q, k, v, True)
        return _linear(out.reshape(b, s, -1), self.o.weight, cfg.dtype)


class MLP(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        hidden = cfg.mlp_ratio * cfg.embed_dim
        self.up = nn.Linear(cfg.embed_dim, hidden, bias=False, device=device)
        self.down = nn.Linear(hidden, cfg.embed_dim, bias=False,
                              device=device)

    def forward(self, x):
        dt = self.cfg.dtype
        h = F.gelu(_linear(x, self.up.weight, dt), approximate="tanh")
        return _linear(h, self.down.weight, dt)


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
            fan_in = p.shape[1]   # Linear [out, in]; Embedding [V, D]
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


def params_from_flax(tree) -> Dict[str, torch.Tensor]:
    """A flax ``TransformerLM`` parameter tree (``variables["params"]``
    as nested dicts of numpy arrays) -> this module's state dict, fp32.

    Mappings (L = block index, D = embed dim, H x hd = heads):

    - ``embed/embedding`` [V, D]            -> ``embed.weight``
    - ``block_L/ln1/scale``, ``ln2/scale`` [D] -> ``blocks.L.ln1.scale``,
      ``blocks.L.ln2.scale``
    - ``block_L/attn/{q,k,v}/kernel`` [D, H, hd] -> reshaped to
      [D, H*hd] and transposed -> ``blocks.L.attn.{q,k,v}.weight``
    - ``block_L/attn/o/kernel`` [H, hd, D] -> reshaped to [H*hd, D] and
      transposed -> ``blocks.L.attn.o.weight``
    - ``block_L/mlp/{up,down}/kernel`` [in, out] -> transposed ->
      ``blocks.L.mlp.{up,down}.weight``
    - ``ln_f/scale`` [D]                    -> ``ln_f.scale``
    - ``lm_head/kernel`` [D, V]             -> transposed -> ``lm_head.weight``
    """
    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    out = {"embed.weight": t(tree["embed"]["embedding"]),
           "ln_f.scale": t(tree["ln_f"]["scale"]),
           "lm_head.weight": t(tree["lm_head"]["kernel"]).T.contiguous()}
    layers = sorted(int(name.split("_")[1]) for name in tree
                    if name.startswith("block_"))
    for i in layers:
        blk, pre = tree[f"block_{i}"], f"blocks.{i}."
        attn = blk["attn"]
        d = attn["q"]["kernel"].shape[0]
        for name in ("q", "k", "v"):
            w = t(attn[name]["kernel"]).reshape(d, -1)
            out[pre + f"attn.{name}.weight"] = w.T.contiguous()
        out[pre + "attn.o.weight"] = \
            t(attn["o"]["kernel"]).reshape(-1, d).T.contiguous()
        for name in ("up", "down"):
            out[pre + f"mlp.{name}.weight"] = \
                t(blk["mlp"][name]["kernel"]).T.contiguous()
        out[pre + "ln1.scale"] = t(blk["ln1"]["scale"])
        out[pre + "ln2.scale"] = t(blk["ln2"]["scale"])
    return out
