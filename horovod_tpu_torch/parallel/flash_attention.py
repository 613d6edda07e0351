"""Flash attention on Hopper: the attention hot op of the Transformer LM.

Counterpart of ``horovod_tpu/parallel/flash_attention.py`` (public
contract :436-566). The three Pallas kernels there have hand-written
CUDA counterparts in ``horovod_tpu_torch/csrc``:

- ``_kernel`` (:58)          -> ``flash_fwd.cu``  via :func:`_flash_fwd`
- ``_bwd_dq_kernel`` (:204)  -> ``flash_bwd.cu``  via :func:`_flash_dq`
- ``_bwd_dkv_kernel`` (:236) -> ``flash_bwd.cu``  via :func:`_flash_dkv`

Each wrapper launches its kernel for CUDA tensors and counts the launch
(``flash_fwd_launches``, ``flash_dq_launches``, ``flash_dkv_launches``);
for CPU tensors it computes the same function with its plain PyTorch
version (``_flash_fwd_plain``, ``_flash_dq_plain``, ``_flash_dkv_plain``),
which is what the CPU tests run. A CUDA tensor never reaches a plain
version: the kernel launches or the wrapper raises.

Tensors are ``[B, S, H, D]`` (the module layout of models/transformer.py)
and the kernels read that layout in place; the softmax statistics
``(m, l)`` are ``[B, H, Sq]`` fp32. Offsets are the global positions of
q[0] and k[0] and shift the causal mask; they are plain kernel arguments,
so no value needs a new build. The kernels tile by 64 rows: a sequence
that is a multiple of 64, or shorter than 64, runs the kernels; a longer
one that is not falls back to the dense formulation when causal and
raises ``ValueError`` when not, as the reference does for its blocks.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

from horovod_tpu_torch import _cuda

_NEG_INF = -1e30
BLOCK = 64   # rows of the kernels' q and kv tiles (csrc/flash_common.cuh)
HEAD_DIMS = (16, 32, 64, 128)   # head dims the kernels are built for

# Launches of each kernel since the last reset_launch_counts().
flash_fwd_launches = 0
flash_dq_launches = 0
flash_dkv_launches = 0

Offset = Union[int, torch.Tensor]


def reset_launch_counts() -> None:
    global flash_fwd_launches, flash_dq_launches, flash_dkv_launches
    flash_fwd_launches = flash_dq_launches = flash_dkv_launches = 0


def launch_counts() -> dict:
    return {"flash_fwd": flash_fwd_launches, "flash_dq": flash_dq_launches,
            "flash_dkv": flash_dkv_launches}


# ---------------------------------------------------------------------------
# Plain versions (dense, fp32): the CPU path and the kernels' yardstick
# ---------------------------------------------------------------------------

def _scores(q, k, causal, q_offset, k_offset):
    """Scaled fp32 logits [B,H,Sq,Sk] with masked entries at -1e30, and
    the mask (None when not causal)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (1.0 / math.sqrt(d))
    if not causal:
        return s, None
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
    allowed = q_pos[:, None] >= k_pos[None, :]
    return s.masked_fill(~allowed, _NEG_INF), allowed


def _flash_fwd_plain(q, k, v, causal, q_offset, k_offset):
    """What ``_kernel`` computes, densely: (o [B,Sq,H,D] in q.dtype,
    m [B,H,Sq], l [B,H,Sq] fp32); rows that see no key give o = 0,
    m = -1e30, l = 0."""
    s, allowed = _scores(q, k, causal, q_offset, k_offset)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if allowed is not None:
        p = p * allowed
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    o = o / denom.transpose(1, 2)[..., None]
    return o.to(q.dtype), m, l


def _p_ds_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset):
    """What ``_recompute_p_ds`` computes for every tile at once:
    p = exp(s - lse) and ds = p * (dp - delta) * scale, [B,H,Sq,Sk]."""
    s, allowed = _scores(q, k, causal, q_offset, k_offset)
    p = torch.exp(s - lse[..., None])
    if allowed is not None:
        p = p * allowed
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
    return p, ds


def _flash_dq_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset):
    """What ``_bwd_dq_kernel`` computes: dq = ds @ k, in q.dtype."""
    _, ds = _p_ds_plain(q, k, v, do, lse, delta, causal, q_offset,
                        k_offset)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def _flash_dkv_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset):
    """What ``_bwd_dkv_kernel`` computes: dk = ds^T @ q, dv = p^T @ do."""
    p, ds = _p_ds_plain(q, k, v, do, lse, delta, causal, q_offset,
                        k_offset)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _dense_reference(q, k, v, causal: bool, q_offset=0, k_offset=0):
    """Dense attention with an fp32 softmax (reference :347-362): the
    fallback for indivisible causal shapes and the tests' oracle.
    Differentiable by autograd."""
    s, allowed = _scores(q, k, causal, q_offset, k_offset)
    probs = torch.softmax(s, dim=-1)
    if allowed is not None:
        probs = probs * allowed
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(name, tensors, seqs):
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, S, H, D], got {q.shape}")
    b, _, h, d = q.shape
    dev, dt = q.device, q.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev}; CPU or CUDA only")
    if dev.type == "cuda":
        if dt not in _DTYPES:
            raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                            f"got {dt}")
        if d not in HEAD_DIMS:
            raise ValueError(f"{name}: the kernel takes head dims "
                             f"{HEAD_DIMS}, got {d}")
    for t, seq in zip(tensors, seqs):
        _same(name, t, dev, (b, seq, h, d), dt)
    return b, h, d


def _same(name, t, dev, shape, dtype):
    if t.device != dev:
        raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if dev.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs contiguous tensors")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _flash_fwd(q, k, v, causal: bool, q_offset: int, k_offset: int):
    """Forward kernel: (o, m, l) as ``_flash_fwd_plain`` returns them."""
    global flash_fwd_launches
    sq, sk = q.shape[1], k.shape[1]
    b, h, d = _check("flash forward", (q, k, v), (sq, sk, sk))
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
    lib = _cuda.load()
    o = torch.empty_like(q)
    m = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        err = lib.hvdt_flash_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, sq, sk, d,
            q_offset, k_offset, int(causal), _stream(q))
    _cuda.check(err, "flash forward kernel")
    flash_fwd_launches += 1
    return o, m, l


def _bwd_inputs(name, q, k, v, do, lse, delta):
    sq, sk = q.shape[1], k.shape[1]
    b, h, d = _check(name, (q, k, v, do), (sq, sk, sk, sq))
    for t in (lse, delta):
        _same(name, t, q.device, (b, h, sq), torch.float32)
    return b, h, sq, sk, d


def _flash_dq(q, k, v, do, lse, delta, causal: bool, q_offset: int,
              k_offset: int):
    """dq kernel; lse and delta are [B,H,Sq] fp32."""
    global flash_dq_launches
    b, h, sq, sk, d = _bwd_inputs("flash dq", q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return _flash_dq_plain(q, k, v, do, lse, delta, causal, q_offset,
                               k_offset)
    lib = _cuda.load()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.hvdt_flash_dq(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, sq, sk, d, q_offset, k_offset, int(causal), _stream(q))
    _cuda.check(err, "flash dq kernel")
    flash_dq_launches += 1
    return dq


def _flash_dkv(q, k, v, do, lse, delta, causal: bool, q_offset: int,
               k_offset: int):
    """dk/dv kernel; lse and delta are [B,H,Sq] fp32."""
    global flash_dkv_launches
    b, h, sq, sk, d = _bwd_inputs("flash dk/dv", q, k, v, do, lse, delta)
    if q.device.type == "cpu":
        return _flash_dkv_plain(q, k, v, do, lse, delta, causal, q_offset,
                                k_offset)
    lib = _cuda.load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.hvdt_flash_dkv(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, sq, sk, d, q_offset, k_offset, int(causal),
            _stream(q))
    _cuda.check(err, "flash dk/dv kernel")
    flash_dkv_launches += 1
    return dk, dv


# ---------------------------------------------------------------------------
# Public API (reference :436-566)
# ---------------------------------------------------------------------------

def _shapes_ok(seq_q: int, seq_k: int) -> bool:
    return all(s % min(BLOCK, s) == 0 for s in (seq_q, seq_k))


def _offset(x: Offset) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def _require_blocks(seq_q, seq_k):
    if not _shapes_ok(seq_q, seq_k):
        raise ValueError(
            f"sequence lengths ({seq_q}, {seq_k}) must be multiples of "
            f"{BLOCK} or shorter than it")


def flash_attention_stats(q, k, v, causal: bool = True,
                          q_offset: Offset = 0, k_offset: Offset = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Forward-only flash attention that also returns the softmax
    statistics: (o [B,Sq,H,D], m [B,H,Sq] running max, l [B,H,Sq]
    normalizer). Ring attention merges these across rotated kv
    shards."""
    _require_blocks(q.shape[1], k.shape[1])
    return _flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                      bool(causal), _offset(q_offset), _offset(k_offset))


def _lse_from_stats(m, l):
    """lse = m + log l, [B,H,S] fp32; +inf marks dead rows (l == 0) so
    the backward's exp(s - lse) is exactly 0 for them."""
    live = l > 0.0
    lse = m + torch.log(torch.where(live, l, torch.ones_like(l)))
    return torch.where(live, lse, torch.full_like(lse, math.inf))


def flash_attention_bwd(q, k, v, o, m, l, do, causal: bool = True,
                        q_offset: Offset = 0, k_offset: Offset = 0):
    """Flash backward against given softmax stats. q, k, v, o, do:
    [B,S,H,D]; m, l: [B,H,Sq] as flash_attention_stats returns them (or
    as ring attention merges them). Returns (dq, dk, dv) in the input
    dtypes."""
    _require_blocks(q.shape[1], k.shape[1])
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    lse = _lse_from_stats(m.float(), l.float()).contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    qo, ko = _offset(q_offset), _offset(k_offset)
    dq = _flash_dq(q, k, v, do, lse, delta, bool(causal), qo, ko)
    dk, dv = _flash_dkv(q, k, v, do, lse, delta, bool(causal), qo, ko)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward kernel on the way in; dq and dk/dv kernels on the way
    back (reference ``_flash`` custom_vjp, :509-530)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        o, m, l = _flash_fwd(q, k, v, causal, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.args = (causal, q_offset, k_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        causal, q_offset, k_offset = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, o, m, l, do, causal,
                                         q_offset, k_offset)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    q_offset: Offset = 0, k_offset: Offset = 0):
    """Blockwise-softmax attention. q, k, v: [B, S, H, D]; returns
    [B, Sq, H, D] in q.dtype, differentiable in q, k and v.

    ``q_offset``/``k_offset`` (ints or 0-d tensors) are the global
    positions of element 0 and shift the causal mask. Products
    accumulate in fp32 from the input values, so fp32 inputs give
    fp32-exact attention and bf16 inputs differ from fp32 only by the
    rounding of the inputs and of the output."""
    seq_q, seq_k = q.shape[1], k.shape[1]
    if not _shapes_ok(seq_q, seq_k):
        if not causal:
            raise ValueError("non-causal path requires block-divisible "
                             "sequence lengths")
        return _dense_reference(q, k, v, causal, _offset(q_offset),
                                _offset(k_offset))
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal),
                                 _offset(q_offset), _offset(k_offset))
