"""Flash attention on Hopper: the attention hot op of the Transformer LM.

Counterpart of ``horovod_tpu/parallel/flash_attention.py`` (public
contract :436-566). The three Pallas kernels there have hand-written
CUDA counterparts in ``horovod_tpu_torch/csrc``, in several designs:

- ``_kernel`` (:58)          -> ``flash_fwd_sm90.cu``  (bf16/fp16, D 1-512;
                                the caller's tensors as they are at
                                every multiple of 8 past 32)
                                ``flash_fwd_stream_sm90.cu`` (bf16/fp16
                                past D 512; fp32 past D 32, 3xTF32)
                                or ``flash_fwd_tf32_narrow_sm90.cu``
                                (fp32, D <= 32, 3xTF32) via
                                :func:`_flash_fwd`
- ``_bwd_dq_kernel`` (:204)  -> ``flash_bwd_sm90.cu``  (bf16/fp16, D 33-128,
                                dq, dk and dv in one launch; in place
                                at every multiple of 8)
                                ``flash_dq_sm90.cu``   (bf16/fp16, D 1-32
                                and 129-256; in place at every multiple
                                of 8 past 128)
                                ``flash_dq_stream_sm90.cu`` (bf16/fp16
                                past D 256)
                                ``flash_bwd_tf32_sm90.cu`` (fp32 past D
                                32, 3xTF32)
                                or ``flash_bwd_tf32_narrow_sm90.cu``
                                (fp32, D <= 32, 3xTF32) via
                                :func:`_flash_bwd`
- ``_bwd_dkv_kernel`` (:236) -> ``flash_bwd_sm90.cu``  (bf16/fp16, D 33-128)
                                ``flash_dkv_sm90.cu``  (bf16/fp16, D 1-32
                                and 129-256; in place at every multiple
                                of 8 past 128)
                                ``flash_dkv_stream_sm90.cu`` (bf16/fp16
                                past D 256)
                                ``flash_bwd_tf32_sm90.cu`` (fp32 past D
                                32, 3xTF32)
                                or ``flash_bwd_tf32_narrow_sm90.cu``
                                (fp32, D <= 32, 3xTF32) via
                                :func:`_flash_bwd`

:func:`_design` picks each kernel's design from the dtype and head dim
alone, before any launch:

- ``sm90`` (wgmma on 16-bit tiles fed by TMA, warp-specialised, the
  CTA's Q tile resident in shared memory) takes bf16 and fp16: dq and
  dk/dv at any head dim up to 256 and the forward at any up to 512,
  built at 64, 128 and 256 (``SM90_HEAD_DIMS``) and at 16 and 32
  (``SM90_NARROW_DIMS``: tiles of 32- or 64-byte rows in a swizzle of
  that width, small CTAs several to an SM), the forward also at 384 and
  512 (``SM90_KERNEL_DIMS``; past 256 each CTA accumulates one half of
  O's head dim).
- ``stream`` and ``tf32`` (``STREAM_DESIGNS``) hold no tile that spans
  the head dim: the operands of S (and of dP) come through a TMA ring one
  128-byte column region at a time (64 16-bit or 32 fp32 columns), S is
  summed over the regions and each CTA accumulates one part of its
  output's head dim. ``stream`` takes bf16 and fp16 for the forward past
  D 512 and for dq and dk/dv past D 256, at every multiple of 64 (parts
  of 256 columns);
  ``tf32`` takes fp32 past D 32, at every multiple of 32, for all three
  kernels (parts of 128 columns, and 256 for the forward and dq past D
  128; dk/dv 64, and 128 past D 128), and every fp32 D up to 32 as well, on
  narrow builds of its own at D 16 and 32 (``TF32_NARROW_DIMS``: a CTA
  owns 64 rows, a q tile for the forward and dq, a kv tile for dk/dv,
  whose stages of the other sequence several consumer warpgroups share;
  csrc/flash_fwd_tf32_narrow_sm90.cu, flash_bwd_tf32_narrow_sm90.cu);
  each product as hi.hi + hi.lo + lo.hi of tf32 parts (hi = tf32(x), lo
  = tf32(x - hi)) after a pre-pass, one launch, that writes the inputs'
  parts and the transposes the products over the sequence read (the
  forward's v^T; the backward's k^T, q^T and do^T, one pre-pass for dq
  and dk/dv, :func:`_tf32_bwd_split`). The shared-memory bytes of each
  are worked out in the files' headers.
- The 16-bit backward at D 33-128 (:func:`_fused_bwd`, asked before
  :func:`_design` by :func:`_flash_bwd`) runs no sm90 dq and dk/dv pair:
  one launch of ``flash_bwd_sm90`` (csrc/flash_bwd_sm90.cu, built at 64
  and 128, in place at every multiple of 8 between) computes dq, dk and dv,
  paying S and dP once, and adds each kv tile's part of dq into an fp32
  accumulator in a fixed kv-tile order (a second small kernel of the same
  C entry writes dq from it), so dq has the same bits on every run. The sm90 dq and
  dk/dv at D 64 and 128 stay built, checked and timed beside it
  (``_launch("dq", "sm90", ...)``), with no route.
- ``simt`` (fp32 FMAs from fp32 shared-memory tiles, csrc/flash_fwd.cu
  and flash_bwd.cu) takes no input that the dispatchers route: it is
  built, checked and timed beside the others (``_launch`` with design
  ``"simt"``). It is built at ``HEAD_DIMS`` (16 to 512; its tiles shrink
  as D grows so that a block's shared memory holds them, the counterpart
  of the reference's ``_ladders_for``) and at any multiple of 64 past
  512, where each block computes one 64-column chunk of the output and
  streams the logits' reductions over D through 64-wide tiles
  (``csrc/flash_common.cuh`` works the bytes out).

Like the reference, a CUDA call takes any head dim: one that the
kernel's design is not built for runs at the next one that is
(:func:`padded_head_dim`), with q, k, v (and do) zero-padded along D, the
scale of the true D, and the outputs sliced back
(:func:`_on_padded_head_dim`); zero columns leave q.k^T unchanged and the
padded columns of v give output columns that are cut away. So bf16 D 80
runs all three kernels at 128, D 200 at 256, D 20 all three at 32
(sm90), D 320 the forward at 384 (sm90) and dq and dk/dv at 320
(stream), D 600 all three at 640 (stream), fp32 D 100 all three at
128 (tf32) and fp32 D 20 all three at 32 (the narrow tf32 builds). The
sm90 kernels pad nothing where a row of d 16-bit values
is a legal TMA stride (d a multiple of 8 past 32, so D 80, 96 and 200,
:func:`_reads_in_place`): the build of the next head dim reads the
caller's tensors through tensor maps of extent d, which zero-fill the
columns past d as the pad did, and stores only the columns below d.
Where the backward pads (D 20, 260), it pads q, k, v and do once for
the head dim its two kernels run at (:func:`_flash_bwd`). The
tensor-core kernels read their inputs
through TMA (the tf32 pre-pass in 16-byte loads) and need 16-byte
aligned bases; a misaligned CUDA tensor raises, it never falls back to
another design.

:func:`flash_attention_bwd` makes the backward's lse and delta on CUDA
with one pre-pass kernel (``flash_bwd_prep`` in csrc/flash_bwd_sm90.cu,
:func:`_bwd_prep`, every dtype and head dim), which also zeroes the
fused kernel's turn counters; its plain version is
:func:`_bwd_stats_plain`.

Each launcher counts its launches (``launch_counts()``, keyed by
:func:`counter_name`: ``flash_fwd``, ``flash_fwd_sm90``,
``flash_fwd_stream``, ``flash_fwd_tf32``, ``flash_dq``, ``flash_dq_sm90``,
``flash_dq_stream``, ``flash_dq_tf32``, ``flash_dkv``, ``flash_dkv_sm90``,
``flash_dkv_stream``, ``flash_dkv_tf32``, ``flash_bwd_sm90``, and the
pre-pass's ``flash_bwd_prep``).
For CPU tensors the dispatchers compute the same function with the
plain PyTorch versions (``_flash_fwd_plain``, ``_flash_dq_plain``,
``_flash_dkv_plain``, ``_bwd_stats_plain``), which is what the CPU tests
run; ``_flash_bwd_sm90_plain`` sums dq per 128-key kv tile as the fused
kernel does. A CUDA tensor
never reaches a plain version: a kernel launches or the wrapper raises.
The 16-bit tensor-core kernels feed the tensor cores p (and ds) in the
input's 16-bit type, as the reference's own dots do on the TPU by
default; ``operands=dtype`` makes the plain versions round at exactly
those places, which is what the card's checks compare the rounding
with. ``operands=TF32X3`` makes the plain versions take their products
as the tf32 kernels do (``TF32``: as one tf32 product, which misses the
reference's fp32 bound); the card holds the tf32 kernels to the fp32
bound with no allowance.

Tensors are ``[B, S, H, D]`` (the module layout of models/transformer.py)
and the kernels read that layout in place; the softmax statistics
``(m, l)`` are ``[B, H, Sq]`` fp32. Offsets are the global positions of
q[0] and k[0] and shift the causal mask; they are plain kernel arguments,
so no value needs a new build. Sequences shorter than 128 or a multiple
of 64 run the kernels (the kernels mask a ragged last tile); any other
falls back to the dense formulation when causal and raises
``ValueError`` when not. That is every length the reference takes (below
its smallest block, 128, it takes the whole sequence as one block) and,
on purpose, the multiples of 64 past it that it refuses (S = 192).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from horovod_tpu_torch import _cuda

_NEG_INF = -1e30
BLOCK = 64   # the sequence granularity of the kernels' tiles
# Below this length any sequence runs the kernels, as one block of the
# reference does (its smallest block ladder entry).
WHOLE_BELOW = 128
# head dims the simt kernels are built for up to 512; past it, every
# multiple of CHUNK (each block computes one CHUNK-wide slice of D)
HEAD_DIMS = (16, 32, 64, 96, 128, 256, 384, 512)
CHUNK = 64
SM90_HEAD_DIMS = (64, 128, 256)   # head dims all three sm90 kernels take
# The narrow-row builds of all three sm90 kernels.
SM90_NARROW_DIMS = (16, 32)
KERNELS = ("fwd", "dq", "dkv")
# What the sm90 kernels take: their dtypes, and the head dims each one is
# built for (its dispatcher pads any other head dim up to one of them).
SM90_DTYPES = (torch.bfloat16, torch.float16)
SM90_KERNEL_DIMS = {"fwd": SM90_NARROW_DIMS + SM90_HEAD_DIMS + (384, 512),
                    "dq": SM90_NARROW_DIMS + SM90_HEAD_DIMS,
                    "dkv": SM90_NARROW_DIMS + SM90_HEAD_DIMS}
# The fused 16-bit backward (csrc/flash_bwd_sm90.cu, kernel "bwd": dq, dk
# and dv in one launch): built at 64 and 128, it takes every 16-bit
# backward at D 33-128 (:func:`_fused_bwd`), in place at the multiples of
# 8 between.
SM90_KERNEL_DIMS["bwd"] = (64, 128)
# The fused kernel's kv tiles: dq is summed over them in a fixed order.
FUSED_KV_TILE = 128
# The designs streamed over D (csrc/flash_fwd_stream_sm90.cu,
# csrc/flash_dq_stream_sm90.cu, csrc/flash_dkv_stream_sm90.cu,
# csrc/flash_bwd_tf32_sm90.cu): design -> (its dtypes, {kernel it serves:
# the head dim it starts past}, the region width: it is built for every
# multiple of that width past the start). stream starts where each
# kernel's sm90 builds end.
STREAM_DESIGNS = {"stream": (SM90_DTYPES,
                             {kern: SM90_KERNEL_DIMS[kern][-1]
                              for kern in KERNELS}, 64),
                  "tf32": ((torch.float32,),
                           dict.fromkeys(KERNELS, HEAD_DIMS[1]), 32)}
# The tf32 design's narrow builds below its start, per kernel: fp32 D 16
# and 32 (csrc/flash_fwd_tf32_narrow_sm90.cu, flash_bwd_tf32_narrow_sm90.cu),
# which take every fp32 D up to 32.
TF32_NARROW_DIMS = dict.fromkeys(KERNELS, (16, 32))
_KERNEL_NAMES = {"fwd": "forward", "dq": "dq", "dkv": "dk/dv"}
# ``operands`` modes of the plain versions for the tf32 design: each
# product as hi.hi + hi.lo + lo.hi of tf32 parts (what the kernels
# compute), or as one tf32 product (what plain TF32 would give).
TF32X3 = "3xtf32"
TF32 = "tf32"

# Launches of each kernel since the last reset_launch_counts().
flash_fwd_launches = 0
flash_fwd_sm90_launches = 0
flash_fwd_stream_launches = 0
flash_fwd_tf32_launches = 0
flash_dq_launches = 0
flash_dq_sm90_launches = 0
flash_dq_stream_launches = 0
flash_dq_tf32_launches = 0
flash_dkv_launches = 0
flash_dkv_sm90_launches = 0
flash_dkv_stream_launches = 0
flash_dkv_tf32_launches = 0
flash_bwd_sm90_launches = 0
flash_bwd_prep_launches = 0

Offset = Union[int, torch.Tensor]


def reset_launch_counts() -> None:
    global flash_fwd_launches, flash_fwd_sm90_launches, flash_dq_launches
    global flash_dq_sm90_launches, flash_dkv_launches, flash_dkv_sm90_launches
    global flash_fwd_stream_launches, flash_fwd_tf32_launches
    global flash_dq_stream_launches, flash_dq_tf32_launches
    global flash_dkv_stream_launches, flash_dkv_tf32_launches
    global flash_bwd_sm90_launches, flash_bwd_prep_launches
    flash_fwd_launches = flash_fwd_sm90_launches = flash_dq_launches = 0
    flash_dq_sm90_launches = flash_dkv_launches = flash_dkv_sm90_launches = 0
    flash_fwd_stream_launches = flash_fwd_tf32_launches = 0
    flash_dq_stream_launches = flash_dq_tf32_launches = 0
    flash_dkv_stream_launches = flash_dkv_tf32_launches = 0
    flash_bwd_sm90_launches = flash_bwd_prep_launches = 0


def launch_counts() -> dict:
    """{counter_name(kernel, design): launches since the last reset}."""
    return {"flash_fwd": flash_fwd_launches,
            "flash_fwd_sm90": flash_fwd_sm90_launches,
            "flash_fwd_stream": flash_fwd_stream_launches,
            "flash_fwd_tf32": flash_fwd_tf32_launches,
            "flash_dq": flash_dq_launches,
            "flash_dq_sm90": flash_dq_sm90_launches,
            "flash_dq_stream": flash_dq_stream_launches,
            "flash_dq_tf32": flash_dq_tf32_launches,
            "flash_dkv": flash_dkv_launches,
            "flash_dkv_sm90": flash_dkv_sm90_launches,
            "flash_dkv_stream": flash_dkv_stream_launches,
            "flash_dkv_tf32": flash_dkv_tf32_launches,
            "flash_bwd_sm90": flash_bwd_sm90_launches,
            "flash_bwd_prep": flash_bwd_prep_launches}


def counter_name(kernel: str, design: str) -> str:
    """The launch counter (and chip_smoke row) of ``kernel``'s ``design``:
    ``flash_fwd``, ``flash_fwd_sm90``, ``flash_fwd_tf32``, ...; the fused
    backward (kernel ``"bwd"``) is ``flash_bwd_sm90``."""
    return f"flash_{kernel}" + ("" if design == "simt" else f"_{design}")


# ---------------------------------------------------------------------------
# Plain versions (dense, fp32): the CPU path and the kernels' yardstick
# ---------------------------------------------------------------------------

def _softmax_scale(d: int) -> float:
    """What the logits of head dim ``d`` are multiplied by."""
    return 1.0 / math.sqrt(d)


def _next_built(d: int, built) -> int:
    return next(b for b in built if d <= b)


def _narrow_tf32(design: str, kernel: str) -> tuple:
    """The narrow builds of ``kernel``'s ``design``: those of
    ``TF32_NARROW_DIMS`` for tf32, none otherwise."""
    return TF32_NARROW_DIMS[kernel] if design == "tf32" else ()


def padded_head_dim(d: int, design: str, kernel: str) -> int:
    """The head dim a CUDA call at head dim ``d`` runs ``kernel``'s
    ``design`` at: ``d`` itself when one is built for it, else the next
    one that is. sm90: ``SM90_KERNEL_DIMS[kernel]`` (16 to 512 for the
    forward, 16 to 256 for dq and dk/dv), which raises past the largest
    (the dispatchers send it nothing larger); ``stream`` and ``tf32``
    (``STREAM_DESIGNS``): the next multiple of 64 past the kernel's start
    (512 for the forward, 256 for dq and dk/dv) and of 32 past 32, which
    raise at or below the start and never above it, but for the tf32
    narrow builds of all three kernels (``TF32_NARROW_DIMS``): 16 for
    d <= 16 and 32 for 17-32; simt, the same
    for every kernel: ``HEAD_DIMS`` up to 512, then the next multiple of
    ``CHUNK``, so it never refuses a head dim there."""
    if design in STREAM_DESIGNS:
        _, starts, width = STREAM_DESIGNS[design]
        narrow = _narrow_tf32(design, kernel)
        if narrow and d <= narrow[-1]:
            return _next_built(d, narrow)
        if d <= starts.get(kernel, d):
            raise ValueError(f"head dim {d}: the {design} design serves "
                             f"{_serves(starts)}")
        return -(-d // width) * width
    if design == "sm90":
        built = SM90_KERNEL_DIMS[kernel]
        if d > built[-1]:
            raise ValueError(f"head dim {d}: the sm90 {kernel} kernel takes "
                             f"head dims up to {built[-1]}")
        return _next_built(d, built)
    if d <= HEAD_DIMS[-1]:
        return _next_built(d, HEAD_DIMS)
    return -(-d // CHUNK) * CHUNK


def _serves(starts) -> str:
    """``starts`` ({kernel: head dim}) in words: "the forward past head dim
    512 and the dq past head dim 256"; kernels with one start share it."""
    groups = {}
    for kern, start in starts.items():
        groups.setdefault(start, []).append(_KERNEL_NAMES[kern])
    return " and ".join(f"the {' and '.join(names)} past head dim {start}"
                        for start, names in groups.items())


def _pad_head_dim(tensors, built: int):
    """Each ``[B, S, H, D]`` tensor zero-padded along D to ``built``."""
    d = tensors[0].shape[-1]
    if built == d:
        return tuple(tensors)
    return tuple(F.pad(t, (0, built - d)) for t in tensors)


def _at_head_dim(fn, padded, d: int, *args):
    """``fn(*padded, *args)`` on tensors zero-padded from head dim ``d``:
    the scale that of the true D, and every ``[B, S, H, D']`` output
    sliced back to D (the ``[B, H, S]`` stats pass through)."""
    if padded[0].shape[-1] == d:
        return fn(*padded, *args)
    out = fn(*padded, *args, scale=_softmax_scale(d))

    def cut(x):
        return x[..., :d].contiguous() if x.dim() == 4 else x
    return tuple(map(cut, out)) if isinstance(out, tuple) else cut(out)


def _reads_in_place(d: int, design: str, kernel: str) -> bool:
    """Whether ``kernel``'s ``design`` takes tensors of head dim ``d`` as
    they are though its build is of another head dim
    (:func:`padded_head_dim`): each sm90 kernel past its narrow builds, up
    to its widest build (512 for the forward, 256 for dq and dk/dv),
    wherever a row of d 16-bit values is a legal TMA stride (d a multiple
    of 8). Its tensor maps take d as their extent, so the build's boxes
    read zeros past d where a pad would have put them, and it stores only
    the columns below d (csrc/flash_fwd_sm90.cu, flash_dq_sm90.cu,
    flash_dkv_sm90.cu)."""
    return (design == "sm90" and d % 8 == 0
            and SM90_NARROW_DIMS[-1] < d <= SM90_KERNEL_DIMS[kernel][-1])


def _run_head_dim(d: int, design: str, kernel: str) -> int:
    """The head dim of the tensors ``kernel``'s ``design`` is given at
    head dim ``d``: ``d`` itself where it reads them in place
    (:func:`_reads_in_place`), else :func:`padded_head_dim`."""
    if _reads_in_place(d, design, kernel):
        return d
    return padded_head_dim(d, design, kernel)


def _on_padded_head_dim(fn, tensors, *args, design: str, kernel: str):
    """``fn(*tensors, *args)`` at the head dim :func:`_run_head_dim` gives
    for ``kernel``'s ``design``, padded and sliced back by
    :func:`_pad_head_dim` and :func:`_at_head_dim`, or on ``tensors`` as
    they are where the kernel reads them so. A layout step in front of the
    same kernel, which takes the plain versions as well."""
    d = tensors[0].shape[-1]
    built = _run_head_dim(d, design, kernel)
    return _at_head_dim(fn, _pad_head_dim(tensors, built), d, *args)


def _tf32(x):
    """``x`` (fp32) rounded to tf32, 10 mantissa bits, to nearest with
    ties away from zero, by the integer steps of ``tf32_round`` in
    csrc/sm90_common.cuh: the same bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(eq, a, b, operands=None):
    """``torch.einsum(eq, a, b)`` in fp32; with ``operands`` ``TF32X3``
    each factor is split into hi = tf32(x) and lo = tf32(x - hi) and the
    product taken as hi.hi + hi.lo + lo.hi, as the tf32 kernel takes it;
    with ``TF32`` as hi.hi alone. Any other ``operands`` (a 16-bit dtype,
    whose rounding is of p, not of the products) leaves it fp32."""
    a, b = a.float(), b.float()
    if operands not in (TF32, TF32X3):
        return torch.einsum(eq, a, b)
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = torch.einsum(eq, a_hi, b_hi)
    if operands == TF32X3:
        out = (torch.einsum(eq, _tf32(a - a_hi), b_hi)
               + torch.einsum(eq, a_hi, _tf32(b - b_hi)) + out)
    return out


def _scores(q, k, causal, q_offset, k_offset, scale=None, operands=None):
    """Scaled fp32 logits [B,H,Sq,Sk] with masked entries at -1e30, and
    the mask (None when not causal). ``scale`` defaults to that of q's
    head dim; ``operands`` is :func:`_product`'s."""
    if scale is None:
        scale = _softmax_scale(q.shape[-1])
    s = _product("bqhd,bkhd->bhqk", q, k, operands) * scale
    if not causal:
        return s, None
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    k_pos = k_offset + torch.arange(k.shape[1], device=q.device)
    allowed = q_pos[:, None] >= k_pos[None, :]
    return s.masked_fill(~allowed, _NEG_INF), allowed


def _rounded(x, operands):
    """``x`` rounded to the ``operands`` dtype and back to fp32 (as it is
    when ``None`` or a tf32 mode, whose rounding is in the products)."""
    if operands is None or isinstance(operands, str):
        return x
    return x.to(operands).float()


def _flash_fwd_plain(q, k, v, causal, q_offset, k_offset, operands=None,
                     scale=None):
    """What ``_kernel`` computes, densely: (o [B,Sq,H,D] in q.dtype,
    m [B,H,Sq], l [B,H,Sq] fp32); rows that see no key give o = 0,
    m = -1e30, l = 0. ``operands`` a 16-bit dtype rounds p = exp(s - m)
    to that type before p @ v, where the sm90 and stream kernels feed it
    to the tensor cores; ``TF32X3`` (``TF32``) takes q k^T and p v as the
    tf32 kernel does (as one tf32 product); l is still summed from the
    fp32 p."""
    s, allowed = _scores(q, k, causal, q_offset, k_offset, scale, operands)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if allowed is not None:
        p = p * allowed
    l = p.sum(dim=-1)
    o = _product("bhqk,bkhd->bqhd", _rounded(p, operands), v, operands)
    denom = torch.where(l == 0.0, torch.ones_like(l), l)
    o = o / denom.transpose(1, 2)[..., None]
    return o.to(q.dtype), m, l


def _p_ds_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset,
                scale=None, operands=None):
    """What ``_recompute_p_ds`` computes for every tile at once:
    p = exp(s - lse) and ds = p * (dp - delta) * scale, [B,H,Sq,Sk];
    ``operands`` is :func:`_product`'s, for s and dp."""
    if scale is None:
        scale = _softmax_scale(q.shape[-1])
    s, allowed = _scores(q, k, causal, q_offset, k_offset, scale, operands)
    p = torch.exp(s - lse[..., None])
    if allowed is not None:
        p = p * allowed
    dp = _product("bqhd,bkhd->bhqk", do, v, operands)
    ds = p * (dp - delta[..., None]) * scale
    return p, ds


def _flash_dq_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset,
                    operands=None, scale=None):
    """What ``_bwd_dq_kernel`` computes: dq = ds @ k, in q.dtype.
    ``operands`` a 16-bit dtype rounds ds to that dtype before the
    product, as the sm90 kernel does; ``TF32X3`` (``TF32``) takes s, dp
    and ds @ k as the tf32 kernel does (as one tf32 product each)."""
    _, ds = _p_ds_plain(q, k, v, do, lse, delta, causal, q_offset,
                        k_offset, scale, operands)
    return _product("bhqk,bkhd->bqhd", _rounded(ds, operands), k,
                    operands).to(q.dtype)


def _flash_dkv_plain(q, k, v, do, lse, delta, causal, q_offset, k_offset,
                     operands=None, scale=None):
    """What ``_bwd_dkv_kernel`` computes: dk = ds^T @ q, dv = p^T @ do.
    ``operands`` a 16-bit dtype rounds p and ds to that dtype before the
    two products, as the sm90 kernel does (ds from the unrounded p);
    ``TF32X3`` (``TF32``) takes all four products as the tf32 kernel does
    (as one tf32 product each)."""
    p, ds = _p_ds_plain(q, k, v, do, lse, delta, causal, q_offset,
                        k_offset, scale, operands)
    p, ds = _rounded(p, operands), _rounded(ds, operands)
    dk = _product("bhqk,bqhd->bkhd", ds, q, operands)
    dv = _product("bhqk,bqhd->bkhd", p, do, operands)
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_sm90_plain(q, k, v, do, lse, delta, causal, q_offset,
                          k_offset, operands=None, scale=None):
    """What the fused backward (csrc/flash_bwd_sm90.cu) computes: (dq, dk,
    dv), dk and dv as :func:`_flash_dkv_plain` gives them, dq summed as the
    kernel sums it: each 128-key kv tile's part ds_j @ k_j in fp32, the
    parts added one after another in kv-tile order (the kernel adds them in
    ascending or, where its CTAs all fit on the card at once, descending
    order: fp32 sums in another order). ``operands`` a 16-bit dtype rounds
    p and ds to it before the products, where the kernel feeds them to the
    tensor cores."""
    _, ds = _p_ds_plain(q, k, v, do, lse, delta, causal, q_offset,
                        k_offset, scale, operands)
    ds = _rounded(ds, operands)
    dq = None
    for k0 in range(0, k.shape[1], FUSED_KV_TILE):
        part = _product("bhqk,bkhd->bqhd", ds[..., k0:k0 + FUSED_KV_TILE],
                        k[:, k0:k0 + FUSED_KV_TILE])
        dq = part if dq is None else dq + part
    dk, dv = _flash_dkv_plain(q, k, v, do, lse, delta, causal, q_offset,
                              k_offset, operands, scale)
    return dq.to(q.dtype), dk, dv


def _bwd_stats_plain(o, do, m, l):
    """The backward's lse and delta, [B,H,Sq] fp32, from the forward's o
    and the incoming do ([B,Sq,H,D]) and its stats m and l ([B,H,Sq]):
    lse = m + log l (+inf where l == 0, :func:`_lse_from_stats`) and delta
    = rowsum(do * o) in fp32 (reference :462-471, :498-499). The plain
    version of the pre-pass kernel (:func:`_bwd_prep`)."""
    lse = _lse_from_stats(m.float(), l.float()).contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return lse, delta


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

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(name, tensors, seqs):
    q = tensors[0]
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, S, H, D], got {q.shape}")
    b, _, h, d = q.shape
    dev, dt = q.device, q.dtype
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev}; CPU or CUDA only")
    if dev.type == "cuda" and dt not in _DTYPES:
        raise TypeError(f"{name}: the kernel takes float32, bfloat16 or "
                        f"float16, got {dt}")
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


def _design(dtype: torch.dtype, d: int, kernel: str) -> str:
    """The design of ``kernel`` (``"fwd"``, ``"dq"`` or ``"dkv"``) for CUDA
    inputs of this type and head dim: ``"sm90"`` (wgmma on 16-bit tiles
    fed by TMA, Q resident) at bf16 and fp16 with d <= 512 for the
    forward and d <= 256 for dq and dk/dv; ``"stream"`` (the same,
    streamed over D) at bf16 and fp16 for the forward past 512 and dq and
    dk/dv past 256; ``"tf32"`` (3xTF32) for all three at every fp32 d:
    streamed over D past 32, on the narrow builds up to it
    (``TF32_NARROW_DIMS``). No dtype the kernels take reaches ``"simt"``
    (fp32 FMAs), which only a caller that asks for it runs."""
    for design, (dtypes, starts, _) in STREAM_DESIGNS.items():
        if dtype in dtypes and d > starts.get(kernel, d):
            return design
    if dtype in STREAM_DESIGNS["tf32"][0]:
        return "tf32"
    sm90 = dtype in SM90_DTYPES and d <= SM90_KERNEL_DIMS[kernel][-1]
    return "sm90" if sm90 else "simt"


def _fused_bwd(dtype: torch.dtype, d: int) -> bool:
    """Whether a CUDA backward of this type and head dim runs the fused
    kernel (csrc/flash_bwd_sm90.cu: dq, dk and dv in one launch, kernel
    ``"bwd"``) in place of the dq and dk/dv pair: bf16 and fp16 at D
    33-128, on the build of 64 or 128 (:func:`padded_head_dim` with
    kernel ``"bwd"``), in place at the multiples of 8 between
    (:func:`_reads_in_place`), padded once otherwise. :func:`_design` keeps
    its meaning per kernel: it names the pair's design there, which stays
    built, checked and timed."""
    return (dtype in SM90_DTYPES
            and SM90_NARROW_DIMS[-1] < d <= SM90_KERNEL_DIMS["bwd"][-1])


def _launch(kernel: str, design: str, tensors, *args):
    """``kernel``'s launcher of ``design`` on ``tensors`` and ``args``,
    zero-padded to a head dim it is built for and sliced back (or as they
    are, :func:`_reads_in_place`)."""
    return _on_padded_head_dim(_LAUNCHERS[kernel, design], tensors, *args,
                               design=design, kernel=kernel)


def _cuda_only(name, kernel, q):
    """The simt kernels' limits: CUDA tensors at a head dim they are
    built for."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel launcher takes CUDA tensors")
    d = q.shape[-1]
    if padded_head_dim(d, "simt", kernel) != d:
        raise ValueError(f"{name}: the kernels are built for head dims "
                         f"{HEAD_DIMS} and the multiples of {CHUNK} past "
                         f"{HEAD_DIMS[-1]}, got {d}")


def _scale_arg(q, scale):
    return _softmax_scale(q.shape[-1]) if scale is None else scale


def _check_tensor_cores(name, kernel, tensors, design="sm90"):
    """A tensor-core kernel's own limits (``design`` sm90, stream or
    tf32): CUDA tensors of its dtypes at a head dim it is built for (or
    reads in place, :func:`_reads_in_place`), and 16-byte aligned bases
    for TMA and the tf32 pre-pass's 16-byte loads (contiguity, checked
    already, makes every outer stride a multiple of 16 bytes at these head
    dims: the narrowest row, 16-bit D 16, is 32 bytes, and a row read in
    place is a multiple of 16)."""
    q = tensors[0]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: the kernel launcher takes CUDA tensors")
    d = q.shape[-1]
    if design == "sm90":
        dtypes, built_dims = SM90_DTYPES, SM90_KERNEL_DIMS[kernel]
        dims = (f"{built_dims} and the multiples of 8 between "
                f"{SM90_NARROW_DIMS[-1]} and {built_dims[-1]}")
        built = d in built_dims or _reads_in_place(d, design, kernel)
    else:
        dtypes, starts, width = STREAM_DESIGNS[design]
        start = starts.get(kernel)
        narrow = _narrow_tf32(design, kernel)
        dims = (f"{narrow} and " if narrow else "") + (
            f"the multiples of {width} past {start}")
        built = (d in narrow
                 or start is not None and d > start and d % width == 0)
    if q.dtype not in dtypes or not built:
        raise ValueError(f"{name}: the {design} kernel takes {dtypes} at "
                         f"head dims {dims}, got {q.dtype} and {d}")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the {design} kernel loads through "
                             f"TMA, which needs 16-byte-aligned tensors; a "
                             f"base is {t.data_ptr() % 16} bytes past a "
                             f"boundary")


def _flash_fwd(q, k, v, causal: bool, q_offset: int, k_offset: int):
    """Forward kernel: (o, m, l) as ``_flash_fwd_plain`` returns them."""
    sq, sk = q.shape[1], k.shape[1]
    _check("flash forward", (q, k, v), (sq, sk, sk))
    if q.device.type == "cpu":
        return _flash_fwd_plain(q, k, v, causal, q_offset, k_offset)
    return _launch("fwd", _design(q.dtype, q.shape[-1], "fwd"), (q, k, v),
                   causal, q_offset, k_offset)


def _fwd_outputs(q):
    b, sq, h, _ = q.shape
    m = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    return torch.empty_like(q), m, torch.empty_like(m)


def _flash_fwd_simt(q, k, v, causal: bool, q_offset: int, k_offset: int,
                    scale=None):
    """The fp32-FMA forward kernel (flash_fwd.cu), any supported input."""
    global flash_fwd_launches
    sq, sk = q.shape[1], k.shape[1]
    b, h, d = _check("flash forward", (q, k, v), (sq, sk, sk))
    _cuda_only("flash forward", "fwd", q)
    lib = _cuda.load()
    o, m, l = _fwd_outputs(q)
    with torch.cuda.device(q.device):
        err = lib.hvdt_flash_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), m.data_ptr(), l.data_ptr(), b, h, sq, sk, d,
            q_offset, k_offset, int(causal), _scale_arg(q, scale),
            _stream(q))
    _cuda.check(err, "flash forward kernel")
    flash_fwd_launches += 1
    return o, m, l


def _fwd_tensor_cores(design, q, k, v, causal, q_offset, k_offset, scale):
    """Checks and launches the tensor-core forward of ``design`` (sm90,
    stream or tf32); returns (o, m, l). The tf32 kernel's pre-pass writes
    q and k's tf32 hi and lo parts and v^T's, [B, H, D, Sk rounded up to
    32], into scratch allocated here; its narrow builds (D 16 and 32) have
    a C entry of their own."""
    sq, sk = q.shape[1], k.shape[1]
    b, h, d = _check("flash forward", (q, k, v), (sq, sk, sk))
    _check_tensor_cores("flash forward", "fwd", (q, k, v), design)
    lib = _cuda.load()
    o, m, l = _fwd_outputs(q)
    sizes = (b, h, sq, sk, d, q_offset, k_offset, int(causal),
             _scale_arg(q, scale), _stream(q))
    with torch.cuda.device(q.device):
        ptrs = [t.data_ptr() for t in (q, k, v, o, m, l)]
        if design == "tf32":
            scratch = _tf32_fwd_scratch(q, k)
            entry = (lib.hvdt_flash_fwd_tf32_narrow
                     if d in TF32_NARROW_DIMS["fwd"]
                     else lib.hvdt_flash_fwd_tf32)
            err = entry(*ptrs, scratch.data_ptr(), *sizes)
        else:
            entry = (lib.hvdt_flash_fwd_sm90 if design == "sm90"
                     else lib.hvdt_flash_fwd_stream)
            err = entry(_DTYPES[q.dtype], *ptrs, *sizes)
    _cuda.check(err, f"flash forward {design} kernel")
    return o, m, l


def _tf32_fwd_scratch(q, k):
    """The tf32 forward pre-pass's six planes, one fp32 tensor: q and k
    hi and lo, and v^T hi and lo as [B, H, D, Sk rounded up to 32]."""
    b, _, h, d = q.shape
    keys = -(-k.shape[1] // 32) * 32
    return torch.empty(2 * (q.numel() + k.numel() + b * h * d * keys),
                       device=q.device)


def _tf32_fwd_split(q, k, v):
    """The tf32 forward's pre-pass alone (the first step of
    ``hvdt_flash_fwd_tf32``), into scratch allocated here: what
    ``chip_smoke.py`` times apart from the forward."""
    _check_tensor_cores("flash forward", "fwd", (q, k, v), "tf32")
    b, sq, h, d = q.shape
    scratch = _tf32_fwd_scratch(q, k)
    lib = _cuda.load()
    with torch.cuda.device(q.device):
        err = lib.hvdt_flash_fwd_tf32_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), scratch.data_ptr(), b,
            h, sq, k.shape[1], d, _stream(q))
    _cuda.check(err, "flash forward tf32 pre-pass")
    return scratch


def tf32_fwd_part(d: int) -> int:
    """The columns of O that a CTA of the tf32 forward owns at the built
    head dim ``d``, which name its build: D itself at the narrow builds
    (D 16 and 32, csrc/flash_fwd_tf32_narrow_sm90.cu); past them as the
    C entry of csrc/flash_fwd_stream_sm90.cu picks the build, 128 up to D
    128, 256 past it (the wide build, P through shared memory). Needs the
    kernels' library past D 32."""
    if d in TF32_NARROW_DIMS["fwd"]:
        return d
    return _cuda.load().hvdt_flash_fwd_tf32_part(d)


def tf32_dq_part(d: int) -> int:
    """The columns of dQ that a CTA of the tf32 dq owns at the built head
    dim ``d``, which name its build: D itself at the narrow builds (D 16
    and 32, csrc/flash_bwd_tf32_narrow_sm90.cu); past them as the C entry
    of csrc/flash_bwd_tf32_sm90.cu picks the build, 128 up to D 128, 256
    past it (the wide build, dS through shared memory, so that S and dP
    are paid half as often). Needs the kernels' library past D 32."""
    if d in TF32_NARROW_DIMS["dq"]:
        return d
    return _cuda.load().hvdt_flash_dq_tf32_part(d)


def tf32_dkv_part(d: int) -> int:
    """The columns of dK and dV that a CTA of the tf32 dk/dv owns at the
    built head dim ``d``, which name its build: D itself at the narrow
    builds (D 16 and 32, csrc/flash_bwd_tf32_narrow_sm90.cu); past them as
    the C entry of csrc/flash_bwd_tf32_sm90.cu picks the build, 64 up to D
    128, 128 past it (the wide build, P^T and dS^T through shared memory,
    so that S and dP are paid half as often). Needs the kernels' library
    past D 32."""
    if d in TF32_NARROW_DIMS["dkv"]:
        return d
    return _cuda.load().hvdt_flash_dkv_tf32_part(d)


def _flash_fwd_sm90(q, k, v, causal: bool, q_offset: int, k_offset: int,
                    scale=None):
    """The wgmma/TMA forward kernel with Q resident (flash_fwd_sm90.cu):
    bf16 and fp16, D 16/32/64/128/256/384/512, and the multiples of 8
    between 32 and 512 on the next one's build."""
    global flash_fwd_sm90_launches
    out = _fwd_tensor_cores("sm90", q, k, v, causal, q_offset, k_offset,
                            scale)
    flash_fwd_sm90_launches += 1
    return out


def _flash_fwd_stream(q, k, v, causal: bool, q_offset: int, k_offset: int,
                      scale=None):
    """The wgmma/TMA forward kernel streamed over D
    (flash_fwd_stream_sm90.cu): bf16 and fp16 at the multiples of 64 past
    512."""
    global flash_fwd_stream_launches
    out = _fwd_tensor_cores("stream", q, k, v, causal, q_offset, k_offset,
                            scale)
    flash_fwd_stream_launches += 1
    return out


def _flash_fwd_tf32(q, k, v, causal: bool, q_offset: int, k_offset: int,
                    scale=None):
    """The 3xTF32 forward kernel with its pre-pass: fp32 at D 16 and 32
    on the narrow builds (flash_fwd_tf32_narrow_sm90.cu: O whole, a q
    tile's kv tiles shared among consumer warpgroups), and at the
    multiples of 32 past 32 streamed over D (flash_fwd_stream_sm90.cu), in
    128-column parts of O up to D 128 and 256-column parts past it
    (:func:`tf32_fwd_part`)."""
    global flash_fwd_tf32_launches
    out = _fwd_tensor_cores("tf32", q, k, v, causal, q_offset, k_offset,
                            scale)
    flash_fwd_tf32_launches += 1
    return out


def _bwd_inputs(name, q, k, v, do, lse, delta):
    sq, sk = q.shape[1], k.shape[1]
    b, h, d = _check(name, (q, k, v, do), (sq, sk, sk, sq))
    for t in (lse, delta):
        _same(name, t, q.device, (b, h, sq), torch.float32)
    return b, h, sq, sk, d


def _flash_dq_simt(q, k, v, do, lse, delta, causal: bool, q_offset: int,
                   k_offset: int, scale=None):
    """The fp32-FMA dq kernel (flash_bwd.cu), any supported input."""
    global flash_dq_launches
    b, h, sq, sk, d = _bwd_inputs("flash dq", q, k, v, do, lse, delta)
    _cuda_only("flash dq", "dq", q)
    lib = _cuda.load()
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.hvdt_flash_dq(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, sq, sk, d, q_offset, k_offset, int(causal),
            _scale_arg(q, scale), _stream(q))
    _cuda.check(err, "flash dq kernel")
    flash_dq_launches += 1
    return dq


def _dq_tensor_cores(design, q, k, v, do, lse, delta, causal, q_offset,
                     k_offset, scale):
    """Checks and launches the 16-bit tensor-core dq of ``design`` (sm90
    or stream); returns dq."""
    b, h, sq, sk, d = _bwd_inputs("flash dq", q, k, v, do, lse, delta)
    _check_tensor_cores("flash dq", "dq", (q, k, v, do), design)
    lib = _cuda.load()
    dq = torch.empty_like(q)
    entry = (lib.hvdt_flash_dq_sm90 if design == "sm90"
             else lib.hvdt_flash_dq_stream)
    with torch.cuda.device(q.device):
        err = entry(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, h, sq, sk, d, q_offset, k_offset, int(causal),
            _scale_arg(q, scale), _stream(q))
    _cuda.check(err, f"flash dq {design} kernel")
    return dq


def _flash_dq_sm90(q, k, v, do, lse, delta, causal: bool, q_offset: int,
                   k_offset: int, scale=None):
    """The wgmma/TMA dq kernel with Q and dO resident (flash_dq_sm90.cu):
    bf16 and fp16, D 16/32/64/128/256, and the multiples of 8 between 32
    and 256 on the next one's build."""
    global flash_dq_sm90_launches
    dq = _dq_tensor_cores("sm90", q, k, v, do, lse, delta, causal, q_offset,
                          k_offset, scale)
    flash_dq_sm90_launches += 1
    return dq


def _flash_dq_stream(q, k, v, do, lse, delta, causal: bool, q_offset: int,
                     k_offset: int, scale=None):
    """The wgmma/TMA dq kernel streamed over D (flash_dq_stream_sm90.cu):
    bf16 and fp16 at the multiples of 64 past 256."""
    global flash_dq_stream_launches
    dq = _dq_tensor_cores("stream", q, k, v, do, lse, delta, causal,
                          q_offset, k_offset, scale)
    flash_dq_stream_launches += 1
    return dq


def _flash_dkv_simt(q, k, v, do, lse, delta, causal: bool, q_offset: int,
                    k_offset: int, scale=None):
    """The fp32-FMA dk/dv kernel (flash_bwd.cu), any supported input."""
    global flash_dkv_launches
    b, h, sq, sk, d = _bwd_inputs("flash dk/dv", q, k, v, do, lse, delta)
    _cuda_only("flash dk/dv", "dkv", q)
    lib = _cuda.load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        err = lib.hvdt_flash_dkv(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, sq, sk, d, q_offset, k_offset, int(causal),
            _scale_arg(q, scale), _stream(q))
    _cuda.check(err, "flash dk/dv kernel")
    flash_dkv_launches += 1
    return dk, dv


def _dkv_tensor_cores(design, q, k, v, do, lse, delta, causal, q_offset,
                      k_offset, scale):
    """Checks and launches the 16-bit tensor-core dk/dv of ``design``
    (sm90 or stream); returns (dk, dv)."""
    b, h, sq, sk, d = _bwd_inputs("flash dk/dv", q, k, v, do, lse, delta)
    _check_tensor_cores("flash dk/dv", "dkv", (q, k, v, do), design)
    lib = _cuda.load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    entry = (lib.hvdt_flash_dkv_sm90 if design == "sm90"
             else lib.hvdt_flash_dkv_stream)
    with torch.cuda.device(q.device):
        err = entry(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, h, sq, sk, d, q_offset, k_offset, int(causal),
            _scale_arg(q, scale), _stream(q))
    _cuda.check(err, f"flash dk/dv {design} kernel")
    return dk, dv


def _flash_dkv_sm90(q, k, v, do, lse, delta, causal: bool, q_offset: int,
                    k_offset: int, scale=None):
    """The wgmma/TMA dk/dv kernel (flash_dkv_sm90.cu): bf16 and fp16,
    D 16/32/64/128/256, and the multiples of 8 between 32 and 256 on the
    next one's build (``flash_dkv_sm90_wide`` past 128)."""
    global flash_dkv_sm90_launches
    out = _dkv_tensor_cores("sm90", q, k, v, do, lse, delta, causal,
                            q_offset, k_offset, scale)
    flash_dkv_sm90_launches += 1
    return out


def _flash_dkv_stream(q, k, v, do, lse, delta, causal: bool, q_offset: int,
                      k_offset: int, scale=None):
    """The wgmma/TMA dk/dv kernel streamed over D
    (flash_dkv_stream_sm90.cu): bf16 and fp16 at the multiples of 64 past
    256."""
    global flash_dkv_stream_launches
    out = _dkv_tensor_cores("stream", q, k, v, do, lse, delta, causal,
                            q_offset, k_offset, scale)
    flash_dkv_stream_launches += 1
    return out


def _fused_bwd_counters(q):
    """How many int32 counters the fused backward takes for q's shape, all
    zero on entry: a turn flag for each (b h, q tile), then the tile
    counter (csrc/flash_bwd_sm90.cu)."""
    b, sq, h, _ = q.shape
    return b * h * -(-sq // BLOCK) + 1


def _flash_bwd_sm90(q, k, v, do, lse, delta, causal: bool, q_offset: int,
                    k_offset: int, scale=None, counters=None):
    """The fused wgmma/TMA backward (flash_bwd_sm90.cu): bf16 and fp16,
    D 64 and 128 and the multiples of 8 between 32 and 128 on the next
    one's build; returns (dq, dk, dv) in one launch. ``counters``: int32
    zeros, :func:`_fused_bwd_counters` of them, as :func:`_bwd_prep` makes
    them; zeroed here when not given. dq is summed in an fp32 scratch
    allocated here, [B H, Sq / 64, 64, the build's D], which the kernel
    fills itself (no zeroing) and the C entry's second kernel converts."""
    global flash_bwd_sm90_launches
    b, h, sq, sk, d = _bwd_inputs("flash backward", q, k, v, do, lse, delta)
    _check_tensor_cores("flash backward", "bwd", (q, k, v, do), "sm90")
    n = _fused_bwd_counters(q)
    if counters is None:
        counters = torch.zeros(n, dtype=torch.int32, device=q.device)
    _same("flash backward", counters, q.device, (n,), torch.int32)
    built = padded_head_dim(d, "sm90", "bwd")
    acc = torch.empty((n - 1) * BLOCK * built, device=q.device)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    lib = _cuda.load()
    with torch.cuda.device(q.device):
        err = lib.hvdt_flash_bwd_sm90(
            _DTYPES[q.dtype], *(t.data_ptr() for t in (
                q, k, v, do, lse, delta, dq, dk, dv, acc, counters)),
            b, h, sq, sk, d, q_offset, k_offset, int(causal),
            _scale_arg(q, scale), _stream(q))
    _cuda.check(err, "flash backward sm90 kernel")
    flash_bwd_sm90_launches += 1
    return dq, dk, dv


def _bwd_prep(o, do, m, l, counters: int = 0):
    """The backward's lse and delta (:func:`_bwd_stats_plain`) and, with
    ``counters`` > 0, that many int32 zeros (the fused kernel's,
    :func:`_fused_bwd_counters`): on CUDA one launch of the pre-pass
    kernel (csrc/flash_bwd_sm90.cu ``flash_bwd_prep``: o and do read once
    in their own type, every dtype and head dim); on the CPU the plain
    version, and no counters. Returns (lse, delta, counters or None)."""
    global flash_bwd_prep_launches
    b, sq, h, d = o.shape
    if do.device.type == "cpu" and o.device.type == "cpu":
        return (*_bwd_stats_plain(o, do, m, l), None)
    _check("flash backward pre-pass", (o, do), (sq, sq))
    for t in (m, l):
        _same("flash backward pre-pass", t, o.device, (b, h, sq),
              torch.float32)
    lse, delta = torch.empty_like(m), torch.empty_like(m)
    cnt = (torch.empty(counters, dtype=torch.int32, device=o.device)
           if counters else None)
    lib = _cuda.load()
    with torch.cuda.device(o.device):
        err = lib.hvdt_flash_bwd_prep(
            _DTYPES[o.dtype], o.data_ptr(), do.data_ptr(), m.data_ptr(),
            l.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            cnt.data_ptr() if cnt is not None else None, counters, b, h, sq,
            d, _stream(o))
    _cuda.check(err, "flash backward pre-pass")
    flash_bwd_prep_launches += 1
    return lse, delta, cnt


def _tf32_bwd_split(q, k, v, do):
    """The tf32 backward's pre-pass (the C entry
    ``hvdt_flash_bwd_tf32_split``, one launch of csrc/sm90_common.cuh's
    ``tf32_bwd_split_all``), which dq and dk/dv both read, on every build
    (the narrow ones at D 16 and 32 among them): q, do, k and v split into
    tf32 hi and lo parts in their [B, S, H, D] layout, and k, q and do
    transposed to [B, H, D, S rounded up to 64] hi and lo, 14 planes in
    one fp32 scratch tensor allocated here (at the fp32 main shape 0.94
    GB)."""
    _check_tensor_cores("flash backward", "dq", (q, k, v, do), "tf32")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sqp, skp = (-(-x // BLOCK) * BLOCK for x in (sq, sk))
    scratch = torch.empty(4 * (q.numel() + k.numel())
                          + 2 * b * h * d * (skp + 2 * sqp), device=q.device)
    lib = _cuda.load()
    with torch.cuda.device(q.device):
        err = lib.hvdt_flash_bwd_tf32_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            scratch.data_ptr(), b, h, sq, sk, d, _stream(q))
    _cuda.check(err, "flash backward tf32 pre-pass")
    return scratch


def _bwd_tf32(name, kernel, q, k, v, do, lse, delta, split):
    """The tf32 dq and dk/dv launchers' checks; their pre-pass, run here
    unless the caller passes the one it ran for both (``split``)."""
    _bwd_inputs(name, q, k, v, do, lse, delta)
    _check_tensor_cores(name, kernel, (q, k, v, do), "tf32")
    return _tf32_bwd_split(q, k, v, do) if split is None else split


def _flash_dq_tf32(q, k, v, do, lse, delta, causal: bool, q_offset: int,
                   k_offset: int, scale=None, split=None):
    """The 3xTF32 dq kernel: fp32 at D 16 and 32 on the narrow builds
    (flash_bwd_tf32_narrow_sm90.cu: dQ whole, a q tile's kv stages shared
    among consumer warpgroups) and at the multiples of 32 past 32 streamed
    over D (flash_bwd_tf32_sm90.cu) in 128-column parts of dQ up to D 128
    and 256-column parts past it (:func:`tf32_dq_part`). ``split``:
    :func:`_tf32_bwd_split` of these inputs."""
    global flash_dq_tf32_launches
    split = _bwd_tf32("flash dq", "dq", q, k, v, do, lse, delta, split)
    b, sq, h, d = q.shape
    lib = _cuda.load()
    dq = torch.empty_like(q)
    entry = (lib.hvdt_flash_dq_tf32_narrow if d in TF32_NARROW_DIMS["dq"]
             else lib.hvdt_flash_dq_tf32)
    with torch.cuda.device(q.device):
        err = entry(
            split.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), b, h, sq, k.shape[1], d, q_offset, k_offset,
            int(causal), _scale_arg(q, scale), _stream(q))
    _cuda.check(err, "flash dq tf32 kernel")
    flash_dq_tf32_launches += 1
    return dq


def _flash_dkv_tf32(q, k, v, do, lse, delta, causal: bool, q_offset: int,
                    k_offset: int, scale=None, split=None):
    """The 3xTF32 dk/dv kernel: fp32 at D 16 and 32 on the narrow builds
    (flash_bwd_tf32_narrow_sm90.cu: dK and dV whole, a kv tile's q stages
    shared among consumer warpgroups), and at the multiples of 32 past 32
    streamed over D (flash_bwd_tf32_sm90.cu) in 64-column parts of dK and
    dV up to D 128 and 128-column parts past it (:func:`tf32_dkv_part`).
    ``split``: as for :func:`_flash_dq_tf32`."""
    global flash_dkv_tf32_launches
    split = _bwd_tf32("flash dk/dv", "dkv", q, k, v, do, lse, delta, split)
    b, sq, h, d = q.shape
    lib = _cuda.load()
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    entry = (lib.hvdt_flash_dkv_tf32_narrow if d in TF32_NARROW_DIMS["dkv"]
             else lib.hvdt_flash_dkv_tf32)
    with torch.cuda.device(q.device):
        err = entry(
            split.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), b, h, sq, k.shape[1], d, q_offset,
            k_offset, int(causal), _scale_arg(q, scale), _stream(q))
    _cuda.check(err, "flash dk/dv tf32 kernel")
    flash_dkv_tf32_launches += 1
    return dk, dv


_LAUNCHERS = {("fwd", "sm90"): _flash_fwd_sm90,
              ("fwd", "stream"): _flash_fwd_stream,
              ("fwd", "tf32"): _flash_fwd_tf32,
              ("fwd", "simt"): _flash_fwd_simt,
              ("dq", "sm90"): _flash_dq_sm90,
              ("dq", "stream"): _flash_dq_stream,
              ("dq", "tf32"): _flash_dq_tf32,
              ("dq", "simt"): _flash_dq_simt,
              ("dkv", "sm90"): _flash_dkv_sm90,
              ("dkv", "stream"): _flash_dkv_stream,
              ("dkv", "tf32"): _flash_dkv_tf32,
              ("dkv", "simt"): _flash_dkv_simt,
              ("bwd", "sm90"): _flash_bwd_sm90}


def _flash_bwd(q, k, v, do, lse, delta, causal: bool, q_offset: int,
               k_offset: int, launchers=None, counters=None):
    """dq and dk/dv kernels: (dq, (dk, dv)); lse and delta are [B,H,Sq]
    fp32. On CUDA a 16-bit backward at D 33-128 (:func:`_fused_bwd`) is
    one launch of the fused kernel (``launchers[("bwd", "sm90")]``) on the
    caller's tensors where it reads them in place (D a multiple of 8),
    else on one copy padded to its build, with ``counters`` (the
    pre-pass's zeros, :func:`_bwd_prep`; the launcher zeroes its own when
    None); a ``launchers`` without that key (a test's) runs its dq and
    dk/dv instead. Otherwise each kernel takes the design
    :func:`_design` gives it,
    on tensors of the head dim :func:`_run_head_dim` gives that design;
    q, k, v and do are zero-padded once for each head dim the two run at
    (one: every dtype and head dim gives dq and dk/dv the same), so both
    read the same tensors: the caller's own where both read them in place
    (16-bit d a multiple of 8 past 32, D 80, 96 and 200 on the sm90
    builds; D 320 on the stream design, built there), else one padded
    copy (16-bit D 20 and 260, fp32 D 20 and 100). Where both run the
    tf32 design (every fp32 head dim) one pre-pass of those tensors
    (:func:`_tf32_bwd_split`) serves both. ``launchers`` ({(kernel,
    design): function}, default the kernels' own) lets a test run the
    plain versions through the same steps."""
    tensors = (q, k, v, do)
    args = (lse, delta, causal, q_offset, k_offset)
    _bwd_inputs("flash backward", *tensors, lse, delta)
    if q.device.type == "cpu" and launchers is None:
        return (_flash_dq_plain(*tensors, *args),
                _flash_dkv_plain(*tensors, *args))
    launchers = launchers or _LAUNCHERS
    d = q.shape[-1]
    if _fused_bwd(q.dtype, d) and ("bwd", "sm90") in launchers:
        fn = launchers["bwd", "sm90"]
        if fn is _LAUNCHERS["bwd", "sm90"]:
            fn = functools.partial(fn, counters=counters)
        built = _run_head_dim(d, "sm90", "bwd")
        dq, dk, dv = _at_head_dim(fn, _pad_head_dim(tensors, built), d, *args)
        return dq, (dk, dv)
    padded, splits = {}, {}

    def run(kernel):
        design = _design(q.dtype, d, kernel)
        built = _run_head_dim(d, design, kernel)
        if built not in padded:
            padded[built] = _pad_head_dim(tensors, built)
        fn = launchers[kernel, design]
        if design == "tf32" and fn is _LAUNCHERS[kernel, design]:
            if built not in splits:
                splits[built] = _tf32_bwd_split(*padded[built])
            fn = functools.partial(fn, split=splits[built])
        return _at_head_dim(fn, padded[built], d, *args)
    return run("dq"), run("dkv")


# ---------------------------------------------------------------------------
# Public API (reference :436-566)
# ---------------------------------------------------------------------------

def _shapes_ok(seq_q: int, seq_k: int) -> bool:
    return all(s < WHOLE_BELOW or s % BLOCK == 0 for s in (seq_q, seq_k))


def _offset(x: Offset) -> int:
    return int(x.item()) if isinstance(x, torch.Tensor) else int(x)


def _require_blocks(seq_q, seq_k):
    if not _shapes_ok(seq_q, seq_k):
        raise ValueError(
            f"sequence lengths ({seq_q}, {seq_k}) must be shorter than "
            f"{WHOLE_BELOW} or multiples of {BLOCK}")


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
    dtypes. On CUDA, lse and delta come from one pre-pass launch
    (:func:`_bwd_prep`), which also zeroes the fused kernel's counters
    where it runs (16-bit D 33-128); then :func:`_flash_bwd`."""
    _require_blocks(q.shape[1], k.shape[1])
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    fused = q.device.type == "cuda" and _fused_bwd(q.dtype, q.shape[-1])
    lse, delta, counters = _bwd_prep(
        o.contiguous(), do, m.float().contiguous(), l.float().contiguous(),
        _fused_bwd_counters(q) if fused else 0)
    dq, (dk, dv) = _flash_bwd(q, k, v, do, lse, delta, bool(causal),
                              _offset(q_offset), _offset(k_offset),
                              counters=counters)
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
    positions of element 0 and shift the causal mask. Softmax statistics
    and every sum stay fp32. fp32 inputs on CUDA take each product of the
    forward, dq and dk/dv as three tf32 products (3xTF32), which holds the
    reference's fp32 bounds; the bf16 and fp16 tensor-core kernels feed
    p (and in the backward ds) to the tensor cores in the input's type,
    so they also differ from fp32 by that rounding, beside that of the
    inputs and of the outputs (utils/tolerance.py states both). On CUDA
    the 16-bit backward at D 33-128 is one fused launch (dq, dk and dv,
    csrc/flash_bwd_sm90.cu) whose dq is summed over 128-key kv tiles in a
    fixed order, so its bits are the same on every run; every backward
    takes its lse and delta from one pre-pass launch."""
    seq_q, seq_k = q.shape[1], k.shape[1]
    if not _shapes_ok(seq_q, seq_k):
        if not causal:
            raise ValueError(f"non-causal path requires sequence lengths "
                             f"shorter than {WHOLE_BELOW} or multiples of "
                             f"{BLOCK}")
        return _dense_reference(q, k, v, causal, _offset(q_offset),
                                _offset(k_offset))
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), bool(causal),
                                 _offset(q_offset), _offset(k_offset))
