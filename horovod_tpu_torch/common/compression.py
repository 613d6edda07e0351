"""Gradient compression around the allreduce, on torch tensors.

Counterpart of ``horovod_tpu/common/compression.py``: ``Compression.none``
passes tensors through, ``.fp16`` and ``.bf16`` cast floating tensors to
the wire type before the reduction and back to their own type after.
bf16 keeps float32's exponent range, so it needs no loss scaling. While
a wire compression is active (``HOROVOD_COMPRESSION``), the casts pass
tensors through, as the reference's do (:60-107): the runtime casts on
the wire, and a cast here too would quantize twice and decompress once.
Both this module and the wire codec ask the codec's one float table
whether a tensor is a float.
"""

from __future__ import annotations

import torch

from horovod_tpu_torch.common import logging as hlog
from horovod_tpu_torch.common import wire_dtype as _wd


class Compressor:
    """Interface: ``compress(t) -> (wire tensor, ctx)`` and
    ``decompress(wire tensor, ctx) -> tensor``."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


_warned_double_cast = False


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = torch.float16

    @classmethod
    def compress(cls, tensor):
        if _wd.active() != _wd.WIRE_NONE:
            # The negotiated data plane compresses on the wire already.
            # The latch follows the local knob (the verdict is known per
            # batch only), so the knob must be the same on every rank: a
            # rank without it would cast here and submit another dtype,
            # which negotiation rejects.
            global _warned_double_cast
            if not _warned_double_cast:
                _warned_double_cast = True
                hlog.warning(
                    "Compression.fp16/bf16 is a pass-through while "
                    f"HOROVOD_COMPRESSION={_wd.WIRE_NAMES[_wd.active()]} "
                    "is set: the negotiated data plane compresses on the "
                    "wire instead (to the world's least aggressive "
                    "proposal: set the knob on every rank); drop the "
                    "framework-level compressor")
            return tensor, None
        if not _wd.is_floating(tensor.dtype):
            return tensor, None
        return tensor.to(cls.wire_dtype), tensor.dtype

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Compression:
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
