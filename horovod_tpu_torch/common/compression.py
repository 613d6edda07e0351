"""Gradient compression around the allreduce, on torch tensors.

Counterpart of ``horovod_tpu/common/compression.py``: ``Compression.none``
passes tensors through, ``.fp16`` and ``.bf16`` cast floating tensors to
the wire type before the reduction and back to their own type after.
bf16 keeps float32's exponent range, so it needs no loss scaling.
(The reference's pass-through under a negotiated wire compression has no
counterpart yet: the negotiated runtime has no wire dtypes, ROADMAP.md
A6.5.)
"""

from __future__ import annotations

import torch


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


class _CastCompressor(Compressor):
    wire_dtype: torch.dtype = torch.float16

    @classmethod
    def compress(cls, tensor):
        if not tensor.is_floating_point():
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
