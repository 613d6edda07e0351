"""Invariant annotations.

Counterpart of ``horovod_tpu/common/invariants.py`` (:19).
``@world_coherent`` marks a function whose inputs are world-identical by
construction: the broadcast response stream, the coordinator's grant and
invalidate masks, the fused speculative verdict. Only such functions may
change state that every rank must hold alike (the response cache's
slots, LRU order and epoch, the runtime's steady-state predictor), which
the reference's ``hvdlint`` world-coherence analyzer checks. The
decorator is the identity at run time.
"""

from __future__ import annotations


def world_coherent(fn):
    """Identity decorator: ``fn`` applies only world-identical inputs,
    in the canonical world order, and may therefore change
    world-replicated state."""
    fn.__world_coherent__ = True
    return fn
