"""Steady-state step timing for benchmarks.

Counterpart of ``horovod_tpu/utils/timing.py``: warm up, then time
chunks of steps that each end in a sync, and report the median chunk.
On CUDA the sync is ``torch.cuda.synchronize()`` or a ``.item()`` of the
step's result: PyTorch returns before the device finishes, so a clock
without it measures the enqueue.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable


def steady_state_sec_per_step(step: Callable[[], object],
                              sync: Callable[[object], None],
                              warmup_steps: int = 10,
                              chunks: int = 4,
                              chunk_steps: int = 5) -> float:
    """Median seconds per ``step()`` call at steady state.

    ``step`` runs one training step and returns a handle; ``sync``
    waits for it (e.g. ``lambda loss: loss.item()``). Runs
    ``warmup_steps`` (0 allowed) then ``chunks`` timed chunks of
    ``chunk_steps`` (each clamped to >= 1)."""
    r = None
    for _ in range(max(0, warmup_steps)):
        r = step()
    if r is not None:
        sync(r)
    dts = []
    for _ in range(max(1, chunks)):
        t0 = time.perf_counter()
        for _ in range(max(1, chunk_steps)):
            r = step()
        sync(r)
        dts.append((time.perf_counter() - t0) / max(1, chunk_steps))
    return float(statistics.median(dts))
