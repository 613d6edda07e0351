"""The JAX package's reference results of the port's parity tests,
computed in a pool of worker processes ahead of the tests that read them.

The port's parity tests spend most of their time in JAX: the
reference's Pallas kernels run in interpret mode, and every shape and
offset compiles anew, one compile after another on one core. A module
names its reference computations (a module-level function and its
arguments each, which a worker finds by importing the module) in a
function that it ``register``s when it is imported; its autouse module
fixture calls ``start``, which submits the jobs of every module
registered by then, in the order the run reaches them. So the first
such module to run sets the pool to work on the whole run's references
while the tests go on in this process, and each test then reads its own
result and holds the port's to it as before. The inputs, the assertions
and the bounds stay the tests' own: only where the reference runs
changes.

The workers are spawned once for the session, with one intra-op thread
each.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import multiprocessing
import os

# Leave a core to the test process and one to everything else.
WORKERS = max(1, min(6, (os.cpu_count() or 2) - 2))
# A result not ready by then fails its test (the pool is broken or hung).
RESULT_TIMEOUT_S = 600.0

_pool = None
_futures = {}
_registered = []


def _init_worker() -> None:
    import torch
    torch.set_num_threads(1)


def _executor() -> concurrent.futures.ProcessPoolExecutor:
    global _pool
    if _pool is None:
        _pool = concurrent.futures.ProcessPoolExecutor(
            WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_worker)
        atexit.register(_pool.shutdown, wait=True, cancel_futures=True)
    return _pool


def register(jobs) -> None:
    """Queue ``jobs()``, a list of ``(key, fn, args)``, for ``start``."""
    _registered.append(jobs)


def start() -> None:
    """Submit the jobs of every module registered so far."""
    while _registered:
        _submit(_registered.pop(0)())


def _submit(jobs) -> None:
    """Start each ``(key, fn, args)`` of ``jobs`` in the pool (a key
    already submitted is left as it is)."""
    pool = _executor()
    for key, fn, args in jobs:
        if key not in _futures:
            _futures[key] = pool.submit(fn, *args)


def result(key):
    """The result of the job ``key``: its return value, or its exception
    raised here (two tests that read one key share its job)."""
    return _futures[key].result(RESULT_TIMEOUT_S)
