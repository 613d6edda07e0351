"""Deterministic fault injection for the fail-fast abort machinery.

Counterpart of ``horovod_tpu/common/faults.py`` (:131-295). A real death
is easy to cause from a test (SIGKILL) but hard to time; this module
fires failures from inside the background loop, at an exact point of
the negotiation cycle. Faults are armed through the API::

    from horovod_tpu_torch.common import faults
    faults.install(action="kill", at_cycle=200)
    faults.install(action="hang", at_cycle=50, seconds=8)

or through the environment, so that launched ranks are faulted without
code changes::

    HOROVOD_FAULT_SPEC="rank=1:kill:cycle=40;rank=2:delay:op=3:ms=50"

Grammar: directives separated by ``;``, each ``:``-joined tokens, one
bare action word and ``key=value`` arguments. ``rank`` scopes a directive
to one launch-time rank (``HOROVOD_RANK``; absent: every rank). Exactly
one trigger: ``cycle=K`` fires at the K-th negotiation cycle, ``op=K``
just before the K-th executed response (after negotiation, squarely
mid-collective).

Actions: ``kill`` (SIGKILL this process), ``exit`` (``os._exit(code)``,
``code=N``, default 1), ``hang`` (stop the background loop for
``seconds=S``, default 60: alive but silent, which only the heartbeat
deadline sees), ``sever`` (close this rank's control channel(s);
``target=R`` picks one peer on the coordinator) and ``delay`` (sleep
``ms=N`` once, or on ``count=K`` consecutive trigger hits).

The reference's ``rdzv=K`` trigger (a fault during an elastic
re-rendezvous) and ``preempt`` action (SIGTERM with a grace window,
drained by self-operation) need elastic worlds and self-operation
(``ROADMAP.md`` A9): a spec that uses them raises
``NotImplementedError``. Idle, the module costs one check per cycle and
per op.
"""

from __future__ import annotations

import os
import signal
import time
from typing import List, Optional

from horovod_tpu_torch.common import config as hconfig
from horovod_tpu_torch.common import logging as hlog

_ACTIONS = ("kill", "exit", "hang", "sever", "delay")
_NEEDS_A9 = ("elastic worlds and self-operation (ROADMAP.md A9), which "
             "horovod_tpu_torch does not have yet")


class Fault:
    """One armed fault directive."""

    __slots__ = ("action", "rank", "at_cycle", "at_op", "seconds", "ms",
                 "code", "target", "count", "fired")

    def __init__(self, action: str, rank: Optional[int] = None,
                 at_cycle: Optional[int] = None,
                 at_op: Optional[int] = None, seconds: float = 60.0,
                 ms: float = 0.0, code: int = 1,
                 target: Optional[int] = None, count: int = 1):
        if action == "preempt":
            raise NotImplementedError(
                f"the fault action 'preempt' needs {_NEEDS_A9}")
        if action not in _ACTIONS:
            raise ValueError(f"unknown fault action {action!r}; "
                             f"expected one of {_ACTIONS}")
        if count != 1 and action != "delay":
            raise ValueError(
                "count= repeats only make sense for delay faults "
                f"(a fired {action!r} never returns)")
        if count < 1:
            raise ValueError(f"fault count must be >= 1, got {count}")
        if (at_cycle is None) == (at_op is None):
            raise ValueError(
                "a fault needs exactly one trigger: at_cycle= or at_op=")
        self.action = action
        self.rank = rank
        self.at_cycle = at_cycle
        self.at_op = at_op
        self.seconds = seconds
        self.ms = ms
        self.code = code
        self.target = target
        self.count = count
        self.fired = False

    def __repr__(self) -> str:
        trig = (f"cycle={self.at_cycle}" if self.at_cycle is not None
                else f"op={self.at_op}")
        scope = "*" if self.rank is None else self.rank
        return f"Fault({self.action}@{trig}, rank={scope})"


_PLAN: Optional[List[Fault]] = None
_ENV_LOADED = False

# Spec key -> (Fault argument, parser).
_KEYS = {"rank": ("rank", int), "cycle": ("at_cycle", int),
         "op": ("at_op", int), "seconds": ("seconds", float),
         "ms": ("ms", float), "code": ("code", int),
         "target": ("target", int), "count": ("count", int)}


def parse_spec(spec: str) -> List[Fault]:
    """Parse a HOROVOD_FAULT_SPEC string; raises ValueError on garbage (a
    mistyped spec that did nothing would void the test relying on it)."""
    faults: List[Fault] = []
    for directive in spec.split(";"):
        directive = directive.strip()
        if not directive:
            continue
        action = None
        kw = {}
        for token in directive.split(":"):
            token = token.strip()
            if not token:
                continue
            if "=" in token:
                k, v = token.split("=", 1)
                k = k.strip()
                if k == "rdzv":
                    raise NotImplementedError(
                        f"the fault trigger 'rdzv' in {directive!r} needs "
                        f"{_NEEDS_A9}")
                if k not in _KEYS:
                    raise ValueError(
                        f"unknown fault key {k!r} in {directive!r}")
                arg, parse = _KEYS[k]
                kw[arg] = parse(v)
            else:
                if action is not None:
                    raise ValueError(
                        f"two actions in one directive: {directive!r}")
                action = token
        if action is None:
            raise ValueError(f"fault directive has no action: "
                             f"{directive!r}")
        faults.append(Fault(action, **kw))
    return faults


def install(action: str, rank: Optional[int] = None,
            at_cycle: Optional[int] = None, at_op: Optional[int] = None,
            **kw) -> Fault:
    """Arm one fault programmatically."""
    global _PLAN
    f = Fault(action, rank=rank, at_cycle=at_cycle, at_op=at_op, **kw)
    if _PLAN is None:
        _PLAN = []
    _PLAN.append(f)
    return f


def clear() -> None:
    global _PLAN, _ENV_LOADED
    _PLAN = None
    _ENV_LOADED = False


def load_env() -> None:
    """Arm the faults of HOROVOD_FAULT_SPEC, once per process."""
    global _PLAN, _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    spec = hconfig.env_str("HOROVOD_FAULT_SPEC", "")
    if not spec:
        return
    parsed = parse_spec(spec)
    if _PLAN is None:
        _PLAN = []
    _PLAN.extend(parsed)


def _apply(fault: Fault, runtime) -> None:
    fault.count -= 1
    if fault.count <= 0:
        fault.fired = True
    rank = runtime.controller.rank
    hlog.warning(f"fault injection firing on rank {rank}: {fault!r}",
                 rank=rank)
    from horovod_tpu_torch.common import trace as htrace
    htrace.flight().record(htrace.EV_FAULT,
                           note=f"{fault!r} fired on rank {rank}")
    if fault.action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif fault.action == "exit":
        os._exit(fault.code)
    elif fault.action == "hang":
        time.sleep(fault.seconds)
    elif fault.action == "delay":
        time.sleep(fault.ms / 1000.0)
    elif fault.action == "sever":
        runtime.controller.sever_connection(fault.target)


def _tick(runtime, cycle: Optional[int], op: Optional[int]) -> None:
    # Scoped on the launch-time identity, as the reference is (its
    # elastic resizes renumber the survivors).
    rank = hconfig.env_int("HOROVOD_RANK", runtime.controller.rank)
    for f in _PLAN:  # type: ignore[union-attr]
        if f.fired or (f.rank is not None and f.rank != rank):
            continue
        if cycle is not None and f.at_cycle is not None \
                and cycle >= f.at_cycle:
            _apply(f, runtime)
        elif op is not None and f.at_op is not None and op >= f.at_op:
            _apply(f, runtime)


def tick_cycle(runtime, cycle: int) -> None:
    """Called by the background loop at the top of every cycle."""
    if _PLAN is None:
        return
    _tick(runtime, cycle, None)


def tick_op(runtime, op_index: int) -> None:
    """Called just before each negotiated response runs."""
    if _PLAN is None:
        return
    _tick(runtime, None, op_index)
