"""The runtime's knobs, read once from the environment at ``init``.

Counterpart of ``horovod_tpu/common/config.py`` for what this port
runs: the same ``HOROVOD_*`` names with the same defaults (fusion
threshold 64 MiB, cycle time 5 ms, stall check at 60 s, timeline off,
the response cache on at 1024 slots with speculative cycles, :77-96,
:409-414; capacity 0 or ``HOROVOD_CACHE_ENABLED=0`` turns the cache
off; the heartbeat on, a PING every 5 s and a peer dead after 30 s of
silence, :302-311, a timeout of 0 or less turning it off; wire
compression off, ``HOROVOD_COMPRESSION`` none, bf16, fp16 or int8,
:145-155; the metrics and trace planes off, ``HOROVOD_TPU_METRICS``,
``_METRICS_INTERVAL``, ``_METRICS_PORT``, ``_METRICS_ADDR``,
``_METRICS_LOG``, ``HOROVOD_TPU_TRACE`` and ``_TRACE_INTERVAL``,
:250-290, :467-480; autotune off, ``HOROVOD_AUTOTUNE``, ``_LOG``,
``_WARMUP_SAMPLES``, ``_STEPS_PER_SAMPLE``, ``_BAYES_OPT_MAX_SAMPLES``
and ``_GAUSSIAN_PROCESS_NOISE``, :313-319, :493-504). The planes of the reference that are not ported yet are off here.
A variable that would switch one of them on raises
``NotImplementedError`` naming its item in ``ROADMAP.md``, so that
nothing quietly runs another configuration than the one asked for. The
reference's defaults for those planes differ (native core, shm and ring
on): this port's runtime is the reference run with
``HOROVOD_TPU_NATIVE=0 HOROVOD_TPU_SHM=0 HOROVOD_TPU_RING_THRESHOLD=-1``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Tuple


def env_str(name: str, default: str = "") -> str:
    v = os.environ.get(name)
    return default if v is None or v == "" else v


def env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        return default


def env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip() in ("1", "true", "True", "TRUE", "yes", "on")


def _on(name: str) -> bool:
    return env_bool(name, False)


def _positive(name: str) -> bool:
    return env_float(name, 0.0) > 0


# Variable -> (does its value switch a plane on?, what is not ported and
# its item in ROADMAP.md). The debug sanitizers (HOROVOD_TPU_LOCKCHECK,
# HOROVOD_TPU_THREADCHECK, A6.9) change no result and are not listed.
_NOT_PORTED: Dict[str, Tuple[Callable[[str], bool], str]] = {
    "HOROVOD_TPU_RING_THRESHOLD": (
        lambda n: env_int(n, -1) >= 0, "the ring data plane (A6.4)"),
    "HOROVOD_TPU_SHM": (_on, "the shm data plane (A6.4)"),
    "HOROVOD_TWO_LEVEL": (_on, "two-level allreduce (A6.4)"),
    "HOROVOD_TPU_ZERO_COPY": (_on, "the arena zero-copy path (A6.6)"),
    "HOROVOD_TPU_NATIVE": (_on, "the native core (A6.10)"),
    "HOROVOD_OVERLAP_BUCKETS": (_positive, "the overlap tier (A9)"),
    "HOROVOD_OVERLAP_BYTES": (_positive, "the overlap tier (A9)"),
    "HOROVOD_TPU_ICI": (
        _on, "the fused steady-cycle plane, IciPlane, which packs and "
             "casts to the negotiated wire dtype in one collective over "
             "the local cards (A6.5)"),
    "HOROVOD_ELASTIC": (_on, "elastic worlds (A9)"),
}


def check_not_ported() -> None:
    """Raise for the first variable that asks for a plane this port
    does not have yet."""
    for name, (switched_on, what) in _NOT_PORTED.items():
        if switched_on(name):
            raise NotImplementedError(
                f"{name}={os.environ[name]} asks for {what}, which "
                f"horovod_tpu_torch does not have yet (that item of "
                f"ROADMAP.md). Unset it to run the negotiated runtime "
                f"without it.")


@dataclasses.dataclass
class Config:
    """Snapshot of the runtime's knobs."""

    fusion_threshold_bytes: int = 64 * 1024 * 1024
    cycle_time_ms: float = 5.0
    # The response cache (common/coordinator.py ResponseCache): negotiated
    # verdicts kept world-coherently, so that steady-state cycles move one
    # bit per slot instead of serialized Requests. Capacity 0 or
    # HOROVOD_CACHE_ENABLED=0 turns it off; both must match on every rank.
    cache_enabled: bool = True
    cache_capacity: int = 1024
    # The fused speculative cycle: in steady state a rank attaches its
    # pre-packed fused allreduce buffers to the bitmask frame and the
    # coordinator reduces them inline, one world round per step, where
    # the socket star would carry the batch anyway. Ranks may disagree
    # on it: a cycle some rank does not bid runs the classic way.
    cache_speculative: bool = True
    # Idle backoff: after 16 empty cycles the loop's sleep ramps toward
    # this many ms; new work or a shutdown wakes it at once.
    idle_backoff_ms: float = 25.0
    timeline_path: str = ""
    timeline_mark_cycles: bool = False
    stall_check_disable: bool = False
    stall_check_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 0.0
    log_level: str = "warning"
    controller_addr: str = ""
    controller_port: int = 0
    secret_key: str = ""
    start_timeout: float = 30.0
    rank: int = -1
    size: int = -1
    # The process-group plane (ops/process_group_ops.py): allreduce and
    # allgather in two stages, within each host and then across hosts.
    hierarchical_allreduce: bool = False
    hierarchical_allgather: bool = False
    # The hierarchical control plane: a remote host's ranks reach the
    # coordinator through their local root, one frame per host a cycle
    # (``common/controller.py``). HOROVOD_TPU_HIER_CONTROLLER=0 keeps the
    # flat star.
    hier_controller: bool = True
    # The reference's two renderings of a broadcast on its mesh; both
    # are one torch.distributed broadcast here.
    xla_broadcast: str = "psum"
    # Fail-fast liveness: PINGs ride idle waits every interval; a channel
    # silent for the timeout is declared dead and the world aborts with
    # WorldAbortedError. A timeout <= 0 turns detection off.
    heartbeat_interval_s: float = 5.0
    heartbeat_timeout_s: float = 30.0
    # Wire-dtype compression (common/wire_dtype.py): this rank's proposal
    # for its float32/float64 allreduces, allgathers and reducescatters;
    # the coordinator resolves the world's least aggressive one per
    # tensor. none | bf16 | fp16 | int8 (with error feedback).
    compression: str = "none"
    # The world trace plane (common/trace.py): HOROVOD_TPU_TRACE=<path>
    # on every rank; each rank ships its cycle and exec spans every
    # interval in TAG_TRACE frames and rank 0 writes one Chrome trace
    # with a track per rank, in the coordinator's clock. Empty is off.
    # The flight recorder is apart and on by default (HOROVOD_TPU_FLIGHT,
    # _FLIGHT_EVENTS and _FLIGHT_DIR are read by trace.flight()).
    trace_path: str = ""
    trace_interval_s: float = 1.0
    # The metrics plane (common/metrics.py): HOROVOD_TPU_METRICS=1 arms
    # the registry; each rank sends a METRICS frame every interval and
    # rank 0 folds the world view. Rank 0's Prometheus endpoint: -1 off,
    # 0 an ephemeral port (hvd.metrics()["http_port"]); its bind address
    # (all interfaces by default); its JSONL log of world snapshots.
    metrics_enabled: bool = False
    metrics_interval_s: float = 5.0
    metrics_port: int = -1
    metrics_addr: str = ""
    metrics_log: str = ""
    # Autotune (common/parameter_manager.py): rank 0 tunes the fusion
    # threshold and the cycle time, and the wire plan per size bucket;
    # the other ranks adopt its values from the ResponseList's trailer.
    autotune: bool = False
    autotune_log: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8

    @classmethod
    def from_env(cls) -> "Config":
        check_not_ported()
        c = cls()
        c.fusion_threshold_bytes = env_int(
            "HOROVOD_FUSION_THRESHOLD", c.fusion_threshold_bytes)
        c.cycle_time_ms = env_float("HOROVOD_CYCLE_TIME", c.cycle_time_ms)
        c.cache_enabled = env_bool("HOROVOD_CACHE_ENABLED", c.cache_enabled)
        c.cache_capacity = env_int("HOROVOD_CACHE_CAPACITY",
                                   c.cache_capacity)
        c.cache_speculative = env_bool("HOROVOD_CACHE_SPECULATIVE",
                                       c.cache_speculative)
        c.idle_backoff_ms = env_float("HOROVOD_TPU_IDLE_BACKOFF",
                                      c.idle_backoff_ms)
        c.timeline_path = env_str("HOROVOD_TIMELINE")
        c.timeline_mark_cycles = env_bool("HOROVOD_TIMELINE_MARK_CYCLES",
                                          c.timeline_mark_cycles)
        c.stall_check_disable = env_bool("HOROVOD_STALL_CHECK_DISABLE",
                                         c.stall_check_disable)
        c.stall_check_time_seconds = env_float(
            "HOROVOD_STALL_CHECK_TIME_SECONDS", c.stall_check_time_seconds)
        c.stall_shutdown_time_seconds = env_float(
            "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
            c.stall_shutdown_time_seconds)
        c.log_level = env_str("HOROVOD_LOG_LEVEL", c.log_level)
        c.controller_addr = env_str("HOROVOD_CONTROLLER_ADDR")
        c.controller_port = env_int("HOROVOD_CONTROLLER_PORT", 0)
        c.secret_key = env_str("HOROVOD_SECRET_KEY")
        c.start_timeout = env_float("HOROVOD_START_TIMEOUT", c.start_timeout)
        c.rank = env_int("HOROVOD_RANK", c.rank)
        c.size = env_int("HOROVOD_SIZE", c.size)
        c.hierarchical_allreduce = env_bool(
            "HOROVOD_HIERARCHICAL_ALLREDUCE", c.hierarchical_allreduce)
        c.hierarchical_allgather = env_bool(
            "HOROVOD_HIERARCHICAL_ALLGATHER", c.hierarchical_allgather)
        c.hier_controller = env_bool(
            "HOROVOD_TPU_HIER_CONTROLLER", c.hier_controller)
        c.xla_broadcast = env_str("HOROVOD_XLA_BCAST",
                                  c.xla_broadcast).lower()
        c.heartbeat_interval_s = env_float(
            "HOROVOD_HEARTBEAT_INTERVAL", c.heartbeat_interval_s)
        c.heartbeat_timeout_s = env_float(
            "HOROVOD_HEARTBEAT_TIMEOUT", c.heartbeat_timeout_s)
        c.trace_path = os.environ.get("HOROVOD_TPU_TRACE", "")
        c.trace_interval_s = env_float("HOROVOD_TPU_TRACE_INTERVAL",
                                       c.trace_interval_s)
        c.metrics_enabled = env_bool("HOROVOD_TPU_METRICS",
                                     c.metrics_enabled)
        c.metrics_interval_s = env_float("HOROVOD_TPU_METRICS_INTERVAL",
                                         c.metrics_interval_s)
        c.metrics_port = env_int("HOROVOD_TPU_METRICS_PORT", c.metrics_port)
        c.metrics_addr = os.environ.get("HOROVOD_TPU_METRICS_ADDR",
                                        c.metrics_addr)
        c.metrics_log = os.environ.get("HOROVOD_TPU_METRICS_LOG",
                                       c.metrics_log)
        c.autotune = env_bool("HOROVOD_AUTOTUNE", c.autotune)
        c.autotune_log = os.environ.get("HOROVOD_AUTOTUNE_LOG", "")
        c.autotune_warmup_samples = env_int(
            "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", c.autotune_warmup_samples)
        c.autotune_steps_per_sample = env_int(
            "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", c.autotune_steps_per_sample)
        c.autotune_bayes_opt_max_samples = env_int(
            "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
            c.autotune_bayes_opt_max_samples)
        c.autotune_gaussian_process_noise = env_float(
            "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE",
            c.autotune_gaussian_process_noise)
        c.compression = os.environ.get("HOROVOD_COMPRESSION",
                                       c.compression).lower()
        # A typo must not run uncompressed: wire_code_of raises naming
        # the variable.
        from horovod_tpu_torch.common import wire_dtype as _wd
        _wd.wire_code_of(c.compression)
        if c.xla_broadcast not in ("psum", "tree"):
            # A typo must not pick a rendering silently.
            raise ValueError(f"HOROVOD_XLA_BCAST={c.xla_broadcast!r}: "
                             f"must be 'psum' or 'tree'")
        return c
