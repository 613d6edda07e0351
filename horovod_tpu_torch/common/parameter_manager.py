"""Autotune: steer the fusion threshold and the cycle time, and pick a
wire plan per size bucket, for throughput.

Counterpart of ``horovod_tpu/common/parameter_manager.py`` (after
Horovod's ``parameter_manager.{h,cc}``): joint Bayesian optimization of
the fusion threshold in [0, 64] MB and the cycle time in [1, 100] ms,
scored in bytes per microsecond over samples of ``steps_per_sample``
cycles, the median of three samples at a time, after a warm-up whose
samples are discarded. Rank 0 tunes; the tuned values reach the other
ranks in the ResponseList's trailer, which every rank receives every
cycle (``apply_synced``).

Before the Bayesian phase, a discrete grid measures every (algorithm,
wire-dtype cap) combination in each size bucket (``_BucketTuner``), then
the overlap tier's bucket counts (``_OverlapTuner``). Each move of the
plan under test bumps ``plan_revision``, on which the runtime evicts
the cached allreduce verdicts world-wide so that the tensors renegotiate
under the new plan.

On the socket star the grid offers wire dtypes only: ``ALG_DEFAULT`` is
the one algorithm the star has (``wire_dtype.StaticWirePolicy``), so the
runtime passes ``ring_allowed``, ``multi_host``/``shm_enabled`` and
``ici_allowed`` as False until the ring and two-level planes
(``ROADMAP.md`` A6.4) and ``IciPlane`` (A6.5) exist, and arms
``configure_overlap`` with False until the overlap tier (A9) does.

``HOROVOD_AUTOTUNE=1`` turns it on; ``HOROVOD_AUTOTUNE_LOG`` names a CSV
of the Bayesian samples, written by rank 0.
"""

from __future__ import annotations

import time

import numpy as np

from horovod_tpu_torch.common import logging as hlog
from horovod_tpu_torch.common import wire_dtype as _wd
from horovod_tpu_torch.optim.bayesian_optimization import BayesianOptimization

_MB = 1024 * 1024

# Size buckets of the per-bucket (algorithm, wire dtype) table, by the
# fused batch's uncompressed bytes: small latency-bound batches, the
# middle, and large bandwidth-bound ones.
BUCKET_BOUNDS = (64 * 1024, 1 << 20)


def bucket_of(nbytes: int) -> int:
    for i, bound in enumerate(BUCKET_BOUNDS):
        if nbytes < bound:
            return i
    return len(BUCKET_BOUNDS)


def describe_plan(plan) -> str:
    """A per-bucket table as "b0=default/- b1=default/bf16 ...", "-"
    being no cap."""
    return " ".join(
        f"b{i}={_wd.ALG_NAMES[a]}/"
        + ("-" if w is None else _wd.WIRE_NAMES[w])
        for i, (a, w) in enumerate(plan))


class _BucketTuner:
    """A measured sweep over (ALG_*, WIRE_* cap) combinations, one size
    bucket at a time. The grids are small and categorical, so measuring
    every point and keeping the argmax is the whole policy.

    A bucket with no traffic for two sample windows in a row keeps the
    default plan, so that an idle bucket never stalls convergence. Each
    combination is measured in two interleaved passes and scored by the
    maximum of its samples: a host's throttle bursts only ever lower a
    throughput sample, so the upper envelope is the robust comparator."""

    _IDLE_LIMIT = 2
    _PASSES = 2

    def __init__(self, combos, nbuckets: int):
        self._combos = list(combos)
        self._nbuckets = nbuckets
        self._bucket = 0
        self._ci = 0
        self._pass = 0
        self._scores = {}  # (bucket, combo index) -> max sample score
        self._idle = 0
        self.done = nbuckets == 0 or len(self._combos) < 2
        self.plan = [(_wd.ALG_DEFAULT, None)] * nbuckets
        # Bumped on every move of the combination under test (an
        # advance, a bucket change, the settle): the coordinator watches
        # it and evicts the verdicts cached under the previous plan.
        self.revision = 0

    @property
    def bucket(self) -> int:
        return self._bucket

    def current_combo(self):
        return self._combos[self._ci]

    def feed(self, score: float, bucket_traffic: int,
             total_traffic: int = -1) -> None:
        """One median-of-3 sample taken under the current combination.
        ``bucket_traffic`` is the bytes the bucket under test moved in
        the window (0: the sample says nothing about the combination);
        ``total_traffic``, over every bucket, tells an idle bucket (a
        strike toward skipping it) from a lull of the whole job (an
        evaluation phase, a stalled loader: no strike)."""
        if self.done:
            return
        if bucket_traffic <= 0:
            if total_traffic == 0:
                return
            self._idle += 1
            if self._idle >= self._IDLE_LIMIT:
                self._next_bucket(keep_default=True)
            return
        self._idle = 0
        key = (self._bucket, self._ci)
        self._scores[key] = max(score, self._scores.get(key, float("-inf")))
        self._ci += 1
        self.revision += 1
        if self._ci >= len(self._combos):
            self._ci = 0
            self._pass += 1
            if self._pass >= self._PASSES:
                self._next_bucket(keep_default=False)

    def _next_bucket(self, keep_default: bool) -> None:
        self.revision += 1
        if not keep_default:
            best = max(range(len(self._combos)),
                       key=lambda i: self._scores.get(
                           (self._bucket, i), float("-inf")))
            self.plan[self._bucket] = self._combos[best]
        self._bucket += 1
        self._ci = 0
        self._pass = 0
        self._idle = 0
        if self._bucket >= self._nbuckets:
            self.done = True

    def describe(self) -> str:
        return describe_plan(self.plan)


class _OverlapTuner:
    """A measured sweep over the overlap tier's bucket counts, after the
    wire sweep and before the Bayesian phase, by the same protocol as
    ``_BucketTuner``: two interleaved passes, each candidate scored by
    the maximum of its samples, the argmax wins."""

    _PASSES = 2

    def __init__(self, candidates):
        self._candidates = list(candidates)
        self._ci = 0
        self._pass = 0
        self._scores = [float("-inf")] * len(self._candidates)
        self.done = len(self._candidates) < 2
        self.choice = self._candidates[0] if self._candidates else 0

    def current(self) -> int:
        return self._candidates[self._ci]

    def feed(self, score: float, traffic: int) -> None:
        if self.done or traffic <= 0:
            return  # a lull says nothing about the candidate
        self._scores[self._ci] = max(score, self._scores[self._ci])
        self._ci += 1
        if self._ci >= len(self._candidates):
            self._ci = 0
            self._pass += 1
            if self._pass >= self._PASSES:
                best = max(range(len(self._candidates)),
                           key=lambda i: self._scores[i])
                self.choice = self._candidates[best]
                self.done = True


class ParameterManager:
    def __init__(self, config, controller):
        self._is_coordinator = controller.rank == 0
        self._warmup_remaining = config.autotune_warmup_samples
        self._steps_per_sample = config.autotune_steps_per_sample
        self._max_samples = config.autotune_bayes_opt_max_samples
        self._bo = BayesianOptimization(
            bounds=[(0.0, 64.0), (1.0, 100.0)],  # MB, ms
            alpha=config.autotune_gaussian_process_noise)
        self._log_path = config.autotune_log
        if self._log_path and self._is_coordinator:
            with open(self._log_path, "w") as f:
                f.write("sample,fusion_threshold_mb,cycle_time_ms,"
                        "score_bytes_per_us\n")
        self._current = np.asarray(
            [config.fusion_threshold_bytes / _MB, config.cycle_time_ms])
        self._tuning = self._is_coordinator
        self._samples_taken = 0
        # The per-bucket (algorithm, wire cap) table the coordinator
        # stamps fused responses with (Runtime._stamp_wire_plan): all
        # default until the grid phase (configure_wire) settles it, and
        # on workers, which never stamp.
        nb = len(BUCKET_BOUNDS) + 1
        self._bucket_plan = [(_wd.ALG_DEFAULT, None)] * nb
        self._bucket_tuner = None
        # The overlap bucket-count grid (configure_overlap): None until
        # armed; workers adopt the coordinator's value from the trailer.
        self._overlap_tuner = None
        self._overlap_current = None
        self._bucket_bytes = [0] * nb
        self._bucket_mark = [0] * nb
        # The sample being accumulated.
        self._cycle_count = 0
        self._bytes_acc = 0
        self._t0 = time.monotonic()
        # The samples of the current median of three.
        self._scores = []

    # -- the wire plan (algorithm x dtype per size bucket) ---------------
    def configure_wire(self, proposed_wire: int, multi_host: bool,
                       world_size: int, shm_enabled: bool = True,
                       ring_allowed: bool = True,
                       ici_allowed: bool = False) -> None:
        """Arm the discrete grid phase (coordinator only). The algorithm
        candidates follow what the world can run (ring: 3 ranks or more
        and not switched off; two-level: several hosts with the shm
        plane; ICI: the world-agreed mesh plane); the wire candidates
        are every dtype at or below this world's proposal, since the
        tuner explores by capping the negotiated verdict and so never
        compresses harder than the operator asked. On the star the
        runtime passes False for every algorithm but the default (see
        the module's docstring)."""
        if not self._is_coordinator or not self._tuning:
            return
        algs = [_wd.ALG_DEFAULT]
        if world_size >= 3 and ring_allowed:
            algs.append(_wd.ALG_RING)
        if multi_host and shm_enabled:
            algs.append(_wd.ALG_TWOLEVEL)
        if ici_allowed:
            algs.append(_wd.ALG_ICI)
        wires = [w for w in (_wd.WIRE_NONE, _wd.WIRE_BF16,
                             _wd.WIRE_FP16, _wd.WIRE_INT8)
                 if w <= proposed_wire]
        combos = [(a, w) for a in algs for w in wires]
        if len(combos) > 1:
            self._bucket_tuner = _BucketTuner(combos, len(BUCKET_BOUNDS) + 1)

    def configure_overlap(self, armed: bool) -> None:
        """Add the overlap bucket count (0 off, 2, 4, 8) to the discrete
        grid, measured after the wire sweep settles (coordinator only,
        and only where the overlap tier can engage)."""
        if not armed or not self._is_coordinator or not self._tuning:
            return
        self._overlap_tuner = _OverlapTuner([0, 2, 4, 8])

    def overlap_buckets(self):
        """The bucket count the overlap tier should use now, or None when
        the grid never armed. Coordinator: the candidate under
        measurement, then the settled argmax; workers: the value adopted
        from the trailer."""
        t = self._overlap_tuner
        if t is not None:
            if t.done:
                return t.choice
            # Measured only once the wire sweep settled: both grids
            # share the score stream.
            wt = self._bucket_tuner
            if wt is None or wt.done:
                return t.current()
            return None
        return self._overlap_current

    @property
    def tuned_overlap_buckets(self) -> int:
        """The trailer's value: the active or settled count, or -1 (no
        verdict) while the grid is unarmed."""
        v = self.overlap_buckets() if self._is_coordinator else None
        return -1 if v is None else int(v)

    def plan(self, nbytes: int):
        """(ALG_* code, wire cap or None) for one fused batch of
        ``nbytes`` uncompressed bytes: the coordinator's stamping policy.
        While the grid runs, the bucket under test answers with the
        combination being measured, the buckets before it with their
        measured argmax (later buckets are scored in the regime the final
        plan deploys), and the rest with the settled table."""
        b = bucket_of(nbytes)
        self._bucket_bytes[b] += nbytes
        t = self._bucket_tuner
        if t is not None and not t.done:
            if b == t.bucket:
                return t.current_combo()
            if b < t.bucket:
                return t.plan[b]
        return self._bucket_plan[b]

    def bucket_plan(self):
        """The settled per-bucket (algorithm, wire cap) table."""
        return list(self._bucket_plan)

    @property
    def plan_revision(self) -> int:
        """A counter of the moves of the plan under test (combination
        advances and the final convergence), on which the coordinator
        evicts the verdicts cached under a superseded plan."""
        rev = self._bucket_tuner.revision \
            if self._bucket_tuner is not None else 0
        # +1 at convergence: that last eviction moves the cache's epoch,
        # which clears the speculative denials, so the fused speculative
        # cycle engages again for the tuned steady state.
        return rev + (0 if self._tuning else 1)

    @property
    def spec_safe(self) -> bool:
        """May the fused speculative cycle run? Yes on workers, through
        the grid phases (a combination is scored in the regime it would
        deploy, speculative cycle included) and after convergence; no
        only while the Bayesian phase steers the fusion threshold and
        the cycle time through the full responses' trailers, which
        speculative cycles would starve."""
        if not self._is_coordinator or not self._tuning:
            return True
        t = self._bucket_tuner
        if t is not None and not t.done:
            return True
        ot = self._overlap_tuner
        return ot is not None and not ot.done

    # -- the values the runtime reads ------------------------------------
    @property
    def tuning(self) -> bool:
        """True while rank 0's optimizer explores; False once it has
        converged, and on workers, which never tune."""
        return self._tuning

    def status_line(self) -> str:
        """The stall report's autotune part: the phase, the settled
        table, the plan revision and the values in effect."""
        t = self._bucket_tuner
        phase = ("settled" if not self._tuning
                 else "wire grid" if t is not None and not t.done
                 else "bayes")
        return (f"autotune {phase}: plan {describe_plan(self._bucket_plan)}"
                f" (revision {self.plan_revision}), fusion threshold "
                f"{self._current[0]:.3f} MB, cycle time "
                f"{self._current[1]:.3f} ms")

    def fusion_threshold_bytes(self) -> int:
        return int(self._current[0] * _MB)

    def cycle_time_ms(self) -> float:
        return float(self._current[1])

    def apply_synced(self, fusion_threshold_bytes: int,
                     cycle_time_ms: float,
                     overlap_buckets: int = -1) -> None:
        """Workers adopt rank 0's tuned values from the trailer. A cycle
        time of 0 marks a trailer without tuned values (a tuned cycle
        time is at least 1 ms, while a fusion threshold of 0 is a
        tuned value: fusion off); an overlap count of -1 marks none (0
        is a verdict: off)."""
        if not self._is_coordinator and cycle_time_ms > 0:
            self._current = np.asarray(
                [fusion_threshold_bytes / _MB, cycle_time_ms])
        if not self._is_coordinator and overlap_buckets >= 0:
            self._overlap_current = overlap_buckets

    # -- sampling --------------------------------------------------------
    def on_cycle(self, nbytes: int) -> None:
        """Called by the background loop once per cycle with the bytes
        it processed."""
        if not self._tuning:
            return
        self._bytes_acc += nbytes
        self._cycle_count += 1
        if self._cycle_count < self._steps_per_sample:
            return
        elapsed_us = (time.monotonic() - self._t0) * 1e6
        score = self._bytes_acc / max(elapsed_us, 1.0)
        self._cycle_count = 0
        self._bytes_acc = 0
        self._t0 = time.monotonic()

        if self._warmup_remaining > 0:
            self._warmup_remaining -= 1
            return

        self._scores.append(score)
        if len(self._scores) < 3:
            return
        sample_score = float(np.median(self._scores))
        self._scores = []

        # Phase 1, the wire grid: medians go to the bucket tuner until
        # every combination of every bucket with traffic was measured.
        t = self._bucket_tuner
        if t is not None and not t.done:
            b = t.bucket
            traffic = self._bucket_bytes[b] - self._bucket_mark[b]
            total = sum(self._bucket_bytes) - sum(self._bucket_mark)
            self._bucket_mark = list(self._bucket_bytes)
            t.feed(sample_score, traffic, total)
            if t.done:
                self._bucket_plan = list(t.plan)
                hlog.info("autotune wire plan settled: " + t.describe())
            return

        # Phase 2, the overlap grid, scored by the traffic of every
        # bucket (bucketing reshapes every allreduce).
        ot = self._overlap_tuner
        if ot is not None and not ot.done:
            total = sum(self._bucket_bytes) - sum(self._bucket_mark)
            self._bucket_mark = list(self._bucket_bytes)
            ot.feed(sample_score, total)
            if ot.done:
                hlog.info(f"autotune overlap bucket count settled: "
                          f"{ot.choice}")
            return

        # Phase 3, Bayesian optimization of (fusion threshold, cycle time).
        self._samples_taken += 1
        self._bo.add_sample(self._current.copy(), sample_score)
        if self._log_path:
            with open(self._log_path, "a") as f:
                f.write(f"{self._samples_taken},{self._current[0]:.3f},"
                        f"{self._current[1]:.3f},{sample_score:.6f}\n")
        if self._samples_taken >= self._max_samples:
            best, best_score = self._bo.best()
            if best is not None:
                self._current = np.asarray(best)
            self._tuning = False
            hlog.info(
                f"autotune converged: fusion_threshold="
                f"{self._current[0]:.1f} MB cycle_time="
                f"{self._current[1]:.1f} ms (score {best_score:.3f} B/µs)")
            return
        self._current = np.clip(self._bo.next_sample(),
                                [0.0, 1.0], [64.0, 100.0])
