"""Bayesian optimization over a box, the autotuner's search.

Counterpart of ``horovod_tpu/optim/bayesian_optimization.py`` (after
Horovod's ``optim/bayesian_optimization.{h,cc}``): the GP surrogate and
Expected Improvement, maximized by a random sweep of 2048 candidates
whose best five seed L-BFGS-B (scipy); without scipy the sweep's best
stands. The sweep draws from ``np.random.RandomState(seed)`` in the
reference's order, so that the same seed and samples give the same
``next_sample`` sequence, bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from horovod_tpu_torch.optim.gaussian_process import GaussianProcessRegressor


class BayesianOptimization:
    def __init__(self, bounds: List[Tuple[float, float]],
                 alpha: float = 1e-8, xi: float = 0.01, seed: int = 0):
        """``bounds``: [(lo, hi)] per dimension."""
        self.bounds = np.asarray(bounds, np.float64)
        self.dim = len(bounds)
        self.xi = xi
        self._gp = GaussianProcessRegressor(alpha=alpha)
        self._xs: List[np.ndarray] = []
        self._ys: List[float] = []
        self._rng = np.random.RandomState(seed)

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return (x - lo) / np.maximum(hi - lo, 1e-12)

    def _denormalize(self, z: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds[:, 0], self.bounds[:, 1]
        return lo + z * (hi - lo)

    def add_sample(self, x, y: float) -> None:
        self._xs.append(self._normalize(np.asarray(x, np.float64)))
        self._ys.append(float(y))

    def _expected_improvement(self, z: np.ndarray) -> np.ndarray:
        """EI over the best sample so far, at normalized points ``z``."""
        mean, std = self._gp.predict(z)
        best = max(self._ys)
        imp = mean - best - self.xi
        zed = np.where(std > 0, imp / std, 0.0)
        # The standard normal's pdf and cdf without scipy.
        pdf = np.exp(-0.5 * zed ** 2) / np.sqrt(2 * np.pi)
        cdf = 0.5 * (1.0 + _erf(zed / np.sqrt(2.0)))
        ei = imp * cdf + std * pdf
        return np.where(std > 0, ei, 0.0)

    def next_sample(self) -> np.ndarray:
        """Fit the GP and return the point that maximizes EI (a uniform
        draw before the first sample)."""
        if not self._xs:
            return self._denormalize(self._rng.uniform(size=self.dim))
        self._gp.fit(np.stack(self._xs), np.asarray(self._ys))
        cand = self._rng.uniform(size=(2048, self.dim))
        ei = self._expected_improvement(cand)
        best_z = cand[int(np.argmax(ei))]
        best_ei = float(ei[int(np.argmax(ei))])
        refined, refined_ei = self._maximize_ei(cand, ei)
        if refined is not None and refined_ei >= best_ei:
            best_z = refined
        return self._denormalize(best_z)

    def _maximize_ei(self, cand: np.ndarray, ei: np.ndarray,
                     n_starts: int = 5):
        """L-BFGS-B from the ``n_starts`` best candidates: (the best
        point in normalized coordinates, its EI), or (None, -inf)
        without scipy."""
        try:
            from scipy.optimize import minimize
        except ImportError:
            return None, float("-inf")

        def neg_ei(z):
            return -float(self._expected_improvement(
                np.clip(z, 0.0, 1.0)[None, :])[0])

        starts = cand[np.argsort(ei)[-n_starts:]]
        best, best_v = None, float("-inf")
        for s in starts:
            try:
                res = minimize(neg_ei, s, method="L-BFGS-B",
                               bounds=[(0.0, 1.0)] * self.dim)
            except (ValueError, ArithmeticError, np.linalg.LinAlgError):
                continue
            v = -float(res.fun)
            if np.isfinite(v) and v > best_v:
                best, best_v = np.clip(np.asarray(res.x), 0.0, 1.0), v
        return best, best_v

    def best(self) -> Tuple[Optional[np.ndarray], float]:
        """(the best sample's point, its score), or (None, -inf)."""
        if not self._ys:
            return None, float("-inf")
        i = int(np.argmax(self._ys))
        return self._denormalize(self._xs[i]), self._ys[i]


def _erf(x: np.ndarray) -> np.ndarray:
    """Vectorized erf (Abramowitz and Stegun 7.1.26, |err| < 1.5e-7)."""
    sign = np.sign(x)
    x = np.abs(x)
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    t = 1.0 / (1.0 + p * x)
    y = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t \
        * np.exp(-x * x)
    return sign * y
