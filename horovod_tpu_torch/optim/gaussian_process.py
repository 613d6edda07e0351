"""Gaussian-process regression, the autotuner's surrogate.

Counterpart of ``horovod_tpu/optim/gaussian_process.py`` (after
Horovod's ``optim/gaussian_process.{h,cc}``, which uses Eigen): an RBF
kernel, a jittered Cholesky solve, the predictive mean and standard
deviation, in numpy with the reference's operations in its order, so
that the same points give the same bits.
"""

from __future__ import annotations

import numpy as np


class GaussianProcessRegressor:
    """RBF-kernel GP with observation noise ``alpha``."""

    def __init__(self, alpha: float = 1e-8, length_scale: float = 1.0,
                 signal_variance: float = 1.0):
        self.alpha = alpha
        self.length_scale = length_scale
        self.signal_variance = signal_variance
        self._x = None
        self._y = None
        self._l = None  # the Cholesky factor
        self._alpha_vec = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """The squared-exponential kernel between the rows of a and b."""
        d2 = (np.sum(a ** 2, axis=1)[:, None]
              + np.sum(b ** 2, axis=1)[None, :]
              - 2.0 * a @ b.T)
        return self.signal_variance * np.exp(-0.5 * np.maximum(d2, 0.0)
                                             / self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.asarray(y, np.float64).reshape(-1)
        k = self._kernel(x, x)
        k[np.diag_indices_from(k)] += self.alpha
        # A kernel that is not numerically positive definite gets a
        # growing jitter on its diagonal.
        jitter = 0.0
        for _ in range(6):
            try:
                self._l = np.linalg.cholesky(k + jitter * np.eye(len(k)))
                break
            except np.linalg.LinAlgError:
                jitter = max(jitter * 10.0, 1e-10)
        else:
            raise np.linalg.LinAlgError("GP kernel not PD")
        self._x = x
        self._y = y
        z = np.linalg.solve(self._l, y)
        self._alpha_vec = np.linalg.solve(self._l.T, z)

    def predict(self, x: np.ndarray):
        """(mean, std) at the query points; the prior before a fit."""
        x = np.atleast_2d(np.asarray(x, np.float64))
        if self._x is None:
            return (np.zeros(len(x)),
                    np.sqrt(self.signal_variance) * np.ones(len(x)))
        ks = self._kernel(x, self._x)
        mean = ks @ self._alpha_vec
        v = np.linalg.solve(self._l, ks.T)
        var = (self.signal_variance + self.alpha
               - np.sum(v ** 2, axis=0))
        return mean, np.sqrt(np.maximum(var, 1e-12))
