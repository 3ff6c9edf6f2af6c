"""Numerical-derivative oracles, the port's copy of
``mini_opt_tpu/utils/numerical.py`` (numpy only).

Analog of ``math::NumericalJacobian`` from the C++ reference's
geometry_utils (used in its test/nonlinear_test.cc:21-39): the pattern of
checking every hand-written Jacobian against central differences.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def numerical_jacobian(
    f: Callable[[np.ndarray], np.ndarray], x: np.ndarray, h: float = 1e-6
) -> np.ndarray:
    """Central-difference Jacobian of f at x. Returns shape (len(f(x)), len(x))."""
    x = np.asarray(x, dtype=np.float64)
    f0 = np.atleast_1d(np.asarray(f(x), dtype=np.float64))
    J = np.zeros((f0.size, x.size))
    for i in range(x.size):
        dx = np.zeros_like(x)
        dx[i] = h
        fp = np.atleast_1d(np.asarray(f(x + dx), dtype=np.float64)).ravel()
        fm = np.atleast_1d(np.asarray(f(x - dx), dtype=np.float64)).ravel()
        J[:, i] = (fp - fm) / (2.0 * h)
    return J


def numerical_derivative(
    f: Callable[[float], np.ndarray], x: float, h: float = 1e-6
) -> np.ndarray:
    """Central-difference derivative of a scalar-argument function."""
    fp = np.asarray(f(x + h), dtype=np.float64)
    fm = np.asarray(f(x - h), dtype=np.float64)
    return (fp - fm) / (2.0 * h)
