"""ctypes bindings of the native CPU runtime (``native/mini_opt_native.cpp``),
the port's own copy of ``mini_opt_tpu/native.py``.

This module is the CPU baseline by definition: it runs on the host's CPU
whatever device the rest of the port uses, takes and returns numpy arrays,
and imports no torch. On first use it builds the C++ source with ``g++``
(-O3, no other dependency) into ``build/native/`` at the repository root,
and rebuilds when the source is newer than the library; nothing is written
next to the source.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
_SRC = _ROOT / "native" / "mini_opt_native.cpp"
_SO = _ROOT / "build" / "native" / "libmini_opt_native.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> Path:
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        partial = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", str(_SRC), "-o", str(partial)],
            check=True,
            capture_output=True,
        )
        os.replace(partial, _SO)  # atomic: a concurrent loader sees all or nothing
    return _SO


def load() -> ctypes.CDLL:
    """The bound library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            dp = ctypes.POINTER(ctypes.c_double)
            ip = ctypes.POINTER(ctypes.c_int)
            lib.miniopt_native_ik_solve_batch.restype = ctypes.c_int
            lib.miniopt_native_ik_solve_batch.argtypes = [
                dp, dp, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_int, ctypes.c_int, dp, ip, ip,
            ]
            lib.miniopt_native_ldlt_us.restype = ctypes.c_double
            lib.miniopt_native_ldlt_us.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.miniopt_native_planar_fk.restype = None
            lib.miniopt_native_planar_fk.argtypes = [ctypes.c_int, ctypes.c_double, dp, dp, dp]
            _lib = lib
        return _lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def ik_solve_batch(
    targets: np.ndarray,
    x0: np.ndarray,
    link_len: float = 0.4,
    max_iters: int = 50,
    max_qp_iters: int = 10,
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Solve B planar IK instances natively, one after another on one core.
    Returns (x, termination_codes, num_converged, total_inner_iterations)."""
    lib = load()
    targets = np.ascontiguousarray(targets, np.float64)
    x0 = np.ascontiguousarray(x0, np.float64)
    B, n = x0.shape
    x_out = np.empty_like(x0)
    term = np.empty(B, np.int32)
    inner = ctypes.c_int(0)
    ok = lib.miniopt_native_ik_solve_batch(
        _dp(targets), _dp(x0), B, n, link_len, max_iters, max_qp_iters,
        _dp(x_out), term.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), ctypes.byref(inner),
    )
    return x_out, term, int(ok), int(inner.value)


def ldlt_us(n: int, reps: int = 20000) -> float:
    """Microseconds per condensed-KKT LDL^T factor + solve on one CPU core."""
    return float(load().miniopt_native_ldlt_us(n, reps))


def planar_fk(theta: np.ndarray, link_len: float = 0.4):
    """Effector (2,) and its Jacobian (2, n) of the planar chain at joint
    angles ``theta (n,)``."""
    lib = load()
    theta = np.ascontiguousarray(theta, np.float64)
    n = theta.shape[0]
    xy = np.empty(2, np.float64)
    J = np.empty((2, n), np.float64)
    lib.miniopt_native_planar_fk(n, link_len, _dp(theta), _dp(xy), _dp(J))
    return xy, J
