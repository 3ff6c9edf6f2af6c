"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper), and the objects are linked into one
shared library with a plain C interface. The library lands in
``build/kernels/`` at the repository root, named by a hash of the sources and
flags, so an unchanged tree loads the library it already built. A failed
build raises with nvcc's stderr; nothing falls back to another path.

No kernel is built at import: the CPU tests import every module, and this
host may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# No --use_fast_math: sin/cos/sqrt/div stay full precision. --fmad=false
# keeps a*b+c as two rounded operations, as the plain PyTorch version
# computes it, so the kernel reproduces that version bit for bit.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None


def nvcc_path():
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
        "kernels are built only on a machine with the CUDA toolkit"
    )


def _cu_sources():
    cu = sorted(CSRC.glob("*.cu"))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return cu


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _cu_sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmini_opt_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds):
    """Run the commands in parallel; raise with the stderr of the first that
    fails, after every process has ended."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for c in cmds
    ]
    outs = [p.communicate() for p in procs]
    for c, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {p.returncode}): {' '.join(c)}\n{err}"
            )
    return outs


def build():
    """Compile ``csrc/*.cu`` into the hashed shared library unless it is
    already there; return its path. ptxas's report (registers, spills per
    kernel instance) is kept beside it in a ``.log`` file."""
    target = library_path()
    if target.exists():
        return target
    nvcc = nvcc_path()
    cu = _cu_sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, p.stem + ".o") for p in cu]
        outs = _run_all(
            [
                [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(p), "-o", o]
                for p, o in zip(cu, objs)
            ]
        )
        target.with_suffix(".log").write_text("".join(err for _, err in outs))
        partial = os.path.join(tmp, target.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", partial]])
        os.replace(partial, target)  # atomic: a concurrent loader sees all or nothing
    return target


def load_library():
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.mo_fused_ik_launch.argtypes = [
                i, i, i,  # family, n, dtype
                p, p, p, p, p,  # data, x0, x_out, state, history (or NULL)
                i, i, i, i,  # B, max_iterations, qp_iterations, ls_iterations
                i, i,  # polynomial line search, Mehrotra barrier
                ctypes.c_double,  # link length
                p,  # cudaStream_t
            ]
            lib.mo_fused_ik_launch.restype = i
            lib.mo_blocked_launch.argtypes = [
                i, i, i,  # family, n, dtype
                p, p, p, p,  # data, x0, x_out, state
                i, i, i, i,  # B, max_iterations, qp_iterations, ls_iterations
                i, i,  # polynomial line search, Mehrotra barrier
                ctypes.c_double,  # link length
                p,  # cudaStream_t
            ]
            lib.mo_blocked_launch.restype = i
            lib.mo_blocked_kkt_launch.argtypes = [
                i, i,  # dtype, D
                p, p, p,  # H, rhs, x
                i,  # B
                p,  # cudaStream_t
            ]
            lib.mo_blocked_kkt_launch.restype = i
            lib.mo_ldlt_factor_launch.argtypes = [
                i, i,  # dtype, D
                p, p, p,  # H, L, d
                i,  # B
                p,  # cudaStream_t
            ]
            lib.mo_ldlt_factor_launch.restype = i
            lib.mo_ldlt_solve_launch.argtypes = [
                i, i,  # dtype, D
                p, p, p, p,  # L, d, rhs, x
                i,  # B
                p,  # cudaStream_t
            ]
            lib.mo_ldlt_solve_launch.restype = i
            lib.mo_fused_qp_launch.argtypes = [
                i, i, i, i,  # dtype, N, K, M
                ctypes.POINTER(i),  # the M box rows' variables
                p, p, p, p, p, p,  # G, c, A_eq, b_eq, ia, ib
                p, p,  # x, y
                i, i,  # B, iterations
                ctypes.c_double,  # sigma
                i, i,  # Mehrotra barrier, equality-constrained initial guess
                p,  # cudaStream_t
            ]
            lib.mo_fused_qp_launch.restype = i
            lib.mo_pose_ring_scratch_slots.argtypes = [i, i]  # n poses, closures
            lib.mo_pose_ring_scratch_slots.restype = i
            lib.mo_pose_ring_launch.argtypes = [
                i, i, i,  # dtype, n poses, closures
                ctypes.POINTER(i),  # the closures' (from, to) pairs
                ctypes.c_double,  # anchor weight
                p, p, p, p, p,  # data, x0, x_out, state, scratch
                i, i, i,  # B, max_iterations, ls_iterations
                p,  # cudaStream_t
            ]
            lib.mo_pose_ring_launch.restype = i
            lib.mo_cuda_error_string.argtypes = [i]
            lib.mo_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(rc):
    """Text of a launcher's non-zero return code."""
    return f"error {rc}: {load_library().mo_cuda_error_string(rc).decode()}"
