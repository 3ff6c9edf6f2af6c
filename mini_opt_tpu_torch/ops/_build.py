"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper), and the objects are linked into one
shared library with a plain C interface. The library lands in
``build/kernels/`` at the repository root, named by a hash of the sources and
flags, so an unchanged tree loads the library it already built. A family
generated from a Problem gets a library of its own, from the source that
``ops/fused_emit.py`` emits for it, with the same flags
(``load_generated``), and so does each hand-written instance of kernel 1
(``csrc/fused_ik.cu`` at one family, chain length and type:
``load_fused_ik``), so that a process builds only the sizes it launches. A
failed build raises with nvcc's stderr; nothing falls back to another path.

No kernel is built at import: the CPU tests import every module, and this
host may have no ``nvcc``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
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


# Built once per instance (build_fused_ik), never into the main library.
INSTANCE_SOURCES = ("fused_ik.cu",)


def _cu_sources():
    cu = sorted(p for p in CSRC.glob("*.cu") if p.name not in INSTANCE_SOURCES)
    if not cu:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return cu


def _flags():
    """NVCC_FLAGS and the sizes the kernels take from the Python side: the
    register route's largest D of csrc/ldlt.cu (ops/ldlt.py) and kernel 6's
    register caps (ops/fused_qp.py)."""
    from . import fused_qp, ldlt

    return (
        *NVCC_FLAGS,
        f"-DMO_LDLT_REGISTER_MAX_D={ldlt.REGISTER_MAX_D}",
        *(f"-DMO_QP_REGISTER_MAX_N_K{k}={n}" for k, n in enumerate(fused_qp.REGISTER_MAX_N)),
    )


def library_path():
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(_flags()).encode())
    for p in _cu_sources() + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmini_opt_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds, timed=False, jobs=None):
    """Run the commands in parallel, at most ``jobs`` at a time (all at once
    by default); raise with the stderr of the first that fails, after every
    process has ended. Returns each one's (stdout, stderr), with ``timed``
    (stdout, stderr, seconds from its start to its end)."""

    def run(c):
        start = time.perf_counter()
        p = subprocess.run(c, capture_output=True, text=True)
        return p.returncode, p.stdout, p.stderr, time.perf_counter() - start

    with concurrent.futures.ThreadPoolExecutor(jobs or max(1, len(cmds))) as pool:
        done = list(pool.map(run, cmds))
    for c, (rc, _, err, _) in zip(cmds, done):
        if rc != 0:
            raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(c)}\n{err}")
    return [(out, err, s) if timed else (out, err) for _, out, err, s in done]


def build():
    """Compile ``csrc/*.cu`` into the hashed shared library unless it is
    already there; return its path. ptxas's report (registers, spills per
    kernel instance) is kept beside it in a ``.log`` file, each source's
    build seconds in a ``.seconds`` file."""
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
                [nvcc, *_flags(), "-Xptxas", "-v", "-c", str(p), "-o", o]
                for p, o in zip(cu, objs)
            ],
            timed=True,
        )
        target.with_suffix(".log").write_text("".join(err for _, err, _ in outs))
        target.with_suffix(".seconds").write_text(
            "".join(f"{p.name} {s:.2f}\n" for p, (_, _, s) in zip(cu, outs))
        )
        partial = os.path.join(tmp, target.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", partial]])
        os.replace(partial, target)  # atomic: a concurrent loader sees all or nothing
    return target


# An emitted source past this many characters builds with NVVM and ptxas at
# -O1. A planar IK family on the blocked target is one residual block over
# the whole chain: its source is 1.2 MB at n = 33 and 2.7 MB at n = 48, which
# nvcc at -O3 built in 421 s and not within 840 s; at -O1, 12 and 19 s (H100
# machine, PR 16). The arithmetic is the same IEEE operations either way
# (--fmad=false, IEEE division and square root are not optimization levels).
# Every other emitted family so far is under 160,000 characters.
LARGE_GENERATED = 500_000
LARGE_GENERATED_FLAGS = ("-Xcicc", "-O1", "-Xptxas", "-O1")


def _generated_flags(source):
    return NVCC_FLAGS + (LARGE_GENERATED_FLAGS if len(source) > LARGE_GENERATED else ())


def _generated_path(source):
    """Where the library of an emitted family source lives: named by a hash
    of the source, the flags and the csrc/ headers it includes."""
    h = hashlib.sha256(" ".join(_generated_flags(source)).encode())
    h.update(source.encode())
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libmini_opt_generated_{h.hexdigest()[:16]}.so"


def build_generated(sources):
    """Build every emitted family source (ops/fused_emit.py) that is not
    built yet, one nvcc process each, all started together; return their
    library paths. The source is kept beside its library as ``.cu`` and
    ptxas's report as ``.log``."""
    paths = [_generated_path(s) for s in sources]
    todo = {p: s for p, s in zip(paths, sources) if not p.exists()}
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cmds, parts = [], []
            for p, src in todo.items():
                cu = p.with_suffix(".cu")
                cu.write_text(src)
                partial = os.path.join(tmp, p.name)
                cmds.append([nvcc, *_generated_flags(src), "-I", str(CSRC), "-Xptxas", "-v", "-shared", str(cu),
                             "-o", partial])
                parts.append((p, partial))
            outs = _run_all(cmds)
            for (p, partial), (_, err) in zip(parts, outs):
                p.with_suffix(".log").write_text(err)
                os.replace(partial, p)
    return paths


_generated = {}


def load_generated(source):
    """The bound library of an emitted family source, built on first use:
    kernel 1's instance (``mo_generated_launch``) or kernel 2's
    (``mo_generated_blocked_launch``), whichever the library exports."""
    path = build_generated([source])[0]
    with _lock:
        if path not in _generated:
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            if hasattr(lib, "mo_generated_launch"):
                lib.mo_generated_launch.argtypes = [
                    i,  # dtype
                    p, p,  # data, x0
                    ctypes.POINTER(ctypes.c_longlong),  # their 4 strides
                    p, p, p,  # x_out, state, history (or NULL)
                    i, i, i, i,  # B, max_iterations, qp_iterations, ls_iterations
                    i, i,  # polynomial line search, Mehrotra barrier
                    p,  # cudaStream_t
                ]
                lib.mo_generated_launch.restype = i
            if hasattr(lib, "mo_generated_blocked_launch"):
                lib.mo_generated_blocked_launch.argtypes = [
                    i,  # dtype
                    p, p,  # data, x0
                    ctypes.POINTER(ctypes.c_longlong),  # their 4 strides
                    p, p,  # x_out, state
                    i, i,  # B, warps per CTA
                    i, i, i,  # max_iterations, qp_iterations, ls_iterations
                    i, i,  # polynomial line search, Mehrotra barrier
                    p, i, ctypes.c_longlong,  # global scratch (or NULL), its slabs, bytes a slab
                    p,  # cudaStream_t
                ]
                lib.mo_generated_blocked_launch.restype = i
                lib.mo_generated_blocked_occupancy.argtypes = [i, i, i]  # dtype, warps per CTA, global
                lib.mo_generated_blocked_occupancy.restype = i
            lib.mo_generated_error_string.argtypes = [i]
            lib.mo_generated_error_string.restype = ctypes.c_char_p
            _generated[path] = lib
        return _generated[path]


# Kernel 1's hand-written instances past this chain length build with
# LARGE_GENERATED_FLAGS: every D-loop of fused_sqp.cuh is unrolled, so the
# instance grows as n^3 (the LDL^T) and NVVM's time with it. At -O3 one
# instance took 12-15 s at n = 12, 17-22 s at 16, 40-51 s at 24 and more
# than 300 s at 31 (ptxas spilled from n = 9 on); at -O1 every n took
# 5-6 s (H100 machine, 8 cores, 8 builds at a time).
LARGE_FUSED_IK_N = 12


def fused_ik_flags(family: int, n: int, double: bool):
    """nvcc's flags for kernel 1's hand-written instance of ``family`` (0
    planar, 1 spatial) at chain length n in float or double: NVCC_FLAGS, the
    instance's defines and the chain lengths the port takes
    (``ops/fused_ik.py`` CUDA_MIN_N / CUDA_MAX_N, passed so that they have
    one home). Raises ValueError for a chain length without an instance."""
    from . import fused_ik

    if not fused_ik.CUDA_MIN_N <= n <= fused_ik.CUDA_MAX_N or family not in (0, 1):
        raise ValueError(
            f"csrc/fused_ik.cu has instances of families 0 and 1 at n = {fused_ik.CUDA_MIN_N}.."
            f"{fused_ik.CUDA_MAX_N}; got family {family}, n = {n}"
        )
    return (
        *NVCC_FLAGS,
        *(LARGE_GENERATED_FLAGS if n > LARGE_FUSED_IK_N else ()),
        f"-DMO_IK_FAMILY={family}", f"-DMO_IK_N={n}", f"-DMO_IK_DOUBLE={int(double)}",
        f"-DMO_FUSED_IK_MIN_N={fused_ik.CUDA_MIN_N}", f"-DMO_FUSED_IK_MAX_N={fused_ik.CUDA_MAX_N}",
    )


def fused_ik_path(family: int, n: int, double: bool):
    """Where the library of one kernel-1 instance lives: named by the
    instance and a hash of its flags, ``csrc/fused_ik.cu`` and the headers."""
    h = hashlib.sha256(" ".join(fused_ik_flags(family, n, double)).encode())
    for p in [CSRC / "fused_ik.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    tag = f"{('planar', 'spatial')[family]}{n}_{'f64' if double else 'f32'}"
    return BUILD_DIR / f"libmini_opt_fused_ik_{tag}_{h.hexdigest()[:16]}.so"


def build_fused_ik(instances, jobs=None):
    """Build every kernel-1 instance ``(family, n, double)`` of ``instances``
    that is not built yet, one nvcc process each, ``jobs`` at a time (the
    host's cores by default); return their library paths. ptxas's report is
    kept beside each library as ``.log``, the build's seconds as
    ``.seconds``."""
    instances = list(instances)
    paths = [fused_ik_path(*inst) for inst in instances]
    todo = {p: inst for p, inst in zip(paths, instances) if not p.exists()}
    if todo:
        nvcc = nvcc_path()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            cmds, parts = [], []
            for p, inst in todo.items():
                partial = os.path.join(tmp, p.name)
                cmds.append([nvcc, *fused_ik_flags(*inst), "-Xptxas", "-v", "-shared", str(CSRC / "fused_ik.cu"),
                             "-o", partial])
                parts.append((p, partial))
            outs = _run_all(cmds, timed=True, jobs=jobs or os.cpu_count())
            for (p, partial), (_, err, seconds) in zip(parts, outs):
                p.with_suffix(".log").write_text(err)
                p.with_suffix(".seconds").write_text(f"{seconds:.2f}\n")
                os.replace(partial, p)
    return paths


_fused_ik = {}


def load_fused_ik(family: int, n: int, double: bool):
    """The bound library of kernel 1's hand-written instance, built on first
    use (``mo_fused_ik_launch``, ``mo_fused_ik_error_string``). Kept by
    instance, so a call after the first reads and hashes no file."""
    key = (family, n, bool(double))
    lib = _fused_ik.get(key)
    if lib is not None:
        return lib
    path = build_fused_ik([key])[0]
    with _lock:
        if key not in _fused_ik:
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.mo_fused_ik_launch.argtypes = [
                p, p,  # data, x0
                ctypes.POINTER(ctypes.c_longlong),  # their 4 strides
                p, p, p,  # x_out, state, history (or NULL)
                i, i, i, i,  # B, max_iterations, qp_iterations, ls_iterations
                i, i,  # polynomial line search, Mehrotra barrier
                ctypes.c_double,  # link length
                p,  # cudaStream_t
            ]
            lib.mo_fused_ik_launch.restype = i
            lib.mo_fused_ik_error_string.argtypes = [i]
            lib.mo_fused_ik_error_string.restype = ctypes.c_char_p
            _fused_ik[key] = lib
        return _fused_ik[key]


def load_library():
    """The bound kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.mo_blocked_launch.argtypes = [
                i, i, i,  # family, n, dtype
                p, p,  # data, x0
                ctypes.POINTER(ctypes.c_longlong),  # their 4 strides
                p, p,  # x_out, state
                i, i,  # B, warps per CTA
                i, i, i,  # max_iterations, qp_iterations, ls_iterations
                i, i,  # polynomial line search, Mehrotra barrier
                p, i, ctypes.c_longlong,  # global scratch (or NULL), its slabs, bytes a slab
                ctypes.c_double,  # link length
                p,  # cudaStream_t
            ]
            lib.mo_blocked_launch.restype = i
            lib.mo_blocked_occupancy.argtypes = [i, i, i, i, i]  # family, n, dtype, warps, global
            lib.mo_blocked_occupancy.restype = i
            lib.mo_blocked_kkt_launch.argtypes = [
                i, i,  # dtype, D
                p, p, p,  # H, rhs, x
                i, i,  # B, systems per CTA (warp route)
                p,  # cudaStream_t
            ]
            lib.mo_blocked_kkt_launch.restype = i
            lib.mo_blocked_kkt_occupancy.argtypes = [i, i, i]  # dtype, D, systems per CTA
            lib.mo_blocked_kkt_occupancy.restype = i
            lib.mo_ldlt_factor_launch.argtypes = [
                i, i,  # dtype, D
                p, p, p, p,  # H, L, d, ok
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
                ctypes.POINTER(i),  # the M box rows' variables (they choose the route)
                p, p, p, p, p, p,  # G, c, A_eq, b_eq, ia, ib
                ctypes.POINTER(ctypes.c_longlong),  # their 14 strides
                p, p,  # x, y
                i, i,  # B, iterations
                ctypes.c_double,  # sigma
                i, i,  # Mehrotra barrier, equality-constrained initial guess
                p,  # cudaStream_t
            ]
            lib.mo_fused_qp_launch.restype = i
            lib.mo_fused_qp_warp_launch.argtypes = [
                i, i, i, i,  # dtype, N, K, M
                p,  # the box rows' device table: var[M], ptr[N + 1], idx[M]
                p, p, p, p, p, p,  # G, c, A_eq, b_eq, ia, ib
                ctypes.POINTER(ctypes.c_longlong),  # their 14 strides
                p, p,  # x, y
                i, i, i,  # B, instances per CTA, iterations
                ctypes.c_double,  # sigma
                i, i,  # Mehrotra barrier, equality-constrained initial guess
                p,  # cudaStream_t
            ]
            lib.mo_fused_qp_warp_launch.restype = i
            lib.mo_fused_qp_warp_occupancy.argtypes = [i, i, i, i, i]  # dtype, N, K, M, instances per CTA
            lib.mo_fused_qp_warp_occupancy.restype = i
            lib.mo_fused_qp_warp_slab_bytes.argtypes = [i, i, i, i]  # dtype, N, K, M
            lib.mo_fused_qp_warp_slab_bytes.restype = ctypes.c_longlong
            lib.mo_pose_ring_scratch_slots.argtypes = [i, i]  # n poses, closures
            lib.mo_pose_ring_scratch_slots.restype = i
            lib.mo_pose_ring_launch.argtypes = [
                i, i, i,  # dtype, n poses, closures
                ctypes.POINTER(i),  # the closures' (from, to) pairs
                ctypes.c_double,  # anchor weight
                p, p, p, p, p,  # data, x0, x_out, state, scratch (or NULL)
                i, i,  # B, graphs per CTA
                i, i,  # max_iterations, ls_iterations
                p,  # cudaStream_t
            ]
            lib.mo_pose_ring_launch.restype = i
            lib.mo_pose_ring_occupancy.argtypes = [
                i, i, i,  # dtype, n poses, closures
                ctypes.POINTER(i),  # the closures' (from, to) pairs
                i, i,  # graphs per CTA, global scratch
            ]
            lib.mo_pose_ring_occupancy.restype = i
            lib.mo_pose_ring_table_launch.argtypes = [
                i, i, i, i, i,  # dtype, n poses, closures, border poses k, segments
                p,  # the schedule's device table (int32)
                ctypes.c_double,  # anchor weight
                p, p, p, p, p,  # data, x0, x_out, state, scratch (or NULL)
                i, i,  # B, graphs per CTA
                i, i,  # max_iterations, ls_iterations
                p,  # cudaStream_t
            ]
            lib.mo_pose_ring_table_launch.restype = i
            lib.mo_pose_ring_table_slots.argtypes = [i, i, i]  # n poses, closures, k
            lib.mo_pose_ring_table_slots.restype = i
            lib.mo_pose_ring_table_occupancy.argtypes = [i, i, i, i, i, i]  # dtype, n, closures, k, warps, global
            lib.mo_pose_ring_table_occupancy.restype = i
            lib.mo_mpc_scratch_slots.argtypes = [i, i]  # plant, horizon
            lib.mo_mpc_scratch_slots.restype = i
            lib.mo_mpc_launch.argtypes = [
                i, i,  # dtype, plant
                p, p,  # plant constants, cost constants (double arrays)
                i,  # horizon
                p, p, p, p, p, p,  # x0, z0, z_out, stat, history (or NULL), scratch (or NULL)
                i, i,  # B, warps per CTA
                i, i, i,  # max_iterations, qp_iterations, ls_iterations
                p,  # cudaStream_t
            ]
            lib.mo_mpc_launch.restype = i
            lib.mo_mpc_servo_launch.argtypes = [
                i, i,  # dtype, plant
                p, p,  # plant constants, cost constants (double arrays)
                i,  # horizon
                p, p, p, p, p, p,  # x0, z0, x_out, z_out, stats, scratch (or NULL)
                i, i, i,  # B, warps per CTA, periods
                i, i, i,  # max_iterations, qp_iterations, ls_iterations
                p,  # cudaStream_t
            ]
            lib.mo_mpc_servo_launch.restype = i
            lib.mo_mpc_occupancy.argtypes = [i, i, i, i, i, i]  # dtype, plant, horizon, servo, warps, global
            lib.mo_mpc_occupancy.restype = i
            lib.mo_cuda_error_string.argtypes = [i]
            lib.mo_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def error_string(rc):
    """Text of a launcher's non-zero return code."""
    return f"error {rc}: {load_library().mo_cuda_error_string(rc).decode()}"
