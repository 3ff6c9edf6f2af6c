"""Fused whole-period MPC solves for fleets of plants, the PyTorch port of
``mini_opt_tpu/ops/pallas_mpc.py``.

One MPC period is a direct multiple-shooting problem: decision vector
z = [u_0..u_{T-1} (nu each), x_1..x_T (nx each)], RK4 defects
x_{t+1} - rk4(x_t, u_t) as equalities, quadratic tracking and effort costs,
box bounds on the inputs. Each period is solved by the same fixed-trip SQP
as ``nls_solve`` at ``default_mpc_params``: stagewise RK4 linearization with
forward-mode Jacobians, the Mehrotra interior point on the input bounds with
its linear systems solved by a Riccati recursion (T stages of (nx+nu)-sized
algebra, the math of ``ops/riccati.py`` with N_t = I), the L1-merit Armijo
line search, the lambda machine at the MPC constants (lambda_0 = 1e-6,
min 1e-12, failure init 1e-3) and the best-merit return.

Two kernels, one device skeleton (``csrc/mpc.cuh``, float instances and C
launchers in ``mpc.cu``, double instances in ``mpc_f64.cu``), one instance
per warp with its stage arrays in shared memory (``launch_plan``):

* kernel 8, ``fused_mpc_solve_batch``: one period; replaces
  ``pallas_mpc.py::_make_mpc_kernel``;
* kernel 9, ``fused_mpc_servo_batch``: ``periods`` x (solve -> apply u_0 ->
  RK4 plant step -> shift the warm start) in one launch; replaces
  ``pallas_mpc.py::_make_mpc_servo_kernel``.

Beside each sits its plain version (``_mpc_plain``, ``_mpc_servo_plain``),
the same computation in plain PyTorch, operation for operation, on
feature-major ``(rows, B)`` tensors. The stages and the matrix entries are
batched into tensor operations where the JAX kernel writes Python loops, but
every element sees the same operations in the same order as the kernel's
scalar loops: sums start from 0 as Python's ``sum`` does, the Riccati
products sum over their inner index in order, the reductions across stages
run term by term. The plant's Jacobians come from a dual-number helper
(``_Dual``) whose rules the kernel's ``Dual`` repeats. Built without FMA
contraction, the kernel reproduces the plain version bit for bit on the
card.

The entry points dispatch on the tensors' device: CPU tensors run the plain
version, CUDA tensors launch the kernel or raise; ``backend="xla"`` (the
JAX package's oracle route) asks for the plain version wherever the tensors
lie. Layouts are the JAX package's: ``(B, nx)`` plant states and
``(B, T*(nu+nx))`` warm starts in, ``(B, dim)`` trajectories out.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import torch

from .. import convert
from . import _build
from ._common import _CUDA_DTYPE_IDS, _check_cuda_tensors, _div, _maximum, _minimum, _sign
from .fused_ik import _ldlt_apply, _ldlt_bad, _ldlt_factor_unrolled

# Launches of each CUDA kernel in this process: each wrapper adds one right
# where it launches, and nowhere else.
KERNEL_LAUNCHES = 0  # kernel 8, one MPC period
SERVO_LAUNCHES = 0  # kernel 9, the receding-horizon loop

NX = 4  # cart-pole state dimension (the default family)
_TAU_FTB = 0.995
_DBG_CHANNELS = 7  # f, eq, penalty, lam, dd, accepted, alpha

# The plants csrc/mpc.cuh has a device functor for, and the order of their
# constants in the launcher's array.
_CUDA_PLANTS = {"cartpole": 0, "quadrotor": 1}


# ---------------------------------------------------------------------------
# Dual numbers: forward-mode tangents for the stage Jacobians.
# ---------------------------------------------------------------------------


class _Dual:
    """A value ``v`` and its tangents ``t`` (one row per input direction).
    Python numbers are constants with no tangent. Each rule is written in
    one fixed order, which ``csrc/mpc.cuh``'s ``Dual`` repeats."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v, self.t = v, t

    def __add__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v + o.v, self.t + o.t)
        return _Dual(self.v + o, self.t)

    def __radd__(self, o):
        return _Dual(o + self.v, self.t)

    def __sub__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v - o.v, self.t - o.t)
        return _Dual(self.v - o, self.t)

    def __rsub__(self, o):
        return _Dual(o - self.v, -self.t)

    def __mul__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v * o.v, self.t * o.v + self.v * o.t)
        return _Dual(self.v * o, self.t * o)

    def __rmul__(self, o):
        return _Dual(o * self.v, o * self.t)

    def __neg__(self):
        return _Dual(-self.v, -self.t)


def _sin(a):
    if isinstance(a, _Dual):
        return _Dual(torch.sin(a.v), torch.cos(a.v) * a.t)
    return torch.sin(a)


def _cos(a):
    if isinstance(a, _Dual):
        return _Dual(torch.cos(a.v), -torch.sin(a.v) * a.t)
    return torch.cos(a)


def _quot(a, b):
    """a / b, b a Python number or a value of the same kind as a. Divides by
    a tensor, never by a Python scalar (``_common._div``)."""
    if isinstance(b, _Dual):
        q = a.v / b.v
        return _Dual(q, (a.t - q * b.t) / b.v)
    if torch.is_tensor(b):
        return a / b
    if isinstance(a, _Dual):
        return _Dual(_div(a.v, b), _div(a.t, b))
    return _div(a, b)


# ---------------------------------------------------------------------------
# Static family description.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MPCFamily:
    """Static description of one fused MPC problem family: generic direct
    multiple-shooting transcription with user dynamics.

    ``xdot(x, u) -> list[nx]`` is the continuous dynamics over lists of
    values (``x`` list[nx], ``u`` list[nu]), written with ``+ - *``,
    ``ops.mpc._sin``/``_cos`` and ``ops.mpc._quot`` so that the same
    function runs on tensors and on dual numbers; stage Jacobians come from
    it by forward-mode tangents. ``None`` selects the built-in cart-pole with
    the stock constants. ``cuda_functor`` names the device functor of
    ``csrc/mpc.cuh`` that computes the same dynamics, with its constants
    (``("cartpole", (mass_cart, mass_pole, length, gravity))`` or
    ``("quadrotor", (mass, inertia, arm, gravity))``); a family without one
    runs on the CPU only.

    Cost and bound constants are per-dimension tuples: ``q``/``q_terminal``/
    ``goal`` of length nx, ``r_u``/``u_ref``/``u_min``/``u_max`` of length
    nu (effort rows sqrt(r_u) (u - u_ref); bounds u_min <= u <= u_max)."""

    horizon: int
    dt: float
    nx: int = 4
    nu: int = 1
    q: Tuple[float, ...] = (1.0, 0.1, 10.0, 0.1)
    q_terminal: Tuple[float, ...] = (10.0, 1.0, 100.0, 1.0)
    r_u: Tuple[float, ...] = (0.01,)
    goal: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    u_ref: Tuple[float, ...] = (0.0,)
    u_min: Tuple[float, ...] = (-10.0,)
    u_max: Tuple[float, ...] = (10.0,)
    xdot: Optional[Callable] = None
    cuda_functor: Optional[tuple] = None

    def __post_init__(self):
        if self.horizon < 1:
            raise ValueError(f"horizon must be >= 1, not {self.horizon}")
        if len(self.q) != self.nx or len(self.q_terminal) != self.nx or len(self.goal) != self.nx:
            raise ValueError("q, q_terminal and goal need nx entries each")
        for tup in (self.r_u, self.u_ref, self.u_min, self.u_max):
            if len(tup) != self.nu:
                raise ValueError("r_u, u_ref, u_min and u_max need nu entries each")

    @property
    def dim(self) -> int:
        return self.horizon * (self.nu + self.nx)


_CARTPOLE_STOCK = (1.0, 0.1, 0.5, 9.81)  # mass_cart, mass_pole, length, gravity


def _cartpole_register_xdot(mass_cart, mass_pole, length, gravity):
    """models/mpc.py::cartpole_xdot over lists of values."""

    def xdot(x, u):
        _, v, th, w = x
        s, c = _sin(th), _cos(th)
        denom = mass_cart + mass_pole * s * s
        a = _quot(u[0] + mass_pole * s * (length * w * w - gravity * c), denom)
        alpha = _quot(gravity * s - a * c, length)
        return [v, a, w, alpha]

    return xdot


@functools.lru_cache(maxsize=None)
def cartpole_mpc_family(
    horizon: int,
    dt: float,
    u_max: float = 10.0,
    q: Tuple[float, ...] = (1.0, 0.1, 10.0, 0.1),
    q_terminal: Tuple[float, ...] = (10.0, 1.0, 100.0, 1.0),
    r_u: float = 0.01,
    goal: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0),
    mass_cart: float = 1.0,
    mass_pole: float = 0.1,
    length: float = 0.5,
    gravity: float = 9.81,
) -> MPCFamily:
    """Cart-pole, nu = 1, symmetric input bound."""
    consts = (float(mass_cart), float(mass_pole), float(length), float(gravity))
    return MPCFamily(
        horizon=horizon,
        dt=dt,
        nx=4,
        nu=1,
        q=tuple(q),
        q_terminal=tuple(q_terminal),
        r_u=(float(r_u),),
        goal=tuple(goal),
        u_ref=(0.0,),
        u_min=(-float(u_max),),
        u_max=(float(u_max),),
        xdot=_cartpole_register_xdot(*consts),
        cuda_functor=("cartpole", consts),
    )


@functools.lru_cache(maxsize=None)
def quadrotor_mpc_family(
    horizon: int,
    dt: float,
    u_max: float = 8.0,
    mass: float = 0.5,
    inertia: float = 0.01,
    arm: float = 0.25,
    gravity: float = 9.81,
    q: Tuple[float, ...] = (1.0, 1.0, 5.0, 0.1, 0.1, 0.1),
    q_terminal: Tuple[float, ...] = (10.0, 10.0, 50.0, 1.0, 1.0, 1.0),
    r_u: float = 0.01,
) -> MPCFamily:
    """Planar quadrotor (nx = 6, nu = 2): state (x, y, theta, vx, vy,
    omega), inputs two rotor thrusts in [0, u_max]; hover goal at the origin
    with the effort reference at the hover thrust m g / 2 per rotor."""
    hover = mass * gravity / 2.0
    arm_over_inertia = arm / inertia

    def xdot(x, u):
        _, _, th, vx, vy, w = x
        s, c = _sin(th), _cos(th)
        thrust = _quot(u[0] + u[1], mass)
        return [vx, vy, w, -thrust * s, thrust * c - gravity, arm_over_inertia * (u[0] - u[1])]

    return MPCFamily(
        horizon=horizon,
        dt=dt,
        nx=6,
        nu=2,
        q=tuple(q),
        q_terminal=tuple(q_terminal),
        r_u=(float(r_u),) * 2,
        goal=(0.0,) * 6,
        u_ref=(hover, hover),
        u_min=(0.0, 0.0),
        u_max=(float(u_max),) * 2,
        xdot=xdot,
        cuda_functor=("quadrotor", (float(mass), float(inertia), float(arm), float(gravity))),
    )


def _cuda_functor(fam: MPCFamily):
    if fam.xdot is None:
        return ("cartpole", _CARTPOLE_STOCK)
    return fam.cuda_functor


# ---------------------------------------------------------------------------
# The plant model over lists of values.
# ---------------------------------------------------------------------------


def _xdot(fam: MPCFamily, x, u):
    if fam.xdot is not None:
        return fam.xdot(x, u)
    return _cartpole_register_xdot(*_CARTPOLE_STOCK)(x, u)


def _rk4(fam: MPCFamily, x, u):
    """One RK4 step; ``x`` list[nx], ``u`` list[nu]. 0.5 dt and dt / 6 are
    formed in Python double and rounded once, as the JAX kernel folds them."""
    dt = fam.dt
    hdt, dt6 = 0.5 * dt, dt / 6.0
    nx = fam.nx
    k1 = _xdot(fam, x, u)
    k2 = _xdot(fam, [x[i] + hdt * k1[i] for i in range(nx)], u)
    k3 = _xdot(fam, [x[i] + hdt * k2[i] for i in range(nx)], u)
    k4 = _xdot(fam, [x[i] + dt * k3[i] for i in range(nx)], u)
    return [x[i] + dt6 * (k1[i] + 2.0 * k2[i] + 2.0 * k3[i] + k4[i]) for i in range(nx)]


def _rk4_linearized(fam: MPCFamily, x, u):
    """(rk4(x, u), A = d rk4/dx (nx, nx, ...), B = d rk4/du (nx, nu, ...))
    for values ``x`` list[nx] and ``u`` list[nu] of one shape: every input
    is seeded with its unit tangent and the dual numbers carry all nx + nu
    directions at once."""
    nx, nu = fam.nx, fam.nu
    nin = nx + nu
    like = x[0]
    eye = torch.eye(nin, dtype=like.dtype, device=like.device).reshape((nin, nin) + (1,) * like.dim())
    seeds = eye.expand((nin, nin) + tuple(like.shape))
    ins = [_Dual(v, seeds[:, k]) for k, v in enumerate(list(x) + list(u))]
    out = _rk4(fam, ins[:nx], ins[nx:])
    prim = [o.v for o in out]
    J = torch.stack([o.t for o in out])  # (nx, nin, ...)
    return prim, J[:, :nx], J[:, nx:]


# ---------------------------------------------------------------------------
# The plain version of the kernels.
# ---------------------------------------------------------------------------


def _seq_sum(rows, first=None):
    """Term-by-term sum of ``rows`` in order: from ``first`` when given, else
    from the first row (the JAX kernel's ``f = term if f is None else f +
    term``)."""
    acc = first
    for r in rows:
        acc = r if acc is None else acc + r
    return acc


def _mv(M, v):
    """out[i] = sum_j M[i][j] v[j], from 0 in order of j; M (r, c, ...)."""
    acc = torch.zeros_like(M[:, 0])
    for j in range(M.shape[1]):
        acc = acc + M[:, j] * v[j]
    return acc


def _mtv(M, v):
    """out[j] = sum_i M[i][j] v[i], from 0 in order of i."""
    acc = torch.zeros_like(M[0])
    for i in range(M.shape[0]):
        acc = acc + M[i] * v[i]
    return acc


def _mm(A, B):
    """out[i][j] = sum_k A[i][k] B[k][j], from 0 in order of k."""
    acc = torch.zeros(
        (A.shape[0], B.shape[1]) + tuple(A.shape[2:]), dtype=A.dtype, device=A.device
    )
    for k in range(A.shape[1]):
        acc = acc + A[:, k, None] * B[None, k]
    return acc


def _mtm(A, B):
    """out[i][j] = sum_k A[k][i] B[k][j], from 0 in order of k."""
    acc = torch.zeros(
        (A.shape[1], B.shape[1]) + tuple(A.shape[2:]), dtype=A.dtype, device=A.device
    )
    for k in range(A.shape[0]):
        acc = acc + A[k, :, None] * B[k, None]
    return acc


def _diag_plus(d, S):
    """(d[i] if i == j else 0) + S[i][j]."""
    n = S.shape[0]
    D = torch.zeros_like(S)
    for i in range(n):
        D[i, i] = d[i]
    return D + S


def _riccati_factor(R, Q, A, Bm):
    """Backward V/K/F recursion (``pallas_mpc.py::_riccati_factor``). ``R``
    (T, nu, B): the diagonal u block incl. lambda and Sigma; ``Q`` (T, nx,
    B): the diagonal Q of x_{t+1} incl. lambda; ``A`` (T, nx, nx, B) with
    A[0] zero, ``Bm`` (T, nx, nu, B). Returns ((L, d) per stage of F_t's
    LDL^T, K (T, nu, nx, B), Vnext (T, nx, nx, B), bad (B,))."""
    T, nx = Q.shape[0], Q.shape[1]
    nu = R.shape[1]
    zero = torch.zeros_like(Q[0, 0])
    V = torch.zeros_like(A[0])
    for i in range(nx):
        V[i, i] = Q[T - 1, i]
    Ff, Ks, Vn = [None] * T, [None] * T, [None] * T
    bad = zero
    for t in range(T - 1, -1, -1):
        At, Bt = A[t], Bm[t]
        VB = _mm(V, Bt)  # (nx, nu)
        F = _diag_plus(R[t], _mtm(Bt, VB))  # (nu, nu)
        Lf, df = _ldlt_factor_unrolled([[F[i, j] for j in range(nu)] for i in range(nu)])
        bad = _maximum(bad, _ldlt_bad(df, zero))
        # K (nu x nx) = F^-1 B^T V A, all columns through the factor at once.
        K = torch.stack(_ldlt_apply(Lf, df, list(_mtm(VB, At))))
        Ff[t], Ks[t], Vn[t] = (Lf, df), K, V
        if t > 0:
            M = _mm(V, At) - _mm(VB, K)
            Vt = _diag_plus(Q[t - 1], _mtm(At, M))
            V = 0.5 * (Vt + Vt.transpose(0, 1))
    return Ff, torch.stack(Ks), torch.stack(Vn), bad


def _riccati_solve(fact, A, Bm, b1u, b1x, b2):
    """Backward (v, k) and forward (du, dx, dy) sweeps
    (``pallas_mpc.py::_riccati_solve``). ``b1u`` (T, nu, B) is the rhs of the
    u_t rows, ``b1x`` (T, nx, B) of the x_{t+1} rows, ``b2`` (T, nx, B) of
    equality row t. Returns (du, dxs, dy)."""
    Ff, K, Vn = fact
    T = b1u.shape[0]
    v = -b1x[T - 1]
    ks, vnext = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        V1 = Vn[t]
        vnext[t] = v
        tmp = _mv(V1, b2[t]) + v
        ks[t] = torch.stack(_ldlt_apply(*Ff[t], list(b1u[t] - _mtv(Bm[t], tmp))))
        if t > 0:
            w = _mv(V1, _mv(Bm[t], ks[t]) + b2[t]) + v
            v = _mtv(A[t], w) - b1x[t - 1]
    du, dxs, dy = [None] * T, [None] * T, [None] * T
    dx = torch.zeros_like(b1x[0])
    for t in range(T):
        du[t] = -_mv(K[t], dx) + ks[t]
        dxn = _mv(A[t], dx) + _mv(Bm[t], du[t]) + b2[t]
        # dy_t = lambda_{t+1} = V_{t+1} dx_{t+1} + v_{t+1}.
        dy[t] = _mv(Vn[t], dxn) + vnext[t]
        dxs[t] = dxn
        dx = dxn
    return torch.stack(du), torch.stack(dxs), torch.stack(dy)


def _shifted(M, v):
    """out[t] = sum_j M[t][:, j] v[t-1][j] for t >= 1 and 0 at t = 0:
    A_t dx_{t-1} without the structurally zero first stage."""
    acc = torch.zeros_like(M[1:, :, 0])
    for j in range(M.shape[2]):
        acc = acc + M[1:, :, j] * v[:-1, j, None]
    return torch.cat([torch.zeros_like(acc[:1]), acc]) if M.shape[0] > 1 else torch.zeros_like(M[:, :, 0])


def _cost_doubles(fam: MPCFamily):
    """The family's cost and bound constants as Python doubles, folded as the
    JAX kernel folds them: w2 = sqrt(q)^2 of the running stages, w2T of the
    terminal one, hw2 = 0.5 w2 and hr_u = 0.5 r_u for the cost terms. The
    plain version rounds each once to its dtype; the CUDA launcher takes them
    as doubles in this order."""
    w1 = [float(v) ** 0.5 for v in fam.q]
    wT = [float(v) ** 0.5 for v in fam.q_terminal]
    w2, w2T = [w * w for w in w1], [w * w for w in wT]
    r_u = [float(r) for r in fam.r_u]
    return dict(
        w2=w2, w2T=w2T, hw2=[0.5 * v for v in w2], hw2T=[0.5 * v for v in w2T],
        goal=[float(g) for g in fam.goal], r_u=r_u, hr_u=[0.5 * v for v in r_u],
        u_ref=[float(r) for r in fam.u_ref], u_min=[float(b) for b in fam.u_min],
        u_max=[float(b) for b in fam.u_max],
    )


class _Consts:
    """The cost constants as tensors of the working dtype: per-stage (T, nx,
    1) weights, per-dimension (n, 1) columns."""

    def __init__(self, fam: MPCFamily, like):
        T = fam.horizon
        d = _cost_doubles(fam)

        def col(vals, lead=()):
            return torch.tensor(vals, dtype=like.dtype, device=like.device).reshape(*lead, -1, 1)

        def stages(run, term):
            return col([run if t < T - 1 else term for t in range(T)], (T,))

        self.w2 = stages(d["w2"], d["w2T"])
        self.hw2 = stages(d["hw2"], d["hw2T"])
        for name in ("goal", "r_u", "hr_u", "u_ref", "u_min", "u_max"):
            setattr(self, name, col(d[name]))
        self.ncon = 2 * T * fam.nu


def _mpc_core(fam: MPCFamily, x0, u, xs, max_iterations, qp_iterations, ls_iterations, history=False):
    """One MPC period (``pallas_mpc.py::_make_mpc_kernel``'s ``core``) on
    feature-major tensors: ``x0`` (nx, B), ``u`` (T, nu, B), ``xs`` (T, nx,
    B). Returns (u, xs, f, eq, flags, history rows)."""
    T, nx, nu = fam.horizon, fam.nx, fam.nu
    k = _Consts(fam, x0)
    one = torch.ones_like(x0[0])
    zero = torch.zeros_like(x0[0])

    def const(v):
        return torch.full_like(one, v)

    def rk4_stages(u_, xs_):
        """rk4(x_t, u_t) for every stage, x_0 the plant state: (T, nx, B)."""
        xin = torch.cat([x0[None], xs_[:-1]])
        return torch.stack(_rk4(fam, list(xin.unbind(1)), list(u_.unbind(1))), dim=1)

    def cost_rows(u_, xs_):
        """The cost's terms in the kernel's order: per stage the nx tracking
        terms, then the nu effort terms."""
        rr = xs_ - k.goal
        du_ = u_ - k.u_ref
        return torch.cat([k.hw2 * rr * rr, k.hr_u * du_ * du_], dim=1).reshape(-1, rr.shape[-1])

    def errors(u_, xs_):
        """(f, |eq|_1) at (u, xs): the line-search probe."""
        f = _seq_sum(cost_rows(u_, xs_))
        eq = _seq_sum(torch.abs(xs_ - rk4_stages(u_, xs_)).reshape(T * nx, -1))
        return f, eq

    def ftb(vs, dvs, tau):
        blocking = (vs + dvs <= 0.0) & (torch.abs(dvs) > 0.0)
        cand = torch.where(blocking, (-tau * vs) / torch.where(blocking, dvs, one), one)
        alpha = one
        for row in cand.reshape(-1, cand.shape[-1]):
            alpha = _minimum(alpha, row)
        return alpha

    def qp_solve(lam, c_u, c_x, r, A, Bm, u_):
        """The interior point on the stage-structured condensed system
        (``pallas_mpc.py`` ``qp_solve``). Returns (du, dxs, y_abs_max, bad)."""
        Rb = k.r_u + lam  # (nu, B)
        Rbase = Rb.expand(T, nu, -1)
        Q = k.w2 + lam  # (T, nx, B)
        ib_lo = u_ - k.u_min
        ib_hi = k.u_max - u_

        # Equality-constrained initial guess (Sigma = 0).
        fact0 = _riccati_factor(Rbase, Q, A, Bm)
        bad = fact0[3]
        du, dxs, y = _riccati_solve(fact0[:3], A, Bm, -c_u, -c_x, -r)
        # Clamp into the shifted bounds; slack and dual init (qp.cc:470-481).
        du = _minimum(_maximum(du, -ib_lo), ib_hi)
        s_lo = _maximum(du + ib_lo, 1e-9)
        s_hi = _maximum(-du + ib_hi, 1e-9)
        z_lo = torch.ones_like(s_lo) / s_lo
        z_hi = torch.ones_like(s_hi) / s_hi
        mu = one
        for _ in range(qp_iterations):
            # KKT residuals (qp.cc:391-420) per stage.
            r_d_u = c_u + Rb * du + _mtv_stages(Bm, y) - z_lo + z_hi
            r_d_x = Q * dxs + c_x - y + _next_at_y(A, y)
            r_pe = r - _shifted(A, dxs) - _mv_stages(Bm, du) + dxs
            r_pi_lo = du + ib_lo - s_lo
            r_pi_hi = -du + ib_hi - s_hi
            r_c_lo = s_lo * z_lo
            r_c_hi = s_hi * z_hi
            sig_lo = z_lo / s_lo
            sig_hi = z_hi / s_hi
            fact = _riccati_factor(Rbase + sig_lo + sig_hi, Q, A, Bm)
            bad = _maximum(bad, fact[3])

            def solve_step(mu_v, corr_lo, corr_hi):
                c_lo = (r_c_lo + corr_lo - mu_v) / s_lo
                c_hi = (r_c_hi + corr_hi - mu_v) / s_hi
                r_aug = r_d_u + sig_lo * r_pi_lo + c_lo - sig_hi * r_pi_hi - c_hi
                ddu, ddx, ddy = _riccati_solve(fact[:3], A, Bm, -r_aug, -r_d_x, -r_pe)
                ds_lo = ddu + r_pi_lo
                ds_hi = -ddu + r_pi_hi
                dz_lo = -sig_lo * ds_lo - c_lo
                dz_hi = -sig_hi * ds_hi - c_hi
                return ddu, ddx, ddy, ds_lo, ds_hi, dz_lo, dz_hi

            zeros_t = torch.zeros_like(du)
            # Mehrotra predictor-corrector (algorithm 16.4 / qp.cc:170-188).
            _, _, _, dsl_a, dsh_a, dzl_a, dzh_a = solve_step(zero, zeros_t, zeros_t)
            ap_a = ftb(torch.cat([s_lo, s_hi]), torch.cat([dsl_a, dsh_a]), 1.0)
            ad_a = ftb(torch.cat([z_lo, z_hi]), torch.cat([dzl_a, dzh_a]), 1.0)
            # The reference's mu_aff form (qp.cc:519-537): the carried mu
            # stands in for s^T z / M.
            x_lo = ad_a * s_lo * dzl_a + ap_a * z_lo * dsl_a + ap_a * ad_a * dsl_a * dzl_a
            x_hi = ad_a * s_hi * dzh_a + ap_a * z_hi * dsh_a + ap_a * ad_a * dsh_a * dzh_a
            cross = _seq_sum(torch.stack([x_lo, x_hi], dim=2).reshape(-1, x_lo.shape[-1]), zero)
            mu_aff = _maximum(mu + _div(cross, k.ncon), 0.0)
            ratio = mu_aff / mu
            sigma = ratio * (ratio * ratio)
            ddu, ddx, ddy, ds_lo, ds_hi, dz_lo, dz_hi = solve_step(sigma * mu, dsl_a * dzl_a, dsh_a * dzh_a)

            ap = ftb(torch.cat([s_lo, s_hi]), torch.cat([ds_lo, ds_hi]), _TAU_FTB)
            ad = ftb(torch.cat([z_lo, z_hi]), torch.cat([dz_lo, dz_hi]), _TAU_FTB)
            du = du + ap * ddu
            dxs = dxs + ap * ddx
            s_lo = s_lo + ap * ds_lo
            s_hi = s_hi + ap * ds_hi
            y = y + ad * ddy
            z_lo = z_lo + ad * dz_lo
            z_hi = z_hi + ad * dz_hi
            comp = zero
            for t in range(T):
                for r_ in range(nu):
                    comp = comp + s_lo[t, r_] * z_lo[t, r_] + s_hi[t, r_] * z_hi[t, r_]
            mu = 0.1 * _div(comp, k.ncon)

        y_abs = torch.abs(y[0, 0])
        for row in torch.abs(y).reshape(-1, y.shape[-1]):
            y_abs = _maximum(y_abs, row)
        # Non-finite steps fold into the failure flag (qp.py iterate()).
        fin = torch.isfinite(du[0, 0])
        for row in torch.isfinite(torch.cat([du, dxs], dim=1)).reshape(-1, du.shape[-1]):
            fin = fin & row
        bad = _maximum(bad, torch.where(fin, zero, one))
        return du, dxs, y_abs, bad

    lam = 1e-6 * one
    penalty = 1.0 * one
    restore = zero
    best_u, best_xs = u, xs
    f_best = torch.full_like(one, math.inf)
    eq_best = fac_bad = lam_maxed = accepted = f_acc = eq_acc = f_pre = eq_pre = zero
    hist = []
    for _ in range(max_iterations):
        # Stagewise linearization (the LinearizeAndFillQP analog).
        c_u = k.r_u * (u - k.u_ref)
        c_x = k.w2 * (xs - k.goal)
        xin = torch.cat([x0[None], xs[:-1]])
        pred, At, Bm = _rk4_linearized(fam, list(xin.unbind(1)), list(u.unbind(1)))
        r = xs - torch.stack(pred, dim=1)
        # (nx, nx, T, B) -> (T, nx, nx, B); row 0's state coefficient acts on
        # the parameter x_0, so A_0 is structurally zero.
        A = At.permute(2, 0, 1, 3).clone()
        A[0] = 0.0
        Bm = Bm.permute(2, 0, 1, 3).contiguous()
        eq_pre = _seq_sum(torch.abs(r).reshape(T * nx, -1))
        f_pre = _seq_sum(cost_rows(u, xs))

        better = f_pre + penalty * eq_pre < f_best + penalty * eq_best
        best_u = torch.where(better, u, best_u)
        best_xs = torch.where(better, xs, best_xs)
        f_best = torch.where(better, f_pre, f_best)
        eq_best = torch.where(better, eq_pre, eq_best)

        du, dxs_step, y_abs, bad_it = qp_solve(lam, c_u, c_x, r, A, Bm, u)
        fac_bad = _maximum(fac_bad, bad_it)

        # Directional derivative and penalty (nonlinear.cc:457-502).
        d_f = _seq_sum(torch.cat([c_u * du, c_x * dxs_step], dim=1).reshape(-1, du.shape[-1]), zero)
        # A_eq row: -A_t dx_t - B_t du_t + dx_{t+1}.
        lin = -_shifted(A, dxs_step) - _mv_stages(Bm, du) + dxs_step
        d_eq = _seq_sum((_sign(r) * lin).reshape(T * nx, -1), zero)
        penalty = torch.where(y_abs > penalty, y_abs * 1.01, penalty)
        dd = d_f + penalty * d_eq
        merit_pre = f_pre + penalty * eq_pre

        # Armijo backtracking line search (tau = 0.5).
        alpha = one
        accepted = zero
        bu, bxs = u, xs
        f_acc, eq_acc = f_pre, eq_pre
        for probe in range(ls_iterations + 1):
            if probe > 0:
                alpha = alpha * 0.5
            cand_u = u + alpha * du
            cand_x = xs + alpha * dxs_step
            f_c, eq_c = errors(cand_u, cand_x)
            merit_c = f_c + penalty * eq_c
            ok = (merit_c <= merit_pre + 1e-4 * alpha * _minimum(dd, zero)).to(one.dtype)
            take = ok * (1.0 - accepted)
            bu = take * cand_u + (1.0 - take) * bu
            bxs = take * cand_x + (1.0 - take) * bxs
            f_acc = take * f_c + (1.0 - take) * f_acc
            eq_acc = take * eq_c + (1.0 - take) * eq_acc
            accepted = _minimum(accepted + take, 1.0)

        u = torch.where(accepted > 0, bu, u)
        xs = torch.where(accepted > 0, bxs, xs)
        if history:
            hist.append((f_pre, eq_pre, penalty, lam, dd, accepted, alpha))
        # Lambda machine at the MPC family constants.
        lam_succ = _maximum(lam * torch.where(restore > 0, const(0.8), const(0.1)), 1e-12)
        lam_fail = torch.where(restore > 0, lam * 10.0, _maximum(1e-3 * one, lam * 10.0))
        lam = torch.where(accepted > 0, lam_succ, lam_fail)
        restore = torch.where(accepted > 0, zero, one)
        lam_maxed = torch.where((accepted == 0) & (lam > 1.0), one, zero)

    f_fin = torch.where(accepted > 0, f_acc, f_pre)
    eq_fin = torch.where(accepted > 0, eq_acc, eq_pre)
    better = f_fin + penalty * eq_fin < f_best + penalty * eq_best
    u_out = torch.where(better, u, best_u)
    xs_out = torch.where(better, xs, best_xs)
    f_out = torch.where(better, f_fin, f_best)
    eq_out = torch.where(better, eq_fin, eq_best)
    return u_out, xs_out, f_out, eq_out, fac_bad + 2.0 * lam_maxed, hist


def _mtv_stages(Bm, y):
    """out[t][r] = sum_i Bm[t][i][r] y[t][i], from 0 in order of i."""
    acc = torch.zeros_like(Bm[:, 0])
    for i in range(Bm.shape[1]):
        acc = acc + Bm[:, i] * y[:, i, None]
    return acc


def _mv_stages(Bm, du):
    """out[t][i] = sum_r Bm[t][i][r] du[t][r], from 0 in order of r."""
    acc = torch.zeros_like(Bm[:, :, 0])
    for r in range(Bm.shape[2]):
        acc = acc + Bm[:, :, r] * du[:, r, None]
    return acc


def _next_at_y(A, y):
    """out[t][i] = sum_k A[t+1][k][i] y[t+1][k] for t < T-1, and 0 at
    t = T-1."""
    acc = torch.zeros_like(y[1:])
    for kk in range(A.shape[1]):
        acc = acc + A[1:, kk] * y[1:, kk, None]
    return torch.cat([acc, torch.zeros_like(y[:1])])


def _split(fam: MPCFamily, z_t):
    """(dim, B) -> u (T, nu, B), xs (T, nx, B)."""
    T, nx, nu = fam.horizon, fam.nx, fam.nu
    return z_t[: T * nu].reshape(T, nu, -1), z_t[T * nu :].reshape(T, nx, -1)


def _join(u, xs):
    return torch.cat([u.reshape(-1, u.shape[-1]), xs.reshape(-1, xs.shape[-1])])


def _mpc_plain(fam, x0_t, z0_t, max_iterations, qp_iterations, ls_iterations, debug_history=False):
    """Kernel 8's computation as plain PyTorch: ``x0_t`` (nx, B), ``z0_t``
    (dim, B) -> z (dim, B), stat (3, B) = (f, |eq|_1, flags), history
    (max_iterations, 7, B) or None."""
    u, xs = _split(fam, z0_t)
    u_o, xs_o, f, eq, flags, hist = _mpc_core(
        fam, x0_t, u, xs, max_iterations, qp_iterations, ls_iterations, debug_history
    )
    history = torch.stack([torch.stack(row) for row in hist]) if debug_history else None
    return _join(u_o, xs_o), torch.stack([f, eq, flags]), history


def _mpc_servo_plain(fam, x_t, z0_t, periods, max_iterations, qp_iterations, ls_iterations):
    """Kernel 9's computation as plain PyTorch: ``periods`` x (solve ->
    apply u_0 -> RK4 plant step -> shift). Returns x (nx, B), z (dim, B),
    stats (4, B) = (f and |eq|_1 of the last period's solve, sticky flags,
    max |u_0| over the rollout and the inputs)."""
    T, nu = fam.horizon, fam.nu
    u, xs = _split(fam, z0_t)
    x = x_t
    zero = torch.zeros_like(x_t[0])
    maxu = f = eq = flags = zero
    for _ in range(periods):
        u_o, xs_o, f, eq, flg, _ = _mpc_core(fam, x, u, xs, max_iterations, qp_iterations, ls_iterations)
        u0 = u_o[0]
        x = torch.stack(_rk4(fam, list(x), list(u0)))
        # shift_warm_start: u_t <- u_{t+1} (last repeated), x_t <- x_{t+1},
        # the new terminal state integrated from the last shifted pair.
        u = torch.cat([u_o[1:], u_o[T - 1 :]])
        x_term = torch.stack(_rk4(fam, list(xs_o[T - 1]), list(u[T - 1])))
        xs = torch.cat([xs_o[1:], x_term[None]])
        for r_ in range(nu):
            maxu = _maximum(maxu, torch.abs(u0[r_]))
        flags = _maximum(flags, flg)
    return x, _join(u, xs), torch.stack([f, eq, flags, maxu])


# ---------------------------------------------------------------------------
# The CUDA kernels.
# ---------------------------------------------------------------------------


def _cuda_args(fam: MPCFamily):
    """(plant id, plant constants, cost constants) for csrc/mpc.cu's
    launchers; raises for a family the kernels have no functor for."""
    functor = _cuda_functor(fam)
    if functor is None:
        raise NotImplementedError(
            "this MPCFamily has no device functor (cuda_functor is None): csrc/mpc.cuh "
            f"has the plants {sorted(_CUDA_PLANTS)}; a family with other dynamics runs on "
            "the CPU only until a functor for it is added"
        )
    kind, consts = functor
    if kind not in _CUDA_PLANTS:
        raise NotImplementedError(f"no CUDA functor named {kind!r}")
    nx_want, nu_want = {"cartpole": (4, 1), "quadrotor": (6, 2)}[kind]
    if (fam.nx, fam.nu) != (nx_want, nu_want):
        raise ValueError(f"the {kind} functor has nx={nx_want}, nu={nu_want}; the family {fam.nx}, {fam.nu}")
    d = _cost_doubles(fam)
    cost = [0.5 * fam.dt, float(fam.dt), fam.dt / 6.0] + [
        v for name in ("w2", "w2T", "hw2", "hw2T", "goal", "r_u", "hr_u", "u_ref", "u_min", "u_max") for v in d[name]
    ]
    return (
        _CUDA_PLANTS[kind],
        (ctypes.c_double * len(consts))(*consts),
        (ctypes.c_double * len(cost))(*cost),
    )


def _budget_args(max_iterations, qp_iterations, ls_iterations):
    if max_iterations < 1:
        raise ValueError("the MPC kernels need max_iterations >= 1")
    if qp_iterations < 0 or ls_iterations < 0:
        raise ValueError("qp_iterations and ls_iterations must be >= 0")
    return max_iterations, qp_iterations, ls_iterations


# The launch plan of kernels 8 and 9 (csrc/mpc.cuh): one warp per instance,
# WARPS_PER_CTA instances per CTA, each warp's Layout slots a slab of the
# CTA's dynamic shared memory; fewer warps where WARPS_PER_CTA slabs do not
# fit one CTA, and an instance-major global scratch array where one slab
# does not.
WARPS_PER_CTA = 4
MAX_CTA_SMEM = 232_448  # bytes of dynamic shared memory one H100 CTA may hold


def layout_slots(horizon: int, nx: int, nu: int) -> int:
    """Slots of one instance's slab at this horizon: csrc/mpc.cuh's
    ``Layout(T, nx, nu).total`` (four trajectories, the stage Jacobians,
    defects and gradients, the Riccati factors, 26 per-input and 7
    per-state arrays of the interior point)."""
    dim, tu, tx = horizon * (nu + nx), horizon * nu, horizon * nx
    return 4 * dim + tx * nx + tx * nu + tx + tu + tx + tu * nu + tu + tu * nx + tx * nx + 26 * tu + 7 * tx


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How kernels 8 and 9 launch for B instances: ``warps`` per CTA,
    ``cta_bytes`` of dynamic shared memory per CTA (0 on the global route),
    ``storage`` "shared" or "global", ``grid`` CTAs, ``slots`` per
    instance."""

    warps: int
    cta_bytes: int
    storage: str
    grid: int
    slots: int


def launch_plan(fam: MPCFamily, B: int, dtype: torch.dtype) -> LaunchPlan:
    """The launch plan of ``fam`` at B instances of ``dtype``."""
    slots = layout_slots(fam.horizon, fam.nx, fam.nu)
    slab = slots * torch.empty((), dtype=dtype).element_size()
    if slab <= MAX_CTA_SMEM:
        warps = min(WARPS_PER_CTA, MAX_CTA_SMEM // slab)
        storage, cta_bytes = "shared", warps * slab
    else:
        warps, storage, cta_bytes = WARPS_PER_CTA, "global", 0
    return LaunchPlan(warps, cta_bytes, storage, -(-B // warps), slots)


def _scratch(plan: LaunchPlan, B, kw):
    """The global route's (B, slots) scratch, or None on the shared route."""
    return torch.empty((B, plan.slots), **kw) if plan.storage == "global" else None


def _mpc_cuda(fam, x0_t, z0_t, max_iterations, qp_iterations, ls_iterations, debug_history=False):
    """Launch kernel 8 (``csrc/mpc.cu``) on feature-major CUDA tensors; same
    contract as ``_mpc_plain``. Raises on anything the kernel does not take
    and on a refused launch."""
    global KERNEL_LAUNCHES
    plant, consts, cost = _cuda_args(fam)
    budget = _budget_args(max_iterations, qp_iterations, ls_iterations)
    dtype = x0_t.dtype
    B = x0_t.shape[1] if x0_t.dim() == 2 else -1
    _check_cuda_tensors((("x0", x0_t, (fam.nx, B)), ("z0", z0_t, (fam.dim, B))), dtype, x0_t.device, B)
    kw = dict(dtype=dtype, device=x0_t.device)
    z_out = torch.empty((fam.dim, B), **kw)
    stat = torch.empty((3, B), **kw)
    hist = torch.empty((max_iterations, _DBG_CHANNELS, B), **kw) if debug_history else None
    if B == 0:
        return z_out, stat, hist
    lib = _build.load_library()
    plan = launch_plan(fam, B, dtype)
    scratch = _scratch(plan, B, kw)
    with torch.cuda.device(x0_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mo_mpc_launch(
            _CUDA_DTYPE_IDS[dtype], plant, consts, cost, fam.horizon,
            x0_t.data_ptr(), z0_t.data_ptr(), z_out.data_ptr(), stat.data_ptr(),
            hist.data_ptr() if debug_history else None, None if scratch is None else scratch.data_ptr(),
            B, plan.warps, *budget, stream,
        )
    if rc != 0:
        raise RuntimeError(f"mpc kernel launch failed: {_build.error_string(rc)}")
    KERNEL_LAUNCHES += 1
    return z_out, stat, hist


def _mpc_servo_cuda(fam, x_t, z0_t, periods, max_iterations, qp_iterations, ls_iterations):
    """Launch kernel 9 (``csrc/mpc.cu``) on feature-major CUDA tensors; same
    contract as ``_mpc_servo_plain``."""
    global SERVO_LAUNCHES
    plant, consts, cost = _cuda_args(fam)
    budget = _budget_args(max_iterations, qp_iterations, ls_iterations)
    if periods < 0:
        raise ValueError("periods must be >= 0")
    dtype = x_t.dtype
    B = x_t.shape[1] if x_t.dim() == 2 else -1
    _check_cuda_tensors((("x", x_t, (fam.nx, B)), ("z0", z0_t, (fam.dim, B))), dtype, x_t.device, B)
    kw = dict(dtype=dtype, device=x_t.device)
    x_out = torch.empty((fam.nx, B), **kw)
    z_out = torch.empty((fam.dim, B), **kw)
    stats = torch.empty((4, B), **kw)
    if B == 0:
        return x_out, z_out, stats
    lib = _build.load_library()
    plan = launch_plan(fam, B, dtype)
    scratch = _scratch(plan, B, kw)
    with torch.cuda.device(x_t.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mo_mpc_servo_launch(
            _CUDA_DTYPE_IDS[dtype], plant, consts, cost, fam.horizon,
            x_t.data_ptr(), z0_t.data_ptr(), x_out.data_ptr(), z_out.data_ptr(), stats.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, plan.warps, periods, *budget, stream,
        )
    if rc != 0:
        raise RuntimeError(f"mpc servo kernel launch failed: {_build.error_string(rc)}")
    SERVO_LAUNCHES += 1
    return x_out, z_out, stats


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------


def _inputs(family, x_plant, z0, backend, device):
    if backend not in ("pallas", "xla"):
        raise ValueError(f"backend must be 'pallas' or 'xla', not {backend!r}")
    x_t, z_t = convert.to_feature_major(x_plant, z0, device)
    if x_t.shape[0] != family.nx or z_t.shape[0] != family.dim:
        raise ValueError(
            f"expected x_plant (B, {family.nx}) and z0 (B, {family.dim}); got "
            f"{tuple(x_t.T.shape)} and {tuple(z_t.T.shape)}"
        )
    plain = backend == "xla" or x_t.device.type == "cpu"
    if not plain and not x_t.is_cuda:
        raise NotImplementedError(f"no MPC solve for device {x_t.device}")
    return x_t, z_t, plain


def fused_mpc_servo_batch(
    family: MPCFamily,
    x_plant,  # (B, nx)
    z0,  # (B, T*(nu+nx)) warm starts
    periods: int,
    max_iterations: int = 1,
    qp_iterations: int = 1,
    ls_iterations: int = 1,
    backend: str = "pallas",
    device=None,
):
    """Run ``periods`` receding-horizon control periods for B plants in one
    kernel launch. Returns (x_final (B, nx), z_final (B, dim), stats (B, 4)
    = [f_last, |eq|_1_last, sticky flags, max |u_0|]).

    Feed a cold-solved, one-step-advanced state (``fused_mpc_solve_batch``
    at a verification budget, then ``shift_warm_start``): the warm budget
    here assumes near-optimal warm starts. With the default
    ``backend="pallas"`` tensors run where they lie (CPU: the plain version;
    CUDA: the kernel); ``backend="xla"`` runs the plain version on the
    tensors' device. numpy inputs go to ``device``, "cuda" unless the caller
    passes "cpu"."""
    _budget_args(max_iterations, qp_iterations, ls_iterations)
    if periods < 0:
        raise ValueError("periods must be >= 0")
    x_t, z_t, plain = _inputs(family, x_plant, z0, backend, device)
    args = (family, x_t, z_t, periods, max_iterations, qp_iterations, ls_iterations)
    xf, zf, stats = _mpc_servo_plain(*args) if plain else _mpc_servo_cuda(*args)
    return xf.T, zf.T, stats.T


def fused_mpc_solve_batch(
    family: MPCFamily,
    x_plant,  # (B, nx) current plant states
    z0,  # (B, T*(nu+nx)) warm starts (models/mpc.py z layout)
    max_iterations: int = 3,
    qp_iterations: int = 3,
    ls_iterations: int = 2,
    debug_history: bool = False,
    return_state: bool = False,
    backend: str = "pallas",
    unroll: Optional[bool] = None,
    device=None,
):
    """Solve B MPC instances of ``family``: one launch of kernel 8 on the
    card.

    Returns z (B, dim); ``return_state`` appends per-lane (f, |eq|_1, flags)
    (B, 3) for ``fused_termination_status``; ``debug_history`` appends
    (B, max_iterations, 7) per-outer-iteration channels [f, eq, penalty,
    lam, dd, accepted, alpha]. ``unroll`` is the JAX package's compile-size
    switch and changes nothing here; as there, ``debug_history`` needs it
    left at None or True. ``backend`` and ``device`` as for
    ``fused_mpc_servo_batch``."""
    _budget_args(max_iterations, qp_iterations, ls_iterations)
    if debug_history and unroll is False:
        raise ValueError("debug_history requires unroll")
    x_t, z_t, plain = _inputs(family, x_plant, z0, backend, device)
    args = (family, x_t, z_t, max_iterations, qp_iterations, ls_iterations, debug_history)
    z, stat, hist = _mpc_plain(*args) if plain else _mpc_cuda(*args)
    outs = [z.T]
    if return_state:
        outs.append(stat.T)
    if debug_history:
        outs.append(hist.permute(2, 0, 1))
    return tuple(outs) if len(outs) > 1 else outs[0]
