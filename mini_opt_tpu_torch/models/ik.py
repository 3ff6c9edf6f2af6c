"""Batched transform-chain inverse kinematics on the general solver, the
port of ``mini_opt_tpu/models/ik.py`` (ik.py:28-238).

The reference's actuator-limit IK problem (its nonlinear_test.cc:828-960):
a planar chain of Z-rotation actuators whose effector must reach a target,
with a nonlinear equality constraint on x, a soft cost on y and optional
joint-limit box constraints, solved for a whole batch of targets by
``nls_solve``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nonlinear import NLSParams, Problem
from ..parallel.batch import solve_batch
from ..qp import Var
from ..residual import make_residual
from ..structs import LineSearchStrategy, NLSResult
from ..utils import so3
from .chains import ActuatorChain, ActuatorLink, Pose


def make_planar_chain(n_active: int = 2, link_length: float = 0.4, dtype=torch.float32, device=None) -> ActuatorChain:
    """A chain of ``n_active`` Z-rotation actuators plus a fixed end link
    (the reference's two-angle chain for n_active=2)."""
    mask = (0, 0, 1, 0, 0, 0)
    off = (0, 0, 0, 0, 0, 0)
    kw = dict(dtype=dtype, device=device)
    qi = so3.quat_identity(dtype, device)
    step = torch.tensor([link_length, 0.0, 0.0], **kw)
    links = [ActuatorLink.create(Pose(qi, torch.zeros(3, **kw)), mask)]
    for _ in range(n_active - 1):
        links.append(ActuatorLink.create(Pose(qi, step), mask))
    links.append(ActuatorLink.create(Pose(qi, step), off))
    return ActuatorChain(links=tuple(links))


def mod_pi_retraction(x, dx, alpha):
    """Angle-wrapping retraction of one instance (nonlinear_test.cc:869-874)."""
    return so3.mod_pi(x + dx * alpha)


def make_ik_problem(
    chain: ActuatorChain, target_xy, with_joint_limits: bool = True, joint_limit: float = 3.14159265
) -> Problem:
    """The reference IK problem of ONE instance: a soft cost pins effector y,
    an equality constraint pins effector x, and optional joint-limit box
    constraints hold every non-leading joint in [0, joint_limit]."""
    P = chain.total_active

    def y_res(params):
        st = chain.update(params)
        return torch.stack([st.translation[1] - target_xy[1]]), st.translation_D_params[1:2, :]

    def x_eq(params):
        st = chain.update(params)
        return torch.stack([st.translation[0] - target_xy[0]]), st.translation_D_params[0:1, :]

    ineq = ()
    if with_joint_limits:
        ineq = tuple(c for i in range(1, P) for c in (Var(i) >= 0.0, Var(i) <= joint_limit))
    def y_value(params):
        return torch.stack([chain.effector(params).translation[1] - target_xy[1]])

    def x_value(params):
        return torch.stack([chain.effector(params).translation[0] - target_xy[0]])

    idx = list(range(P))
    return Problem(
        dimension=P,
        costs=(make_residual(idx, y_value, 1, jac=y_res),),
        equality_constraints=(make_residual(idx, x_value, 1, jac=x_eq),),
        inequality_constraints=ineq,
    )


def default_ik_params(dtype=torch.float32, max_iterations: int = 12, max_qp_iterations: int = 6) -> NLSParams:
    """Practical tolerances for the float32 throughput path; float64 uses
    the tighter reference tolerances (ik.py:190-216)."""
    f32 = dtype == torch.float32
    return NLSParams(
        max_iterations=max_iterations,
        max_qp_iterations=max_qp_iterations,
        relative_exit_tol=1e-6 if f32 else 1e-12,
        absolute_first_derivative_tol=1e-6 if f32 else 1e-10,
        absolute_exit_tol=1e-7 if f32 else 1e-9,
        termination_kkt_tolerance=1e-5 if f32 else 1e-6,
        max_line_search_iterations=10,
        equality_penalty_initial=0.01,
        line_search_strategy=LineSearchStrategy.ARMIJO_BACKTRACK,
        lambda_failure_init=0.001,
        armijo_search_tau=0.5,
        lambda_initial=0.001,
        min_lambda=1e-9,
        kkt_solver="auto",
    )


def solve_ik_batch(
    targets,  # (B, 2)
    x0,  # (B, P)
    chain: Optional[ActuatorChain] = None,
    params: Optional[NLSParams] = None,
    with_joint_limits: bool = True,
    device=None,
) -> NLSResult:
    """Solve B independent IK instances in one batched call. Numpy inputs go
    to ``device`` ("cuda" unless the caller names one); tensors run where
    they lie. The targets are cast to x0's dtype, the chain to x0's device
    and dtype."""
    from ..nonlinear import _as_batch

    x0, targets = _as_batch(x0, targets, device)
    dtype = x0.dtype
    targets = targets.to(dtype)
    if chain is None:
        chain = make_planar_chain(n_active=x0.shape[-1], dtype=dtype, device=x0.device)
    else:
        chain = chain.to(x0.device, dtype)
    if params is None:
        params = default_ik_params(dtype)

    def problem_fn(target):
        return make_ik_problem(chain, target, with_joint_limits)

    return solve_batch(problem_fn, params, x0, targets, retraction=mod_pi_retraction)

