"""Serialization of solver outputs: JSON and npz round trips, the port of
``mini_opt_tpu/utils/serialization.py``.

The JSON document of one lane's ``NLSResult`` (its nested iteration,
line-search, QP and eigenvalue records; enum names as strings) is the JAX
package's key for key, so a file written by either package loads in the
other. The npz file holds a whole batch's stacked arrays, one ``leaf_<i>``
per leaf in the dataclasses' field order (the JAX package's pytree order,
so each package reads the other's leaves), with the leaves' dotted paths
under ``__fields__`` to check on load. ``load_*`` put the tensors on
``device`` (the CPU unless named).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

import numpy as np
import torch

from ..structs import (
    Errors,
    NLSIterationHistory,
    NLSResult,
    NLSTerminationState,
    OptimizerState,
    QPNullSpaceTerminationState,
    QPSolverVariant,
    QPTerminationState,
    StepSizeSelectionResult,
    tree_map,
)


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _kkt_row(k, i, j):
    return {
        "r_dual": float(k.r_dual[i, j]),
        "r_comp": float(k.r_comp[i, j]),
        "r_primal_eq": float(k.r_primal_eq[i, j]),
        "r_primal_ineq": float(k.r_primal_ineq[i, j]),
    }


def _qp_iterations_to_json(qh, i, n_qp):
    """The nested per-QP-iteration records of outer iteration ``i``
    (QPInteriorPointIteration, serialization.cc:98-124)."""
    return [
        {
            "kkt_initial": _kkt_row(qh.kkt_initial, i, j),
            "kkt_final": _kkt_row(qh.kkt_final, i, j),
            "mu": float(qh.mu[i, j]),
            "alpha": {"primal": float(qh.alpha.primal[i, j]), "dual": float(qh.alpha.dual[i, j])},
            "alpha_probe": {"primal": float(qh.alpha_probe.primal[i, j]), "dual": float(qh.alpha_probe.dual[i, j])},
            "mu_affine": float(qh.mu_affine[i, j]),
        }
        for j in range(n_qp)
    ]


def nls_result_to_json(result: NLSResult) -> Dict[str, Any]:
    """ONE lane's ``NLSResult`` (``tree_map(lambda t: t[i], batched)``) as a
    JSON-able dict: iteration rows truncated to the executed count, enums as
    names (serialization.cc:32-77), the JAX package's keys."""
    r = _np(result)
    n = int(r.num_iterations)
    it = r.iterations
    with_ev = it.qp_eigenvalues.min.shape[0] > 0
    variant = QPSolverVariant(int(r.solver_variant))
    with_qp_hist = variant == QPSolverVariant.INTERIOR_POINT and it.qp_iterations.mu.shape[-1] > 0
    iterations = []
    for i in range(n):
        nsteps = int(it.line_search.num_steps[i])
        row_ev = (
            {
                "qp_eigenvalues": {
                    "min": float(it.qp_eigenvalues.min[i]),
                    "max": float(it.qp_eigenvalues.max[i]),
                    "abs_min": float(it.qp_eigenvalues.abs_min[i]),
                }
            }
            if with_ev
            else {}
        )
        if variant == QPSolverVariant.NULL_SPACE:
            # A discriminated union by key (serialization.cc:79-91).
            qp_part = {
                "qp_null_space_termination_state": QPNullSpaceTerminationState(int(it.qp_termination_state[i])).name
            }
        else:
            qp_part = {
                "qp_outputs": {
                    "termination_state": QPTerminationState(int(it.qp_termination_state[i])).name,
                    "num_iterations": int(it.qp_num_iterations[i]),
                    "kkt_final_max": float(it.qp_kkt_final_max[i]),
                    "iterations": (
                        _qp_iterations_to_json(it.qp_iterations, i, int(it.qp_num_iterations[i]))
                        if with_qp_hist
                        else []
                    ),
                }
            }
        iterations.append(
            {
                **row_ev,
                "iteration": i,
                "optimizer_state": OptimizerState(int(it.optimizer_state[i])).name,
                "lambda": float(it.lam[i]),
                "errors_initial": {"f": float(it.errors_initial.f[i]), "equality": float(it.errors_initial.equality[i])},
                "directional_derivatives": {
                    "d_f": float(it.directional_derivatives.d_f[i]),
                    "d_equality": float(it.directional_derivatives.d_equality[i]),
                },
                "penalty": float(it.penalty[i]),
                "step_result": StepSizeSelectionResult(int(it.step_result[i])).name,
                **qp_part,
                "line_search_steps": [
                    {
                        "alpha": float(it.line_search.alpha[i, j]),
                        "f": float(it.line_search.f[i, j]),
                        "equality": float(it.line_search.equality[i, j]),
                    }
                    for j in range(nsteps)
                ],
            }
        )
    return {
        "termination_state": NLSTerminationState(int(r.termination_state)).name,
        "num_iterations": n,
        "x": r.x.tolist(),
        "errors": {"f": float(r.errors.f), "equality": float(r.errors.equality)},
        "solver_variant": variant.name,
        "iterations": iterations,
        "_shape": {
            "max_iterations": int(it.lam.shape[0]),
            "max_line_search_steps": int(it.line_search.alpha.shape[1]),
            "max_qp_iterations": int(it.qp_iterations.mu.shape[-1]),
            "dtype": str(r.x.dtype),
            "with_eigenvalues": bool(with_ev),
        },
    }


def nls_result_from_json(doc: Dict[str, Any], device=None) -> NLSResult:
    """Inverse of ``nls_result_to_json``: one lane's fixed-shape
    ``NLSResult`` on ``device`` (rows past num_iterations zero, as the solver
    leaves them)."""
    shape = doc["_shape"]
    dtype = getattr(torch, shape["dtype"])
    variant = QPSolverVariant[doc.get("solver_variant", "INTERIOR_POINT")]
    hist = NLSIterationHistory.empty(
        1, shape["max_iterations"], shape["max_line_search_steps"], dtype, "cpu",
        max_qp_iterations=shape.get("max_qp_iterations", 0),
        with_eigenvalues=shape.get("with_eigenvalues", False),
    )
    hist = tree_map(lambda t: t[0].clone(), hist)
    for row in doc["iterations"]:
        i = row["iteration"]
        hist.optimizer_state[i] = OptimizerState[row["optimizer_state"]]
        hist.lam[i] = row["lambda"]
        hist.errors_initial.f[i] = row["errors_initial"]["f"]
        hist.errors_initial.equality[i] = row["errors_initial"]["equality"]
        hist.directional_derivatives.d_f[i] = row["directional_derivatives"]["d_f"]
        hist.directional_derivatives.d_equality[i] = row["directional_derivatives"]["d_equality"]
        hist.penalty[i] = row["penalty"]
        hist.step_result[i] = StepSizeSelectionResult[row["step_result"]]
        if "qp_null_space_termination_state" in row:
            hist.qp_termination_state[i] = QPNullSpaceTerminationState[row["qp_null_space_termination_state"]]
        else:
            qp = row["qp_outputs"]
            hist.qp_termination_state[i] = QPTerminationState[qp["termination_state"]]
            hist.qp_num_iterations[i] = qp["num_iterations"]
            hist.qp_kkt_final_max[i] = qp["kkt_final_max"]
            qh = hist.qp_iterations
            for j, q in enumerate(qp["iterations"]):
                for name in ("kkt_initial", "kkt_final"):
                    dst = getattr(qh, name)
                    for f in ("r_dual", "r_comp", "r_primal_eq", "r_primal_ineq"):
                        getattr(dst, f)[i, j] = q[name][f]
                qh.mu[i, j] = q["mu"]
                qh.alpha.primal[i, j] = q["alpha"]["primal"]
                qh.alpha.dual[i, j] = q["alpha"]["dual"]
                qh.alpha_probe.primal[i, j] = q["alpha_probe"]["primal"]
                qh.alpha_probe.dual[i, j] = q["alpha_probe"]["dual"]
                qh.mu_affine[i, j] = q["mu_affine"]
        if "qp_eigenvalues" in row:
            hist.qp_eigenvalues.min[i] = row["qp_eigenvalues"]["min"]
            hist.qp_eigenvalues.max[i] = row["qp_eigenvalues"]["max"]
            hist.qp_eigenvalues.abs_min[i] = row["qp_eigenvalues"]["abs_min"]
        hist.line_search.num_steps[i] = len(row["line_search_steps"])
        for j, step in enumerate(row["line_search_steps"]):
            hist.line_search.alpha[i, j] = step["alpha"]
            hist.line_search.f[i, j] = step["f"]
            hist.line_search.equality[i, j] = step["equality"]

    kw = dict(device=device if device is not None else "cpu")
    i32 = dict(dtype=torch.int32, **kw)
    return NLSResult(
        termination_state=torch.tensor(int(NLSTerminationState[doc["termination_state"]]), **i32),
        num_iterations=torch.tensor(doc["num_iterations"], **i32),
        x=torch.tensor(doc["x"], dtype=dtype, **kw),
        errors=Errors(torch.tensor(doc["errors"]["f"], dtype=dtype, **kw),
                      torch.tensor(doc["errors"]["equality"], dtype=dtype, **kw)),
        iterations=tree_map(lambda t: t.to(**kw), hist),
        solver_variant=torch.tensor(int(variant), **i32),
    )


def save_result_json(path: str, result: NLSResult) -> None:
    """Write one lane's result as ``nls_result_to_json``'s document."""
    with open(path, "w") as f:
        json.dump(nls_result_to_json(result), f, indent=1)


def load_result_json(path: str, device=None) -> NLSResult:
    with open(path) as f:
        return nls_result_from_json(json.load(f), device)


# ---------------------------------------------------------------------------
# The npz round trip of whole (batched) results.
# ---------------------------------------------------------------------------


def _field_paths(tree, prefix="") -> List[str]:
    """Dotted paths of a dataclass tree's leaves, in ``tree_map``'s order."""
    if dataclasses.is_dataclass(tree):
        return [p for f in dataclasses.fields(tree)
                for p in _field_paths(getattr(tree, f.name), f"{prefix}{f.name}.")]
    return [prefix[:-1]]


def _template() -> NLSResult:
    z = torch.zeros(())
    return NLSResult(
        termination_state=z, num_iterations=z, x=z, errors=Errors(z, z),
        iterations=NLSIterationHistory.empty(0, 0, 0), solver_variant=z,
    )


def save_result_npz(path: str, result: NLSResult) -> None:
    """Save a batched (or one lane's) ``NLSResult`` as one compressed npz:
    ``leaf_<i>`` in field order, the leaves' paths under ``__fields__``."""
    leaves = []
    tree_map(lambda t: leaves.append(t.detach().cpu().numpy()) or t, result)
    fields = "\n".join(_field_paths(result))
    np.savez_compressed(
        path, __fields__=np.frombuffer(fields.encode(), np.uint8), **{f"leaf_{i}": a for i, a in enumerate(leaves)}
    )


def load_result_npz(path: str, device=None) -> NLSResult:
    """Inverse of ``save_result_npz`` (a JAX package's file too: its leaves
    come in the same order), the tensors on ``device``."""
    template = _template()
    want = _field_paths(template)
    with np.load(path) as data:
        if "__fields__" in data:
            stored = bytes(data["__fields__"]).decode().split("\n")
            if stored != want:
                raise ValueError(f"npz fields do not match the current NLSResult structure (stored {stored!r})")
        leaves = iter([data[f"leaf_{i}"] for i in range(len(want))])
    dev = device if device is not None else "cpu"
    return tree_map(lambda _: torch.as_tensor(next(leaves)).to(dev), template)
