"""Warm-start / resume surface, the port of ``mini_opt_tpu/utils/checkpoint.py``.

The reference resumes through externally provided iterates
(``InitialGuessMethod::USER_PROVIDED`` + ``SetVariables`` / ``variables()``,
qp.hpp:199-202) and persisted solver-output histories. Here the same surface
is trees of tensors: a (possibly batched) interior-point iterate saved and
loaded with numpy, and any tree of tensors checkpointed with ``torch.save``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def save_warm_start(path: str, x, s=None, y=None, z=None) -> None:
    """Persist a (batched or unbatched) interior-point iterate as a
    compressed npz; feed it back through ``qp_ip_solve(..., x0=..., s0=...,
    y0=..., z0=...)`` with ``InitialGuessMethod.USER_PROVIDED``."""
    arrays = {"x": _host(x)}
    for name, v in (("s", s), ("y", y), ("z", z)):
        if v is not None:
            arrays[name] = _host(v)
    np.savez_compressed(path, **arrays)


def load_warm_start(path: str, device=None) -> Dict[str, torch.Tensor]:
    """The iterate ``save_warm_start`` wrote, as tensors on ``device`` (the
    CPU unless named)."""
    with np.load(path) as data:
        return {k: torch.as_tensor(data[k]).to(device if device is not None else "cpu") for k in data.files}


def save_pytree_orbax(path: str, tree) -> bool:
    """Checkpoint a tree of tensors (dicts, lists, tuples, the solver's
    dataclasses' fields as a dict) to ``path``. The JAX package writes with
    orbax; the port keeps the name and the contract and writes with
    ``torch.save``. Returns True once written."""
    torch.save(_plain(tree), path)
    return True


def load_pytree_orbax(path: str, template=None, device=None):
    """Read what ``save_pytree_orbax`` wrote (``torch.load(weights_only=
    True, map_location=device)``); with a dataclass ``template`` the tree is
    rebuilt as that dataclass."""
    tree = torch.load(path, weights_only=True, map_location=device if device is not None else "cpu")
    return _rebuild(template, tree) if template is not None else tree


def _host(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _plain(tree):
    """Dataclasses as dicts of their fields, recursively (``torch.load``'s
    weights-only reader takes tensors, dicts, lists and tuples)."""
    import dataclasses

    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_plain(v) for v in tree)
    return tree


def _rebuild(template, tree):
    import dataclasses

    if dataclasses.is_dataclass(template):
        return type(template)(**{f.name: _rebuild(getattr(template, f.name), tree[f.name])
                                 for f in dataclasses.fields(template)})
    return tree
