"""Phase labels for profiles, the port's part of
``mini_opt_tpu/utils/tracing.py``: ``annotate`` and ``traced_phase``.

The JAX package pairs a host timer with ``jax.named_scope``; here a phase
is a ``torch.profiler.record_function`` range, so the solver's phases
(linearize, step direction, line search, ...) name their spans in a
``torch.profiler`` trace of the host and the card. Outside a profiler the
range costs one small object per call. The JAX package's chrome-trace
collector and ``device_profile`` are not ported.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label the enclosed work ``name`` in a torch.profiler trace."""
    with torch.profiler.record_function(name):
        yield


def traced_phase(name: str):
    """Decorator form of :func:`annotate`, the analog of the reference's
    ``MINI_OPT_FUNCTION_TRACE()`` at the top of each solver phase."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with annotate(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
