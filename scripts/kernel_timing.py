"""Set-up shared by ``scripts/*_kernel_times.py``: the ``--tree`` and
``--label`` options, the import of ``mini_opt_tpu_torch`` from that tree,
``chip_smoke.py``'s timer from this checkout, the card's name and power
limit, and a build of only some of the tree's ``csrc/*.cu``. Not a script of
its own."""

import ctypes
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def add_tree_args(ap):
    """The options every timing script takes: the tree to time and the name
    printed with its rows."""
    ap.add_argument("--tree", default=str(ROOT), help="root of the tree to time")
    ap.add_argument("--label", default=None, help="name printed with each row (default: the tree)")


def open_tree(script, args):
    """Import ``mini_opt_tpu_torch`` from ``args.tree`` and load the timer.
    Exits non-zero without a CUDA card or when the package comes from
    elsewhere. Prints the card's name and power limit (``nvidia-smi``) and
    returns ``(timer, card, row)``: ``chip_smoke.py`` of this checkout as a
    module, that line, and a function that prints one JSON row with the
    tree's label and the card."""
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        sys.exit(f"{script}: torch.cuda.is_available() is False")
    import mini_opt_tpu_torch

    if Path(mini_opt_tpu_torch.__file__).resolve().parents[1] != tree:
        sys.exit(f"{script}: imported {mini_opt_tpu_torch.__file__}, not the tree {tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke_timer", ROOT / "chip_smoke.py")
    timer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timer)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    label = args.label or str(tree)

    def row(**kw):
        print(json.dumps(dict(tree=label, card=card, **kw)), flush=True)

    return timer, card, row


class _PartialLibrary(ctypes.CDLL):
    """A library with only some of the port's entry points: the names it
    lacks absorb the argtypes the loader sets on them."""

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return types.SimpleNamespace()


def bind_subset(build, sources):
    """Build and load only the ``csrc`` files named in ``sources`` through
    the tree's ``_build``; the other entry points are left unbound."""
    build._cu_sources = lambda: sorted(p for p in build.CSRC.glob("*.cu") if p.name in sources)
    saved = ctypes.CDLL
    ctypes.CDLL = _PartialLibrary
    try:
        build.load_library()
    finally:
        ctypes.CDLL = saved
