"""The import guard: JAX, its libraries and the JAX package must not be
loaded by anything the benchmark runs, and the reference must not load the
port.  Names are compared by their top-level package (the part before the
first dot), whole: ``bp_from_video_tpu_torch`` is not
``bp_from_video_tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "bp_from_video_tpu")
PORT = "bp_from_video_tpu_torch"


def loaded(names=FORBIDDEN, modules=None) -> list[str]:
    """The modules of ``modules`` (default ``sys.modules``) whose top-level
    name is one of ``names``."""
    mods = sys.modules if modules is None else modules
    top = set(names)
    return sorted(m for m in mods if m.split(".", 1)[0] in top)


def check(where: str, names=FORBIDDEN) -> None:
    """Raise naming what is loaded, if anything of ``names`` is."""
    bad = loaded(names)
    if bad:
        raise ImportError(f"{where}: forbidden modules loaded: "
                          f"{', '.join(bad[:20])}")
