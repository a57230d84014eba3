"""The modules a run of the port's benchmark may never load: JAX and the
JAX package. Compared by whole top-level names, since the port's package
name, dpdist_tpu_torch, begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "dpdist_tpu")


def forbidden_loaded(modules=None) -> list:
    """The loaded modules (sys.modules by default) whose top-level name is
    a forbidden one, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
