"""The check that no JAX, and nothing of the JAX package, is loaded. The
port's name begins with the JAX package's, so names are compared whole, by
their top-level part."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "test_isaacgym_tpu"})


def forbidden_loaded(modules=None):
    """The names in `modules` (default sys.modules) whose top-level part is
    forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
