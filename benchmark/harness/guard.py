"""What a run's process may not hold: JAX or the JAX package."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "epivo_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Modules whose top-level name (the part before the first dot) is a
    forbidden name, compared whole: ``epivo_tpu_torch`` is not
    ``epivo_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
