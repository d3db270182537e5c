"""The import guard: no run may load JAX or the JAX package.

Names are compared whole, by the top-level part of each module's name:
``gpudrive_lab_torch`` begins with the JAX package's name and is no
match."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gpudrive_lab_tpu"})


def forbidden_modules(modules) -> list:
    """The loaded module names (keys of ``sys.modules``) whose top-level
    name is forbidden, sorted."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)
