"""The run may not have loaded JAX or the JAX package: names compared by
their whole top-level part, since the port's ``repro_torch`` starts with
``repro``."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})
