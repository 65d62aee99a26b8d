"""What a run may not load: JAX, or the JAX package the port was made
from. Compared by each module's whole top-level name (the part before
the first dot), since the port's own name, ``repro_torch``, begins with
the JAX package's."""
from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names that ``modules`` (default
    ``sys.modules``) holds."""
    names = sys.modules if modules is None else modules
    tops = {str(n).split(".", 1)[0] for n in names}
    return sorted(t for t in FORBIDDEN if t in tops)
