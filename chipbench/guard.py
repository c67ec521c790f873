"""The import guard: a run may load neither JAX nor the JAX package
``repro``.  Names are compared by their top-level part (before the first
dot) as a whole, so ``repro_torch`` passes and ``repro.core`` does not."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is
    forbidden, sorted."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check(where: str) -> None:
    """Exit with code 3, naming what was found on standard error, when a
    forbidden module is loaded; say that none is otherwise."""
    found = forbidden_modules()
    if found:
        print(f"chipbench guard ({where}): forbidden modules loaded: "
              f"{', '.join(found[:20])}", file=sys.stderr)
        sys.exit(3)
    print(f"chipbench guard ({where}): no jax, jaxlib, flax or repro module "
          f"loaded", file=sys.stderr)
