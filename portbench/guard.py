"""Keeps JAX and the JAX package out of the benchmark's process.

`install()` puts a finder in front of every other: importing `jax`,
`jaxlib`, `flax` or `bronko_tpu` (or a submodule of one) raises
ImportError. Names are compared whole by their top-level part, so the
port, `bronko_tpu_torch`, is not caught. `loaded()` lists any such
module that is in `sys.modules` all the same.
"""

from __future__ import annotations

import sys

BLOCKED = frozenset({"jax", "jaxlib", "flax", "bronko_tpu"})


class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in the benchmark's process")
        return None


def install() -> None:
    if not any(isinstance(f, _Blocker) for f in sys.meta_path):
        sys.meta_path.insert(0, _Blocker())


def loaded() -> list[str]:
    return sorted(m for m, mod in list(sys.modules.items())
                  if mod is not None and m.partition(".")[0] in BLOCKED)
