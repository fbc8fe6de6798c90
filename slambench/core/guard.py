"""What the benchmark may not load: JAX, its libraries, and the JAX package
that the port was made from. Names are compared whole, by the part before
the first dot (the port's own name begins with the JAX package's)."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax",
                       "semantic_slam_mapping_tpu"})
PORT = "semantic_slam_mapping_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level name
    is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def imported_top_levels(path: Path) -> set:
    """Top-level names of the modules a source file imports, as written in
    its ``import`` and ``from ... import`` statements (relative imports
    left out)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(top_level(node.module))
    return out
