"""Import guards: the reference under reference/ imports nothing of the
program, of the JAX package or of JAX (a static look at its sources and
a look at its modules after set-up), and the process that prints the
result has loaded none of JAX, jaxlib, flax or the JAX package. Names
are compared by their whole top-level part: adgs_tpu_torch begins with
adgs_tpu and is not it."""

from __future__ import annotations

import ast
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "adgs_tpu"}
NOT_IN_REFERENCE = FORBIDDEN | {"adgs_tpu_torch"}
# what the reference may import by absolute name
REFERENCE_MAY_IMPORT = {"__future__", "contextlib", "dataclasses",
                        "functools", "math", "random", "typing", "numpy",
                        "scipy", "torch"}
# the benchmark's modules outside reference/ that it may import: the
# inputs, the render capture and the readings of a training check, which
# import only what it may
SHARED = ("scene", "capture", "readings")


def top(name: str) -> str:
    return name.split(".")[0]


def reference_import_faults(root: Path = HERE) -> list:
    """Absolute imports of the reference's sources (and of SHARED)
    outside REFERENCE_MAY_IMPORT, and relative imports that leave
    reference/ for anything but SHARED."""
    faults = []
    ref = root / "reference"
    files = sorted(ref.rglob("*.py")) + [root / f"{m}.py" for m in SHARED]
    for path in files:
        # a relative import of a level above this leaves reference/
        inside = (len(path.relative_to(ref).parts)
                  if ref in path.parents else 0)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.ImportFrom):
                if node.level <= inside:
                    continue
                leaves = ([node.module] if node.module
                          else [a.name for a in node.names])
                if (node.level > inside + 1
                        or any(n not in SHARED for n in leaves)):
                    faults.append(f"{path.relative_to(root)}: from "
                                  f"{'.' * node.level}{node.module or ''} "
                                  "leaves the reference for more than "
                                  f"{', '.join(SHARED)}")
                continue
            else:
                continue
            for n in names:
                if top(n) not in REFERENCE_MAY_IMPORT:
                    faults.append(f"{path.relative_to(root)}: import {n}")
    return faults


def reference_leaks() -> list:
    """Objects of the program, the JAX package or JAX held in the globals
    of a loaded reference module."""
    out = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("port_bench.reference") or mod is None:
            continue
        for key, value in vars(mod).items():
            origin = (value.__name__ if isinstance(value, types.ModuleType)
                      else getattr(value, "__module__", None))
            if isinstance(origin, str) and top(origin) in NOT_IN_REFERENCE:
                out.append(f"{name}.{key} comes from {origin}")
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or
    adgs_tpu."""
    found = sorted({top(m) for m in sys.modules} & FORBIDDEN)
    return [f"module {m} is loaded" for m in found]
