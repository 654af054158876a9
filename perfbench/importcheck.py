"""A static check of what the benchmark's files import, by each imported
module's top-level name (the part before the first dot), compared whole:

- no file under ``perfbench/`` imports ``jax``, ``jaxlib``, ``flax`` or the
  JAX package ``repro`` (``repro_torch`` is another name);
- no file under ``perfbench/reference/`` imports the program,
  ``repro_torch``.

Run: ``python3 perfbench/importcheck.py`` (exit 1 and the offending lines
when either fails).
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PROGRAM = {"repro_torch"}


def imported(path: Path):
    """(line, top-level name) of every import in the file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            yield node.lineno, node.args[0].value.split(".")[0]


def violations(root: Path = HERE):
    out = []
    for path in sorted(root.rglob("*.py")):
        banned = set(FORBIDDEN)
        if "reference" in path.relative_to(root).parts:
            banned |= PROGRAM
        for line, name in imported(path):
            if name in banned:
                out.append(f"{path.relative_to(root.parent)}:{line}: {name}")
    return out


if __name__ == "__main__":
    bad = violations()
    print("\n".join(bad) or "perfbench imports: ok")
    sys.exit(1 if bad else 0)
