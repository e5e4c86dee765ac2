"""Per-file AST context: parents, suppressions, device-scope discovery.

Counterpart of ``repro.analysis.walker``.  The walker is project-aware in
exactly the ways the rules need:

* **Suppressions** — a ``# pilint: disable=PI001,PI004`` comment on the
  physical line a finding is reported on silences those rules there
  (``disable=all`` or ``disable=*`` silences everything on the line).
* **Device scopes** — the functions whose bodies enqueue one window's or
  one step's work on the card.  The JAX package finds its jit scopes by
  ``jax.jit`` syntax; eager PyTorch has no such syntax, so the scopes are
  named by the project (``ProjectConfig.device_scopes``: a path suffix, a
  function name and the parameters that are host values, not tensors)
  and every function of that name in a matching file is one.

Only syntax is consulted: the walker never imports the file it lints.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Set, Tuple

_SUPPRESS_RE = re.compile(r"#\s*pilint:\s*disable=([A-Za-z0-9_*,\s]+)")


def callee_name(node: ast.expr) -> str:
    """Dotted name of a call target ('np.ceil', 'faultpoint', '')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def param_names(fn: ast.FunctionDef) -> List[str]:
    return [a.arg for a in (*fn.args.posonlyargs, *fn.args.args,
                            *fn.args.kwonlyargs)]


class FileContext:
    """Everything the rules need to know about one parsed file.

    ``device_scopes`` is ``ProjectConfig.device_scopes``: ``(path suffix,
    function name, static parameter names)`` triples.
    """

    def __init__(self, path: str, rel: str, source: str,
                 device_scopes: Iterable[Tuple[str, str, Tuple[str, ...]]]
                 = ()):
        self.path = path
        self.rel = rel.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent
        self.suppressions = self._scan_suppressions()
        self.device_functions: Dict[ast.FunctionDef, Set[str]] = {}
        self._discover_scopes(device_scopes)

    # -- suppressions ------------------------------------------------------

    def _scan_suppressions(self) -> Dict[int, Set[str]]:
        out: Dict[int, Set[str]] = {}
        for lineno, text in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(text)
            if m:
                out[lineno] = {r.strip() for r in m.group(1).split(",")
                               if r.strip()}
        return out

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self.suppressions.get(line, ())
        return "all" in rules or "*" in rules or rule in rules

    # -- device-scope discovery --------------------------------------------

    def _discover_scopes(self, device_scopes) -> None:
        wanted: Dict[str, Set[str]] = {}
        for suffix, name, statics in device_scopes:
            if self.rel.endswith(suffix):
                wanted.setdefault(name, set()).update(statics)
        if not wanted:
            return
        for node in ast.walk(self.tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in wanted):
                self.device_functions[node] = set(wanted[node.name])
