"""PI006 — fault-point coverage of the durability tier.

Counterpart of ``repro.analysis.rules_faults``, over
``repro_torch.faults.FAULT_POINTS`` (the same five names).  The crash
suite can only prove recovery from the torn states it can reach, and it
reaches them by raising out of ``repro_torch.faults.faultpoint(name)``
calls.  Two ways to silently lose that coverage are flagged:

* a durable-I/O effect (``write`` / ``flush`` / ``fsync`` / ``rename``
  / ``replace`` / ``savez``) in ``pipeline/wal.py`` or ``checkpoint.py``
  inside a function with no registered fault point — a crash there is a
  state the suite never exercises;
* a ``faultpoint("...")`` call whose name is not registered in
  ``faults.FAULT_POINTS`` — the matrix parametrizes over the registry,
  so an unregistered name is dead coverage that looks alive.

Granularity is the enclosing function: one registered point per
I/O-performing function keeps the crash matrix dense without demanding
a point between every pair of syscalls.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.rules import Rule, register
from repro_torch.analysis.walker import callee_name

_FAULTPOINT_CALLEES = frozenset({"faultpoint", "faults.faultpoint"})


def _own_nodes(fn: ast.AST):
    """Walk ``fn`` without descending into nested function definitions."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _faultpoint_name(node: ast.AST):
    """Registered-point literal of a ``faultpoint(...)`` call, else None."""
    if (isinstance(node, ast.Call)
            and callee_name(node.func) in _FAULTPOINT_CALLEES
            and node.args and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)):
        return node.args[0].value
    return None


@register
class FaultCoverageRule(Rule):
    id = "PI006"
    title = "durable I/O outside fault-point coverage"

    def check(self, ctx, cfg):
        registered = frozenset(cfg.fault_points)
        for node in ast.walk(ctx.tree):
            name = _faultpoint_name(node)
            if name is not None and name not in registered:
                yield node, (
                    f"fault point {name!r} is not registered in "
                    f"faults.FAULT_POINTS — the crash matrix iterates the "
                    f"registry, so this site is never driven")
        if not cfg.is_fault_file(ctx.rel):
            return
        functions = [n for n in ast.walk(ctx.tree)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]
        for fn in functions:
            own = list(_own_nodes(fn))
            covered = any(_faultpoint_name(n) in registered for n in own)
            if covered:
                continue
            for node in own:
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in cfg.io_verbs):
                    yield node, (
                        f"`.{node.func.attr}()` durable-I/O effect with no "
                        f"registered fault point in `{fn.name}` — the "
                        f"crash suite cannot reach this state; add a "
                        f"faultpoint() and register it in "
                        f"faults.FAULT_POINTS")
