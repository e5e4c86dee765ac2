"""PI001 — one-writer ownership of index state.

Counterpart of ``repro.analysis.rules_ownership``.  The paper's
latch-free protocol ("each list node that will be modified ... will be
accessed by exactly one thread") maps here to: every ``PIIndex`` /
``ShardedPIIndex`` leaf is written only inside the sanctioned ``core``
modules, and everyone else routes mutation through ``execute`` /
``rebuild`` / ``repack`` / ``Dispatcher``.  The JAX package's three
shapes of bypass are flagged outside the owner modules:

* ``obj.<leaf>.at[...].set(...)``-style scatter writes,
* direct stores ``obj.<leaf> = ...`` / ``obj.<leaf>[i] = ...``,
* reaching for the private rebuild internals (``_rebuild_repack`` & co),
  whether by attribute or by import;

and torch's own two ways of writing a tensor in place:

* an in-place method on a leaf, ``obj.<leaf>.copy_(...)``,
  ``obj.<leaf>[i].fill_(...)`` (any ``<name>_``),
* a leaf as an ``out=`` argument, ``torch.add(a, b, out=obj.<leaf>)``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.rules import Rule, register

_AT_MUTATORS = frozenset({"set", "add", "multiply", "divide", "power",
                          "min", "max", "apply"})


def is_inplace_name(name: str) -> bool:
    """torch's in-place naming: ``add_``, ``index_put_``, not ``_x_``."""
    return len(name) > 1 and name.endswith("_") and not name.startswith("_")


def _leaf_of_target(node: ast.expr, leaves) -> str:
    """Leaf name when ``node`` stores to ``obj.<leaf>`` or ``obj.<leaf>[...]``."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute) and node.attr in leaves:
        return node.attr
    return ""


def _leaf_of_at_call(call: ast.Call, leaves) -> str:
    """Leaf name when ``call`` is ``obj.<leaf>.at[...].<mutator>(...)``."""
    func = call.func
    if not (isinstance(func, ast.Attribute) and func.attr in _AT_MUTATORS):
        return ""
    sub = func.value
    if not isinstance(sub, ast.Subscript):
        return ""
    at = sub.value
    if not (isinstance(at, ast.Attribute) and at.attr == "at"):
        return ""
    owner = at.value
    if isinstance(owner, ast.Attribute) and owner.attr in leaves:
        return owner.attr
    return ""


def _leaf_of_inplace_call(call: ast.Call, leaves) -> str:
    """Leaf name when ``call`` is ``obj.<leaf>[...].<name>_(...)``."""
    func = call.func
    if isinstance(func, ast.Attribute) and is_inplace_name(func.attr):
        return _leaf_of_target(func.value, leaves)
    return ""


def _leaf_of_out(call: ast.Call, leaves) -> str:
    """Leaf name when ``call`` passes ``out=obj.<leaf>``."""
    for kw in call.keywords:
        if kw.arg == "out":
            leaf = _leaf_of_target(kw.value, leaves)
            if leaf:
                return leaf
    return ""


@register
class OneWriterRule(Rule):
    id = "PI001"
    title = "one-writer ownership of index state"

    def check(self, ctx, cfg):
        if cfg.owns_index(ctx.rel):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if alias.name in cfg.private_entrypoints:
                        yield node, (
                            f"importing private rebuild internal "
                            f"`{alias.name}`; use the sanctioned entry "
                            f"points (execute/rebuild/repack/Dispatcher)")
            elif isinstance(node, ast.Attribute):
                if node.attr in cfg.private_entrypoints:
                    yield node, (
                        f"`{node.attr}` is a private rebuild internal; "
                        f"use the sanctioned entry points "
                        f"(execute/rebuild/repack/Dispatcher)")
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for target in targets:
                    leaf = _leaf_of_target(target, cfg.index_leaves)
                    if leaf:
                        yield target, (
                            f"direct store to index leaf `.{leaf}` outside "
                            f"the ownership API — index state has exactly "
                            f"one writer (core execute/rebuild)")
            elif isinstance(node, ast.Call):
                leaf = _leaf_of_at_call(node, cfg.index_leaves)
                if leaf:
                    yield node, (
                        f"`.at[...]` write to index leaf `.{leaf}` outside "
                        f"core — slot scatters belong to the one-writer "
                        f"execute/rebuild paths")
                    continue
                leaf = _leaf_of_inplace_call(node, cfg.index_leaves)
                if leaf:
                    yield node, (
                        f"in-place `.{node.func.attr}()` on index leaf "
                        f"`.{leaf}` outside core — index state has exactly "
                        f"one writer (core execute/rebuild)")
                    continue
                leaf = _leaf_of_out(node, cfg.index_leaves)
                if leaf:
                    yield node, (
                        f"`out=` writes into index leaf `.{leaf}` outside "
                        f"core — index state has exactly one writer (core "
                        f"execute/rebuild)")
