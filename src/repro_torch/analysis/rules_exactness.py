"""PI004 float-on-exact and PI005 sentinel hygiene.

Counterpart of ``repro.analysis.rules_exactness``.  PI004 is the
``needs_rebuild`` bug class: a churn threshold computed as
``n * rebuild_frac`` in float32 is wrong past 2^24 occupied slots; the
fix froze the fraction to a /1024 rational and kept everything integer.
The rule flags (a) float division truncated back to an integer
(``int(...)`` / ``round`` / ``ceil`` / ``floor``, torch's included, over
a ``/``) when an operand's name marks an exact domain (keys, seqs,
capacities, thresholds, fences), and (b) ``float()`` casts of such
values.  Deliberately estimative float math (e.g. the rebalancer's
load-CDF interpolation) is suppressed inline with a justification.

PI005 keeps the KSENT family nameable: the max-key sentinel threads
through storage slack, pending padding, fence tops and engine pads, and
grepping for ``sentinel_for`` must find every site.  Inline
``iinfo(...).max`` construction (``torch.iinfo`` and ``np.iinfo`` alike)
and raw ``2147483647``-class literals are flagged outside the modules
that define the symbols (``iinfo(...).min`` is a domain bound, not the
sentinel, and stays legal).
"""
from __future__ import annotations

import ast

from repro_torch.analysis.rules import Rule, register
from repro_torch.analysis.walker import callee_name

_TRUNCATORS = frozenset({
    "int", "round", "np.ceil", "np.floor", "numpy.ceil", "numpy.floor",
    "jnp.ceil", "jnp.floor", "math.ceil", "math.floor",
    "torch.ceil", "torch.floor", "torch.round"})


def _mentions_exact(expr: ast.expr, cfg) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Name) and cfg.is_exact_name(node.id):
            return True
        if isinstance(node, ast.Attribute) and cfg.is_exact_name(node.attr):
            return True
    return False


def _division_on_exact(expr: ast.expr, cfg) -> bool:
    # the whole truncated expression is the unit of exactness: in
    # ``int(batch / S * capacity_factor)`` the marker name sits outside
    # the Div node but the rounding error still lands on the capacity
    has_div = any(isinstance(n, ast.BinOp) and isinstance(n.op, ast.Div)
                  for n in ast.walk(expr))
    return has_div and _mentions_exact(expr, cfg)


@register
class FloatOnExactRule(Rule):
    id = "PI004"
    title = "float arithmetic on exact integer domains"

    def check(self, ctx, cfg):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = callee_name(node.func)
            if name in _TRUNCATORS:
                if _division_on_exact(node.args[0], cfg):
                    yield node, (
                        "float division truncated back to an integer on "
                        "an exact domain (the PR 6 needs_rebuild bug "
                        "class) — use // or a scaled-rational split "
                        "(frac ≈ num/1024)")
            elif name == "float":
                if _mentions_exact(node.args[0], cfg):
                    yield node, (
                        "float() cast of an exact-domain integer — keys, "
                        "seqs, capacities and thresholds must stay "
                        "integer-exact (float32 is wrong past 2^24, "
                        "float64 past 2^53)")


@register
class SentinelRule(Rule):
    id = "PI005"
    title = "inline sentinel construction"

    def check(self, ctx, cfg):
        if cfg.defines_sentinels(ctx.rel):
            return
        for node in ast.walk(ctx.tree):
            if (isinstance(node, ast.Attribute) and node.attr == "max"
                    and isinstance(node.value, ast.Call)
                    and callee_name(node.value.func).endswith("iinfo")):
                yield node, (
                    "inline sentinel construction via iinfo(...).max — "
                    "use sentinel_for(dtype) (kernels.pi_search / "
                    "core.engine) or KSENT_I32 so sentinel sites stay "
                    "greppable")
            elif (isinstance(node, ast.Constant)
                  and type(node.value) is int
                  and node.value in cfg.sentinel_literals):
                yield node, (
                    "raw sentinel literal — compare against the named "
                    "KSENT-family symbol (sentinel_for / KSENT_I32), "
                    "not the magic number")
