"""PI002 host round-trips and PI003 in-place writes to inputs.

Counterpart of ``repro.analysis.rules_tracing``, restated for eager
PyTorch, where nothing is traced or donated.

PI002 guards the one-launch-a-window contract (``launch_guard`` is its
runtime half).  A host read inside a device scope retraces nothing here:
it syncs the stream and stalls the enqueue that ``Dispatcher(depth=...)``
pipelines.  Inside a device scope it flags ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``np.asarray``/``np.array`` and
``torch.cuda.synchronize()``; ``float()``/``int()``/``bool()`` of
anything but a static value (the cast is itself the host read, so a
local is flagged as well as a parameter); and a Python ``if``/``while``
whose test reads a non-static parameter, which makes the same implicit
sync.  A parameter is static when every use in the expression goes
through ``.shape`` / ``.ndim`` / ``.dtype`` / ``.size`` / ``.device`` /
``.config`` / ``.cfg`` or ``numel()`` or is an operand of ``is`` /
``is not``, or when the scope names it static.
The check is first-order (the tests of ``if``/``while`` chase no locals,
and no scope's callees are followed); the runtime guards backstop the
rest.

PI003 guards the dispatcher's reads of the pre-window state: breaker
rollback reads it, and ranges are enqueued before the point execute,
which is sound only because the point execute never writes to its input
index.  Inside the index's device scopes (``core/``, ``pipeline/``,
``kernels/ops.py``) it flags an in-place write to an input: an in-place
method (``x.add_(...)``, ``torch.add_(x, ...)``), a subscript store
(``x[...] = ...``, ``x.attr[...] = ...``) or ``out=x``, where ``x`` is a
parameter or an attribute chain rooted at one (``self`` excepted).  The
LM steps are not index scopes: the decode step writes its cache in place
by design.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.rules import Rule, register
from repro_torch.analysis.rules_ownership import is_inplace_name
from repro_torch.analysis.walker import callee_name, param_names

_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "device",
                           "config", "cfg"})
_STATIC_METHODS = frozenset({"numel"})
_HOST_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_NP_MATERIALIZERS = frozenset({"np.asarray", "np.array", "numpy.asarray",
                               "numpy.array"})
_SYNCS = frozenset({"torch.cuda.synchronize", "cuda.synchronize"})
_HOST_CASTS = frozenset({"float", "int", "bool"})


def _reads_value(expr: ast.expr, names, ctx) -> bool:
    """True when ``expr`` reads one of ``names`` *as a value* (not just
    its static metadata)."""
    for node in ast.walk(expr):
        if not (isinstance(node, ast.Name) and node.id in names
                and isinstance(node.ctx, ast.Load)):
            continue
        cur = node
        static = False
        while True:
            parent = ctx.parents.get(cur)
            if isinstance(parent, ast.Attribute) and parent.value is cur:
                if parent.attr in _STATIC_ATTRS:
                    static = True
                    break
                if (parent.attr in _STATIC_METHODS
                        and isinstance(ctx.parents.get(parent), ast.Call)):
                    static = True
                    break
                cur = parent
            elif isinstance(parent, ast.Subscript) and parent.value is cur:
                cur = parent
            else:
                # ``x is None`` compares identities: it reads no value
                static = (isinstance(parent, ast.Compare)
                          and all(isinstance(op, (ast.Is, ast.IsNot))
                                  for op in parent.ops))
                break
        if not static:
            return True
    return False


def _locals_of(fn) -> set:
    """Names bound inside ``fn`` (its own body, nested functions too)."""
    return {n.id for n in ast.walk(fn)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)}


@register
class HostReadRule(Rule):
    id = "PI002"
    title = "host round-trip inside a device scope"

    def check(self, ctx, cfg):
        for fn, statics in ctx.device_functions.items():
            data_params = {p for p in param_names(fn)
                           if p not in statics and p != "self"}
            values = (data_params | _locals_of(fn)) - statics
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    func = node.func
                    name = callee_name(func)
                    if (isinstance(func, ast.Attribute)
                            and func.attr in _HOST_METHODS):
                        yield node, (
                            f".{func.attr}() inside a device scope — a host "
                            f"round-trip that syncs the stream; keep the "
                            f"value on the device or read it outside the "
                            f"window's work")
                    elif name in _NP_MATERIALIZERS:
                        yield node, (
                            f"{name}() inside a device scope copies a "
                            f"device value to the host and syncs the "
                            f"stream; use torch ops on the device instead")
                    elif name in _SYNCS:
                        yield node, (
                            "torch.cuda.synchronize() inside a device scope "
                            "— the host waits for the card and the next "
                            "window's enqueue stalls")
                    elif (name in _HOST_CASTS and node.args
                          and _reads_value(node.args[0], values, ctx)):
                        yield node, (
                            f"{name}() of a device value inside a device "
                            f"scope — a host scalar syncs the stream and "
                            f"stalls the pipelined enqueue; keep it a "
                            f"tensor or pass it as a host value")
                elif isinstance(node, (ast.If, ast.While)):
                    if _reads_value(node.test, data_params, ctx):
                        yield node, (
                            "Python control flow on a device value — the "
                            "implicit bool() syncs the stream; use "
                            "torch.where or decide on the host before the "
                            "window")


def _root_param(node: ast.expr, params) -> str:
    """The parameter an attribute/subscript chain is rooted at, else ''."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    if isinstance(node, ast.Name) and node.id in params:
        return node.id
    return ""


@register
class InputWriteRule(Rule):
    id = "PI003"
    title = "in-place write to an input of an index scope"

    def check(self, ctx, cfg):
        if not cfg.in_index_scope(ctx.rel):
            return
        for fn, statics in ctx.device_functions.items():
            params = {p for p in param_names(fn)
                      if p not in statics and p != "self"}
            for node in ast.walk(fn):
                root = ""
                if isinstance(node, ast.Call):
                    func = node.func
                    if (isinstance(func, ast.Attribute)
                            and is_inplace_name(func.attr)):
                        root = _root_param(func.value, params)
                        if (not root and callee_name(func).startswith(
                                "torch.") and node.args):
                            root = _root_param(node.args[0], params)
                    for kw in node.keywords:
                        if kw.arg == "out" and not root:
                            root = _root_param(kw.value, params)
                elif isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    for target in targets:
                        if isinstance(target, ast.Subscript):
                            root = root or _root_param(target, params)
                if root:
                    yield node, (
                        f"in-place write to input `{root}` inside "
                        f"`{fn.name}` — the dispatcher reads the "
                        f"pre-window state (breaker rollback, ranges "
                        f"enqueued before the execute); write a new "
                        f"tensor instead")
