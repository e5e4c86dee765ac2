"""Rule base, project knowledge, registry, and the lint entry points.

Counterpart of ``repro.analysis.rules``.  A rule is a class with an
``id``, a ``title`` and a ``check(ctx, cfg)`` generator yielding
``(node, message)`` pairs; ``@register`` puts it in the registry.
``ProjectConfig`` concentrates the repo-specific facts (which attribute
names are index-state leaves, which modules own them, which functions
are device scopes, which files are the durability tier, ...) so fixtures
and future layouts can re-target the same rules without touching their
logic.
"""
from __future__ import annotations

import dataclasses
import os
import posixpath
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.walker import FileContext


def _default_fault_points() -> Tuple[str, ...]:
    from repro_torch.faults import FAULT_POINTS
    return tuple(FAULT_POINTS)


# (path suffix, function, static parameters): the functions that enqueue
# one window's or one step's work.  The first twelve are the JAX
# package's resolved jit scopes (its names without a leading underscore),
# then the train and decode steps, which it jits through a call
# (``jax.jit(make_train_step(...))``), and the decode step's body, where
# the decode position is read.
DEVICE_SCOPES: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = (
    ("core/index.py", "execute_impl", ()),
    ("core/index.py", "rebuild", ()),
    ("core/index.py", "_rebuild_repack", ()),
    ("core/index.py", "range_agg", ("max_span",)),
    ("core/distributed.py", "run", ()),
    ("core/distributed.py", "maybe_rebuild_shards", ()),
    ("kernels/ops.py", "pi_search_op", ("fanout", "tile_q")),
    ("kernels/ops.py", "bitonic_sort_op", ()),
    ("pipeline/dispatcher.py", "step_single", ()),
    ("pipeline/dispatcher.py", "step_recover", ()),
    ("pipeline/ranges.py", "execute_ranges", ("max_span",)),
    ("pipeline/ranges.py", "execute_ranges_sharded", ("max_span",)),
    ("models/steps.py", "train_step", ()),
    ("models/steps.py", "decode_step", ()),
    ("models/decode.py", "decode_step", ("cfg",)),
)


@dataclasses.dataclass(frozen=True)
class ProjectConfig:
    """The facts that make pilint project-aware rather than generic."""

    # PI001: PIIndex / ShardedPIIndex leaves and their sanctioned owners
    index_leaves: frozenset = frozenset({
        "keys", "vals", "tomb", "n", "levels", "pkeys", "pvals", "ptomb",
        "pn", "n_updates", "overflow", "shards", "fences"})
    owner_suffixes: Tuple[str, ...] = ("core/index.py", "core/distributed.py")
    private_entrypoints: frozenset = frozenset({
        "_rebuild_repack", "_rebuild_incremental", "_route_pending"})

    # PI002, PI003: the device scopes and their static parameters
    device_scopes: Tuple[Tuple[str, str, Tuple[str, ...]], ...] = \
        DEVICE_SCOPES

    # PI003: the index's scopes never write to their inputs (breaker
    # rollback and range serving read the pre-window state)
    index_scope_fragments: Tuple[str, ...] = ("/core/", "/pipeline/",
                                              "/kernels/ops.py")

    # PI004: identifier substrings marking integer-exact domains
    exact_tokens: Tuple[str, ...] = ("key", "seq", "capacity", "thresh",
                                     "fence")

    # PI005: where the named sentinels are *defined* (inline iinfo there
    # is the definition, not a violation)
    sentinel_def_suffixes: Tuple[str, ...] = ("kernels/pi_search.py",
                                              "core/index.py")
    sentinel_literals: frozenset = frozenset({
        2147483647,              # pilint: disable=PI005 — the registry itself
        9223372036854775807})    # pilint: disable=PI005 — the registry itself

    # PI006: the durability tier and its registered crash points
    fault_file_names: Tuple[str, ...] = ("wal.py", "checkpoint.py")
    fault_points: Tuple[str, ...] = dataclasses.field(
        default_factory=_default_fault_points)
    io_verbs: frozenset = frozenset({"write", "flush", "fsync", "rename",
                                     "replace", "savez"})

    def owns_index(self, rel: str) -> bool:
        return any(rel.endswith(s) for s in self.owner_suffixes)

    def defines_sentinels(self, rel: str) -> bool:
        return any(rel.endswith(s) for s in self.sentinel_def_suffixes)

    def in_index_scope(self, rel: str) -> bool:
        return any(f in "/" + rel for f in self.index_scope_fragments)

    def is_fault_file(self, rel: str) -> bool:
        return posixpath.basename(rel) in self.fault_file_names

    def is_exact_name(self, identifier: str) -> bool:
        low = identifier.lower()
        return any(tok in low for tok in self.exact_tokens)


class Rule:
    """One contract; subclasses yield ``(node, message)`` violations."""

    id: str = ""
    title: str = ""

    def check(self, ctx: FileContext, cfg: ProjectConfig):
        raise NotImplementedError


_REGISTRY: Dict[str, Rule] = {}


def register(cls):
    _REGISTRY[cls.id] = cls()
    return cls


def _load_rule_modules() -> None:
    # import-for-effect: each module registers its rules on import
    from repro_torch.analysis import rules_exactness    # noqa: F401
    from repro_torch.analysis import rules_faults       # noqa: F401
    from repro_torch.analysis import rules_ownership    # noqa: F401
    from repro_torch.analysis import rules_tracing      # noqa: F401


def all_rules() -> List[Rule]:
    _load_rule_modules()
    return [_REGISTRY[rule_id] for rule_id in sorted(_REGISTRY)]


# ---------------------------------------------------------------------------
# linting
# ---------------------------------------------------------------------------

def lint_file(path: str, rel: Optional[str] = None,
              cfg: Optional[ProjectConfig] = None) -> List[Finding]:
    """Lint one file; findings are suppression-filtered and deduplicated
    per (rule, line) so nested matches report once."""
    cfg = cfg or ProjectConfig()
    rel = (rel or path).replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        source = f.read()
    try:
        ctx = FileContext(path, rel, source, cfg.device_scopes)
    except SyntaxError as e:
        return [Finding(rel, e.lineno or 1, 0, "PI000",
                        f"file does not parse: {e.msg}")]
    out: List[Finding] = []
    seen = set()
    for rule in all_rules():
        for node, message in rule.check(ctx, cfg):
            line = getattr(node, "lineno", None) or 1
            col = getattr(node, "col_offset", 0)
            if ctx.suppressed(line, rule.id):
                continue
            if (rule.id, line) in seen:
                continue
            seen.add((rule.id, line))
            context = (ctx.lines[line - 1].strip()
                       if 0 < line <= len(ctx.lines) else "")
            out.append(Finding(rel, line, col, rule.id, message, context))
    return sorted(out)


def iter_python_files(paths: Iterable[str]) -> List[str]:
    files: List[str] = []
    for path in paths:
        if os.path.isfile(path):
            files.append(path)
        else:
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith(".py"))
    return files


def lint_paths(paths: Iterable[str],
               cfg: Optional[ProjectConfig] = None) -> List[Finding]:
    """Lint every ``.py`` under ``paths`` (files or directories)."""
    cfg = cfg or ProjectConfig()
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        rel = os.path.relpath(path)
        if rel.startswith(".."):
            rel = path
        findings.extend(lint_file(path, rel, cfg))
    return sorted(findings)
