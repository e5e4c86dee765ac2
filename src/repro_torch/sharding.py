"""Logical-axis sharding rules and the SPMD layer over ``torch.distributed``.

Counterpart of ``repro.sharding``.  Two halves:

* **The rules** (MaxText-style), copied: models name their tensors' axes
  logically, a rule set maps each logical name to physical mesh axes, and
  ``logical_to_spec`` turns a tuple of logical names into the
  ``PartitionSpec`` the reference computes for the same mesh, entry for
  entry.  A mesh here is a ``torch.distributed.device_mesh.DeviceMesh``
  with the reference's axis names (``launch.mesh``).

    DP    : "batch"   → ("pod","data")
    FSDP  : "fsdp"    → "data"
    TP    : "heads"/"mlp"/"vocab" → "model"
    EP    : "experts" → "model"
    SP    : "seq"     → "model" (enabled per config)

* **The SPMD helpers**: the reference's ``shard_map`` body becomes a
  function that every rank runs on its own block, one process a rank.
  ``axis_size`` / ``axis_index`` read a named axis of the mesh in scope,
  and ``psum``, ``all_gather``, ``all_to_all`` and ``ppermute`` run on that
  axis's process group (``mesh.get_group(axis)``).  Each has a form over a
  group (``group_*``) that the index uses without a mesh in scope; a
  ``None`` group is one rank and runs no collective.

The GSPMD half (``constrain``, ``named_sharding``, ``tree_shardings``)
places tensors of the whole LM: it stays a no-op without a mesh, or with
a mesh of one rank, and raises under a mesh of several ranks (ROADMAP
A13, the LM across cards).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as tdist

Rules = Tuple[Tuple[str, object], ...]

LM_ACROSS_RANKS = ("placing the LM's tensors over a mesh of several ranks "
                   "needs DTensor placements, not ported yet (ROADMAP A13, "
                   "the LM across cards)")

# default rule set for the production meshes (see launch/mesh.py)
DEFAULT_RULES: Rules = (
    ("batch", ("pod", "data")),
    ("seq", None),           # overridden to "model" when SP is on
    ("embed", None),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("head_dim", None),
    ("mlp", "model"),
    ("vocab", "model"),
    ("experts", "model"),
    ("expert_mlp", None),
    ("fsdp", "data"),        # parameter / optimizer-state sharding axis
    ("layers", None),
    ("state", None),         # SSM state / conv / lru lanes
    ("kv_seq", None),
)


class PartitionSpec(tuple):
    """One entry a tensor dim: ``None``, a mesh axis, or a tuple of axes
    (``jax.sharding.PartitionSpec``'s entries)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


_ctx = threading.local()


def _current():
    return getattr(_ctx, "mesh", None), getattr(_ctx, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Rules = DEFAULT_RULES):
    """Activate (mesh, rules) within the block; ``mesh`` a ``DeviceMesh``
    or ``None``."""
    old = _current()
    _ctx.mesh, _ctx.rules = mesh, rules
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = old


def current_mesh():
    return _current()[0]


def current_rules() -> Rules:
    return _current()[1]


def mesh_sizes(mesh) -> dict:
    """Axis name → size of a ``DeviceMesh`` (``{}`` for ``None``)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def physical_axes(name: str, shape_dim: Optional[int] = None):
    """Mesh axes a logical name maps to (divisibility-filtered prefix)."""
    mesh, rules = _current()
    if mesh is None:
        return ()
    phys = dict(rules).get(name)
    if phys is None:
        return ()
    if isinstance(phys, str):
        phys = (phys,)
    sizes = mesh_sizes(mesh)
    keep = []
    prod = 1
    for p in phys:
        if p not in sizes:
            continue
        if shape_dim is not None and shape_dim % (prod * sizes[p]) != 0:
            break
        keep.append(p)
        prod *= sizes[p]
    return tuple(keep)


def with_rules(overrides: dict) -> Rules:
    base = dict(DEFAULT_RULES)
    base.update(overrides)
    return tuple(base.items())


def logical_to_spec(logical: Sequence[Optional[str]], rules: Rules = None,
                    mesh=None,
                    shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    """Map logical axis names to a ``PartitionSpec`` under the rules.

    Axes whose physical target is absent from the mesh are left unsharded;
    a physical axis already used by an earlier dim is dropped (first
    wins); with ``shape``, mesh axes that do not divide the dim are
    dropped (the longest dividing prefix wins).
    """
    if rules is None:
        _, rules = _current()
    if mesh is None:
        mesh, _ = _current()
    rd = dict(rules)
    sizes = mesh_sizes(mesh)
    used = set()
    out = []
    for i, name in enumerate(logical):
        phys = rd.get(name) if name is not None else None
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        keep = [p for p in phys if p in sizes and p not in used]
        if shape is not None and i < len(shape):
            prefix = []
            prod = 1
            for p in keep:
                if shape[i] % (prod * sizes[p]) == 0:
                    prefix.append(p)
                    prod *= sizes[p]
                else:
                    break
            keep = prefix
        used.update(keep)
        if not keep:
            out.append(None)
        elif len(keep) == 1:
            out.append(keep[0])
        else:
            out.append(tuple(keep))
    return PartitionSpec(*out)


# ---------------------------------------------------------------------------
# the GSPMD half: placements of the LM (one rank only)
# ---------------------------------------------------------------------------

def _single_rank(mesh) -> bool:
    return mesh is None or mesh.size() == 1


def constrain(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical names: a
    no-op without a mesh or on one rank."""
    mesh, _ = _current()
    if _single_rank(mesh):
        return x
    raise NotImplementedError(LM_ACROSS_RANKS)


def named_sharding(logical: Sequence[Optional[str]], mesh=None,
                   shape: Optional[Sequence[int]] = None):
    """``(mesh, spec)`` of a tensor on a mesh of one rank, where every
    placement is the whole tensor."""
    m, rules = _current()
    mesh = mesh or m
    assert mesh is not None, "named_sharding needs an active or explicit mesh"
    if not _single_rank(mesh):
        raise NotImplementedError(LM_ACROSS_RANKS)
    return mesh, logical_to_spec(logical, rules, mesh, shape)


def tree_shardings(logical_tree, mesh, rules: Rules = DEFAULT_RULES,
                   shape_tree=None):
    """``named_sharding`` of every leaf of a nested dict of logical-axis
    tuples (``shape_tree``: tensors of the same structure)."""
    if not _single_rank(mesh):
        raise NotImplementedError(LM_ACROSS_RANKS)

    def walk(lg, sh):
        if isinstance(lg, dict):
            return {k: walk(v, None if sh is None else sh[k])
                    for k, v in lg.items()}
        shape = None if sh is None else tuple(sh.shape)
        return mesh, logical_to_spec(lg, rules, mesh, shape)

    return walk(logical_tree, shape_tree)


# ---------------------------------------------------------------------------
# collectives over a process group (None: one rank, no collective)
# ---------------------------------------------------------------------------

def group_size(group) -> int:
    return 1 if group is None else tdist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else tdist.get_rank(group)


def group_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in group-rank order."""
    if group is None:
        return x[None]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    tdist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def group_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of ``x``'s leading dim (one per rank) goes to rank j; block
    j of the result came from rank j."""
    if group is None:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    tdist.all_to_all_single(out, x, group=group)
    return out


def group_psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (the backend's reduction order)."""
    if group is None:
        return x
    out = x.clone()
    tdist.all_reduce(out, op=tdist.ReduceOp.SUM, group=group)
    return out


def group_ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: rank ``dst`` receives ``x`` of rank ``src``
    for each ``(src, dst)`` of ``perm``; a rank no pair names receives
    zeros.  Written as one ``all_to_all_single`` whose splits are zero
    but for the partner's, so that it runs on every backend."""
    if group is None:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    n, me = group_size(group), group_rank(group)
    flat = x.contiguous().reshape(-1)
    send = [0] * n
    recv = [0] * n
    for src, dst in perm:
        if src == me:
            send[dst] = flat.numel()
        if dst == me:
            recv[src] = flat.numel()
    out = torch.zeros(sum(recv), dtype=x.dtype, device=x.device)
    # a permutation: each rank sends to one rank at most
    src_buf = flat if sum(send) else flat[:0]
    tdist.all_to_all_single(out, src_buf, output_split_sizes=recv,
                            input_split_sizes=send, group=group)
    return out.reshape(x.shape) if sum(recv) else torch.zeros_like(x)


# ---------------------------------------------------------------------------
# the shard_map body's primitives over a named axis of the mesh in scope
# ---------------------------------------------------------------------------

def axis_group(axis_name: str, mesh=None):
    """The process group of a named axis of ``mesh`` (default: the mesh
    in scope)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        raise ValueError(f"axis {axis_name!r} is not bound: no mesh in "
                         f"scope (sharding.use_mesh)")
    return mesh.get_group(axis_name)


def axis_size(axis_name: str, mesh=None) -> int:
    return group_size(axis_group(axis_name, mesh))


def axis_index(axis_name: str, mesh=None) -> int:
    return group_rank(axis_group(axis_name, mesh))


def psum(x: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    return group_psum(x, axis_group(axis_name, mesh))


def all_gather(x: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    return group_all_gather(x, axis_group(axis_name, mesh))


def all_to_all(x: torch.Tensor, axis_name: str, mesh=None) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis_name, 0, 0, tiled=False)``."""
    return group_all_to_all(x, axis_group(axis_name, mesh))


def ppermute(x: torch.Tensor, axis_name: str, perm, mesh=None):
    return group_ppermute(x, axis_group(axis_name, mesh), perm)
