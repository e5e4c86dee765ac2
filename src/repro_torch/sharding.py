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

* **The GSPMD half**: the LM's tensors are DTensors.  A
  ``PartitionSpec`` becomes one ``Placement`` a mesh dim
  (``spec_placements``); ``named_sharding`` / ``tree_shardings`` give
  ``(mesh, placements)`` a leaf, ``place`` makes every leaf a DTensor, and
  ``constrain`` redistributes one to the rules' placements (a no-op
  without a mesh or on one rank).  Where DTensor has no rule for a piece
  of the model (the attention kernel, the scans, the expert dispatch),
  the model runs it on each rank's local block, and ``psum_to_all`` /
  ``sum_grads`` carry the gradients across ranks as JAX's transposes do.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard)
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

Rules = Tuple[Tuple[str, object], ...]

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


def bound(fn):
    """``fn`` run under the mesh and rules in scope now.  The scope is a
    thread's, and autograd runs a backward (a rematerialized layer's
    recompute among it) on a device's own thread."""
    mesh, rules = _current()

    def run(*args, **kwargs):
        with use_mesh(mesh, rules):
            return fn(*args, **kwargs)
    return run


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
# the GSPMD half: the LM's tensors as DTensors
# ---------------------------------------------------------------------------

def _single_rank(mesh) -> bool:
    return mesh is None or mesh.size() == 1


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def spec_placements(spec: PartitionSpec, mesh) -> Tuple[Placement, ...]:
    """One ``Placement`` a mesh dim: ``Shard(i)`` on every mesh dim that
    entry i names (a tuple entry shards dim i on each of its axes), else
    ``Replicate()``.

    A DTensor shards a dim over several mesh dims major to minor in the
    mesh's order, JAX in the entry's order: the two agree when the entry
    lists its axes in mesh order, as ``DEFAULT_RULES``' ("pod", "data")
    does on every mesh of ``launch.mesh``; another order raises."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"dim {i} is sharded over {axes}, not in the "
                             f"mesh's order {names}: a DTensor cannot "
                             f"place it as JAX does")
        for m in dims:
            out[m] = Shard(i)
    return tuple(out)


def placements_of(logical: Sequence[Optional[str]], shape=None, mesh=None,
                  rules: Rules = None) -> Tuple[Placement, ...]:
    """The placements of a tensor of ``shape`` named ``logical`` (default:
    the mesh and rules in scope)."""
    m, r = _current()
    mesh = mesh if mesh is not None else m
    rules = rules if rules is not None else r
    return spec_placements(logical_to_spec(logical, rules, mesh, shape),
                           mesh)


def constrain(x, *logical: Optional[str]):
    """The reference's ``with_sharding_constraint`` by logical names: a
    DTensor redistributed to the rules' placements.  A no-op without a
    mesh or on one rank; under a mesh of several ranks ``x`` must be a
    DTensor (a plain tensor there is a rank's own block or a copy: it is
    never placed silently)."""
    mesh, rules = _current()
    if _single_rank(mesh):
        return x
    if not isinstance(x, DTensor):
        raise TypeError(f"constrain{tuple(logical)} under a mesh of "
                        f"{mesh.size()} ranks got a plain tensor of shape "
                        f"{tuple(x.shape)}: place it first (sharding.place)")
    want = spec_placements(logical_to_spec(logical, rules, mesh,
                                           tuple(x.shape)), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def named_sharding(logical: Sequence[Optional[str]], mesh=None,
                   shape: Optional[Sequence[int]] = None):
    """``(mesh, placements)`` of a tensor named ``logical`` (the
    reference's ``NamedSharding``)."""
    mesh = mesh or current_mesh()
    assert mesh is not None, "named_sharding needs an active or explicit mesh"
    return mesh, placements_of(logical, shape, mesh)


def tree_shardings(logical_tree, mesh, rules: Rules = DEFAULT_RULES,
                   shape_tree=None):
    """``(mesh, placements)`` of every leaf of a nested dict of
    logical-axis tuples (``shape_tree``: tensors of the same structure,
    whose shapes drop the mesh axes that do not divide a dim)."""
    def walk(lg, sh):
        if isinstance(lg, dict):
            return {k: walk(v, None if sh is None else sh[k])
                    for k, v in lg.items()}
        shape = None if sh is None else tuple(sh.shape)
        return mesh, placements_of(lg, shape, mesh, rules)

    return walk(logical_tree, shape_tree)


def gather_fsdp(tree):
    """Every DTensor of a layer's parameter tree with the mesh axes of the
    "fsdp" rule replicated: FSDP's gather of a layer's weights before its
    products (the backward reduce-scatters their gradients), so that the
    activations, split over the batch on those axes, stay where they
    are.  Without a mesh in scope the tree as it is."""
    mesh, rules = _current()
    if mesh is None:
        return tree
    axes = dict(rules).get("fsdp")
    axes = {axes} if isinstance(axes, str) else set(axes or ())

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if not isinstance(x, DTensor):
            return x
        names = x.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if p.is_shard() and names[m] in axes else p
                   for m, p in enumerate(x.placements))
        return x if pl == tuple(x.placements) else \
            x.redistribute(x.device_mesh, pl)
    return walk(tree)


def is_sharding(s) -> bool:
    """Whether ``s`` is a ``(DeviceMesh, placements)`` pair."""
    return isinstance(s, tuple) and len(s) == 2 and \
        isinstance(s[0], DeviceMesh)


def local_block(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``placements``
    (a view of ``x``)."""
    shape, offset = compute_local_shape_and_global_offset(
        tuple(x.shape), mesh, placements)
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != x.shape[d]:
            x = x.narrow(d, o, n)
    return x


def mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh`` (the current card for "cuda")."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place_tensor(x: torch.Tensor, mesh, placements) -> DTensor:
    """``x`` as a DTensor on ``mesh``: every rank holds the same ``x`` (a
    draw from one seed, a loaded file) and keeps its own block, copied to
    the mesh's device with no collective."""
    dev = mesh_device(mesh)
    placements = tuple(placements)
    block = local_block(x, mesh, placements).to(dev, copy=True) \
        .contiguous()
    return DTensor.from_local(block, mesh, placements, run_check=False,
                              shape=x.shape, stride=_contiguous_stride(
                                  x.shape))


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def place(tree, shardings):
    """Every leaf of a nested dict as a DTensor where ``shardings`` (the
    same structure, ``(mesh, placements)`` leaves: ``tree_shardings``)
    says (``place_tensor``)."""
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    mesh, pl = shardings
    return place_tensor(tree, mesh, pl)


def zeros(shape, dtype, mesh, placements) -> DTensor:
    """A DTensor of zeros, each rank's block made where it lives."""
    dev = mesh_device(mesh)
    local_shape, _ = compute_local_shape_and_global_offset(
        tuple(shape), mesh, placements)
    return DTensor.from_local(
        torch.zeros(local_shape, dtype=dtype, device=dev), mesh,
        tuple(placements), run_check=False, shape=torch.Size(shape),
        stride=_contiguous_stride(shape))


def one_rank_mesh(tree):
    """The mesh of a tree's DTensors when it is one of a single rank
    (else ``None``: plain tensors, or a mesh of several ranks)."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)
    walk(tree)
    meshes = {x.device_mesh for x in leaves if isinstance(x, DTensor)}
    if len(meshes) == 1:
        mesh = meshes.pop()
        if mesh.size() == 1:
            return mesh
    return None


def full(x):
    """The whole value of ``x``: a DTensor gathered (every rank calls it),
    a plain tensor itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local(x):
    """This rank's block of ``x`` (a plain tensor: itself)."""
    return x.to_local() if isinstance(x, DTensor) else x


def replicate(x):
    """``x`` with every placement ``Replicate`` (Partial sums reduced):
    a value every rank holds whole, and whose gradient is taken once."""
    if not isinstance(x, DTensor):
        return x
    want = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == want else \
        x.redistribute(x.device_mesh, want)


def placed_like(x, ref):
    """``x`` redistributed to ``ref``'s placements (plain tensors, or the
    same placements: ``x``)."""
    if isinstance(x, DTensor) and tuple(x.placements) != \
            tuple(ref.placements):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def copy_into(dst, src):
    """``dst.copy_(src)`` in place: a DTensor's local block takes
    ``src``'s, redistributed to ``dst``'s placements (no autograd)."""
    local(dst).copy_(local(placed_like(src, dst)))
    return dst


def like(local_x: torch.Tensor, ref, placements=None):
    """``local_x``, a rank's block, as a DTensor on ``ref``'s mesh with
    ``placements`` (default ``ref``'s); a plain ``ref``: ``local_x``."""
    if not isinstance(ref, DTensor):
        return local_x
    pl = tuple(ref.placements) if placements is None else tuple(placements)
    return DTensor.from_local(local_x, ref.device_mesh, pl, run_check=False)


def replicated(t, ref):
    """``t``, a value every rank computes alike (a mask, a position
    table), as a replicated DTensor on ``ref``'s mesh; with a plain
    ``ref``, or a DTensor ``t``, ``t`` itself.  A model constant meets a
    DTensor only so: a plain tensor in an op with a DTensor raises."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    return like(t, ref, (Replicate(),) * ref.device_mesh.ndim)


def mesh_dims_of(x: DTensor, dim: int) -> Tuple[int, ...]:
    """The mesh dims over which ``x`` shards tensor dim ``dim``."""
    return tuple(m for m, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == dim)


def block_offset(x: DTensor, dim: int) -> int:
    """Where this rank's block of ``x`` starts along ``dim``."""
    _, offset = compute_local_shape_and_global_offset(
        tuple(x.shape), x.device_mesh, x.placements)
    return int(offset[dim])


def mesh_groups(mesh, dims: Sequence[int]) -> tuple:
    """The process groups of mesh dims ``dims`` that span more than one
    rank (a sum over several is one over each in turn)."""
    return tuple(mesh.get_group(mesh.mesh_dim_names[d]) for d in dims
                 if mesh.size(d) > 1)


def local_call(fn, args, logical, out_logical):
    """``fn`` on each rank's blocks, for a piece of the model that DTensor
    has no rule for (a scan, a custom autograd function).

    ``args`` are placed by ``logical`` (one tuple of names an arg) and
    ``fn`` gets their local blocks; its outputs (a tensor or a tuple)
    come back as DTensors whose dims ``out_logical`` names are split as
    the inputs' dims of the same names.  An arg that a mesh dim does not
    split while another arg's is split there is used by each rank for its
    own block: its gradient is a partial sum over that dim.  With no
    DTensor among ``args``, ``fn(*args)``."""
    ref = next((a for a in args if isinstance(a, DTensor)), None)
    if ref is None:
        return fn(*args)
    mesh = ref.device_mesh
    pls = [placements_of(lg, tuple(a.shape), mesh)
           for a, lg in zip(args, logical)]
    split = {m for pl in pls for m, p in enumerate(pl) if p.is_shard()}
    where = {}                       # logical name -> the mesh dims
    for lg, pl in zip(logical, pls):
        for m, p in enumerate(pl):
            if p.is_shard() and lg[p.dim] is not None:
                where.setdefault(lg[p.dim], set()).add(m)
    blocks = []
    for a, pl in zip(args, pls):
        if tuple(a.placements) != pl:
            a = a.redistribute(mesh, pl)
        gp = tuple(Partial() if m in split and not p.is_shard() else p
                   for m, p in enumerate(pl))
        blocks.append(a.to_local(grad_placements=gp))
    out = fn(*blocks)
    outs = out if isinstance(out, tuple) else (out,)
    wrapped = []
    for t, lg in zip(outs, out_logical):
        pl = [Replicate()] * mesh.ndim
        for i, name in enumerate(lg):
            for m in where.get(name, ()) if name is not None else ():
                pl[m] = Shard(i)
        wrapped.append(DTensor.from_local(t, mesh, tuple(pl),
                                          run_check=False))
    return tuple(wrapped) if isinstance(out, tuple) else wrapped[0]


def rowwise(fn, x, *params, rows=()):
    """``fn(x, *params, *rows)`` where ``fn`` works on each row of ``x``'s
    last dim alone (a norm, a rotation): on each rank's block of a
    DTensor ``x``, its last dim whole.  ``params`` (replicated: a norm's
    scale) get partial-sum gradients over the mesh dims that split ``x``;
    ``rows`` are plain tensors indexed like ``x``'s leading dims (the
    positions), cut to the block.  One pass a row, not the op-by-op
    DTensor propagation of ``fn``'s body."""
    if not isinstance(x, DTensor):
        return fn(x, *params, *rows)
    mesh, last = x.device_mesh, x.dim() - 1
    pl = tuple(Replicate() if p.is_partial() or (p.is_shard() and
                                                 p.dim == last) else p
               for p in x.placements)
    if tuple(x.placements) != pl:
        x = x.redistribute(mesh, pl)
    part = tuple(Partial() if p.is_shard() else Replicate() for p in pl)
    rep = (Replicate(),) * mesh.ndim
    ps = [q.redistribute(mesh, rep).to_local(grad_placements=part)
          if isinstance(q, DTensor) else q for q in params]
    rs = []
    for r in rows:
        rpl = tuple(p if p.is_shard() and p.dim < r.dim() else Replicate()
                    for p in pl)
        rs.append(local_block(r, mesh, rpl))
    return DTensor.from_local(fn(x.to_local(), *ps, *rs), mesh, pl,
                              run_check=False)


# ---------------------------------------------------------------------------
# collectives with a gradient (the transposes JAX takes inside shard_map)
# ---------------------------------------------------------------------------

class _SumToAll(torch.autograd.Function):
    """y = the sum of every rank's x, which every rank then uses alike:
    the gradient of each x is y's (no collective)."""

    @staticmethod
    def forward(ctx, x, *groups):
        for g in groups:
            x = group_psum(x, g)
        return x

    @staticmethod
    def backward(ctx, g):
        return (g,) + (None,) * len(ctx.needs_input_grad[1:])


class _SumGrads(torch.autograd.Function):
    """y = x, held alike on every rank, each of which uses it for its own
    part: the gradient of x is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, *groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        for grp in ctx.groups:
            g = group_psum(g, grp)
        return (g,) + (None,) * len(ctx.groups)


def psum_to_all(x: torch.Tensor, groups) -> torch.Tensor:
    """``jax.lax.psum`` over ``groups`` whose result every rank uses
    alike (its backward passes the gradient through)."""
    return _SumToAll.apply(x, *groups) if groups else x


def sum_grads(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` itself, its gradient summed over ``groups`` (the transpose of
    using a replicated value for each rank's own part)."""
    return _SumGrads.apply(x, *groups) if groups else x


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


def group_pmax(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x``."""
    if group is None:
        return x
    out = x.clone()
    tdist.all_reduce(out, op=tdist.ReduceOp.MAX, group=group)
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
