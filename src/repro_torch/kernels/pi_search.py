"""PI index-layer descent (the paper's Alg. 2) as hand-written CUDA kernels.

Counterpart of ``repro.kernels.pi_search``.  Two entry points, with the
same arguments and outputs as the JAX package's:

* ``pi_search`` — floor slot over the storage layer, −1 on underflow.
  Serves ``traverse`` and ``SearchEngine.floor``.
* ``pi_probe``  — the hot path: ONE launch fuses the descent with the
  pending-buffer lower bound and returns (mpos, ppos, flags).  Every
  ``execute`` and ``lookup`` of the ``cuda`` backend reaches it through
  ``core.engine.SearchEngine.probe``.

Both kernels serve each query with a group of ``PROBE_GROUP`` lanes (a
constant of ``csrc/pi_search.cu``): the descent reads a level's F keys at
once, and the pending bound is a ``PROBE_GROUP``-ary search, interleaved
with the descent (``group_bounds_plain`` is its model).  Both take int32
and float32 keys on the card.

Each wrapper routes by the device of its tensors: a CPU tensor runs the
plain PyTorch version beside it (``pi_search_plain`` / ``pi_probe_plain``,
the port's counterpart of Pallas interpret mode); a CUDA tensor launches
the kernel in ``csrc/pi_search.cu`` or raises.  There is no fallback from
the card to the plain version.

The kernels do not pad anything, unlike the TPU version (which pads every
level to ``len(parent)*F``, storage to ``len(level1)*F`` and the pending
buffer to a power of two on every call): an index past the end of an
array reads as the sentinel, which is exactly what the padding held.  The
plain versions follow the same arithmetic, so kernel and plain version
agree bit for bit, and both agree with the JAX kernels.

Each wrapper bumps its launch guard (``launch_guard("pi_search")``,
``launch_guard("pi_probe")``, ``analysis/runtime.py``) where it launches
its kernel (CPU calls never count), so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.runtime import launch_guard
from repro_torch.kernels.build import load_library

FLAG_MAIN_MATCH = 1    # storage key at the floor position equals the query
FLAG_PENDING_HIT = 2   # pending key at the insertion point equals the query

MAX_LEVELS = 32        # PI_MAX_LEVELS in csrc/pi_descend.cuh
PROBE_GROUP = 8        # lanes a query: PI_PROBE_GROUP of csrc/pi_search.cu

_SEARCH_LAUNCHES = launch_guard("pi_search")
_PROBE_LAUNCHES = launch_guard("pi_probe")


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name
    (``"bfloat16"`` included, which numpy does not know)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        return getattr(torch, dtype)
    return getattr(torch, np.dtype(dtype).name)


def sentinel_for(dtype):
    """Max-value padding key (KSENT) of a key dtype, as a Python scalar."""
    dtype = torch_dtype(dtype)
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def gather_fill(arr: torch.Tensor, idx: torch.Tensor, fill) -> torch.Tensor:
    """``arr[idx]`` with out-of-range indices reading ``fill``.

    The counterpart of ``jnp.take(arr, idx, mode="fill")`` along dim 0: a
    CUDA gather past the end is a device fault, not a clip, so the index
    is clamped and the lane masked.
    """
    n = arr.shape[0]
    valid = (idx >= 0) & (idx < n)
    if n == 0:
        shape = idx.shape + arr.shape[1:]
        return torch.full(shape, fill, dtype=arr.dtype, device=arr.device)
    got = arr[idx.clamp(0, n - 1).long()]
    if arr.dim() > 1:
        valid = valid.reshape(valid.shape + (1,) * (arr.dim() - 1))
    return torch.where(valid, got, fill)


def derive_levels(storage: torch.Tensor, fanout: int) -> Tuple[torch.Tensor, ...]:
    """Index-layer levels of a storage array, bottom-up (level 1 first).

    Level l holds every ``fanout**l``-th storage key; the level sizes are
    those of ``pad_levels`` in the JAX package.  Nothing is padded: the
    descent reads past the end of a level as the sentinel.
    """
    sent = sentinel_for(storage.dtype)
    levels = []
    size, stride = storage.shape[0], 1
    while size > fanout:
        size = -(-size // fanout)
        stride *= fanout
        src = torch.arange(size, device=storage.device) * stride
        levels.append(gather_fill(storage, src, sent))
    return tuple(levels)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' arithmetic, lane-parallel)
# ---------------------------------------------------------------------------

def _descend(levels: Sequence[torch.Tensor], storage: torch.Tensor,
             q: torch.Tensor, fanout: int):
    """Alg. 2 descent → (pos, underflow); twin of the JAX ``_descend``.

    ``levels`` is bottom-up, as on ``PIIndex.levels``; the top level holds
    at most ``fanout`` keys.  Without levels the top is the storage, read
    at least ``fanout`` wide as the JAX kernel pads it.  Out-of-range keys
    read as the sentinel.
    """
    sent = sentinel_for(storage.dtype)
    if levels:
        top = levels[-1]
    else:
        width = max(storage.shape[0], fanout)
        top = gather_fill(storage, torch.arange(width, device=q.device), sent)
    rank = (top[None, :] <= q[:, None]).sum(1, dtype=torch.int32) - 1
    underflow = rank < 0
    pos = rank.clamp_min(0)
    lanes = torch.arange(fanout, dtype=torch.int32, device=q.device)
    for arr in list(levels[:-1])[::-1] + ([storage] if levels else []):
        child = pos[:, None].long() * fanout + lanes[None, :]
        ck = gather_fill(arr, child, sent)
        r = (ck <= q[:, None]).sum(1, dtype=torch.int32) - 1
        pos = pos * fanout + r.clamp_min(0)
    return pos, underflow


def _lower_bound(sorted_keys: torch.Tensor, q: torch.Tensor,
                 right: bool = False) -> torch.Tensor:
    """#{i : sorted_keys[i] < q} per lane (``right``: <= q), capped at the
    length; twin of the JAX ``_lower_bound``, and the count the kernels'
    G-ary search (``group_bounds_plain``) must give.

    The branchless binary search over the buffer as if it were padded to a
    power of two with the sentinel (reads past the end are the sentinel).
    """
    n = sorted_keys.shape[0]
    sent = sentinel_for(sorted_keys.dtype)
    p2 = 1 << max(0, (n - 1).bit_length())
    below = torch.le if right else torch.lt
    count = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    step = p2 >> 1
    while step:
        cand = count + step
        ck = gather_fill(sorted_keys, cand - 1, sent)
        count = torch.where(below(ck, q), cand, count)
        step >>= 1
    last = gather_fill(sorted_keys, count, sent)
    return (count + below(last, q).to(torch.int32)).clamp_max(n)


def group_bounds_plain(sorted_keys: torch.Tensor, q: torch.Tensor,
                       right: bool = False, group: int = PROBE_GROUP):
    """#{i : sorted_keys[i] < q} per lane (``right``: <= q), by the kernels'
    ``group``-ary search (``group_bounds`` and its one-sided half
    ``GroupLowerBound`` in ``csrc/pi_descend.cuh``).

    The count lies in a window of width ``w``, at first the least power of
    two >= n.  A round splits it into ``group`` equal parts (``w`` of one
    key once ``w <= group``), probes the last key of each, and moves the
    count past the parts whose last key is below ``q`` -- a prefix of them,
    as the keys are sorted; a probe past the end is not below.
    """
    n = sorted_keys.shape[0]
    below = torch.le if right else torch.lt
    count = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    w = (1 << max(0, (n - 1).bit_length())) if n else 0
    while w > 0:
        s = w // group if w > group else 1
        idx = count[..., None] + s * torch.arange(
            1, w // s + 1, device=q.device) - 1
        hit = (idx < n) & below(sorted_keys[idx.clamp_max(n - 1)],
                                q[..., None])
        count = count + s * hit.sum(-1)
        w = s if s > 1 else 0
    return count.to(torch.int32)


def pi_search_plain(storage: torch.Tensor, queries: torch.Tensor, *,
                    fanout: int = 8,
                    levels: Sequence[torch.Tensor] | None = None
                    ) -> torch.Tensor:
    """Plain version of ``pi_search`` (same arguments and output)."""
    if levels is None:
        levels = derive_levels(storage, fanout)
    q = queries.to(storage.dtype)
    pos, underflow = _descend(levels, storage, q, fanout)
    return torch.where(underflow, -1, pos)


def pi_probe_plain(storage: torch.Tensor, pending: torch.Tensor,
                   queries: torch.Tensor, *, fanout: int = 8,
                   levels: Sequence[torch.Tensor] | None = None):
    """Plain version of ``pi_probe``; twin of the JAX ``_probe_kernel``,
    with the pending bound by the kernel's G-ary search (the same count as
    the JAX ``_lower_bound``)."""
    if levels is None:
        levels = derive_levels(storage, fanout)
    q = queries.to(storage.dtype)
    C, PC = storage.shape[0], pending.shape[0]
    pos, underflow = _descend(levels, storage, q, fanout)
    mpos = torch.where(underflow, -1, pos)
    main_match = (mpos >= 0) & (storage[mpos.clamp(0, C - 1).long()] == q)
    ppos = group_bounds_plain(pending, q)
    p_hit = (pending[ppos.clamp_max(PC - 1).long()] == q) & (ppos < PC)
    flags = main_match.to(torch.int32) * FLAG_MAIN_MATCH | \
        p_hit.to(torch.int32) * FLAG_PENDING_HIT
    return mpos, ppos, flags


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

_SUFFIX = {torch.int32: "i32", torch.float32: "f32"}


def _check_launch_args(name, storage, levels, others, dtypes):
    if storage.dtype not in dtypes:
        raise TypeError(f"{name}: key dtype {storage.dtype} not supported "
                        f"on the card (takes {sorted(map(str, dtypes))})")
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"{name}: {len(levels)} levels > {MAX_LEVELS}")
    for t in (storage, *levels, *others):
        if t.device != storage.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{storage.device}")
        if t.dtype != storage.dtype:
            raise TypeError(f"{name}: mixed key dtypes {t.dtype} and "
                            f"{storage.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: arrays must be 1-D and contiguous")
        if t.shape[0] >= 2 ** 31:
            raise ValueError(f"{name}: array longer than int32 indexing")


def _level_args(levels):
    n = len(levels)
    ptrs = (ctypes.c_void_p * max(n, 1))(*[lv.data_ptr() for lv in levels])
    lens = (ctypes.c_int * max(n, 1))(*[lv.shape[0] for lv in levels])
    return ptrs, lens, n


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def pi_search(storage: torch.Tensor, queries: torch.Tensor, *,
              fanout: int = 8, tile_q: int = 256,
              levels: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
    """Batched floor search over a gapped, sentinel-padded key array.

    Args:
      storage: (C,) storage-layer keys (sorted runs + sentinel slack).
      queries: (B,) query keys, any B.
      levels:  optional index-layer arrays (bottom-up, as on
               ``PIIndex.levels``); derived from storage when absent.
      tile_q:  kept for parity with the JAX signature; the CUDA kernel
               runs ``PROBE_GROUP`` lanes a query.
    Returns:
      (B,) int32 positions (−1 where q < storage[0]).
    """
    del tile_q
    if storage.device.type == "cpu":
        return pi_search_plain(storage, queries, fanout=fanout, levels=levels)
    if levels is None:
        levels = derive_levels(storage, fanout)
    q = queries.to(storage.dtype).contiguous()
    _check_launch_args("pi_search", storage, levels, (q,),
                       (torch.int32, torch.float32))
    out = torch.empty(q.shape, dtype=torch.int32, device=storage.device)
    if q.shape[0] == 0:
        return out
    fn = getattr(load_library("pi_search"),
                 "pi_search_" + _SUFFIX[storage.dtype])
    ptrs, lens, n_levels = _level_args(levels)
    with torch.cuda.device(storage.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ptrs, lens, n_levels, storage.data_ptr(), storage.shape[0],
                q.data_ptr(), q.shape[0], fanout, out.data_ptr(), stream)
    _raise_on("pi_search", rc)
    _SEARCH_LAUNCHES.bump()
    return out


def pi_probe(storage: torch.Tensor, pending: torch.Tensor,
             queries: torch.Tensor, *, fanout: int = 8, tile_q: int = 256,
             levels: Sequence[torch.Tensor] | None = None):
    """Fused production probe: descent + pending lower bound, ONE launch.

    Args:
      storage: (C,)  storage-layer keys, int32 or float32.
      pending: (PC,) sorted pending-buffer keys, sentinel-padded.
      queries: (B,)  query keys, any B.
      levels:  optional index-layer arrays (bottom-up); derived when absent.
    Returns:
      (mpos, ppos, flags) int32 triplet per query:
        mpos  — storage floor position (−1 underflow),
        ppos  — unclipped insertion point into the pending buffer
                (== searchsorted(pending, q), never above PC),
        flags — FLAG_MAIN_MATCH / FLAG_PENDING_HIT bitmask.
    """
    del tile_q
    if storage.device.type == "cpu":
        return pi_probe_plain(storage, pending, queries, fanout=fanout,
                              levels=levels)
    if levels is None:
        levels = derive_levels(storage, fanout)
    q = queries.to(storage.dtype).contiguous()
    _check_launch_args("pi_probe", storage, levels, (pending, q),
                       (torch.int32, torch.float32))
    outs = [torch.empty(q.shape, dtype=torch.int32, device=storage.device)
            for _ in range(3)]
    if q.shape[0] == 0:
        return tuple(outs)
    fn = getattr(load_library("pi_search"),
                 "pi_probe_" + _SUFFIX[storage.dtype])
    ptrs, lens, n_levels = _level_args(levels)
    with torch.cuda.device(storage.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(ptrs, lens, n_levels, storage.data_ptr(), storage.shape[0],
                pending.data_ptr(), pending.shape[0], q.data_ptr(),
                q.shape[0], fanout, *(o.data_ptr() for o in outs), stream)
    _raise_on("pi_probe", rc)
    _PROBE_LAUNCHES.bump()
    return tuple(outs)
