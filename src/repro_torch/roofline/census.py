"""Per-device census of one eager step: dot FLOPs, traffic, collectives
and peak memory.

Counterpart of ``repro.roofline.hlo``.  The reference parses the SPMD HLO
that XLA compiles for one device; the port has no compiled program, so
``analyze(fn, *args)`` runs the step function itself once, on ``meta``
tensors (shapes and dtypes, no storage, no card), under a
``TorchDispatchMode`` that sees every aten op the program issues and
counts it:

* ``dot_flops``: 2 x result elements x contracted size of every ``mm``,
  ``bmm``, ``addmm``, ``baddbmm`` and convolution, whatever the dtype: the float64 products of the
  attention's plain recompute count as the port runs them.
* ``traffic_bytes``: operand plus result bytes of every op that is not a
  view or a metadata op, each operand counted by the bytes of the view
  it is (a slice touches only the slice).  As in ``hlo.py``: a gather
  (``index_select``, ``gather``, ``index``, ``embedding``) moves twice its
  result, a scatter (``scatter``, ``index_copy``, ``index_add``,
  ``index_put``) three times its update, a ``copy_`` (the eager
  dynamic-update-slice) twice its source.
* ``traffic_bytes_fused``: equal to ``traffic_bytes``.  Eager PyTorch
  fuses nothing: every op reads its operands from memory and writes its
  result there.
* ``collective_bytes``, ``collective_bytes_by_kind``,
  ``collective_count``: operand bytes of each collective (functional or
  c10d), under the reference's kind names (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``; the port's
  ``ppermute`` is an ``all_to_all_single``).
* ``peak_bytes``: the largest sum of live storages' bytes, each storage
  counted once, from the step's arguments on (``argument_bytes``): the
  counterpart of XLA's argument plus temp sizes.  A storage is live from
  the op that makes it until the last tensor on it is freed.
* ``while_trip_counts`` is ``None``: an eager program has no loops to
  recover.

Everything is per device.  Under DTensor a dispatch mode sees each op
first at its global shapes; the census declines those (returns
``NotImplemented``), so that DTensor runs its redistributions and then
the rank's local op, which come through the mode on local tensors and
are counted: the rank's own work and its own collectives.  DTensor's
sharding propagation infers shapes by running ops on ``FakeTensor``s of
global shape; those are skipped.

The hand-written kernels are counted by their own formulas, whatever
implements them: a call of ``repro_torch::flash_attention_fwd`` is one op
whose FLOPs are the two products over the keys that its causal mask and
window leave, and whose bytes are ``flash_hbm_bytes``.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# the reference's kind names, by the op's name in _c10d_functional,
# c10d_functional and c10d (another collective counts under its own name)
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}
# c10d ops whose first argument is the output and second the operand
_OPERAND_SECOND = {"allgather_", "_allgather_base_", "alltoall_",
                   "alltoall_base_", "reduce_scatter_",
                   "_reduce_scatter_base_", "allgather_into_tensor_coalesced_",
                   "reduce_scatter_tensor_coalesced_"}
_C10D = ("_c10d_functional", "c10d_functional", "c10d")
_C10D_METADATA = {"wait_tensor", "_wrap_tensor_autograd", "barrier"}

# ops that allocate or relabel without moving bytes
_NO_TRAFFIC = {
    "empty", "empty_strided", "empty_like", "new_empty",
    "new_empty_strided", "_unsafe_view", "lift_fresh", "resize_", "set_",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
}
_DOTS = {"mm", "bmm", "addmm", "baddbmm", "convolution"}
_GATHERS = {"index_select", "gather", "index", "embedding", "take"}
# scatters: the update's position in the arguments
_SCATTERS = {"scatter": 3, "scatter_": 3, "scatter_add": 3,
             "scatter_add_": 3, "scatter_reduce": 3, "scatter_reduce_": 3,
             "index_copy": 3, "index_copy_": 3, "index_add": 3,
             "index_add_": 3, "index_put": 2, "index_put_": 2,
             "_index_put_impl_": 2}
FLASH_OP = "flash_attention_fwd"


def tensor_bytes(t: torch.Tensor) -> int:
    """The bytes of the view ``t`` is (not of its whole storage)."""
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def dot_flops(name: str, args, out: torch.Tensor) -> int:
    """2 x result elements x contracted size of one product (``out``
    its result)."""
    if name == "convolution":
        w, transposed = args[1], bool(args[6])
        per = math.prod(w.shape[2:])
        if transposed:        # weight (C_in, C_out / g, *k): per input
            return 2 * args[0].numel() * w.shape[1] * per
        return 2 * out.numel() * w.shape[1] * per
    a = args[1] if name in ("addmm", "baddbmm") else args[0]
    return 2 * out.numel() * a.shape[-1]


def flash_flops(B, Sq, Sk, H, D, Dv, causal=True, window=None) -> int:
    """The flash kernel's products, QK^T (2 D) and PV (2 Dv) for each
    (query, key) pair that its mask leaves; query positions start at 0
    (a prefill), keys at 0."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(0, q - window + 1) if window is not None else 0
    pairs = int(np.maximum(0, hi - lo).sum())
    return 2 * (D + Dv) * pairs * B * H


def flash_bytes(q, k, v) -> int:
    from repro_torch.kernels.flash_attention import flash_hbm_bytes
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    return flash_hbm_bytes(B, Sq, Sk, H, KV, D, v.shape[-1],
                           itemsize=q.element_size())


@dataclasses.dataclass
class OpTally:
    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0


@dataclasses.dataclass
class CensusStats:
    collective_bytes: float = 0.0
    collective_bytes_by_kind: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    collective_count: int = 0
    dot_flops: float = 0.0
    traffic_bytes: float = 0.0     # Σ (operands + results) over real ops
    traffic_bytes_fused: float = 0.0  # = traffic_bytes: eager fuses nothing
    while_trip_counts: Optional[Dict[str, int]] = None
    peak_bytes: int = 0            # largest sum of live storages
    argument_bytes: int = 0        # the arguments' storages
    ops: Dict[str, OpTally] = dataclasses.field(default_factory=dict)
    wall_s: float = 0.0            # the census's own time on the host


class Census(TorchDispatchMode):
    """Counts the ops run within it (see the module docstring); the
    totals are in ``stats``."""

    def __init__(self):
        super().__init__()
        self.stats = CensusStats()
        self._live: Dict[int, int] = {}
        self._cur = 0

    # -- live storages ---------------------------------------------------
    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage live until it is freed; its bytes if it
        is new, else 0."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self._cur += n
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._cur)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key):
        self._cur -= self._live.pop(key, 0)

    # -- the ops ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs the local ops
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                  # DTensor's shape inference
        for t in outs:
            self.track(t)
        self._count(func, args, ins, outs)
        return out

    def _count(self, func, args, ins, outs):
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        st = self.stats
        flops = 0
        if ns == "repro_torch" and name == FLASH_OP:
            q, k, v = args[0], args[1], args[2]
            causal, window = bool(args[3]), args[4]
            B, Sq, H, D = q.shape
            flops = flash_flops(B, Sq, k.shape[1], H, D, v.shape[-1],
                                causal, window)
            nbytes = flash_bytes(q, k, v)
        elif ns in _C10D:
            if name in _C10D_METADATA:
                return
            kind = _KINDS.get(name, name)
            operand = args[1] if name in _OPERAND_SECOND else args[0]
            b = sum(tensor_bytes(t) for t in _tensors(operand))
            st.collective_bytes += b
            st.collective_bytes_by_kind[kind] = \
                st.collective_bytes_by_kind.get(kind, 0.0) + b
            st.collective_count += 1
            nbytes = sum(tensor_bytes(t) for t in ins + outs)
        elif func.is_view or name in _NO_TRAFFIC:
            return
        else:
            if name in _DOTS:
                flops = dot_flops(name, args, outs[0])
            if name in _GATHERS:
                nbytes = 2 * sum(tensor_bytes(t) for t in outs)
            elif name in _SCATTERS:
                upd = args[_SCATTERS[name]] \
                    if len(args) > _SCATTERS[name] else None
                if isinstance(upd, torch.Tensor):
                    nbytes = 3 * tensor_bytes(upd)
                else:
                    nbytes = sum(tensor_bytes(t) for t in outs)
            elif name == "copy_":
                nbytes = 2 * tensor_bytes(args[1])
            else:
                nbytes = sum(tensor_bytes(t) for t in ins + outs)
        st.dot_flops += flops
        st.traffic_bytes += nbytes
        st.traffic_bytes_fused += nbytes
        tally = st.ops.setdefault(f"{ns}.{name}", OpTally())
        tally.calls += 1
        tally.flops += flops
        tally.bytes += nbytes


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def analyze(fn, *args, **kwargs) -> CensusStats:
    """Run ``fn(*args, **kwargs)`` once under a ``Census`` and return its
    per-device stats.  The arguments' storages (a DTensor's local block)
    are live from the start: ``argument_bytes``.  Give ``meta`` tensors:
    the census runs the program, on whatever device its tensors are."""
    census = Census()
    leaves = [_local(t) for t in tree_flatten((args, kwargs))[0]
              if isinstance(t, torch.Tensor)]
    census.stats.argument_bytes = sum(census.track(t) for t in leaves)
    t0 = time.perf_counter()
    with census:
        out = fn(*args, **kwargs)
    del out
    census.stats.wall_s = time.perf_counter() - t0
    return census.stats
