"""Windowed dispatch: collector windows → ranges → execute.

Counterpart of ``repro.pipeline.dispatcher``.  The ``Dispatcher`` owns the
index state and runs sealed collector windows against it in order.  A
window's RANGE lanes run first, against the pre-window state
(``pipeline.ranges.execute_ranges``: one ``pi_range`` launch on the card);
then its point view runs through ``step_single``: execute, the overflow
snapshot, and the rebuild when one is due.

Routing: a ``PIIndex`` executes locally through ``step_single``; a
``ShardedPIIndex`` (with the ``mesh`` it lives on) goes through
``core.distributed.execute_sharded``, whose fence partitioning routes each
window's per-shard slices, then ``maybe_rebuild_shards`` rebuilds the
shards that are due; its ranges go through
``pipeline.ranges.execute_ranges_sharded``.  Over the ranks of a mesh
every rank runs the same dispatcher on the same windows, and every device
value that a host branch reads is first gathered from every rank: the
results, drops, overflow and rebuild flags and the pending fill, with a
digest of the window that must be the same on every rank (a rank that
diverged fails loudly; one that stops fails its peers at the process
group's timeout).

PyTorch launches asynchronously, so with ``depth >= 1`` the host forms
window k+1 while the card still runs window k, and a window's results
reach the host (its *retirement*) ``depth`` windows late.  The overlap is
partial: ``step_single`` reads ``needs_rebuild`` on the host — where the
JAX package branches with ``lax.cond`` inside one program — which waits
for the window's execute; and one more read, of ``incremental_fits``,
picks the tier when a rebuild is due.  Ranges can be enqueued before the
point execute only because ``execute_impl`` never writes to its input
index.

Failure contract: a pending-buffer ``overflow`` means a net insert was
dropped — data loss.  The dispatcher snapshots the flag after every
execute (the rebuild that follows resets it on the state) and raises
``PendingOverflowError`` at retirement; the failure then poisons the
dispatcher, so every later ``submit``/``flush`` raises it again.
Sharded routing has an analogous loss mode — a fence bucket exceeding its
``capacity_factor`` drops real queries — surfaced as
``DispatchOverflowError`` the same way (dropped padding is not counted).

With an ``OverloadConfig`` whose breaker is armed, a pending overflow is
no longer fatal: a **circuit breaker** rolls the index back to the state
before the failing window (kept on the in-flight record; ``execute_impl``
never writes its input, so no copy is needed), forces a full repack to
reclaim the pending space, replays the quarantined windows through
``step_recover`` (which rebuilds after every window), and resumes.
Repeated trips within a rolling interval degrade to a read-only mode
(write windows rejected with ``ReadOnlyModeError``, reads served); only
an unrecoverable replay — an overflow from an empty pending buffer, a
geometry error — or a trip while already read-only latches the poisoned
state.  The breaker does not apply to the sharded path, whose routing
drops have no rollback point.

Durability (``pipeline.recovery.Durability``): ``run`` hands the
collector ``durability.on_seal``, so every window is in the WAL before it
is dispatched, and ``submit`` calls ``durability.maybe_snapshot`` after
each window's step; a sharded dispatcher records its capacity factor
(``durability.record_capacity_factor``), at which recovery replays.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import distributed as dist
from repro_torch.core import index as pi
from repro_torch.core.batch import RANGE, SEARCH
from repro_torch.kernels.pi_search import sentinel_for
from repro_torch.pipeline.collector import Collector, Window, WindowConfig
from repro_torch.pipeline.metrics import PipelineMetrics
from repro_torch.pipeline.overload import (BREAKER_CLOSED, BREAKER_POISONED,
                                           BREAKER_READ_ONLY,
                                           BREAKER_RECOVERING,
                                           OverloadConfig, ReadOnlyModeError)
from repro_torch.pipeline.ranges import execute_ranges, execute_ranges_sharded


class PendingOverflowError(RuntimeError):
    """The index dropped net inserts: pending buffer overflowed mid-window.

    ``windows`` carries every in-flight ``Window`` at failure time — the
    failing one first — so a caller can account for exactly which arrivals
    never produced results.
    """

    windows: List[Window] = []


class DispatchOverflowError(RuntimeError):
    """Sharded routing dropped queries: a fence bucket exceeded its send
    capacity (``capacity_factor`` too small for the window's skew).

    ``windows`` carries every in-flight ``Window`` at failure time — the
    failing one first (see ``PendingOverflowError``).
    """

    windows: List[Window] = []


def _digest(ops, keys, vals) -> torch.Tensor:
    """An int32 digest of a window's lanes (wrapping sums, a float32 key
    by its bits), by which the ranks of a sharded dispatcher check that
    they run the same window."""
    w = torch.arange(1, ops.numel() + 1, dtype=torch.int32,
                     device=ops.device)
    k = keys if keys.dtype == torch.int32 else keys.view(torch.int32)
    return ((ops * 3 + k * 5 + vals * 7) * w).sum(dtype=torch.int32)


def step_single(index: pi.PIIndex, ops, keys, vals):
    """Execute one window + overflow snapshot + rebuild-if-due.

    Returns ``(new_index, found, val, ovf, due, incr, pn)`` as the JAX
    step does: ``ovf`` is the pending-overflow flag right after execute
    (a rebuild resets it on the state), ``pn`` the pending fill before
    any rebuild, ``due`` whether a rebuild ran and ``incr`` whether it
    took the incremental tier.  The input index is left untouched.
    """
    new_index, (found, val) = pi.execute_impl(index, ops, keys, vals)
    ovf = new_index.overflow
    pn = new_index.pn  # fill high-water: post-rebuild pn is ~always zero
    due = pi.needs_rebuild(new_index)
    incr = False
    # the one host read of a window: which rebuild, if any (ROADMAP
    # performance note 3; a CUDA graph of the window would remove it)
    with tracing.span(tracing.WAIT_REBUILD_CHECK):
        rebuild_due = bool(due)  # pilint: disable=PI002 — ROADMAP note 3
    if rebuild_due:
        new_index, incr = pi.rebuild_tier(new_index)
    incr = torch.tensor(incr, device=new_index.device)
    return new_index, found, val, ovf, due, incr, pn


def step_recover(index: pi.PIIndex, ops, keys, vals):
    """The breaker's replay step: ``step_single`` with a rebuild after
    every window → ``(new_index, found, val, ovf, pn)``.

    During recovery the pending buffer must end every replayed window
    empty — the quarantined windows were the ones that overflowed it, and
    the ordinary threshold leaves enough residue to trip again on the
    next one.  Off the fast path: it runs only after a breaker trip.
    """
    new_index, (found, val) = pi.execute_impl(index, ops, keys, vals)
    ovf = new_index.overflow
    pn = new_index.pn
    return pi.rebuild(new_index), found, val, ovf, pn


@dataclasses.dataclass
class WindowResult:
    """A retired window: per-slot results + the arrival→slot map to read them."""

    window: Window
    found: np.ndarray      # (batch,) bool
    val: np.ndarray        # (batch,) int32
    t_retired: float
    rebuilt: bool
    rebuilt_incremental: bool = False  # rebuild took the segmented fast tier
    pending_fill: float = float("nan")  # pn high-water / pending_capacity
    rcnt: Optional[np.ndarray] = None  # (batch,) int32 RANGE counts
    rsum: Optional[np.ndarray] = None  # (batch,) int32 RANGE value sums

    def per_arrival(self) -> Dict[int, Tuple[bool, int]]:
        """qid → (found, val) for *point* arrivals, fanning shared slots
        back out; RANGE arrivals read theirs from ``per_arrival_ranges``."""
        out = {}
        ops = self.window.ops
        for qid, slot in zip(self.window.qids, self.window.slots):
            if ops[slot] != RANGE:
                out[qid] = (bool(self.found[slot]), int(self.val[slot]))
        return out

    def per_arrival_ranges(self) -> Dict[int, Tuple[int, int]]:
        """qid → (count, sum) for RANGE arrivals (coalesced pairs fan back
        out to every arrival sharing the slot)."""
        out = {}
        if self.rcnt is None:
            return out
        ops = self.window.ops
        for qid, slot in zip(self.window.qids, self.window.slots):
            if ops[slot] == RANGE:
                out[qid] = (int(self.rcnt[slot]), int(self.rsum[slot]))
        return out

    def latencies(self) -> np.ndarray:
        """Per-arrival enqueue→result latency, on the caller's time axis."""
        return self.t_retired - self.window.t_enq


@dataclasses.dataclass
class _InFlight:
    window: Window
    found: torch.Tensor
    val: torch.Tensor
    overflow: torch.Tensor  # snapshot scalar, taken before the rebuild reset
    rebuilt: torch.Tensor
    incr: Optional[torch.Tensor]     # rebuild tier taken (None: sharded)
    dropped: Optional[torch.Tensor]  # sharded routing drops (None: local)
    pn: torch.Tensor        # pending fill high-water (pre-rebuild)
    rcnt: Optional[torch.Tensor] = None  # RANGE counts (pre-window state)
    rsum: Optional[torch.Tensor] = None  # RANGE value sums
    # index state BEFORE this window's execute, which execute_impl leaves
    # untouched; the breaker rolls back to it on a trip.  Kept only when
    # the breaker is armed (it pins the card's memory).
    pre_index: Optional[pi.PIIndex] = None


class Dispatcher:
    """Owns the index state; executes sealed windows against it in order."""

    def __init__(self, index, *, mesh=None, depth: int = 1,
                 check_overflow: bool = True,
                 capacity_factor: float = 2.0,
                 max_span: int = 1024,
                 metrics: Optional[PipelineMetrics] = None,
                 durability=None,
                 overload: Optional[OverloadConfig] = None,
                 clock=time.perf_counter):
        if isinstance(index, dist.ShardedPIIndex) and mesh is None:
            raise ValueError("a ShardedPIIndex needs its mesh for routing")
        self._index = index
        self._mesh = mesh
        self.depth = max(0, int(depth))
        self.check_overflow = check_overflow
        self.capacity_factor = capacity_factor
        # occupied-key scan budget per RANGE (core.range_agg's max_span)
        self.max_span = int(max_span)
        self.metrics = metrics
        # durability tier (pipeline.recovery.Durability): submit() calls
        # maybe_snapshot after each window, run() wires on_seal
        self.durability = durability
        # overload tier (pipeline.overload.OverloadConfig): with a breaker
        # armed, a pending overflow recovers (rollback + repack + replay)
        # instead of poisoning.  None keeps the poisoning contract, as does
        # the sharded path.
        self.overload = overload
        self._clock = clock
        self._inflight: List[_InFlight] = []
        self._poisoned: Optional[BaseException] = None
        self._breaker = BREAKER_CLOSED
        self._trip_times: List[float] = []
        self._read_only_since: Optional[float] = None
        self.breaker_trips = 0
        self.breaker_recoveries = 0
        cfg = index.shards.config if self._sharded else index.config
        self._pending_capacity = int(cfg.pending_capacity)
        if durability is not None and self._sharded:
            # recover replays the WAL at this routing
            durability.record_capacity_factor(capacity_factor)

    @property
    def _sharded(self) -> bool:
        return isinstance(self._index, dist.ShardedPIIndex)

    @property
    def index(self):
        """Current index state (reading its tensors may wait for the card)."""
        return self._index

    @property
    def poisoned(self) -> Optional[BaseException]:
        """The latched retirement failure, if any (see ``_retire_front``)."""
        return self._poisoned

    @property
    def breaker_state(self) -> str:
        """Where the breaker sits in closed → recovering → read_only →
        poisoned.  ``recovering`` is only visible from within a recovery
        (e.g. a durability hook); callers see the settled state.  Reading
        the state applies the time-based read-only decay."""
        if self._poisoned is not None:
            return BREAKER_POISONED
        self._read_only_active()
        return self._breaker

    def _read_only_active(self) -> bool:
        """Whether read-only mode is still in force, applying quiet decay:
        a full ``recovery_interval`` without a trip closes the breaker."""
        if self._breaker != BREAKER_READ_ONLY:
            return False
        if self._clock() - self._read_only_since \
                >= self.overload.recovery_interval:
            self.reset_breaker()
            return False
        return True

    def reset_breaker(self):
        """Operator override: close a read-only breaker and forget trips.

        A latched poisoning is *not* resettable — it means data was lost
        or recovery itself failed, so the index state cannot be trusted.
        """
        if self._poisoned is not None:
            raise RuntimeError(
                "cannot reset a poisoned dispatcher: the failure was "
                "unrecoverable, the index state is not trustworthy")
        self._breaker = BREAKER_CLOSED
        self._trip_times.clear()
        self._read_only_since = None

    # -- execution ---------------------------------------------------------

    def _step(self, ops, keys, vals):
        """One execute + rebuild-if-due → (found, val, ovf, rebuilt, incr,
        dropped, pn)."""
        if self._sharded:
            state, (found, val), _, dropped = dist.execute_sharded(
                self._index, self._mesh, ops, keys, vals,
                capacity_factor=self.capacity_factor)
            # this rank's hottest shard's fill high-water and, over
            # several ranks, a digest of the window, gathered with the
            # rebuild flags
            mine = state.shards.pn.max()[None]
            if state.group is not None:
                mine = torch.cat([mine, _digest(ops, keys, vals)[None]])
            shards, ovf, rebuilt, every = dist.rebuild_due(
                state.shards, state.group, mine)
            if state.group is not None and len({e[1] for e in every}) > 1:
                raise RuntimeError(
                    "the ranks ran different windows: every rank must run "
                    "the same collector on the same arrivals")
            self._index = dataclasses.replace(state, shards=shards)
            return found, val, ovf, rebuilt, None, dropped.sum(), \
                max(e[0] for e in every)
        self._index, found, val, ovf, rebuilt, incr, pn = step_single(
            self._index, ops, keys, vals)
        return found, val, ovf, rebuilt, incr, None, pn

    def _tensors(self, *arrays):
        """Window arrays as tensors on the index's device."""
        dev = self._index.device
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    @staticmethod
    def _window_has_writes(window: Window) -> bool:
        ops = np.asarray(window.ops[:window.occupancy])
        return bool(np.any((ops != SEARCH) & (ops != RANGE)))

    @staticmethod
    def _window_has_ranges(window: Window) -> bool:
        if window.keys2 is None:  # pre-range producer: no range lane
            return False
        return bool(np.any(np.asarray(window.ops[:window.occupancy])
                           == RANGE))

    @staticmethod
    def _point_view(window: Window):
        """The window's point-op image: RANGE lanes become sentinel
        SEARCHes — the exact shape of a pad slot — so the point execute
        serves range-bearing windows unchanged.  Windows without ranges
        pass through untouched (zero-copy).  The breaker's replay masks
        the same way, so it stays bit-identical.
        """
        ops = np.asarray(window.ops)
        is_r = ops == RANGE
        if not is_r.any():
            return window.ops, window.keys
        keys = np.asarray(window.keys)
        sent = sentinel_for(keys.dtype)
        return (np.where(is_r, SEARCH, ops).astype(ops.dtype),
                np.where(is_r, sent, keys).astype(keys.dtype))

    def _breaker_armed(self) -> bool:
        return (self.overload is not None and self.overload.breaker
                and not self._sharded)

    def submit(self, window: Window) -> List[WindowResult]:
        """Dispatch a sealed window; retire whatever exceeds the depth.

        Returns the windows retired by this call (possibly empty) so
        callers can stream results without a separate polling loop.
        Raises ``ReadOnlyModeError`` for a window with writes while the
        breaker is read-only (before anything runs).
        """
        with tracing.span(tracing.SUBMIT):
            return self._submit(window)

    def _submit(self, window: Window) -> List[WindowResult]:
        self._check_poisoned()
        if self._read_only_active() and self._window_has_writes(window):
            if self.metrics is not None:
                self.metrics.read_only_rejections += window.n_arrivals
            raise ReadOnlyModeError(
                f"dispatcher is read-only after {self.breaker_trips} "
                f"breaker trips: window with writes rejected (searches "
                f"still serve).  Retry after the breaker closes, or "
                f"reset_breaker() to override.")
        pre = self._index if self._breaker_armed() else None
        # ranges first, against the pre-execute state: every RANGE in the
        # window observes the index as of the window boundary
        rcnt = rsum = None
        if self._window_has_ranges(window):
            ranges = execute_ranges_sharded if self._sharded \
                else execute_ranges
            with tracing.span(tracing.SUBMIT_RANGES):
                rcnt, rsum = ranges(
                    self._index, *self._tensors(window.ops, window.keys,
                                                window.keys2), self.max_span)
        ops, keys = self._point_view(window)
        found, val, ovf, rebuilt, incr, dropped, pn = self._step(
            *self._tensors(ops, keys, window.vals))
        self._inflight.append(_InFlight(window, found, val, ovf, rebuilt,
                                        incr, dropped, pn, rcnt=rcnt,
                                        rsum=rsum, pre_index=pre))
        if self.durability is not None:
            # the new index state reflects every window up to and
            # including this one, so window.seq is its WAL position
            self.durability.maybe_snapshot(self._index, window.seq)
        retired = []
        while len(self._inflight) > self.depth:
            retired.append(self._retire_front())
        return retired

    def flush(self) -> List[WindowResult]:
        """Retire every in-flight window (blocks until the card drains)."""
        self._check_poisoned()
        retired = []
        while self._inflight:
            retired.append(self._retire_front())
        return retired

    def run(self, stream, wcfg: Optional[WindowConfig] = None, *,
            collector: Optional[Collector] = None,
            chunk: Optional[int] = None,
            clock=None) -> List[WindowResult]:
        """Replay a whole arrival stream: bulk admission fused with
        double-buffered submit.

        ``stream`` is anything with 1-D ``t/ops/keys/vals`` arrays (an
        ``ArrivalStream``; an optional ``keys2`` array carries RANGE
        upper bounds); arrival i's qid is its position i.  Admission goes
        through ``Collector.offer_many`` one ``chunk`` at a time (default:
        one window's worth) so window formation for chunk k+1 overlaps the
        card executing chunk k.  With ``clock`` given, admission times are
        stamped from it per chunk (wall-clock replay); otherwise the
        stream's own virtual times drive deadline splitting.  The tail
        window is flush-sealed and every window is retired before
        returning, in retirement order.
        """
        col = collector if collector is not None else Collector(
            wcfg if wcfg is not None else WindowConfig(),
            on_seal=(self.durability.on_seal
                     if self.durability is not None else None))
        step = chunk or col.cfg.batch
        n = len(stream.t)
        qids = np.arange(n)
        keys2 = getattr(stream, "keys2", None)
        retired: List[WindowResult] = []
        for s in range(0, n, step):
            e = min(n, s + step)
            t = np.full(e - s, clock()) if clock is not None \
                else stream.t[s:e]
            _, sealed = col.offer_many(t, stream.ops[s:e], stream.keys[s:e],
                                       stream.vals[s:e], qids[s:e],
                                       keys2[s:e] if keys2 is not None
                                       else None)
            for w in sealed:
                retired.extend(self.submit(w))
        tail = col.take(clock()) if clock is not None else col.take()
        if tail is not None:
            retired.extend(self.submit(tail))
        retired.extend(self.flush())
        return retired

    def _check_poisoned(self):
        if self._poisoned is not None:
            # a fresh instance per raise, so that the latched one's
            # traceback does not grow with every call; the original rides
            # along as __cause__
            e = self._poisoned
            fresh = type(e)(*e.args)
            fresh.windows = getattr(e, "windows", [])
            raise fresh from e

    def _retire_front(self) -> WindowResult:
        """Retire the oldest in-flight window; latch any data-loss error.

        A failed retirement means the index state already reflects an
        execute that lost inserts, and every later window ran against it.
        With a breaker armed a pending overflow is *recovered* instead
        (``_breaker_recover``).  Otherwise — or when recovery itself
        fails — the failure poisons the dispatcher, the failing window
        stays in flight, and the exception's ``windows`` lists it plus
        every window queued behind it, so the caller can replay them
        elsewhere.
        """
        try:
            res = self._retire(self._inflight[0])
        except PendingOverflowError as e:
            if self._breaker_armed() and \
                    self._inflight[0].pre_index is not None:
                return self._breaker_recover(e)
            e.windows = [f.window for f in self._inflight]
            self._poisoned = e
            raise
        except DispatchOverflowError as e:
            e.windows = [f.window for f in self._inflight]
            self._poisoned = e
            raise
        self._inflight.pop(0)
        return res

    def _breaker_recover(self, cause: PendingOverflowError) -> WindowResult:
        """Recover from a pending overflow: rollback → repack → replay.

        The overflowing execute dropped net inserts, so the post-execute
        state is corrupt — but the state *before* the failing window is
        still on the card (``pre_index``), and every window that executed
        after it is still in flight with its inputs intact.  Roll back,
        force a full repack (which empties the pending buffer, the
        resource that overflowed), and replay every quarantined window
        through ``step_recover``.  A replay that overflows *from an empty
        pending buffer* is a geometry error (one window nets more inserts
        than the whole buffer) and latches poisoned for real.

        Escalation: recoveries inside one rolling ``recovery_interval``
        beyond ``max_recoveries`` degrade the breaker to read-only; a trip
        while *already* read-only latches poisoned — after the recovery
        completes, so the state stays consistent for a post-mortem.
        """
        ocfg = self.overload
        now = self._clock()
        self.breaker_trips += 1
        self._trip_times.append(now)
        if self.metrics is not None:
            self.metrics.breaker_trips += 1
        was_read_only = self._breaker == BREAKER_READ_ONLY
        self._breaker = BREAKER_RECOVERING
        quarantined = self._inflight
        self._inflight = []
        # the forced reclaim: merge the pending buffer into storage and
        # re-spread the slack, so that the replay has all of it
        self._index = pi.repack(quarantined[0].pre_index)
        for i, f in enumerate(quarantined):
            w = f.window
            # the same point view as the live submit; the range results
            # ride along as served (they read the pre-window state, which
            # the rollback restored)
            ops, keys = self._point_view(w)
            self._index, found, val, ovf, pn = step_recover(
                self._index, *self._tensors(ops, keys, w.vals))
            if bool(ovf):  # a host sync, off the fast path
                err = PendingOverflowError(
                    f"unrecoverable overflow: window nets more inserts than "
                    f"the entire pending buffer even after a repack "
                    f"(occupancy {w.occupancy} vs pending_capacity "
                    f"{self._pending_capacity}) — geometry error, grow "
                    f"PIConfig.pending_capacity above the window batch")
                err.windows = [g.window for g in quarantined[i:]]
                self._poisoned = err
                raise err from cause
            dev = self._index.device
            self._inflight.append(_InFlight(
                w, found, val, ovf, torch.tensor(True, device=dev),
                torch.tensor(False, device=dev), None, pn, rcnt=f.rcnt,
                rsum=f.rsum))
        self.breaker_recoveries += 1
        if self.metrics is not None:
            self.metrics.breaker_recoveries += 1
        if self.durability is not None and quarantined[-1].window.seq \
                is not None:
            # the quarantined windows were in the WAL before dispatch, so
            # no acknowledged op is lost — but a snapshot taken between the
            # corrupt execute and this recovery would hold the state before
            # the rollback.  A fresh blocking snapshot at the replayed
            # frontier supersedes it.
            self.durability.snapshot(self._index,
                                     seq=quarantined[-1].window.seq)
        if was_read_only:
            err = PendingOverflowError(
                "overflow while the breaker was already read-only: the "
                "degraded mode failed to protect the index.  State was "
                "recovered (no data lost) but serving halts — the workload "
                "is beyond what this geometry can absorb.")
            err.windows = []
            self._poisoned = err
            raise err from cause
        self._trip_times = [t for t in self._trip_times
                            if now - t <= ocfg.recovery_interval]
        if len(self._trip_times) > ocfg.max_recoveries:
            self._breaker = BREAKER_READ_ONLY
            self._read_only_since = now
        else:
            self._breaker = BREAKER_CLOSED
        res = self._retire(self._inflight[0])
        self._inflight.pop(0)
        return res

    def _retire(self, infl: _InFlight) -> WindowResult:
        with tracing.span(tracing.RETIRE):
            with tracing.span(tracing.WAIT_RETIRE):
                res = self._read_back(infl)
            if self.metrics is not None:
                self.metrics.on_retire(res)
            return res

    def _read_back(self, infl: _InFlight) -> WindowResult:
        """A window's results read back from the card, where the host
        waits for its execute; raises on a lost insert or query."""
        found = infl.found.cpu().numpy()   # waits for the card here
        val = infl.val.cpu().numpy()
        if self.check_overflow and bool(infl.overflow):
            raise PendingOverflowError(
                "pending buffer overflowed while executing a window: net "
                "inserts were dropped.  Grow PIConfig.pending_capacity "
                "above the window batch, or rebuild more aggressively.")
        if self.check_overflow and infl.dropped is not None \
                and int(infl.dropped) > 0:
            raise DispatchOverflowError(
                f"fence routing dropped {int(infl.dropped)} queries: a "
                f"shard's send bucket overflowed.  Raise capacity_factor "
                f"({self.capacity_factor}) or rebalance the fences.")
        return WindowResult(
            window=infl.window, found=found, val=val,
            t_retired=self._clock(), rebuilt=bool(infl.rebuilt),
            rebuilt_incremental=infl.incr is not None and bool(infl.incr),
            pending_fill=int(infl.pn) / self._pending_capacity,
            rcnt=infl.rcnt.cpu().numpy() if infl.rcnt is not None else None,
            rsum=infl.rsum.cpu().numpy() if infl.rsum is not None else None)
