"""Batched LM serving with a PI-indexed session table.

Counterpart of ``repro.launch.serve``.  The session table (request id →
KV-cache slot) is a ``PIIndex``, and every scheduler tick issues ONE
sorted batch of index queries — admissions are INSERTs, lookups are
SEARCHes, completions are DELETEs — the paper's batch-processing model
applied to a continuous-batching server.  Ticks go through the port's
pipeline: a collector window of one static ``tick_width`` (sentinel
SEARCHes pad it), a depth-0 ``Dispatcher`` (the scheduler needs the
lookups within the tick) with the overload breaker armed by default, and,
with ``wal_dir``, the WAL and snapshots of ``pipeline.recovery``.

The model side is the port's LM of any family (dense, moe, mla_moe,
ssm, griffin): every token, prompt tokens included, goes through
``make_decode_step`` over the whole slot pool, as the JAX server does.
A MoE decode step of ``n_slots`` <= 8 tokens drops no copy (its capacity
is at least 8 rows an expert), so one slot's tokens never change
another's.  A recurrent family's step advances the state of every slot,
idle or mid-request, with the token the step gives it (0 where the slot
has none), as the JAX server's does: a live request's state moves with
the other slots' prompt steps.  Pass parameters already in the compute dtype
(``cast_floats`` once): the decode step then casts nothing.  Everything
lives on ``device`` (default: the card); ``index_backend`` is ``cuda``
(the CUDA kernels on the card, their plain versions on the CPU) or
``torch``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import DELETE, INSERT, RANGE, SEARCH, PIConfig, build
from repro_torch.core.index import _device
from repro_torch.models import decode as dec
from repro_torch.models import make_decode_step
from repro_torch.models.base import ModelConfig
from repro_torch.pipeline import (Collector, Dispatcher, Durability,
                                  OverloadConfig, PipelineMetrics,
                                  WindowConfig)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray        # (S,) token ids
    max_new: int = 8
    out: Optional[List[int]] = None


class Server:
    """Continuous batching with a fixed pool of cache slots."""

    def __init__(self, cfg: ModelConfig, params, n_slots: int = 8,
                 max_len: int = 64, index_backend: str = "cuda",
                 tick_width: int | None = None,
                 wal_dir: str | None = None,
                 wal_fsync: str = "per_window",
                 snapshot_every: int = 0,
                 overload: OverloadConfig | None = None,
                 device=None):
        self.cfg = cfg
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = _device(device)
        # PI session table: key = request id, value = slot
        table = build(PIConfig(capacity=4 * n_slots,
                               pending_capacity=2 * n_slots, fanout=4,
                               backend=index_backend,
                               tile_q=min(256, 4 * n_slots)),
                      np.zeros((0,), np.int32), np.zeros((0,), np.int32),
                      device=self.device)
        # every tick issues at most one op per slot per phase, so n_slots
        # bounds the window; padding to this one width keeps the shapes
        # static
        self.tick_width = tick_width or max(8, n_slots)
        self.pipeline_metrics = PipelineMetrics()
        # optional durability tier: with wal_dir set, every tick window is
        # written ahead to a segmented WAL before dispatch, and the session
        # table is snapshotted every snapshot_every windows (in the
        # background, so a periodic save does not stall the tick) —
        # recover the table after a crash with pipeline.recovery.recover
        self.durability = None
        if wal_dir is not None:
            self.durability = Durability(
                wal_dir, table, fsync=wal_fsync,
                snapshot_every=snapshot_every,
                metrics=self.pipeline_metrics,
                async_snapshots=True)
        self._collector = Collector(
            WindowConfig(batch=self.tick_width),
            on_seal=(self.durability.on_seal
                     if self.durability is not None else None))
        # the serving path arms the circuit breaker by default: a session
        # table that poisons on one pending overflow takes the whole
        # server down, while a recovered one costs a repack
        self._dispatcher = Dispatcher(table, depth=0,
                                      metrics=self.pipeline_metrics,
                                      durability=self.durability,
                                      overload=(overload if overload
                                                is not None
                                                else OverloadConfig()))
        self.free = list(range(n_slots))
        self.cache = dec.init_cache(cfg, n_slots, max_len, device=self.device)
        self.pos = np.zeros(n_slots, np.int32)
        self.live: Dict[int, Request] = {}
        self.slot_of: Dict[int, int] = {}
        self._decode = make_decode_step(cfg)
        self.queries_processed = 0

    @property
    def table(self):
        """Current session-table state (owned by the dispatcher)."""
        return self._dispatcher.index

    def close(self):
        """Flush the durability tier (no-op when WAL is off)."""
        if self.durability is not None:
            self.durability.close()

    # -- PI session-table tick (one sorted batch per scheduler round) -----
    def _index_tick(self, admits, lookups, completes):
        """Collect this tick's ops into a window, dispatch, map back.

        The dispatcher runs synchronously (depth 0): a scheduler tick needs
        its lookup results to resolve KV slots before decoding.
        """
        tick_ops = ([(INSERT, rid, slot) for rid, slot in admits]
                    + [(SEARCH, rid, 0) for rid in lookups]
                    + [(DELETE, rid, 0) for rid in completes])
        if not tick_ops:
            return {}
        if len(tick_ops) > self.tick_width:
            raise ValueError(
                f"tick issues {len(tick_ops)} ops > tick_width "
                f"{self.tick_width}; raise tick_width (ops per tick are "
                f"bounded by the slot pool, so this is a config error)")
        now = time.perf_counter()
        tick_arr = np.asarray(tick_ops, np.int32)
        _, sealed = self._collector.offer_many(
            np.full(len(tick_ops), now), tick_arr[:, 0], tick_arr[:, 1],
            tick_arr[:, 2], np.arange(len(tick_ops)))
        assert not sealed, "tick window sized to admit every tick op"
        window = self._collector.take(now)
        (result,) = self._dispatcher.submit(window)  # depth 0 → sync retire
        per_qid = result.per_arrival()
        self.queries_processed += len(tick_ops)
        base = len(admits)
        out = {}
        for i, rid in enumerate(lookups):
            found, val = per_qid[base + i]
            out[rid] = val if found else None
        return out

    def session_range(self, lo: int, hi: int):
        """Aggregate over live sessions with rid in ``[lo, hi]``.

        One RANGE op through the same tick pipeline every point op rides
        (collect → WAL when armed → range execute).  Returns
        ``(count, slot_sum)`` — how many live rids fall in the interval
        and the sum of their KV-cache slots.
        """
        now = time.perf_counter()
        _, sealed = self._collector.offer_many(
            np.full(1, now), np.asarray([RANGE], np.int32),
            np.asarray([lo], np.int32), np.asarray([0], np.int32),
            np.arange(1), keys2=np.asarray([hi], np.int32))
        assert not sealed, "tick window sized to admit every tick op"
        window = self._collector.take(now)
        (result,) = self._dispatcher.submit(window)  # depth 0 → sync retire
        self.queries_processed += 1
        return result.per_arrival_ranges()[0]

    def admit(self, reqs: List[Request]):
        admits = []
        for r in reqs:
            if not self.free:
                break
            slot = self.free.pop()
            self.live[r.rid] = r
            self.slot_of[r.rid] = slot
            r.out = []
            admits.append((r.rid, slot))
            # per-slot prefill: the prompt through decode steps, as the
            # JAX server does
            for t, tok in enumerate(r.prompt):
                self._step_slot(slot, int(tok), t)
            self.pos[slot] = len(r.prompt)
        self._index_tick(admits, [], [])
        return len(admits)

    def _decode_tokens(self, tokens: np.ndarray, idx: int) -> np.ndarray:
        nxt, _, self.cache = self._decode(
            self.params, {"cache": self.cache,
                          "tokens": torch.from_numpy(tokens).to(self.device),
                          "idx": idx})
        return nxt.cpu().numpy()

    def _step_slot(self, slot, tok, idx):
        tokens = np.zeros((self.n_slots, 1), np.int32)
        tokens[slot, 0] = tok
        return int(self._decode_tokens(tokens, idx)[slot])

    def tick(self):
        """One decode round for every live request (batched), then retire
        finished ones.  Slot resolution goes through the PI table."""
        if not self.live:
            return []
        rids = sorted(self.live)
        slots = self._index_tick([], rids, [])
        tokens = np.zeros((self.n_slots, 1), np.int32)
        idx = int(max(self.pos[self.slot_of[r]] for r in rids))
        for rid in rids:
            slot = slots[rid]
            assert slot == self.slot_of[rid], "PI table diverged"
            last = self.live[rid].out[-1] if self.live[rid].out else \
                int(self.live[rid].prompt[-1])
            tokens[slot, 0] = last
        nxt = self._decode_tokens(tokens, idx)
        finished = []
        for rid in rids:
            slot = self.slot_of[rid]
            r = self.live[rid]
            r.out.append(int(nxt[slot]))
            self.pos[slot] += 1
            if len(r.out) >= r.max_new or self.pos[slot] >= self.max_len - 1:
                finished.append(rid)
        self._index_tick([], [], finished)
        for rid in finished:
            self.free.append(self.slot_of.pop(rid))
            del self.live[rid]
        return finished
