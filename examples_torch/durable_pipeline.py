"""Durable ingestion end to end: WAL → simulated crash → bit-exact recovery.

The port's counterpart of ``examples/durable_pipeline.py``: the
open-loop pipeline with the durability tier on.  Every sealed window is
written ahead to a segmented, CRC-framed WAL before dispatch, and the
index is snapshotted every few windows.  Mid-stream the process "dies"
(a fault point tears the record being appended, exactly as ``kill -9``
would), then ``recover()`` rebuilds the index from the latest snapshot
plus the WAL tail — through the same dispatcher execute path, on the
card — and the example verifies the recovered state is bit-identical to
a replay of the acknowledged prefix.

  PYTHONPATH=src python examples_torch/durable_pipeline.py [--device cpu]
"""
import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch import data as data_mod
from repro_torch import faults
from repro_torch.core import PIConfig, build, flat_leaves
from repro_torch.pipeline import (ArrivalConfig, Collector, Dispatcher,
                                  Durability, PipelineMetrics, WindowConfig,
                                  make_arrivals, read_wal, recover)


class Crash(RuntimeError):
    pass


def fresh_index(n_keys, keys, vals, device):
    return build(PIConfig(capacity=n_keys * 2, pending_capacity=1 << 12),
                 keys, vals, device=device)


def copy_window(w):
    return dataclasses.replace(
        w, ops=w.ops.copy(), keys=w.keys.copy(), vals=w.vals.copy(),
        qids=list(w.qids), slots=w.slots.copy(), t_enq=w.t_enq.copy(),
        seq=None)


def main(argv=None):
    """Runs the example; returns its counts and the audit's verdict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keys", type=int, default=1 << 14)
    ap.add_argument("--arrivals", type=int, default=1 << 13)
    args = ap.parse_args(argv)
    dev = args.device
    n_keys = args.keys
    ycfg = data_mod.YCSBConfig(n_keys=n_keys, theta=0.9, write_ratio=0.05)
    keys, vals = data_mod.ycsb_dataset(ycfg)
    stream = make_arrivals(
        ArrivalConfig(process="bursty", n_arrivals=args.arrivals), ycfg,
        keys)

    with tempfile.TemporaryDirectory() as wal_dir:
        # -- first life: serve with the WAL on, die mid-append ------------
        index = fresh_index(n_keys, keys, vals, dev)
        mets = PipelineMetrics()
        dur = Durability(wal_dir, index, fsync="per_window",
                         snapshot_every=4, metrics=mets)
        sealed = []

        def on_seal(win):            # keep copies so we can audit recovery
            sealed.append(copy_window(win))
            dur.on_seal(win)

        col = Collector(WindowConfig(batch=512, deadline=0.005),
                        on_seal=on_seal)
        disp = Dispatcher(index, depth=1, metrics=mets, durability=dur)

        kill = {"after": 4, "seen": 0}

        def fault_hook(point):       # tear the 5th record mid-write
            if point == "wal.mid_append":
                kill["seen"] += 1
                if kill["seen"] > kill["after"]:
                    raise Crash(point)

        faults.set_fault_hook(fault_hook)
        try:
            disp.run(stream, collector=col, clock=time.perf_counter)
            raise SystemExit("stream ended before the crash point")
        except Crash:
            pass
        finally:
            faults.set_fault_hook(None)
        acked = dur.durable_seq
        print(f"crashed mid-append of window {acked + 1}: "
              f"{len(sealed)} sealed, {acked} acknowledged durable, "
              f"last snapshot at seq {dur.last_snapshot_seq}")

        # -- second life: recover from disk -------------------------------
        surviving = read_wal(f"{wal_dir}/wal")
        print(f"WAL scan: {len(surviving)} intact records, torn tail "
              f"excluded")
        rmet = PipelineMetrics()
        recovered, replayed = recover(wal_dir, metrics=rmet, device=dev)
        print(f"recovered: snapshot + {rmet.recovery_replayed} replayed "
              f"windows -> seq {replayed[-1].seq if replayed else 0}")

        # -- audit: bit-identical to never having crashed ------------------
        oracle = Dispatcher(fresh_index(n_keys, keys, vals, dev), depth=0)
        for w in sealed[:acked]:
            oracle.submit(w)
        oracle.flush()
        same = all(torch.equal(a, b) for a, b in
                   zip(flat_leaves(recovered), flat_leaves(oracle.index)))
        print(f"recovered state bit-identical to acked-prefix replay: "
              f"{same}")
        assert same, "recovery diverged from the acknowledged prefix"
        print(f"metrics: wal_appends={mets.wal_appends} "
              f"wal_fsyncs={mets.wal_fsyncs} "
              f"recovery_replayed={rmet.recovery_replayed}")
    return {"sealed": len(sealed), "acked": acked, "intact": len(surviving),
            "replayed": rmet.recovery_replayed, "same": same}


if __name__ == "__main__":
    main()
