"""``pi_probe``'s share of its roofline: the least bytes the window's
probes need (``pibench.roofline.probe_bytes``) over the H100's 3.35 TB/s,
divided by the device time of ``pi_probe_kernel`` in the traced window.
On S shards each shard's launch probes the S * cap lanes routed to it."""
import numpy as np

from pibench import roofline, trace, ycsb


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    device_s = sum(trace.device_time(tl, "pi_probe_kernel").values())
    cfg = run.cell.config
    C, F, S = cfg["capacity"], cfg["fanout"], cfg["shards"]
    sent = np.iinfo(np.int32).max
    num = round(cfg.get("capacity_factor", 2.0) * 1024)
    lanes_per_shard = S * -(-(cfg["window"] // S) * num // (S * 1024))
    results = {id(r.window): r.result for r in run.retired}
    nbytes, pending = 0, 0
    for w, t in run.submitted:
        if run.in_window(t):
            ops = np.asarray(w.ops)
            keys = np.where(ops == ycsb.RANGE, sent, np.asarray(w.keys))
            if S == 1:
                nbytes += roofline.probe_bytes(keys.size, np.unique(keys).size,
                                               C, F, pending)
            else:
                real = keys[keys != sent]
                dest = np.clip(np.searchsorted(run.fences[1:-1], real,
                                               side="right"), 0, S - 1)
                for s in range(S):
                    mine = real[dest == s]
                    distinct = np.unique(mine).size + \
                        int(mine.size < lanes_per_shard)
                    nbytes += roofline.probe_bytes(lanes_per_shard, distinct,
                                                   C, F, pending)
        res = results.get(id(w))
        # the next window probes the pending keys this one left (none
        # after a rebuild); on shards, the fullest shard's
        pending = 0 if res is None or res.rebuilt else \
            round(res.pending_fill * cfg["pending_capacity"])
    return roofline.share_pct(nbytes, device_s)
