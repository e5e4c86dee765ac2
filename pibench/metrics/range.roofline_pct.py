"""``pi_range``'s share of its roofline on one shard: the least bytes the
window's scans need (``pibench.roofline.range_bytes``, each scan's records
as the reference counts them) over the H100's 3.35 TB/s, divided by the
device time of ``pi_range_group_kernel`` in the traced window."""
import numpy as np

from pibench import roofline, trace, ycsb


def read(run):
    tl = run.timeline
    cfg = run.cell.config
    if tl is None or run.expected is None or cfg["shards"] != 1:
        return None
    device_s = sum(trace.device_time(tl, "pi_range_group_kernel").values())
    C, F = cfg["capacity"], cfg["fanout"]
    counts = run.expected[0]
    results = {id(r.window): r.result for r in run.retired}
    nbytes, pending = 0, 0
    for w, t in run.submitted:
        ops = np.asarray(w.ops)
        is_r = ops == ycsb.RANGE
        if run.in_window(t) and is_r.any():
            per_slot = np.zeros(ops.size, np.int64)
            per_slot[np.asarray(w.slots)] = counts[np.asarray(w.qids)]
            lo = np.asarray(w.keys)[is_r]
            nbytes += roofline.range_bytes(
                ops.size, int(is_r.sum()), np.unique(lo).size,
                int(per_slot[is_r].sum()), C, F, pending)
        res = results.get(id(w))
        pending = 0 if res is None or res.rebuilt else \
            round(res.pending_fill * cfg["pending_capacity"])
    return roofline.share_pct(nbytes, device_s)
