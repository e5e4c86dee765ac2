"""A/B of ``chip_smoke.py``'s ``[sharded]`` path between checkouts.

    python3 sharded_ab.py OTHER_CHECKOUT [MORE ...] [--reps 3] [--rounds 2]

Runs the other checkouts and this one (each with its own ``src`` and its
own kernel build) in rounds, in the order others, this, then this,
others reversed, and so on, each run in a process of its own on the
card.  A run builds ``[sharded]``'s index
(2^24 YCSB keys in 8 fence-routed shards) with each checkout's
``chip_smoke.py`` helpers and times, ``--reps`` times, its 32 point
windows through a
depth-0 sharded ``Dispatcher`` (the window p50) and its YCSB-E stream
through ``Dispatcher.run`` (arrivals a second), as ``[sharded]`` does,
and counts, under ``torch.profiler``, the operators the host issues and
the kernels the card runs for 4 point windows and for the stream.
Every checkout must give the same results bit for bit (a digest of every
window's found/val and range results).  Prints one JSON line a run, and
last the card's name and power limit.
"""
import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def one(tree: str, reps: int) -> dict:
    """Measure ``tree`` in this process."""
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch import core as pi
    from repro_torch import data
    from repro_torch.kernels import build as kbuild
    from repro_torch.pipeline import PipelineMetrics
    assert cs.__file__.startswith(tree), cs.__file__
    kbuild.build()
    ycfg = data.YCSBConfig(n_keys=cs.N_KEYS, key_space=1 << 30, batch=8192,
                           write_ratio=0.5, theta=0.9, seed=cs.SEED)
    keys_np, vals_np = data.ycsb_dataset(ycfg)
    state = pi.build_sharded(cs.shard_config(len(keys_np)), cs.SHARDS,
                             keys_np, vals_np, device="cuda")
    mesh = pi.make_mesh((cs.SHARDS,), ("data",), device="cuda")
    windows = cs.point_windows(ycfg, keys_np, cs.SHARD_WINDOWS)
    stream = cs.ycsb_e_stream(ycfg, keys_np, cs.SHARD_SERVE_WINDOWS,
                              cs.SEED + 3)
    kw = dict(mesh=mesh, capacity_factor=cs.CAPACITY_FACTOR)
    cs.run_point_windows(state, mesh, windows[:2])          # warm-up
    cs.serve(state, cs.ycsb_e_stream(ycfg, keys_np, 2, cs.SEED + 9),
             ycfg.batch, **kw)
    digest = hashlib.sha256()
    out = dict(tree=tree, p50_ms=[], stream_arrivals_s=[],
               stream_p50_ms=[])
    for rep in range(reps):
        retired, lat, _, _ = cs.run_point_windows(state, mesh, windows)
        out["p50_ms"].append(float(np.percentile(np.array(lat) * 1e3, 50)))
        met = PipelineMetrics()
        _, s_retired, wall = cs.serve(state, stream, ycfg.batch, met, **kw)
        out["stream_arrivals_s"].append(len(stream) / wall)
        out["stream_p50_ms"].append(met.summary()["p50_ms"])
        if rep == 0:
            for r in retired + s_retired:
                for x in (r.found, r.val, r.rcnt, r.rsum):
                    if x is not None:
                        digest.update(np.ascontiguousarray(x).tobytes())
    out["digest"] = digest.hexdigest()
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    for name, fn in (
            ("windows4", lambda: cs.run_point_windows(state, mesh,
                                                      windows[:4])),
            ("stream", lambda: cs.serve(state, stream, ycfg.batch, **kw))):
        with torch.profiler.profile(activities=act) as prof:
            fn()
            torch.cuda.synchronize()
        ev = prof.events()
        out[name + "_aten_ops"] = sum(e.name.startswith("aten::")
                                      for e in ev)
        out[name + "_device_ops"] = sum(
            e.device_type == torch.autograd.DeviceType.CUDA for e in ev)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("others", nargs="+", help="the checkouts to compare with")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(os.path.abspath(args.others[0]), args.reps)))
        return 0
    others = [os.path.abspath(t) for t in args.others]
    runs = []
    order = []
    for i in range(args.rounds):
        order += others + [HERE] if i % 2 == 0 else [HERE] + others[::-1]
    for tree in order:
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--one",
             "--reps", str(args.reps)], capture_output=True, text=True,
            cwd=tree)
        if p.returncode:
            print(p.stdout, p.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    assert len({r["digest"] for r in runs}) == 1, "the checkouts disagree"
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
        .stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
