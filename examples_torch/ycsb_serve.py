"""End-to-end serving example: a small LM served with continuous batching,
where the session table (request id → KV slot) is a PI index — the
paper's batched SEARCH/INSERT/DELETE drive the scheduler every tick.

The port's counterpart of ``examples/ycsb_serve.py``: phi3-mini's
``smoke()`` config, its weights drawn from a torch seed
(``init_train_state`` on a CPU generator), served on the card: each
prompt through decode steps over the slot pool (as the reference's
server does), the session table through ``pi_probe`` and
``bitonic_sort``.  Its token streams are the port's own.

  PYTHONPATH=src python examples_torch/ycsb_serve.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import get_config, smoke
from repro_torch.launch.serve import Request, Server
from repro_torch.models import init_train_state


def main(argv=None):
    """Serves ten requests; returns the finished ids and the counts."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = smoke(get_config("phi3-mini-3.8b"))
    params, _ = init_train_state(cfg, optim.OptConfig(),
                                 torch.Generator().manual_seed(0),
                                 device=args.device)
    srv = Server(cfg, params, n_slots=4, max_len=48, device=args.device)
    rng = np.random.default_rng(0)

    waiting = [Request(rid=1000 + i,
                       prompt=rng.integers(0, cfg.vocab, 6),
                       max_new=6) for i in range(10)]
    done = []
    tick = 0
    while waiting or srv.live:
        if waiting and srv.free:
            n = srv.admit(waiting[:len(srv.free)])
            print(f"tick {tick}: admitted {n}, live={len(srv.live)}")
            waiting = waiting[n:]
        finished = srv.tick()
        for rid in finished:
            done.append(rid)
            print(f"tick {tick}: finished request {rid}")
        tick += 1
        if tick > 100:
            raise RuntimeError("server did not drain")
    print(f"served {len(done)} requests in {tick} ticks; "
          f"PI session-table processed {srv.queries_processed} index queries")
    s = srv.pipeline_metrics.summary()
    print(f"pipeline: {s['windows']} windows (one execute a tick), "
          f"occupancy {s['mean_occupancy']:.1f}/{srv.tick_width}, "
          f"index p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms, "
          f"rebuilds {s['rebuilds']}")
    return {"done": done, "ticks": tick,
            "queries": srv.queries_processed, "windows": s["windows"]}


if __name__ == "__main__":
    main()
