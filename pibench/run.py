"""Run one cell of the benchmark once: ``python3 pibench/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` from the checkout's root.

Exits non-zero and prints no result when there is no card, fewer cards
than the cell asks for, or JAX or the JAX package was loaded.  Otherwise
the last line of standard output is the result (see ``harness.run_cell``)
and the last lines of standard error the numbers ``correct`` compared.
``--control`` judges the plain reference computed on float32 keys in the
program's place: the control that ``correct`` has to refuse.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The ``time.perf_counter`` reading at which this process started."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


STARTED = process_start()


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not read"
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    for path in (ROOT / "src", ROOT):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch
    from pibench import harness
    cell = harness.load_cell(ROOT, args.workload)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell.chips:
        print(f"pibench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    # one process with few threads: the host work of the loop is numpy's
    # and the program's Python, none of it on torch's CPU thread pool
    torch.set_num_threads(1)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", STARTED, control=args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"pibench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    out["card"] = card_line()
    harness.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
