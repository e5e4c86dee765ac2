"""Small cells for the benchmark's CPU tests: the cells' files at a size a
test run holds, run through the whole harness on the CPU."""
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from pibench import harness  # noqa: E402

# The sharded cell's entries: correct on the card at 2^28, but left out of
# BENCHMARK.json because its host-bound throughput spreads past any bound
# (PERF.md, section 7); the tests list it in a copy.
PI8 = {
    "configs": [{"name": "pi-8shard-256m", "source": "test",
                 "file": "pibench/configs/pi-8shard-256m.json",
                 "reduced": [], "why": "test"}],
    "workloads": [{"name": "pi8.ycsb-a", "config": "pi-8shard-256m",
                   "traffic": "ycsb-a", "chips": 1, "why": "test"}],
    "per_layer": [{"name": "route.imbalance", "unit": "x", "better": "lower",
                   "source": "program_counter", "layer": "routing, shards",
                   "moves": "card_ops_per_s",
                   "workloads": ["pi8.ycsb-a"]}],
}


def listed(tmp: Path, entries: dict) -> Path:
    """A root at ``tmp`` with the benchmark's files and ``BENCHMARK.json``
    with ``entries`` (lists by key) added to its own."""
    for sub in ("configs", "traffic", "metrics"):
        src = ROOT / harness.BENCH_DIR / sub
        dst = tmp / harness.BENCH_DIR / sub
        if not dst.exists():
            shutil.copytree(src, dst)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key, more in entries.items():
        bench[key] = bench[key] + list(more)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def small_cell(name: str, root=ROOT, key_space: int = 1 << 14) -> \
        "harness.Cell":
    """Cell ``name`` of ``root`` cut to 2^12 records: windows of 256 slots
    a shard, 512 clients a shard, a capacity factor that skew at 2^12
    records cannot overflow."""
    cell = harness.load_cell(root, name)
    c = cell.config
    s = c["shards"]
    c.update(records=1 << 12, key_space=key_space, capacity=(1 << 13) // s,
             pending_capacity=(1 << 10) // s, window=256 * s,
             capacity_factor=float(s))
    cell.traffic.update(clients=512 * s, max_ops_per_s=100_000 * s)
    return cell


def pi8_cell(tmp: Path, key_space: int = 1 << 14) -> "harness.Cell":
    return small_cell("pi8.ycsb-a", listed(tmp, PI8), key_space)


def run_small(cell, seed: int = 2 ** 31 + 7, traced: bool = False,
              control: bool = False, seconds: float = 0.2) -> dict:
    return harness.run_cell(cell, seed, seconds, traced, "cpu",
                            time.perf_counter(), control=control)
