"""The harness on the CPU at a small size: cells, mixes and metrics found by
name from files alone, the result line's shape, and no run without a
card."""
import io
import json

import torch

from pibench import harness, run
from pibench.smallcells import listed, pi8_cell, run_small, small_cell


def test_the_small_cells_run_correct():
    for name in ("pi1.ycsb-a", "pi1.ycsb-e"):
        cell = small_cell(name)
        out = run_small(cell)
        assert out["correct"], (name, out["checks"])
        assert out["attempted"] > 0 and out["failed"] == 0
        # end-to-end metrics only; the card's needs a card, and the rate
        # its cell reports on the host's clock is always there
        e2e = {m["name"]: m for m in cell.end_to_end}
        assert set(out["metrics"]) <= {
            k for k, m in e2e.items() if m["source"] != "device_trace"}
        assert set(out["metrics"]) >= {"setup_s"} | (
            {"ops_per_s"} & set(e2e))


def test_eight_shards_run_correct(tmp_path):
    out = run_small(pi8_cell(tmp_path), traced=True, seconds=0.1)
    assert out["correct"], out["checks"]
    assert out["metrics"]["route.imbalance"]["value"] >= 1.0


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as files
    and entries: the harness runs the new cell and reads the new metric
    without an edit to any file it had."""
    root = listed(tmp_path, {})
    bench_dir = root / harness.BENCH_DIR
    cfg = json.loads((bench_dir / "configs" / "pi-1shard-256m.json")
                     .read_text())
    cfg["fanout"] = 4
    (bench_dir / "configs" / "pi-1shard-f4.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "ycsb-c.json").write_text(json.dumps(
        {"mix": {"read": 1.0}, "request_distribution": "uniform",
         "clients": 512, "max_ops_per_s": 100000}))
    (bench_dir / "metrics" / "windows_timed.py").write_text(
        "def read(run):\n"
        "    return sum(1 for _, t in run.submitted if run.in_window(t))\n")
    listed(tmp_path, {
        "configs": [{"name": "pi-1shard-f4", "source": "test",
                     "file": "pibench/configs/pi-1shard-f4.json",
                     "reduced": [], "why": "test"}],
        "workloads": [{"name": "pi1f4.ycsb-c", "config": "pi-1shard-f4",
                       "traffic": "ycsb-c", "chips": 1, "why": "test"}],
        "per_layer": [{"name": "windows_timed", "unit": "windows",
                       "better": "higher", "source": "host_clock",
                       "layer": "test", "moves": "ops_per_s",
                       "workloads": ["pi1f4.ycsb-c"]}]})
    cell = small_cell("pi1f4.ycsb-c", root=tmp_path)
    assert cell.config["fanout"] == 4 and cell.traffic["mix"] == {"read": 1.0}
    assert [m["name"] for m in cell.per_layer][-1] == "windows_timed"
    out = run_small(cell, traced=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["windows_timed"]["value"] >= 1


def test_the_last_line_is_the_result():
    out = run_small(small_cell("pi1.ycsb-e"), traced=True)
    stdout, stderr = io.StringIO(), io.StringIO()
    harness.emit(out, stdout, stderr)
    last = json.loads(stdout.getvalue().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(last)[-1] == "checks"
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes", "busy_s", "window_s"}
    assert {"device_ops", "idle_gaps"} <= set(last["breakdown"])
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}
    lines = stderr.getvalue().splitlines()
    assert lines[-len(last["checks"]):] == [
        f"check {k} {c['value']} limit {c['limit']}"
        for k, c in last["checks"].items()]


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "pi1.ycsb-a", "--seed", str(2 ** 31 + 1),
                   "--seconds", "10", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
