"""The seven examples of the port (``examples_torch/``) on the CPU.

Each runs through its ``main([..., "--device", "cpu"])`` in this process,
at reduced sizes where it takes size flags (``durable_pipeline`` at 4096
keys and arrivals, ``train_lm`` 16 steps, ``distributed_index`` 4096
keys), and its own checks hold
(``durable_pipeline``'s bit-identical recovery, ``overload_degradation``'s
every acknowledged op of the armed breaker, ``train_lm``'s falling loss).
``quickstart`` runs at the reference's sizes and prints the same result
lines as ``examples/quickstart.py``, which runs unedited in a subprocess
meanwhile (~20 s).

~70 s on one worker.
"""
import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def example(name):
    path = os.path.join(REPO, "examples_torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def reference_quickstart():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "examples", "quickstart.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    proc.kill()
    proc.communicate()


def test_quickstart_matches_the_reference(reference_quickstart, capsys):
    res = example("quickstart").main(CPU)
    lines = capsys.readouterr().out.splitlines()
    out, err = reference_quickstart.communicate(timeout=300)
    assert reference_quickstart.returncode == 0, err[-3000:]
    assert lines == out.splitlines()
    assert res["n"] == 23670 and res["pending_after"] == 0
    assert res["range_counts"] == [4024, 4042]


def test_open_loop_pipeline():
    s = example("open_loop_pipeline").main(CPU)
    assert s["arrivals"] == 1 << 14 and s["windows"] >= 2


def test_durable_pipeline():
    res = example("durable_pipeline").main(
        CPU + ["--keys", "4096", "--arrivals", "4096"])
    assert res["same"] and res["acked"] == 4 and res["sealed"] == 5


def test_overload_degradation():
    out = example("overload_degradation").main(CPU)
    assert out["breaker"]["acked"] == out["breaker"]["n"] == 512
    assert out["breaker"]["state"] == "closed"
    assert 0 < out["shed"]["goodput"] < out["shed"]["n"]
    assert out["deadline"]["retunes"] >= 1


def test_ycsb_serve():
    res = example("ycsb_serve").main(CPU)
    assert sorted(res["done"]) == list(range(1000, 1010))
    assert res["queries"] > 0


def test_train_lm(tmp_path):
    res = example("train_lm").main(
        CPU + ["--steps", "16", "--ckpt", str(tmp_path / "ckpt")])
    assert len(res.losses) == 16


def test_distributed_index():
    res = example("distributed_index").main(CPU + ["--keys", "4096"])
    # four windows of 4096 lanes, before and after the re-cut
    assert sum(res["before"]) == sum(res["after"]) == 4 * 4096
