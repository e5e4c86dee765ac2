"""The port's whole slice against the JAX package: YCSB windows through
``step_single`` and the JAX ``_step_single``, across rebuilds of both
tiers, bit for bit; plus the port's import boundary and ``chip_smoke.py``
refusing to run without a card.
"""
import ast
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from repro import data as jdata
from repro.core import index as jpi
from repro.pipeline.dispatcher import _step_single
from repro_torch import data as tdata
from repro_torch.core import RefIndex
from repro_torch.core import index as tpi
from repro_torch.pipeline import step_single
from torch_parity import assert_same_state, configs, ref_results, t

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ycsb_data_matches_jax_package():
    cfg = dict(n_keys=3000, key_space=1 << 20, batch=256, write_ratio=0.5,
               theta=0.9, seed=3)
    for a, b in zip(tdata.ycsb_dataset(tdata.YCSBConfig(**cfg)),
                    jdata.ycsb_dataset(jdata.YCSBConfig(**cfg))):
        np.testing.assert_array_equal(a, b)
    keys = jdata.ycsb_dataset(jdata.YCSBConfig(**cfg))[0]
    for step in range(3):
        for a, b in zip(tdata.ycsb_batch(tdata.YCSBConfig(**cfg), keys, step),
                        jdata.ycsb_batch(jdata.YCSBConfig(**cfg), keys,
                                         step)):
            np.testing.assert_array_equal(a, b)


def _local_window(rng, lo, span, n_ins, batch):
    """Inserts of fresh keys inside [lo, lo+span): a few dirty segments."""
    ops = np.zeros(batch, np.int32)
    ops[:n_ins] = 1
    keys = rng.integers(lo, lo + span, batch).astype(np.int32)
    return rng.permutation(ops), keys, rng.integers(0, 1 << 30, batch) \
        .astype(np.int32)


@pytest.mark.parametrize("backend", ["pallas-interpret", "xla"])
def test_windows_through_step_single_match_jax(backend):
    """12 YCSB windows (write ratio 0.5, theta 0.9) with clustered insert
    windows after rebuilds, so that both rebuild tiers run."""
    ycfg = tdata.YCSBConfig(n_keys=1024, key_space=1 << 20, batch=256,
                            write_ratio=0.5, theta=0.9, seed=0)
    keys, vals = tdata.ycsb_dataset(ycfg)
    jcfg, tcfg = configs(backend=backend, capacity=4096,
                         pending_capacity=512, fanout=8, tile_q=64)
    jidx = jpi.build(jcfg, jnp.asarray(keys), jnp.asarray(vals))
    tidx = tpi.build(tcfg, keys, vals, device="cpu")
    ref = RefIndex.build(keys, vals)
    rng = np.random.default_rng(7)
    tiers, prev_due = [], False
    for w in range(12):
        if prev_due:
            batch = _local_window(rng, (w * 77_003) % (1 << 19), 3 << 16,
                                  250, ycfg.batch)
        else:
            batch = tdata.ycsb_batch(ycfg, keys, w)
        jout = _step_single(jidx, *map(jnp.asarray, batch))
        tout = step_single(tidx, *map(t, batch))
        jidx, tidx = jout[0], tout[0]
        for name, a, b in zip(("found", "val", "ovf", "due", "incr", "pn"),
                              jout[1:], tout[1:]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"window {w}: {name}")
        assert_same_state(jidx, tidx, f"window {w}")
        rf, rv = ref_results(ref, *batch)
        np.testing.assert_array_equal(tout[1].numpy(), rf)
        np.testing.assert_array_equal(tout[2].numpy(), rv)
        prev_due = bool(tout[4])
        if prev_due:
            tiers.append(bool(tout[5]))
    assert True in tiers and False in tiers, tiers
    assert tpi.validate_layout(tidx)
    k, v = tpi.live_items(tidx)
    np.testing.assert_array_equal(k, np.array(sorted(ref.data), np.int32))
    np.testing.assert_array_equal(v, [ref.data[int(x)] for x in k])


# ---------------------------------------------------------------------------
# the import boundary and the chip script
# ---------------------------------------------------------------------------

def _port_files():
    pkg = os.path.join(ROOT, "src", "repro_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
             if f.endswith(".py")]
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")]


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) >= 12
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_to_run_without_a_card():
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
