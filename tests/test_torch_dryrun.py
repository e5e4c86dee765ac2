"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``) on the same cells, at ``smoke()``
widths and the production shapes.

The port runs in one subprocess, rank 0 of an 8-rank fake process group;
the reference in another, meanwhile, on meshes built by hand over
``jax.devices()[:8]`` (its ``jax.make_mesh`` fails on jax 0.9.0, ROADMAP
C; its import forces 512 host devices), ``get_config`` patched to
``smoke()`` in both.  Cells: phi3-mini train_4k on one device and on
(2, 2, 2), granite-moe train_4k on (2, 2, 2), phi3-mini decode_32k on
(4, 2), and yi-34b long_500k (skipped by both, for the same reason).

* ``model_flops`` and the per-device ``argument_bytes`` are equal.
* Per device: the port's (2, 2, 2) products are at most half its
  one-device ones (the reference's are exactly an eighth).
* Against the reference on one device: the port runs the flash kernel's
  forward (its causal products, by its formula) and then, in the
  backward, recomputes the attention through the plain float64 version
  and differentiates it; XLA shares the reference's attention forward
  with its rematerialization.  So the port's products exceed the
  reference's by the kernel's forward, 13 % here: the test holds the
  dense products (``mm``) equal to the reference's unbatched dots, the
  attention's recompute and gradients (``bmm``) equal to its batched
  dots, and the kernel's to its formula.
* Collectives: none on one device; some on (2, 2, 2).  No equality with
  GSPMD's choice of collectives is asked.

~30 s on one worker (both subprocesses at once).
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = [("phi3-mini-3.8b", "train_4k", "one"),
         ("phi3-mini-3.8b", "train_4k", "test-multi"),
         ("granite-moe-3b-a800m", "train_4k", "test-multi"),
         ("phi3-mini-3.8b", "decode_32k", "test-single"),
         ("yi-34b", "long_500k", "test-single")]

# the reference's per-device argument bytes (its lower_cell, measured)
ARGUMENT_BYTES = {CELLS[0]: 9_768_708, CELLS[1]: 2_543_364,
                  CELLS[2]: 2_899_716, CELLS[3]: 537_240_964}

PORT = r"""
import json, sys
from repro_torch import configs
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as lmesh
real = configs.get_config
dr.get_config = lambda a: configs.smoke(real(a))
lmesh.init_fake_world(8)
build = dr.build_mesh
out = []
for arch, shape, kind in json.loads(sys.argv[1]):
    dr.build_mesh = (lambda k: None) if kind == "one" else build
    out.append(dr.lower_cell(arch, shape, kind))
print("RESULT" + json.dumps(out))
"""

REF = r"""
import json, re, sys
import numpy as np
from repro.launch import dryrun as dr
import jax
from jax.sharding import Mesh
from repro import configs
from repro.roofline import hlo as H
real = configs.get_config
dr.get_config = lambda a: configs.smoke(real(a))
MESHES = {"one": ((1, 1), ("data", "model")),
          "test-single": ((4, 2), ("data", "model")),
          "test-multi": ((2, 2, 2), ("pod", "data", "model"))}
dr.build_mesh = lambda k: Mesh(np.array(jax.devices()[:int(np.prod(
    MESHES[k][0]))]).reshape(MESHES[k][0]), MESHES[k][1])
texts = []
analyze = dr.hlo_mod.analyze
dr.hlo_mod.analyze = lambda t: (texts.append(t), analyze(t))[1]


def split(text):
    # dot FLOPs with batch dims (the attention's) and without (the rest)
    comps, types, entry = H.parse_hlo(text)
    mult = H.execution_multipliers(comps, entry)
    out = {"batched": 0.0, "plain": 0.0}
    for c, comp in comps.items():
        for op in comp.ops:
            if op.opcode in ("dot", "convolution"):
                b = re.search(r"lhs_batch_dims=\{([0-9,]+)\}", op.rest)
                out["batched" if b else "plain"] += \
                    mult.get(c, 0.0) * H.dot_flops(op, types)
    return out


out = []
for arch, shape, kind in json.loads(sys.argv[1]):
    texts.clear()
    r = dr.lower_cell(arch, shape, kind)
    if texts:
        r["split"] = split(texts[0])
    out.append(r)
print("RESULT" + json.dumps(out, default=float))
"""


def _start(script):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", script, json.dumps(CELLS)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc, name):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{name}:\n{out[-3000:]}\n{err[-6000:]}"
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT"))
    return {tuple(c): r for c, r in zip(CELLS, json.loads(line[6:]))}


@pytest.fixture(scope="module")
def cells():
    port, ref = _start(PORT), _start(REF)
    return _result(port, "port"), _result(ref, "reference")


def test_skip_reason(cells):
    port, ref = cells
    p, r = port[CELLS[4]], ref[CELLS[4]]
    assert p["status"] == r["status"] == "skipped"
    assert p["reason"] == r["reason"] and "quadratic" in p["reason"]


@pytest.mark.parametrize("cell", CELLS[:4], ids=lambda c: "-".join(c))
def test_model_flops_and_argument_bytes(cells, cell):
    port, ref = cells
    p, r = port[cell], ref[cell]
    assert p["status"] == r["status"] == "ok", p.get("trace")
    assert p["roofline"]["model_flops"] == r["roofline"]["model_flops"]
    assert p["memory"]["argument_bytes"] == r["memory"]["argument_bytes"] \
        == ARGUMENT_BYTES[cell]
    assert p["chips"] == r["chips"]
    assert p["compile_s"] is None and p["memory"]["alias_bytes"] is None
    rl = p["roofline"]
    assert rl["step_time_s"] > 0 and rl["bottleneck"] in (
        "compute", "memory", "collective")
    assert p["memory"]["temp_bytes"] > 0


def test_products_per_device(cells):
    port, ref = cells
    one, multi = CELLS[0], CELLS[1]
    assert port[multi]["hlo"]["dot_flops"] <= \
        0.5 * port[one]["hlo"]["dot_flops"]
    assert ref[multi]["hlo"]["dot_flops"] * 8 == ref[one]["hlo"]["dot_flops"]
    assert port[CELLS[2]]["hlo"]["dot_flops"] < \
        ref[CELLS[2]]["hlo"]["dot_flops"] * 1.5


def test_products_against_the_reference(cells):
    """Term by term on one device (see the module docstring)."""
    from repro_torch.configs import get_config, smoke
    from repro_torch.roofline.census import flash_flops
    port, ref = cells[0][CELLS[0]], cells[1][CELLS[0]]
    ops, split = port["hlo"]["ops"], ref["split"]
    assert ops["aten.mm"][1] == split["plain"]          # 618,475,290,624
    assert ops["aten.bmm"][1] == split["batched"]       # 7,696,581,394,432
    cfg = smoke(get_config("phi3-mini-3.8b"))
    B, S = 256, 4096
    kernel = cfg.n_layers * flash_flops(B, S, S, cfg.n_heads, cfg.hd,
                                        cfg.hd)
    assert ops["repro_torch.flash_attention_fwd"][1] == kernel
    assert set(k for k, v in ops.items() if v[1]) == {
        "aten.mm", "aten.bmm", "repro_torch.flash_attention_fwd"}
    assert port["hlo"]["dot_flops"] == ref["hlo"]["dot_flops"] + kernel
    assert ref["hlo"]["dot_flops"] == split["plain"] + split["batched"]


def test_collectives(cells):
    port, _ = cells
    assert port[CELLS[0]]["hlo"]["collective_bytes"] == 0
    assert port[CELLS[0]]["hlo"]["collective_count"] == 0
    for cell in CELLS[1:4]:
        assert port[cell]["hlo"]["collective_bytes"] > 0, cell
        assert port[cell]["hlo"]["collective_count"] > 0, cell
