"""The plain reference against a brute-force dict oracle, and the rule
that the benchmark imports neither JAX nor the JAX package, and that the
reference imports nothing of the program."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from pibench import reference, ycsb

HERE = Path(__file__).resolve().parent
CONFIG = {"records": 1 << 12, "key_space": 1 << 14, "max_span": 1024}
MIXES = {
    "ycsb-a": {"mix": {"read": 0.5, "update": 0.5},
               "request_distribution": "zipfian", "zipfian_constant": 0.99},
    "ycsb-e": {"mix": {"scan": 0.95, "insert": 0.05},
               "request_distribution": "zipfian", "zipfian_constant": 0.99,
               "max_scan_length": 100},
    "mixed": {"mix": {"read": 0.3, "update": 0.3, "insert": 0.1,
                      "scan": 0.3},
              "request_distribution": "uniform", "max_scan_length": 100},
}


def oracle(base_k, base_v, ops, keys, keys2, vals, window):
    """Window by window: ranges on the state at the window's start, point
    ops one by one in issue order."""
    state = dict(zip(base_k.tolist(), base_v.tolist()))
    out = [None] * len(ops)
    i = 0
    while i < len(ops):
        j = i
        while j < len(ops) and window[j] == window[i]:
            j += 1
        items = sorted(state.items())
        for p in range(i, j):
            if ops[p] == ycsb.RANGE:
                sel = [v for k, v in items if keys[p] <= k <= keys2[p]]
                s = (sum(sel) + 2 ** 31) % 2 ** 32 - 2 ** 31
                out[p] = (len(sel), s)
        for p in range(i, j):
            k = keys[p]
            if ops[p] == ycsb.SEARCH:
                out[p] = (int(k in state), state.get(k, 0))
            elif ops[p] == ycsb.INSERT:
                state[k] = vals[p]
                out[p] = (0, 0)
            elif ops[p] == ycsb.DELETE:
                had = k in state
                state.pop(k, None)
                out[p] = (int(had), int(had))
        i = j
    return out, state


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_reference_matches_a_dict_oracle(mix):
    seed = 2 ** 31 + 99
    n = 3000
    t = ycsb.make_ops(MIXES[mix], CONFIG, seed, n, "cpu")
    ops, keys, keys2, vals = t["ops"], t["keys"], t["keys2"], t["vals"]
    # a few deletes, of loaded and of written keys, to cover their path
    ops = ops.clone()
    ops[::97] = ycsb.DELETE
    keys2 = torch.where(ops == ycsb.RANGE, keys2, 0)
    rng = np.random.default_rng(1)
    cuts = np.sort(rng.choice(np.arange(1, n), 40, replace=False))
    window = torch.from_numpy(np.searchsorted(cuts, np.arange(n),
                                              side="right"))
    bk, bv = ycsb.base_records(CONFIG, seed, "cpu")
    ref = reference.Reference(bk, bv, ops, keys, vals)
    e1, e2 = reference.expected(ref, ops, keys, keys2, window, block=700)
    want, state = oracle(bk, bv, ops.tolist(), keys.tolist(), keys2.tolist(),
                         vals.tolist(), window.tolist())
    assert list(zip(e1.tolist(), e2.tolist())) == want
    rk, rv = ref.live_set()
    wk = sorted(state)
    assert rk.tolist() == wk and rv.tolist() == [state[k] for k in wk]


def test_set_difference():
    k = torch.tensor([1, 5, 9])
    v = torch.tensor([10, 50, 90])
    assert reference.set_difference(k, v, k, v) == 0
    assert reference.set_difference(k, v, k, v + (k == 5)) == 1
    assert reference.set_difference(k[:2], v[:2], k, v) == 1


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def test_no_jax_and_a_reference_free_of_the_program():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        tops = {m.split(".")[0] for m in _imports(f)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, f
    # the reference and every module of the benchmark it imports
    todo, seen = ["pibench.reference"], set()
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        path = HERE / (mod.split(".", 1)[1].replace(".", "/") + ".py")
        for m in _imports(path):
            assert m.split(".")[0] != "repro_torch", (mod, m)
            if m.split(".")[0] == "pibench" and m != "pibench":
                todo.append(m)
    assert seen == {"pibench.reference", "pibench.ycsb"}
