"""``correct`` has to come out false for the control and for each fault a
cell can have: the whole run, with the timed path broken underneath."""
import pytest
import torch

from pibench.smallcells import pi8_cell, run_small, small_cell
from repro_torch.core import distributed, index
from repro_torch.pipeline import dispatcher

EXECUTE = index.execute_impl


def unchanged(idx, ops, keys, vals):
    """A step that returns its state unchanged."""
    _, res = EXECUTE(idx, ops, keys, vals)
    return idx, res


def half(idx, ops, keys, vals):
    """Half of the batch left out: the second half's lanes never run."""
    h = ops.shape[0] // 2
    new, (found, val) = EXECUTE(idx, ops[:h], keys[:h], vals[:h])
    pad = torch.zeros(ops.shape[0] - h, dtype=val.dtype, device=val.device)
    return new, (torch.cat([found, pad.bool()]), torch.cat([val, pad]))


def altered(idx, ops, keys, vals):
    """One answer altered where it is produced."""
    new, (found, val) = EXECUTE(idx, ops, keys, vals)
    return new, (found, val + (torch.arange(val.numel()) == 0).to(val.dtype))


def no_exchange(x, group):
    """The exchange between the shards left out."""
    return x


def altered_range(*args):
    cnt, sm = RANGES(*args)
    return cnt + 1, sm


RANGES = dispatcher.execute_ranges

FAULTS = {
    "unchanged": (index, "execute_impl", unchanged),
    "half": (index, "execute_impl", half),
    "altered": (index, "execute_impl", altered),
    "no_exchange": (distributed, "_exchange", no_exchange),
    "altered_range": (dispatcher, "execute_ranges", altered_range),
}
CASES = [("pi1.ycsb-a", f) for f in ("unchanged", "half", "altered")] + \
    [("pi8.ycsb-a", f) for f in ("unchanged", "half", "altered",
                                 "no_exchange")] + \
    [("pi1.ycsb-e", f) for f in ("unchanged", "half", "altered_range")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_is_not_correct(cell, fault, monkeypatch, tmp_path):
    mod, name, fn = FAULTS[fault]
    c = pi8_cell(tmp_path) if cell == "pi8.ycsb-a" else small_cell(cell)
    monkeypatch.setattr(mod, name, fn)
    out = run_small(c, seconds=0.1)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["pi1.ycsb-a", "pi8.ycsb-a"])
def test_the_float32_control_is_not_correct(cell, tmp_path):
    # keys over 2^26 of key space, where float32 cannot hold them apart
    c = pi8_cell(tmp_path, 1 << 26) if cell == "pi8.ycsb-a" else \
        small_cell(cell, key_space=1 << 26)
    out = run_small(c, control=True, seconds=0.1)
    assert not out["correct"], out["checks"]
    assert out["checks"]["live_set_diff"]["value"] > 0

