"""The YCSB generator: the key bijection, YCSB's scrambled zipfian, scan
spans counted in records, and inserts of new records."""
import numpy as np
import torch

from pibench import ycsb

A = {"mix": {"read": 0.5, "update": 0.5}, "request_distribution": "zipfian",
     "zipfian_constant": 0.99}
E = {"mix": {"scan": 0.95, "insert": 0.05}, "request_distribution": "zipfian",
     "zipfian_constant": 0.99, "max_scan_length": 100}
CONFIG = {"records": 1 << 12, "key_space": 1 << 14, "max_span": 1024}


def test_zeta_tail_matches_the_exact_sum():
    n = 1 << 22
    exact = float(np.sum(np.arange(1, n + 1, dtype=np.float64) ** -0.99))
    assert abs(ycsb.zeta(n, 0.99) - exact) < 1e-9 * exact


def test_hottest_record_takes_one_over_zeta():
    n, draws = 1 << 16, 1 << 21
    zipf = ycsb.Zipfian(n, 0.99)
    gen = torch.Generator().manual_seed(3)
    rec = ycsb.scrambled_zipfian(
        zipf, torch.rand(draws, dtype=torch.float64, generator=gen))
    counts = torch.bincount(rec, minlength=n)
    p = 1 / ycsb.zeta(n, 0.99)
    sd = (p * (1 - p) / draws) ** 0.5
    # the hottest record is rank 0's, hashed (at this n no other rank's
    # share hashes onto it by more than the band)
    hot = int(ycsb.fnv64(torch.zeros(1, dtype=torch.int64)) % n)
    assert int(counts.argmax()) == hot
    assert abs(int(counts[hot]) / draws - p) < 5 * sd


def test_skew_at_the_cells_size_is_ycsb_not_the_approximation():
    # YCSB's zipfian gives rank 0 1/zeta(2^28, 0.99) = 4.5 % of the draws;
    # repro_torch.data._zipf_ranks' floor(n u^(1/(1-theta))) gives it
    # n^-(1-theta) = 82.4 %
    from repro_torch.data import _zipf_ranks
    n, draws = 1 << 28, 1 << 20
    u = torch.rand(draws, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(5))
    ours = float((ycsb.Zipfian(n, 0.99).ranks(u) == 0).double().mean())
    assert abs(ours - 1 / ycsb.zeta(n, 0.99)) < 0.002
    assert abs(1 / ycsb.zeta(n, 0.99) - 0.0451) < 0.0005
    legacy = float(np.mean(_zipf_ranks(np.random.default_rng(5), draws, 0.99,
                                       n) == 0))
    assert abs(legacy - n ** -0.01) < 0.002 and abs(legacy - 0.824) < 0.002


def test_keys_are_distinct_and_inside_the_key_space():
    km = ycsb.KeyMap(2 ** 31 + 11, 1 << 20)
    keys = km(torch.arange(1 << 20))
    assert keys.min() >= 0 and keys.max() < 1 << 20
    assert torch.unique(keys).numel() == 1 << 20


def test_inserts_are_new_records_and_scans_count_records():
    seed = 2 ** 32 + 9
    ops = ycsb.make_ops(E, CONFIG, seed, 20000, "cpu")
    base, _ = ycsb.base_records(CONFIG, seed, "cpu")
    ins = ops["ops"] == ycsb.INSERT
    new = ops["keys"][ins]
    assert 0.04 < float(ins.double().mean()) < 0.06
    assert torch.unique(new).numel() == new.numel()
    assert not torch.isin(new, base).any()
    # the j-th insert is record N + j, with its record id as its value
    n = CONFIG["records"]
    assert torch.equal(ops["vals"][ins], n + torch.arange(new.numel(),
                                                          dtype=torch.int32))
    scan = ops["ops"] == ycsb.RANGE
    hi = ops["keys2"][scan]
    span = (hi - ops["keys"][scan] + 1).long()
    unit = CONFIG["key_space"] // n
    # a scan that would pass the last key stops there
    cut = hi == CONFIG["key_space"] - 1
    assert torch.all(span[~cut] % unit == 0) and torch.all(span <= 100 * unit)
    assert span[~cut].min() == unit and span[~cut].max() == 100 * unit
    assert torch.isin(ops["keys"][scan], base).all()


def test_updates_write_values_no_record_held():
    seed = 17
    ops = ycsb.make_ops(A, CONFIG, seed, 20000, "cpu")
    upd = ops["ops"] == ycsb.INSERT
    assert 0.48 < float(upd.double().mean()) < 0.52
    idx = torch.nonzero(upd).flatten()
    assert torch.equal(ops["vals"][upd].long(), CONFIG["records"] + idx)
    base, _ = ycsb.base_records(CONFIG, seed, "cpu")
    assert torch.isin(ops["keys"], base).all()


def test_same_seed_same_ops():
    a = ycsb.make_ops(E, CONFIG, 2 ** 31 + 3, 5000, "cpu")
    b = ycsb.make_ops(E, CONFIG, 2 ** 31 + 3, 5000, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
