"""The byte counts of the roofline shares and the idle-share arithmetic,
against hand counts."""
import types

import pytest

from pibench import harness, roofline, trace


def test_descent_and_probe_bytes_by_hand():
    # C = 64 slots, F = 4: levels of 16 and 4 entries.  A descent reads
    # the top level whole (4 keys, 16 B), then one group of 4 keys (16 B)
    # on level 1 (4 groups) and on storage (16 groups), each distinct
    # group once: 3 distinct keys read 16 + 3 * 16 + 3 * 16 = 112 B.
    assert roofline.level_sizes(64, 4) == [16, 4]
    assert roofline.descent_bytes(3, 64, 4) == 112
    # 10 distinct keys: level 1 has only 4 groups
    assert roofline.descent_bytes(10, 64, 4) == 16 + 4 * 16 + 10 * 16
    # a lower bound over 5 pending keys takes 3 halving steps, reading at
    # most 1, 2 and 4 distinct keys: 3 keys read 1 + 2 + 3 = 6 keys
    assert roofline.bound_bytes(3, 5) == 24
    assert roofline.bound_bytes(3, 0) == 0
    # 8 lanes: key read + three int32 results = 16 B a lane
    assert roofline.probe_bytes(8, 3, 64, 4, 5) == 128 + 112 + 24


def test_range_bytes_by_hand():
    # 8 lanes (bounds and results, 16 B each), 2 real ranges with 2
    # distinct lower bounds holding 7 records (key + value each), the key
    # past each end, both bounds of each in 5 pending keys
    got = roofline.range_bytes(8, 2, 2, 7, 64, 4, 5)
    assert got == 8 * 16 + (16 + 2 * 16 + 2 * 16) + 7 * 8 + 2 * 4 + \
        2 * 4 * (1 + 2 + 2)


def test_share():
    assert roofline.share_pct(3.35e9, 0.01) == pytest.approx(10.0)
    assert roofline.share_pct(1, 0.0) is None


def canned():
    # window 0..100 ns; kernels overlap at 10..30 and 20..40, one at
    # 60..70 and one past the window's end
    dev = [("k_a", 10, 30), ("k_b", 20, 40), ("k_a", 60, 70),
           ("k_c", 95, 120)]
    host = [("admit", 0, 12), ("submit", 40, 80), ("admit", 80, 92)]
    return trace.Timeline((0, 100), trace.clip(dev, 0, 100),
                          trace.clip(host, 0, 100))


def test_idle_share_of_overlapping_kernels():
    tl = canned()
    # busy: 10..40 (30), 60..70 (10), 95..100 (5)
    assert trace.busy_ns(tl) == 45
    assert trace.idle_gaps(tl) == [(0, 10), (40, 60), (70, 95)]
    assert trace.idle_pct(tl) == pytest.approx(55.0)
    times = trace.device_time(tl)
    assert times["k_a"] == pytest.approx(30e-9)
    assert times["k_c"] == pytest.approx(5e-9)


def test_idle_gaps_by_what_the_host_did():
    got = trace.idle_by_host(canned())
    # 0..10 admit; 40..60 submit; 70..95: submit 10 of 25, admit 12 of
    # 25, neither covers half: the harness's own loop
    assert got == pytest.approx({"admit": 10e-9, "submit": 20e-9,
                                 "clients": 25e-9})


def test_the_card_rate_reads_between_the_marks():
    mark = "void at::cuda::spin_kernel(long)"
    # warm-up kernels before the first mark, two windows' kernels between
    # the marks (overlapping once at 25..30), the drain's after the last
    dev = [("warm", 0, 5), (mark, 8, 10), ("k_a", 20, 30), ("k_b", 25, 40),
           ("k_a", 60, 70), (mark, 80, 82), ("drain", 90, 99)]
    tl = trace.between_marks(dev)
    assert tl.window == (10, 80)
    assert [d[0] for d in tl.device] == ["k_a", "k_b", "k_a"]
    assert trace.busy_ns(tl) == 30
    assert trace.between_marks(dev[:3]) is None
    # the windows dispatched between the marks on the host's clock: 3 + 5
    # ops over 30 ns of device time; one before and one after are not
    w = types.SimpleNamespace
    run = w(card=tl, marks=(1.0, 2.0), submitted=[
        (w(qids=[0, 1]), 0.5), (w(qids=[2, 3, 4]), 1.2),
        (w(qids=[5, 6, 7, 8, 9]), 1.9), (w(qids=[10]), 2.1)])
    read = harness.reader(harness.Path(__file__).resolve().parents[1],
                          "card_ops_per_s")
    assert read(run) == pytest.approx(8 / 30e-9)
    assert read(w(card=None, marks=None, submitted=[])) is None
