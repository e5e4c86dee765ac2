"""The port's roofline model and census (``repro_torch.roofline``) against
the JAX package's (``repro.roofline``), on hand-sized cases.

* The model: the same (per-device FLOPs, bytes, collective bytes, chips,
  model FLOPs) go into both packages' ``roofline()``; each of the port's
  terms is the reference's times the ratio of the two rates (TPU v5e's
  over the H100's).  ``model_flops_for`` is equal for every arch and
  shape.
* The census on ``meta`` tensors: an ``mm``'s FLOPs and bytes, a view
  that costs nothing, a slice's, a gather's and a scatter's bytes by
  ``hlo.py``'s rules, the flash kernel counted by its own formula (not by
  its plain version's products), live bytes, and one DTensor product on
  a fake (2, 2, 2) mesh counted at the rank's local shapes (a dispatch
  mode sees the op at its global shapes first: 8 times the rank's work).

~12 s on one worker, most of it importing both packages.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.roofline import census as cs
from repro_torch.roofline import model as tm

F32 = torch.float32


def meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    (3.0e12, 4.0e11, 0.0, 1, 1.0e12),
    (8.3e12, 9.7e6, 1.1e9, 8, 6.2e11),
    (1.0e9, 5.0e12, 7.0e10, 256, 2.4e16),
    (1.0, 1.0, 1.0e12, 512, 1.0)])
def test_roofline_terms_at_h100_rates(case):
    from repro.roofline import model as jm
    port = tm.roofline(*case)
    ref = jm.roofline(*case)
    for term, ratio in (("compute_s", jm.PEAK_FLOPS_BF16 / tm.PEAK_FLOPS_BF16),
                        ("memory_s", jm.HBM_BW / tm.HBM_BW),
                        ("collective_s", jm.ICI_BW / tm.NVLINK_BW)):
        want = getattr(ref, term) * ratio
        assert math.isclose(getattr(port, term), want, rel_tol=1e-12,
                            abs_tol=1e-300), (term, getattr(port, term), want)
    for term in ("flops_global", "bytes_global", "collective_bytes_global",
                 "model_flops", "useful_ratio"):
        assert getattr(port, term) == getattr(ref, term), term
    terms = {"compute": port.compute_s, "memory": port.memory_s,
             "collective": port.collective_s}
    assert port.bottleneck == max(terms, key=terms.get)
    assert port.step_time_s == max(terms.values())
    assert math.isclose(port.mfu, case[4] / max(
        case[3] * tm.PEAK_FLOPS_BF16 * port.step_time_s, 1e-30),
        rel_tol=1e-12)


def test_roofline_without_products():
    """No FLOPs: the reference's dead ``mfu`` arithmetic in ``finish()``
    divides 0 by 0 there (ROADMAP C); the port computes ``mfu`` once."""
    port = tm.roofline(0.0, 1.0e6, 0.0, 1, 0.0)
    assert port.compute_s == 0.0 and port.bottleneck == "memory"
    assert port.mfu == 0.0 and port.step_time_s == 1.0e6 / tm.HBM_BW


def test_model_flops_for_every_cell():
    from repro import configs as jc
    from repro.models import SHAPES as JSHAPES
    from repro.roofline import model as jm
    from repro_torch import configs as tc
    from repro_torch.models import SHAPES
    assert list(SHAPES) == list(JSHAPES)
    for arch in tc.ARCH_IDS:
        for name, s in SHAPES.items():
            port = tm.model_flops_for(tc.get_config(arch), s.kind, s.seq_len,
                                      s.global_batch)
            ref = jm.model_flops_for(jc.get_config(arch), s.kind, s.seq_len,
                                     s.global_batch)
            assert port == ref, (arch, name, port, ref)


def test_fmt_seconds():
    from repro.roofline import model as jm
    for s in (2.5, 0.0123, 4.5e-5):
        assert tm.fmt_seconds(s) == jm.fmt_seconds(s)


# ---------------------------------------------------------------------------
# the census
# ---------------------------------------------------------------------------

def test_mm_flops_and_bytes():
    a, b = meta(32, 64), meta(64, 16)
    st = cs.analyze(lambda x, y: x @ y, a, b)
    assert st.dot_flops == 2 * 32 * 16 * 64
    assert st.traffic_bytes == 4 * (32 * 64 + 64 * 16 + 32 * 16)
    assert st.traffic_bytes_fused == st.traffic_bytes
    assert st.collective_bytes == 0 and st.collective_count == 0
    assert st.while_trip_counts is None


def test_views_cost_no_bytes():
    x = meta(8, 16, 4)

    def views(t):
        return t.view(8, 64), t.transpose(0, 1), t[:, :4], t.unsqueeze(0), \
            t.reshape(128, 4), t.detach()
    st = cs.analyze(views, x)
    assert st.traffic_bytes == 0 and st.dot_flops == 0, st.ops
    assert st.peak_bytes == st.argument_bytes == 8 * 16 * 4 * 4


def test_slice_gather_scatter_copy_bytes():
    x = meta(64, 32)
    # a slice touches only the slice: its consumer reads 64 x 4 floats
    st = cs.analyze(lambda t: t[:, :4] * 2.0, x)
    assert st.traffic_bytes == 2 * 64 * 4 * 4
    # a gather moves twice its result
    idx = torch.empty(10, dtype=torch.long, device="meta")
    st = cs.analyze(lambda t, i: torch.index_select(t, 0, i), x, idx)
    assert st.traffic_bytes == 2 * 10 * 32 * 4
    st = cs.analyze(lambda t, i: t[i], x, idx)
    assert st.traffic_bytes == 2 * 10 * 32 * 4
    # a scatter three times its update
    upd = meta(10, 32)
    st = cs.analyze(lambda t, i, u: t.index_add(0, i, u), x, idx, upd)
    assert st.traffic_bytes == 3 * 10 * 32 * 4
    # a copy into a slice (the eager dynamic-update-slice): twice its source
    st = cs.analyze(lambda t, u: t[:10].copy_(u), x, upd)
    assert st.traffic_bytes == 2 * 10 * 32 * 4


def test_peak_bytes_counts_live_storages():
    n = 1 << 16
    x = meta(n)

    def f(t):
        y = t * 2.0          # x, y live
        z = y + 1.0          # x, y, z live: the peak
        del y
        w = z * 3.0          # x, z, w
        return w.view(-1)    # a view: no new storage

    st = cs.analyze(f, x)
    assert st.argument_bytes == 4 * n
    assert st.peak_bytes == 3 * 4 * n


def _pairs(Sq, Sk, causal, window):
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    mask = (kpos <= qpos) if causal else np.ones((Sq, Sk), bool)
    if window is not None:
        mask &= kpos > qpos - window
    return int(mask.sum())


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24),
                                           (False, None), (False, 7)])
def test_flash_counted_by_its_formula(causal, window):
    from repro_torch.kernels.flash_attention import (flash_attention_fwd,
                                                     flash_attention_fwd_plain,
                                                     flash_hbm_bytes)
    B, S, H, KV, D = 2, 100, 4, 2, 16
    q, k, v = meta(B, S, H, D), meta(B, S, KV, D), meta(B, S, KV, D)
    st = cs.analyze(lambda *a: flash_attention_fwd(
        *a, causal=causal, window=window), q, k, v)
    assert set(st.ops) == {"repro_torch.flash_attention_fwd"}, st.ops
    assert st.dot_flops == 2 * (D + D) * _pairs(S, S, causal, window) * B * H
    assert st.dot_flops == cs.flash_flops(B, S, S, H, D, D, causal, window)
    assert st.traffic_bytes == flash_hbm_bytes(B, S, S, H, KV, D, D, 4)
    # its plain version computes every chunk's full products: another count
    plain = cs.analyze(lambda *a: flash_attention_fwd_plain(
        *a, causal=causal, window=window), q, k, v)
    assert "aten.bmm" in plain.ops
    assert plain.dot_flops > st.dot_flops


def test_dtensor_product_counted_at_local_shapes():
    import torch.distributed as tdist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch import mesh as lmesh
    if tdist.is_initialized():
        pytest.fail("a process group is already initialized in this process")
    lmesh.init_fake_world(8)
    try:
        mesh = lmesh.make_test_mesh(multi_pod=True, device_type="cuda")
        M, K, N = 64, 4096, 8192
        # a: rows over ("pod", "data"); b: columns over "model"
        a = DTensor.from_local(meta(M // 4, K), mesh,
                               (Shard(0), Shard(0), Replicate()),
                               run_check=False, shape=(M, K),
                               stride=(K, 1))
        b = DTensor.from_local(meta(K, N // 2), mesh,
                               (Replicate(), Replicate(), Shard(1)),
                               run_check=False, shape=(K, N),
                               stride=(N, 1))
        st = cs.analyze(lambda x, y: x @ y, a, b)
        glob = 2 * M * N * K                  # 4,294,967,296
        assert st.dot_flops == 2 * (M // 4) * (N // 2) * K == glob // 8
        assert st.collective_count == 0
        assert st.argument_bytes == 4 * ((M // 4) * K + K * (N // 2))
        # a redistribution: the all-gather of the rank's block
        st = cs.analyze(lambda x: x.redistribute(
            mesh, (Replicate(),) * 3).to_local(), a)
        assert st.collective_bytes_by_kind.get("all-gather", 0) > 0
        assert st.collective_bytes_by_kind["all-gather"] >= 4 * (M // 4) * K
    finally:
        tdist.destroy_process_group()
