"""Three-term roofline model for NVIDIA H100 cards.

Counterpart of ``repro.roofline.model``, with the same terms and
formulas priced at the H100's rates:

  compute    = FLOPs_global    / (chips × 989 TF/s bf16)
  memory     = bytes_global    / (chips × 3.35 TB/s)
  collective = coll_bytes_glob / (chips × 450 GB/s)

The rates are the data sheet's peaks for "NVIDIA H100 80GB HBM3, 700 W"
(SXM): the dense bfloat16 tensor-core rate, HBM3's bandwidth, and one
direction of NVLink 4 per GPU.  ``PEAK_FLOPS_F32`` is the non-tensor
float32 rate, which ``chip_smoke.py`` takes for the int32 compares of the
index kernels.  As in the reference, one collective rate prices every
mesh axis: the "pod" axis of the multi-pod mesh, InfiniBand between
hosts, is modelled at NVLink's rate.

The census (``roofline.census``) counts one rank's program, so
per-device quantities × chips give the globals (the formulas then reduce
to per-device / per-card rate, as they must).
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS_BF16 = 989e12      # per card, dense bf16 tensor core
PEAK_FLOPS_F32 = 67e12        # per card, float32 on the CUDA cores
HBM_BW = 3.35e12              # B/s per card
NVLINK_BW = 450e9             # B/s per card, one direction of NVLink 4


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_global: float
    bytes_global: float
    collective_bytes_global: float
    model_flops: float            # 6·N(active)·D
    useful_ratio: float           # model_flops / flops_global
    bottleneck: str = ""
    step_time_s: float = 0.0      # max of the three (no-overlap bound)
    mfu: float = 0.0              # model_flops / (step_time × chips × peak)


def roofline(per_device_flops: float, per_device_bytes: float,
             per_device_collective_bytes: float, chips: int,
             model_flops: float) -> RooflineTerms:
    fg = per_device_flops * chips
    bg = per_device_bytes * chips
    cg = per_device_collective_bytes * chips
    t = RooflineTerms(
        compute_s=fg / (chips * PEAK_FLOPS_BF16),
        memory_s=bg / (chips * HBM_BW),
        collective_s=cg / (chips * NVLINK_BW),
        flops_global=fg,
        bytes_global=bg,
        collective_bytes_global=cg,
        model_flops=model_flops,
        useful_ratio=model_flops / max(fg, 1e-30),
    )
    terms = {"compute": t.compute_s, "memory": t.memory_s,
             "collective": t.collective_s}
    t.bottleneck = max(terms, key=terms.get)
    t.step_time_s = max(terms.values())
    t.mfu = model_flops / max(chips * PEAK_FLOPS_BF16 * t.step_time_s, 1e-30)
    return t


def model_flops_for(cfg, shape_kind: str, seq_len: int, global_batch: int,
                    mtp: bool = False) -> float:
    """6·N_active·D (train) or 2·N_active·D (inference)."""
    n = cfg.active_param_count()
    if shape_kind == "train":
        d = seq_len * global_batch
        return 6.0 * n * d
    if shape_kind == "prefill":
        d = seq_len * global_batch
        return 2.0 * n * d
    # decode: one token per sequence
    return 2.0 * n * global_batch


def fmt_seconds(s: float) -> str:
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.2f}ms"
    return f"{s * 1e6:.1f}µs"
