"""Roofline analysis: the per-device census of an eager step + the H100
hardware model (counterpart of ``repro.roofline``)."""
from repro_torch.roofline.census import CensusStats, analyze, tensor_bytes
from repro_torch.roofline.model import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                        PEAK_FLOPS_F32, RooflineTerms,
                                        fmt_seconds, model_flops_for,
                                        roofline)

__all__ = ["analyze", "CensusStats", "tensor_bytes", "NVLINK_BW", "HBM_BW",
           "PEAK_FLOPS_BF16", "PEAK_FLOPS_F32", "RooflineTerms",
           "fmt_seconds", "model_flops_for", "roofline"]
