"""Assigned-architecture registry: ``--arch <id>`` resolves here.

Counterpart of ``repro.configs``: one module per architecture (the same
public-literature configs, built on the port's ``ModelConfig``) plus
``smoke()``, which shrinks any config to a CPU-runnable variant of the
same family.  The port serves every family of them.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.base import ModelConfig

ARCH_IDS = [
    "granite-moe-3b-a800m",
    "deepseek-v3-671b",
    "musicgen-medium",
    "command-r-plus-104b",
    "yi-34b",
    "phi3-mini-3.8b",
    "gemma-7b",
    "chameleon-34b",
    "mamba2-2.7b",
    "recurrentgemma-9b",
]

_MODULES = {a: a.replace("-", "_").replace(".", "p") for a in ARCH_IDS}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; choices: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: tiny widths, few layers/experts."""
    upd = dict(
        n_layers=3 if cfg.family == "griffin" else 2,
        d_model=64,
        n_heads=4,
        n_kv=min(cfg.n_kv, 4) if cfg.n_kv else cfg.n_kv,
        head_dim=16 if cfg.head_dim else None,
        d_ff=128,
        vocab=128,
        sliding_window=min(cfg.sliding_window, 16)
        if cfg.sliding_window else None,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
    if cfg.family in ("moe", "mla_moe"):
        upd.update(n_experts=8, top_k=2, d_ff_expert=32,
                   n_shared_experts=min(cfg.n_shared_experts, 1),
                   first_k_dense=min(cfg.first_k_dense, 1),
                   d_ff_dense=64 if cfg.d_ff_dense else 0,
                   moe_capacity=64.0)
    if cfg.use_mla:
        upd.update(q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=16,
                   qk_rope_dim=8, v_head_dim=16)
    if cfg.family == "ssm":
        upd.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8, ssm_conv=4)
    if cfg.family == "griffin":
        upd.update(lru_width=64, attn_every=3, n_kv=1)
    return dataclasses.replace(cfg, **upd)
