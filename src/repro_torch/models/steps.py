"""Step builders: prefill_step / decode_step and the shape cells.

Counterpart of ``repro.models.steps`` for serving.  The JAX package
lowers these for the dry-run and executes them in its training and
serving loops; here they run eagerly.  ``make_train_step``, the
optimizer state and ``input_specs`` wait for the training slice
(ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.models import decode as dec
from repro_torch.models.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# full-attention archs skip long_500k (quadratic KV); ssm/griffin run it
SUBQUADRATIC_FAMILIES = ("ssm", "griffin")


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True


def make_prefill_step(cfg: ModelConfig, total_len: Optional[int] = None):
    def prefill_step(params, batch):
        with torch.no_grad():
            return dec.prefill(cfg, params, tokens=batch.get("tokens"),
                               embeds=batch.get("embeds"),
                               total_len=total_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, batch):
        with torch.no_grad():
            logits, cache = dec.decode_step(cfg, params, batch["cache"],
                                            batch["tokens"], batch["idx"])
        # the first index of the maximum, as jnp.argmax
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, logits, cache
    return decode_step
