"""Serving path above the PI core.  Ported so far: ``step_single``, one
point-op window through one shard (execute, then rebuild if due)."""
from repro_torch.pipeline.dispatcher import step_single

__all__ = ["step_single"]
