"""Model zoo of the port: the dense family as PyTorch functions over the
JAX package's parameter trees, prefill through the CUDA flash kernel.

Not ported yet (ROADMAP A10): the moe, mla_moe, ssm and griffin families,
``loss_fn`` and the training steps.
"""
from repro_torch.models.base import (ModelConfig, abstract_params,
                                     cast_floats, init_params,
                                     params_from_numpy, params_to_numpy,
                                     tree_bytes)
from repro_torch.models.steps import (SHAPES, ShapeSpec, make_decode_step,
                                      make_prefill_step, shape_applicable)
from repro_torch.models.transformer import (DenseLM, flash_attention,
                                            forward, model_layout)

__all__ = [
    "ModelConfig", "abstract_params", "cast_floats", "init_params",
    "model_layout", "params_from_numpy", "params_to_numpy", "tree_bytes",
    "SHAPES", "ShapeSpec", "make_decode_step", "make_prefill_step",
    "shape_applicable", "DenseLM", "flash_attention", "forward",
]
