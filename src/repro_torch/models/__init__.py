"""Model zoo of the port: every family of the JAX package (dense, moe,
mla_moe, ssm, griffin) as PyTorch functions over its parameter trees,
GQA prefill and training through the CUDA flash kernel
(``models.moe``: routed experts by the PI sorted dispatch, MLA, MTP;
``models.ssm``: mamba2's chunked SSD and recurrent decode;
``models.griffin``: the RG-LRU scan and local attention over a ring
cache; ``models.kvquant``: the int8 KV cache; ``models.pipeline``: GPipe
over a mesh axis of ranks).
"""
from repro_torch.models.base import (ModelConfig, abstract_params,
                                     cast_floats, init_params,
                                     params_from_numpy, params_to_numpy,
                                     spec_tree, tree_bytes)
from repro_torch.models.steps import (SHAPES, ShapeSpec, abstract_train_state,
                                      init_train_state, input_specs,
                                      loss_and_grad, make_decode_step,
                                      make_prefill_step, make_train_step,
                                      shape_applicable)
from repro_torch.models.transformer import (DenseLM, flash_attention,
                                            forward, loss_fn, model_layout)

__all__ = [
    "ModelConfig", "abstract_params", "cast_floats", "init_params",
    "model_layout", "params_from_numpy", "params_to_numpy", "spec_tree",
    "tree_bytes", "SHAPES", "ShapeSpec", "abstract_train_state",
    "init_train_state", "input_specs", "loss_and_grad", "make_decode_step",
    "make_prefill_step", "make_train_step", "shape_applicable", "DenseLM",
    "flash_attention", "forward", "loss_fn",
]
