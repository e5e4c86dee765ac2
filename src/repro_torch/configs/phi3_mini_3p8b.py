"""phi3-mini-3.8b [dense] — 32L d3072 32H(kv32) d_ff8192 vocab 32064,
RoPE + SwiGLU.  [arXiv:2404.14219; unverified]"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32064,
    act="swiglu",
    norm="rmsnorm",
    param_dtype="float32",
    compute_dtype="bfloat16",
)
