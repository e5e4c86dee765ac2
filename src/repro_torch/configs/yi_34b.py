"""yi-34b [dense] — 60L d7168 56H(kv8) d_ff20480 vocab 64000, llama-arch
GQA (RMSNorm, RoPE theta 5M, SwiGLU).  [arXiv:2403.04652; hf]"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv=8,
    d_ff=20480,
    vocab=64000,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=5_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
