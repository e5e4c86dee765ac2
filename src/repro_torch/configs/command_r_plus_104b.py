"""command-r-plus-104b [dense] — 64L d12288 96H(kv8) d_ff33792 vocab
256000, no-bias GQA, tied embeddings.  [hf:CohereForAI; unverified]"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv=8,
    d_ff=33792,
    vocab=256000,
    act="swiglu",
    norm="layernorm",
    rope_theta=75_000_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
