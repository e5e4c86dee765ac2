"""gemma-7b [dense] — 28L d3072 16H(kv16) head_dim 256 d_ff24576 vocab
256000, GeGLU, embedding scaling, tied embeddings.  [arXiv:2403.08295; hf]"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    embed_scale=True,
    param_dtype="float32",
    compute_dtype="bfloat16",
)
