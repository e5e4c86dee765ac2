"""recurrentgemma-9b [hybrid] — 38L d4096 16H (MQA kv=1) d_ff12288
lru_width 4096, local-attention window 2048, pattern (rec, rec, attn),
vocab 256000, GeGLU, tied + scaled embeddings.  [arXiv:2402.19427;
unverified]"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="griffin",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    act="geglu",
    norm="rmsnorm",
    use_rope=True,
    sliding_window=2048,
    lru_width=4096,
    attn_every=3,
    ssm_conv=4,
    tie_embeddings=True,
    embed_scale=True,
    param_dtype="float32",
    compute_dtype="bfloat16",
)
