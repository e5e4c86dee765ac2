"""granite-moe-3b-a800m [moe] — 32L d1536 24H(kv8) MoE 40 experts top-8,
expert d_ff 512, vocab 49155.  [hf:ibm-granite/granite-3.0 family; hf]"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv=8,
    d_ff=512,
    vocab=49155,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    n_experts=40,
    top_k=8,
    d_ff_expert=512,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="bfloat16",
)
