"""chameleon-34b [vlm] — 48L d8192 64H(kv8) d_ff22016 vocab 65536 (early
fusion: text + VQ image tokens share the table), qk-norm.  The VQ image
tokenizer frontend is a stub — input_specs() feeds precomputed patch/token
embeddings.  [arXiv:2405.09818; unverified]"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=22016,
    vocab=65536,
    act="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    input_mode="embeddings",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
