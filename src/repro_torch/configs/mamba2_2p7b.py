"""mamba2-2.7b [ssm] — 64L d2560 attn-free, SSD state 128, expand 2,
headdim 64, conv 4, vocab 50280, tied embeddings.  [arXiv:2405.21060;
unverified]"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=50280,
    norm="rmsnorm",
    use_rope=False,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
    param_dtype="float32",
    compute_dtype="bfloat16",
)
