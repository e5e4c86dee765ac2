"""musicgen-medium [audio] — 48L d1536 24H(kv24) d_ff6144 vocab 2048
(EnCodec codes).  Decoder-only over audio tokens; the EnCodec frontend is a
stub — input_specs() feeds precomputed frame embeddings (input_mode=
"embeddings").  LayerNorm + GELU + sinusoidal positions per the paper.
[arXiv:2306.05284; hf]"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="dense",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv=24,
    d_ff=6144,
    vocab=2048,
    act="gelu",
    norm="layernorm",
    use_rope=False,
    input_mode="embeddings",
    param_dtype="float32",
    compute_dtype="bfloat16",
)
