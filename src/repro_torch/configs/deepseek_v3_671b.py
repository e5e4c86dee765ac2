"""deepseek-v3-671b [moe] — 61L d7168 128H, MLA (q_lora 1536 / kv_lora 512,
nope 128 + rope 64, v 128), 1 shared + 256 routed experts top-8 (expert
d_ff 2048), first 3 layers dense (d_ff 18432), vocab 129280, MTP depth 1.
[arXiv:2412.19437; hf]"""
from repro_torch.models.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv=128,
    d_ff=18432,
    vocab=129280,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    n_experts=256,
    n_shared_experts=1,
    top_k=8,
    d_ff_expert=2048,
    first_k_dense=3,
    d_ff_dense=18432,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp_depth=1,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
