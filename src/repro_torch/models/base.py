"""Model config + declarative parameter layout shared by every architecture.

Counterpart of ``repro.models.base``.  A model declares its parameters
once as ``ParamDef`` entries (shape + logical axes + init kind and scale);
the parameter tree, the ``meta``-device stand-in and the concrete init all
derive from that one declaration.  Trees are nested dicts of tensors with
the JAX package's keys (``blocks/attn/wq`` → ``tree["blocks"]["attn"]
["wq"]``), so ``params_from_numpy`` / ``params_to_numpy`` carry one set of
weights across the packages leaf for leaf.

``init_params`` draws from an explicit ``torch.Generator`` on the target
device: the same layout, init kinds and scales as the JAX package, other
numbers than ``jax.random`` gives (the parity tests carry the JAX
package's weights instead).  Sharding has no place on one card, so the
logical axes are kept for parity only and ``spec_tree`` is left out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.index import _device
from repro_torch.kernels.pi_search import torch_dtype


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"       # dense | moe | mla_moe | ssm | griffin
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    n_kv: int = 4
    head_dim: Optional[int] = None   # default d_model // n_heads
    d_ff: int = 256
    vocab: int = 256
    act: str = "swiglu"         # swiglu | geglu | gelu
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qk_norm: bool = False       # chameleon
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None  # local attention window
    input_mode: str = "tokens"  # tokens | embeddings (stub modality frontend)
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_capacity: float = 1.25
    moe_impl: str = "auto"
    first_k_dense: int = 0
    d_ff_dense: int = 0
    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64
    # --- griffin (recurrentgemma) ---
    lru_width: int = 0
    attn_every: int = 0
    # --- numerics / parallel policy ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    seq_shard: bool = False
    embed_scale: bool = False   # gemma: scale embeddings by sqrt(d)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 (padding logits are masked
        to -1e30 in unembed)."""
        return -(-self.vocab // 256) * 256

    @property
    def experts_padded(self) -> int:
        """Experts padded to a multiple of 16."""
        return -(-self.n_experts // 16) * 16 if self.n_experts else 0

    def param_count(self) -> int:
        """Analytic parameter count, the JAX package's formula."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        hd = self.hd
        emb = V * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            din = self.ssm_expand * d
            nh = din // self.ssm_headdim
            per = d * (2 * din + 2 * self.ssm_state + nh) + \
                (din + 2 * self.ssm_state) * self.ssm_conv + nh * 2 + din + \
                din * d + d
            return emb + L * per + d
        att = d * self.n_heads * hd + d * self.n_kv * hd * 2 + \
            self.n_heads * hd * d
        if self.use_mla:
            att = (d * self.q_lora_rank +
                   self.q_lora_rank * self.n_heads *
                   (self.qk_nope_dim + self.qk_rope_dim) +
                   d * (self.kv_lora_rank + self.qk_rope_dim) +
                   self.kv_lora_rank * self.n_heads *
                   (self.qk_nope_dim + self.v_head_dim) +
                   self.n_heads * self.v_head_dim * d)
        glu = self.act in ("swiglu", "geglu")

        def ff_params(width):
            return d * width * (3 if glu else 2)
        if self.family in ("moe", "mla_moe"):
            moe_layers = L - self.first_k_dense
            per_moe = self.n_experts * ff_params(self.d_ff_expert) + \
                self.n_shared_experts * ff_params(self.d_ff_expert) + \
                d * self.n_experts
            dense_part = self.first_k_dense * \
                ff_params(self.d_ff_dense or self.d_ff)
            ff = moe_layers * per_moe + dense_part
        elif self.family == "griffin":
            n_att = L // (self.attn_every or 3)
            n_rec = L - n_att
            rec = d * self.lru_width * 2 + self.lru_width * d + \
                self.lru_width * (self.ssm_conv or 4) + 3 * self.lru_width
            ff = L * ff_params(self.d_ff)
            return emb + n_att * att + n_rec * rec + ff + 2 * d * L + d
        else:
            ff = L * ff_params(self.d_ff)
        norms = L * 2 * d + d
        return emb + L * att + ff + norms

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if self.family not in ("moe", "mla_moe"):
            return self.param_count()
        full = self.param_count()
        glu = self.act in ("swiglu", "geglu")
        per_expert = self.d_model * self.d_ff_expert * (3 if glu else 2)
        moe_layers = self.n_layers - self.first_k_dense
        inactive = moe_layers * (self.n_experts - self.top_k) * per_expert
        return full - inactive


# ---------------------------------------------------------------------------
# declarative parameter layout
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | zeros | ones | small
    scale: Optional[float] = None   # default: 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


Layout = Dict[str, ParamDef]


def abstract_params(layout: Layout, dtype) -> Dict:
    """The parameter tree on the ``meta`` device: shapes and dtypes, no
    storage (the counterpart of the JAX ``ShapeDtypeStruct`` tree)."""
    dt = torch_dtype(dtype)
    return _unflatten({k: torch.empty(v.shape, dtype=dt, device="meta")
                       for k, v in layout.items()})


def init_params(layout: Layout, generator: torch.Generator, dtype) -> Dict:
    """Draw every parameter of ``layout`` on the generator's device, in
    sorted name order: zeros / ones, or a normal scaled by 1/sqrt(fan_in)
    (``scale`` when given, 0.02 for ``small``), drawn in float32 and cast
    to ``dtype``."""
    dt = torch_dtype(dtype)
    dev = generator.device
    flat = {}
    for k in sorted(layout):
        d = layout[k]
        if d.init == "zeros":
            arr = torch.zeros(d.shape, dtype=dt, device=dev)
        elif d.init == "ones":
            arr = torch.ones(d.shape, dtype=dt, device=dev)
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            scale = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
            if d.init == "small":
                scale = 0.02
            arr = torch.randn(d.shape, generator=generator,
                              dtype=torch.float32, device=dev)
            arr = arr.mul_(scale).to(dt)
        flat[k] = arr
    return _unflatten(flat)


def _unflatten(flat: Dict[str, object]) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def tree_map(fn, tree):
    """``fn`` on every leaf of a nested dict, the same keys out."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def cast_floats(tree, dtype):
    """Cast floating leaves to the compute dtype (mixed-precision entry).

    A leaf already of that dtype comes back as the same tensor, not a
    copy: the JAX steps cast on every call, which ``jit`` fuses away, and
    a copy of the weights on every eager decode step would cost their
    whole size.  Callers that serve cast once, up front.
    """
    dt = torch_dtype(dtype)
    return tree_map(lambda a: a.to(dt) if a.is_floating_point() else a, tree)


def tree_bytes(tree) -> int:
    return sum(int(np.prod(leaf.shape)) * leaf.element_size()
               for leaf in tree_leaves(tree))


def params_from_numpy(tree, device=None) -> Dict:
    """A tree of numpy arrays (the JAX package's parameters, converted
    with ``np.asarray``) as the port's tensors, leaf for leaf, on
    ``device`` (default: the card)."""
    device = _device(device)
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(tree) -> Dict:
    """The inverse of ``params_from_numpy``: every leaf as a numpy array
    on the host (bfloat16 leaves become float32, which numpy lacks)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(host, tree)
