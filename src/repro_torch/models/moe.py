"""Mixture-of-Experts blocks (granite-moe, deepseek-v3) and MLA attention.

Counterpart of ``repro.models.moe``.  Token → expert dispatch reuses the
port's PI query routing, ``core.distributed.dispatch_plan``: tokens are
the queries, experts the key-range shards, and the capacity factor bounds
each expert's send buffer, as the paper's sorted, capacity-bounded
routing bounds a shard's.

Three choices hold the port to the reference's numbers:

* the router's top k is a stable descending sort, which puts the lower
  expert id first among equal scores, as ``jax.lax.top_k`` does
  (``torch.topk`` does not, and bfloat16 scores tie often);
* the send buffer has one spare row past its end that every dropped copy
  lands on and that is cut off, so a dropped copy vanishes as under the
  reference's ``mode="drop"``;
* the combine adds each token's contributions one at a time from zero, in
  ascending expert id (the order of the sorted dispatch, in which the
  reference's scatter-add visits them), in the activation dtype.  It
  gathers by permutations and slots that are each taken once, so it adds
  nothing with atomics and gives the same bits on every run; so does its
  backward.

The expert products are batched matrix products (cuBLAS on the card), as
the reference computes them with ``jnp.einsum`` outside any Pallas
kernel: this module launches no kernel of its own.  MLA's full-sequence
attention takes the plain chunked ``transformer.flash_attention`` (its
value head dim differs from its query head dim, which the flash kernel
does not take), as the reference takes its pure-JAX one.  Decode writes
the compressed cache in place at the absolute position, as the dense
family's decode writes its own.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shd
from repro_torch.core.distributed import dispatch_plan
from repro_torch.kernels.flash_attention import weak_scalar
from repro_torch.models.base import Layout, ModelConfig, ParamDef, tree_map
from repro_torch.models.transformer import (_scan_blocks, attn_apply,
                                            attn_layout, embed_tokens,
                                            flash_attention, gold_logits,
                                            logsumexp, mlp_apply, mlp_layout,
                                            norm, on_local_heads, rope,
                                            unbind_layers, unembed,
                                            write_cache)

# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_layout(cfg: ModelConfig, prefix: str, layers: int) -> Layout:
    d = cfg.d_model
    H = cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    L, ll = (layers,), ("layers",)
    return {
        f"{prefix}/wq_a": ParamDef(L + (d, qr), ll + ("fsdp", None)),
        f"{prefix}/q_a_norm": ParamDef(L + (qr,), ll + (None,), "zeros"),
        f"{prefix}/wq_b": ParamDef(L + (qr, H * (dn + dr)),
                                   ll + (None, "heads")),
        f"{prefix}/wkv_a": ParamDef(L + (d, kvr + dr), ll + ("fsdp", None)),
        f"{prefix}/kv_a_norm": ParamDef(L + (kvr,), ll + (None,), "zeros"),
        f"{prefix}/wkv_b": ParamDef(L + (kvr, H * (dn + dv)),
                                    ll + (None, "heads")),
        f"{prefix}/wo": ParamDef(L + (H * dv, d), ll + ("heads", "fsdp")),
    }


def mla_apply(cfg: ModelConfig, p: Dict, x, positions, cache=None):
    """DeepSeek MLA.  The cache holds the *compressed* c_kv and the shared
    k_rope, (kv_lora + rope_dim) a token instead of 2·H·hd, expanded per
    head on read.  ``cache``: None, or a dict with c_kv (B,T,kvr), k_rope
    (B,T,1,dr) and idx (an int), written in place at [idx, idx + S)."""
    B, S, d = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank

    cq = norm(cfg, x @ p["wq_a"], p["q_a_norm"])
    q = (cq @ p["wq_b"]).reshape(B, S, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    kv_a = x @ p["wkv_a"]                       # (B,S,kvr+dr)
    c_kv = norm(cfg, kv_a[..., :kvr], p["kv_a_norm"])
    k_rope = rope(kv_a[..., kvr:][..., None, :], positions,
                  cfg.rope_theta)               # (B,S,1,dr) shared head

    if cache is not None:
        idx = int(cache["idx"])
        write_cache(cache["c_kv"], c_kv, idx)
        write_cache(cache["k_rope"], k_rope, idx)
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    kv = (c_kv @ p["wkv_b"]).reshape(B, -1, H, dn + dv)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    k = torch.cat([k_nope, k_rope.expand(*k_nope.shape[:3], dr)], -1)
    qq = torch.cat([q_nope, q_rope], -1)
    qq = shd.constrain(qq, "batch", "seq", "heads", None)
    if cache is None:
        o = on_local_heads(lambda q_, k_, v_: flash_attention(
            q_, k_, v_, causal=True), qq, k, v, kv_name="heads")
    else:
        T = k.shape[1]
        kpos = torch.arange(T, device=shd.local(x).device)
        qpos = idx + torch.arange(S, device=kpos.device)
        mask = kpos[None, :] <= qpos[:, None]

        def attend(q_, k_, v_):
            q_ = q_ / weak_scalar(math.sqrt(dn + dr), q_.dtype)
            s = torch.einsum("bqhd,bkhd->bhqk", q_.float(), k_.float())
            s = torch.where(mask[None, None], s, -1e30)
            w = torch.softmax(s, dim=-1).to(v_.dtype)
            return torch.einsum("bhqk,bkhd->bhqd", w.float(),
                                v_.float()).transpose(1, 2).to(x.dtype)

        o = on_local_heads(attend, qq, k, v, kv_name="heads")
    return o.reshape(B, S, H * dv) @ p["wo"], (c_kv, k_rope)


# ---------------------------------------------------------------------------
# expert layer — PI-style sorted dispatch
# ---------------------------------------------------------------------------

def experts_layout(cfg: ModelConfig, prefix: str, layers: int) -> Layout:
    d, fe = cfg.d_model, cfg.d_ff_expert
    Ep = cfg.experts_padded       # padding experts take no tokens
    L, ll = (layers,), ("layers",)
    out = {
        f"{prefix}/router": ParamDef(L + (d, cfg.n_experts),
                                     ll + (None, None)),
        f"{prefix}/w_gate": ParamDef(L + (Ep, d, fe),
                                     ll + ("experts", "fsdp", "expert_mlp")),
        f"{prefix}/w_up": ParamDef(L + (Ep, d, fe),
                                   ll + ("experts", "fsdp", "expert_mlp")),
        f"{prefix}/w_down": ParamDef(L + (Ep, fe, d),
                                     ll + ("experts", "expert_mlp", "fsdp")),
    }
    if cfg.n_shared_experts:
        out.update(mlp_layout(cfg, f"{prefix}/shared", layers,
                              width=cfg.d_ff_expert * cfg.n_shared_experts))
    return out


def _route(cfg: ModelConfig, p: Dict, xf, groups=(), n_tokens=None):
    """Router scores → (gate_vals, expert_ids, lb_loss), (N, K) each and a
    float32 scalar.  The top k by a stable descending sort: among equal
    scores the lower expert id comes first, as from ``jax.lax.top_k``.
    With ``groups`` (the batch's blocks split over their ranks), the
    load-balance means run over all ``n_tokens`` tokens: the sums of the
    blocks added over the groups."""
    E, K = cfg.n_experts, cfg.top_k
    scores = (xf @ p["router"]).float()                      # (N, E)
    probs = torch.sigmoid(scores) if cfg.family == "mla_moe" \
        else torch.softmax(scores, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = vals[:, :K], ids[:, :K]
    if cfg.family == "mla_moe":                              # deepseek norm
        gate_vals = gate_vals / torch.clamp_min(
            gate_vals.sum(-1, keepdim=True), 1e-9)
    # the mean of the one-hot sums: integer counts (no host sync, unlike
    # bincount on the card) over N
    flat = expert_ids.reshape(-1)
    counts = torch.zeros(E, dtype=flat.dtype, device=flat.device) \
        .scatter_add_(0, flat, torch.ones_like(flat))
    if groups:
        me = shd.psum_to_all(torch.softmax(scores, dim=-1).sum(dim=0),
                             groups) / n_tokens
        for g in groups:
            counts = shd.group_psum(counts, g)
        ce = counts.float() / n_tokens
    else:
        me = torch.softmax(scores, dim=-1).mean(dim=0)
        ce = counts.float() / xf.shape[0]
    lb_loss = E * torch.sum(me * ce) / K
    return gate_vals, expert_ids, lb_loss


def capacity(cfg: ModelConfig, n_tokens: int, capacity_factor=None) -> int:
    """An expert's buffer rows for ``n_tokens`` tokens: the reference's
    ``max(8, min(ceil(N K / E cf), N))`` with E the real experts."""
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity
    cap = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cf))
    return max(8, min(cap, n_tokens))


# the dropped copies of each moe_apply inside ``record_drops``
_drop_log: list | None = None


@contextlib.contextmanager
def record_drops():
    """Within the block, every ``moe_apply`` appends the copies that its
    capacity dropped to the list this yields, as an int32 scalar on its
    device (no host sync)."""
    global _drop_log
    outer, _drop_log = _drop_log, []
    try:
        yield _drop_log
    finally:
        _drop_log = outer


def moe_apply(cfg: ModelConfig, p: Dict, x, capacity_factor=None):
    """Top-k routed experts by sorted, capacity-bounded dispatch.

    The N = B·S tokens are copied top_k times, the copies sorted by
    expert (``dispatch_plan``), the first ``cap`` of each expert placed in
    its rows of an (Ep, cap, d) buffer, run as one batched product per
    projection, and combined with the router gates.  A copy past its
    expert's capacity is dropped (the residual carries the token).
    Returns (out (B,S,d), lb_loss).

    Each phase runs inside a ``torch.profiler.record_function`` span
    (``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``),
    by which a profile splits the layer's device time.
    """
    if isinstance(x, DTensor):
        return _one_rank(moe_apply, cfg, p, x, capacity_factor)
    B, S, d = x.shape
    K, Ep = cfg.top_k, cfg.experts_padded
    N = B * S
    xf = x.reshape(N, d)
    with record_function("moe.route"):
        gate_vals, expert_ids, lb_loss = _route(cfg, p, xf)
    cap = capacity(cfg, N, capacity_factor)
    with record_function("moe.dispatch"):
        order, slot, keep, n_dropped = dispatch_plan(
            expert_ids.reshape(-1).to(torch.int32), Ep, cap)
        if _drop_log is not None:
            _drop_log.append(n_dropped)
        # each copy's buffer row in (token, k) order: order is a
        # permutation, so this scatter writes every element once
        slot_of = torch.empty_like(slot).scatter_(0, order.long(), slot) \
            .long()
        # copy i of token i // K into its row; dropped copies all land on
        # the spare row Ep * cap, which is cut off.  The expand's backward
        # sums a token's K row gradients, which index_copy's backward
        # gathers.
        copies = xf[:, None].expand(N, K, d).reshape(N * K, d)
        xbuf = xf.new_zeros((Ep * cap + 1, d)).index_copy(0, slot_of, copies)
        xbuf = xbuf[:-1].view(Ep, cap, d)
    with record_function("moe.experts"):
        h = torch.bmm(xbuf, p["w_gate"])
        u = torch.bmm(xbuf, p["w_up"])
        h = F.silu(h) * u
        y = torch.bmm(h, p["w_down"]).reshape(Ep * cap, d)
    with record_function("moe.combine"):
        out = combine(y, slot_of.view(N, K), expert_ids, gate_vals)
    out = out.reshape(B, S, d)
    if cfg.n_shared_experts:
        out = out + mlp_apply(cfg, p["shared"], x)
    return out, lb_loss


def _one_rank(fn, cfg, p, x, capacity_factor):
    """``fn`` on DTensors of a one-rank mesh (whose blocks are the whole
    tensors).  Across several ranks the experts need the rules' experts
    axis in the mesh (``moe_apply_shardmap``): the capacity-bounded
    dispatch has no DTensor rule, and gathering the batch is refused."""
    mesh = x.device_mesh
    if mesh.size() > 1:
        raise ValueError(f"moe_apply over a mesh of {mesh.size()} ranks "
                         f"without an axis for the experts (mesh axes "
                         f"{tuple(mesh.mesh_dim_names)}): give the mesh the "
                         f"rules' experts axis")
    rep = (Replicate(),) * mesh.ndim
    y, lb = fn(cfg, tree_map(shd.local, p), x.to_local(), capacity_factor)
    return (DTensor.from_local(y, mesh, rep, run_check=False),
            DTensor.from_local(lb, mesh, rep, run_check=False))


def combine(y, rows, expert_ids, gate_vals):
    """The experts' output rows back to their tokens: (N, d) in y's dtype.

    ``rows`` (N, K) is each copy's row of ``y`` (Ep·cap rows; Ep·cap for
    a dropped copy, which reads a zero row past the end).  A token's K
    rows, scaled by their gates cast to y's dtype, are added one at a
    time from zero in ascending expert id: on the CPU that reproduces the
    reference's ``zeros.at[tok_of].add(contrib)`` bit for bit, in
    bfloat16 and float32, where the router's rank order does not.
    """
    N, K = rows.shape
    d = y.shape[-1]
    _, kth = torch.sort(expert_ids, dim=-1)
    gates = gate_vals.gather(1, kth).to(y.dtype)
    taken = _TakeRows.apply(torch.cat([y, y.new_zeros((1, d))]),
                            rows.gather(1, kth).reshape(-1))
    contrib = taken.view(N, K, d) * gates[..., None]
    out = y.new_zeros((N, d))
    for c in contrib.unbind(1):      # one stack of the K gradients back
        out = out + c
    return out


class _TakeRows(torch.autograd.Function):
    """``src.index_select(0, idx)`` for an ``idx`` that takes every row at
    most once but the last: its backward writes each gradient row back
    with ``index_copy`` instead of accumulating (the backward of an
    indexing gather sorts and adds: 1.28 s of a granite-moe train step of
    4 x 2048 tokens on an H100).  The last row, which many may take, is a
    zero row whose gradient the caller drops."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = src.shape[0]
        return src.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.n_rows, grad.shape[-1]))
        return out.index_copy_(0, idx, grad), None


def moe_apply_shardmap(cfg: ModelConfig, p: Dict, x, capacity_factor=None):
    """Expert-parallel dispatch over the mesh in scope (``sharding``): the
    reference's ``shard_map`` body, run by every rank on its own block,
    with a gradient.

    ``x`` (B, S, d) is a DTensor whose batch the rules split (tokens
    ``P(bspec)`` in and out); the expert weights are redistributed to
    ``P(model_ax)``: a rank holds the ``E_local = Ep / model`` experts of
    its model-axis index.  Each rank routes its block's tokens (the
    load-balance means summed over the batch's ranks), filters the copies
    routed to its experts (PI: a NUMA node answers only its key range),
    places them in its capacity buffer by ``dispatch_plan``, runs the
    three expert products, and a ``psum`` over the model axis combines
    each token's contributions.  The gradients take JAX's transposes: the
    psum's passes through; the tokens and gates, which every model rank
    holds alike and uses for its own experts, get the sum of the ranks'
    (``sharding.sum_grads``); an expert block's is summed over the batch.
    Plain ``x`` and ``p`` (every rank the same: the reference's replicated
    activations) run as replicated DTensors and come back whole.  Without
    a mesh, or with no axis for the experts, it is ``moe_apply``, as in
    the reference.
    """
    mesh = shd.current_mesh()
    model_axes = shd.physical_axes("experts", cfg.experts_padded)
    if mesh is None or not model_axes:
        return moe_apply(cfg, p, x, capacity_factor)
    if not isinstance(x, DTensor):
        rep = (Replicate(),) * mesh.ndim
        y, lb = moe_apply_shardmap(
            cfg, tree_map(lambda t: DTensor.from_local(
                t, mesh, rep, run_check=False), p),
            DTensor.from_local(x, mesh, rep, run_check=False),
            capacity_factor)
        return y.full_tensor(), lb.full_tensor()
    names = tuple(mesh.mesh_dim_names)
    m_dim = names.index(model_axes[0])
    B, S, d = x.shape
    K, Ep = cfg.top_k, cfg.experts_padded
    x = shd.constrain(x, "batch", "seq", "embed")
    bdims = shd.mesh_dims_of(x, 0)
    xpl = tuple(Shard(0) if m in bdims else Replicate()
                for m in range(mesh.ndim))
    if tuple(x.placements) != xpl:
        x = x.redistribute(mesh, xpl)
    bgroups = shd.mesh_groups(mesh, bdims)
    mgroups = shd.mesh_groups(mesh, (m_dim,))
    # a rank's grads: its batch block's part of a replicated leaf's
    bsum = tuple(Partial() if m in bdims else Replicate()
                 for m in range(mesh.ndim))

    x_l = x.to_local()
    N_loc = x_l.shape[0] * S
    xf_l = x_l.reshape(N_loc, d)
    router = p["router"].redistribute(mesh, (Replicate(),) * mesh.ndim)
    gate_vals, expert_ids, lb_loss = _route(
        cfg, {"router": router.to_local(grad_placements=bsum)}, xf_l,
        groups=bgroups, n_tokens=B * S)

    E_local = Ep // mesh.size(m_dim)
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity
    cap = int(math.ceil(N_loc * K / Ep * cf))
    cap = max(8, min(cap, N_loc))
    wpl = tuple(Shard(0) if m == m_dim else Replicate()
                for m in range(mesh.ndim))
    wgrad = tuple(Shard(0) if m == m_dim else b for m, b in enumerate(bsum))
    wg, wu, wd = (p[k].redistribute(mesh, wpl).to_local(grad_placements=wgrad)
                  for k in ("w_gate", "w_up", "w_down"))
    lo = mesh.get_local_rank(m_dim) * E_local

    # tokens and gates are the same on every model rank, each using them
    # for its own experts
    xf_d = shd.sum_grads(xf_l, mgroups)
    gv_l = shd.sum_grads(gate_vals.to(x_l.dtype), mgroups)
    dest = expert_ids.reshape(-1).to(torch.int32) - lo
    valid = (dest >= 0) & (dest < E_local)
    dest_c = torch.where(valid, dest, E_local)          # overflow bucket
    order, slot, keep, _ = dispatch_plan(dest_c, E_local + 1, cap)
    olong = order.long()
    live = keep & valid[olong]
    slot = torch.where(live, slot, E_local * cap)       # bucket rows drop
    tok_of = (torch.arange(N_loc * K, device=x_l.device) // K)[olong]
    # every live copy has its own row; the rest land on the spare row
    xbuf = xf_d.new_zeros((E_local * cap + 1, d)).index_copy(
        0, slot.long(), xf_d[tok_of])[:-1].view(E_local, cap, d)
    h = torch.bmm(xbuf, wg)
    u = torch.bmm(xbuf, wu)
    h = F.silu(h) * u
    y = torch.bmm(h, wd).reshape(E_local * cap, d)
    g = torch.where(live, gv_l.reshape(-1)[olong], 0).to(x_l.dtype)
    contrib = y[torch.where(live, slot, 0).long()] * g[:, None]
    out = xf_d.new_zeros((N_loc, d)).index_add_(0, tok_of, contrib)
    out = shd.psum_to_all(out, mgroups)
    out = DTensor.from_local(out.reshape(x_l.shape), mesh, xpl,
                             run_check=False)
    lb_loss = DTensor.from_local(lb_loss, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    if cfg.n_shared_experts:
        out = out + mlp_apply(cfg, p["shared"], x)
    return out, lb_loss


# ---------------------------------------------------------------------------
# block assembly
# ---------------------------------------------------------------------------

def block_layout(cfg: ModelConfig) -> Layout:
    """MoE families: optional leading dense layers + the MoE layers."""
    out: Layout = {}
    n_moe = cfg.n_layers - cfg.first_k_dense
    attn_fn = mla_layout if cfg.use_mla else attn_layout
    if cfg.first_k_dense:
        for k, v in attn_fn(cfg, "attn", cfg.first_k_dense).items():
            out[f"dense/{k}"] = v
        for k, v in mlp_layout(cfg, "mlp", cfg.first_k_dense,
                               width=cfg.d_ff_dense or cfg.d_ff).items():
            out[f"dense/{k}"] = v
        out["dense/ln1"] = ParamDef((cfg.first_k_dense, cfg.d_model),
                                    ("layers", None), "zeros")
        out["dense/ln2"] = ParamDef((cfg.first_k_dense, cfg.d_model),
                                    ("layers", None), "zeros")
    for k, v in attn_fn(cfg, "attn", n_moe).items():
        out[f"moe/{k}"] = v
    for k, v in experts_layout(cfg, "experts", n_moe).items():
        out[f"moe/{k}"] = v
    out["moe/ln1"] = ParamDef((n_moe, cfg.d_model), ("layers", None), "zeros")
    out["moe/ln2"] = ParamDef((n_moe, cfg.d_model), ("layers", None), "zeros")
    return out


def _attn(cfg, p, x, positions, cache=None):
    if cfg.use_mla:
        return mla_apply(cfg, p, x, positions, cache=cache)
    return attn_apply(cfg, p, x, positions, cache=cache,
                      window=cfg.sliding_window)


def dense_layer(cfg, p, x, positions, cache=None):
    h, kv = _attn(cfg, p["attn"], norm(cfg, x, p["ln1"]), positions, cache)
    x = x + h
    x = x + mlp_apply(cfg, p["mlp"], norm(cfg, x, p["ln2"]))
    return shd.constrain(x, "batch", "seq", "embed"), kv


def moe_layer(cfg, p, x, positions, cache=None):
    h, kv = _attn(cfg, p["attn"], norm(cfg, x, p["ln1"]), positions, cache)
    x = x + h
    fn = moe_apply if cfg.moe_impl == "gspmd" else moe_apply_shardmap
    y, lb = fn(cfg, p["experts"], norm(cfg, x, p["ln2"]))
    return shd.constrain(x + y, "batch", "seq", "embed"), (kv, lb)


def forward_blocks(cfg: ModelConfig, params, x, positions):
    """The leading dense layers, then the MoE layers, each under a
    non-reentrant checkpoint with ``cfg.remat`` while autograd records (a
    MoE layer's returns its hidden state and its load-balance term).
    Returns (x, aux): aux holds ``lb_loss``, the mean over the MoE
    layers, and ``h_final``, the last hidden state (MTP's input)."""
    if cfg.first_k_dense:
        x = _scan_blocks(cfg, params["dense"], x, positions, dense_layer)
    remat = cfg.remat and torch.is_grad_enabled()

    def layer(p_l, h):
        h, (_, lb_l) = moe_layer(cfg, shd.gather_fsdp(p_l), h, positions)
        return h, lb_l

    lb = shd.replicated(torch.zeros((), dtype=torch.float32,
                                    device=x.device), x)
    for p_l in unbind_layers(params["moe"]):
        x, lb_l = checkpoint(shd.bound(layer), p_l, x, use_reentrant=False) if remat \
            else layer(p_l, x)
        lb = lb + lb_l
    n_moe = cfg.n_layers - cfg.first_k_dense
    return x, {"lb_loss": lb / max(n_moe, 1), "h_final": x}


# ---------------------------------------------------------------------------
# MTP (deepseek multi-token prediction, depth 1)
# ---------------------------------------------------------------------------

def mtp_layout(cfg: ModelConfig) -> Layout:
    out: Layout = {"proj": ParamDef((2 * cfg.d_model, cfg.d_model),
                                    ("fsdp", None))}
    attn_fn = mla_layout if cfg.use_mla else attn_layout
    for k, v in attn_fn(cfg, "attn", 1).items():
        out[k] = v
    for k, v in experts_layout(cfg, "experts", 1).items():
        out[k] = v
    out["ln1"] = ParamDef((1, cfg.d_model), ("layers", None), "zeros")
    out["ln2"] = ParamDef((1, cfg.d_model), ("layers", None), "zeros")
    out["ln_in"] = ParamDef((cfg.d_model,), (None,), "zeros")
    return out


def mtp_loss(cfg: ModelConfig, params, batch, h_final):
    """Depth-1 MTP: predict token t+2 from (h_t, emb(t+1)).  ``params``
    are the uncast ones, as the reference's ``loss_fn`` passes them: the
    projection's product takes the wider of the two dtypes, as JAX
    promotes it."""
    p = params["mtp"]
    tokens, labels = batch["tokens"], batch["labels"]
    # shift: combine hidden at t with embedding of token t+1
    emb_next = embed_tokens(cfg, params, torch.roll(tokens, -1, dims=1))
    h = torch.cat([norm(cfg, h_final, p["ln_in"]), emb_next], -1)
    dt = torch.promote_types(h.dtype, p["proj"].dtype)
    h = h.to(dt) @ p["proj"].to(dt)
    B, S = tokens.shape
    positions = torch.arange(S, device=h.device).expand(B, S)
    p_l = tree_map(lambda a: a[0], {k: p[k] for k in
                                    ("attn", "experts", "ln1", "ln2")})
    h, _ = moe_layer(cfg, p_l, h, positions)
    logits = unembed(cfg, params, h)
    lf = logits.float()
    # labels for t+2 == labels shifted by one more step
    lbl = torch.roll(labels, -1, dims=1)
    logz = logsumexp(lf)
    gold = gold_logits(lf, lbl)
    # the last two positions have no label two ahead
    mask = shd.replicated((torch.arange(S, device=shd.local(lf).device)
                           < S - 2).to(gold.dtype).expand(B, S), gold)
    return ((logz - gold) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
