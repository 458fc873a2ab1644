"""Mixture-of-Experts transformers: granite-moe (top-8 of 40, GQA) and
deepseek-v3 (MLA + 1 shared + 256 routed top-8 + dense-first layers + MTP)
(counterpart of ``repro.models.moe``).

Dispatch is sort-based with capacity (MegaBlocks-style dense buffers):
assignments are stably sorted by expert, placed into an (E, C, D) buffer
(capacity drop: an expert keeps its first C assignments in token order),
run through the experts as batched products, and combined by router
weight. Under a mesh with a model axis above 1 (``launch.mesh.set_mesh``),
``_moe_ffn`` takes the expert-parallel dispatch ``moe_apply_ep`` where the
reference takes its ``shard_map``: tokens split over "model", routed to
their experts' rank by ``all_to_all``. Where ``launch.train.run`` placed
the parameters by the sharding rules, the attention (GQA as in
``transformer.py``, MLA as in ``mla.py``: over this rank's heads), the
dense-first layers' MLPs, the shared experts, MTP's block and the
vocabulary are tensor-parallel, and ``moe_apply`` computes each rank's
experts (or each expert's block of its width) from the replicated routing.
The router, the norms and MTP's ``proj`` stay whole. With ``cfg.mla`` each
layer's attention is ``models/mla.py``'s, and the cache holds its latents
(c_kv, k_rope) in place of K and V.

Layers are Python lists (``moe_layers``, ``dense_layers``) where the
reference stacks them for ``lax.scan``; the KV cache keeps its stacked
(L, B, S, Hk, Dh) layout (MLA's: (L, B, S, KL) and (L, B, S, DR)).
Attention is ``transformer.train_attention`` in the training forward and
``transformer.prefill_attention`` in the prefill, so both reach the flash
kernel on the card; ``decode_step`` keeps the dense ``decode_attention``
(MLA: the absorbed ``mla_decode``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import ops
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import get_mesh
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mla as mla_mod
from repro_torch.models import transformer as T
from repro_torch.models.base import ParamSpec, tree_map
from repro_torch.parallel import collectives as C
from repro_torch.parallel import tensor


def moe_specs(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s = {
        "router": ParamSpec((d, e), ("embed", None), "scaled", torch.float32),
        "w_in": ParamSpec((e, d, f), ("experts", "embed", "moe_ff"), "scaled"),
        "w_gate": ParamSpec((e, d, f), ("experts", "embed", "moe_ff"), "scaled"),
        "w_out": ParamSpec((e, f, d), ("experts", "moe_ff", "embed"), "scaled"),
    }
    if cfg.n_shared_experts:
        s["shared"] = L.mlp_specs(d, cfg.moe_d_ff * cfg.n_shared_experts)
    return s


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor) + 1
    return -(-c // 8) * 8  # pad for tiling


def _slots(dest, n_dest: int, cap: int, before=None, rows: int | None = None):
    """Capacity slots of a sort-based dispatch. ``dest`` holds each
    assignment's destination in ``[0, n_dest)`` (``n_dest``: none, dropped);
    the assignments are stably sorted by destination and each destination
    keeps its first ``cap``. Returns, in ``dest``'s layout, each one's slot
    ``dest * cap + rank`` (``n_dest * cap`` where it is dropped). No step
    reads a value back to the host.

    ``before`` (n_dest,) counts each destination's assignments that come
    ahead of these in a global order (those of lower data ranks): an
    assignment is kept only while ``before + rank < cap``, and its slot is
    ``dest * rows + rank`` in a buffer of ``rows`` per destination."""
    flat = dest.reshape(-1).long()
    order = torch.argsort(flat, stable=True)
    sorted_d = flat[order]
    seg = torch.searchsorted(sorted_d, torch.arange(n_dest, device=flat.device))
    rank = (torch.arange(flat.shape[0], device=flat.device)
            - seg[torch.clamp(sorted_d, max=n_dest - 1)])
    pos = torch.empty_like(order).scatter_(0, order, rank)
    rows = cap if rows is None else rows
    ahead = 0 if before is None else before[torch.clamp(flat, max=n_dest - 1)]
    keep = (flat < n_dest) & (pos + ahead < cap)
    return torch.where(keep, flat * rows + pos, n_dest * rows).reshape(dest.shape)


def _route(xf, router, k: int):
    """The router's f32 probabilities (N, E) and each token's top-k experts
    (int32) with their weights renormalized to sum to 1."""
    probs = torch.softmax(L.matmul(xf.float(), router).float(), dim=-1)
    w, idx = ops.top_k(probs, k)
    return probs, w / w.sum(-1, keepdim=True), idx


def _experts(hb, w_in, w_gate, w_out, dtype):
    """The gated expert FFNs over their rows, (E, C, D) -> (E, C, D), as
    three batched products."""
    h = L.matmul(hb, w_in)
    g = L.matmul(hb, w_gate)
    return L.matmul((h * F.silu(g)).to(dtype), w_out)


def _combine(rows, slot, w, order):
    """Each token's K output rows ``rows[slot]`` (zero where ``slot`` is past
    the rows: dropped) times its weights ``w``, summed in f32 in the stable
    order of ``order`` (N, K): the order in which the reference's scatter-add
    adds them, with no atomics. Returns (N, D)."""
    n, k = slot.shape
    m, d = rows.shape
    by = torch.argsort(order, dim=-1, stable=True)
    slot = torch.gather(slot, 1, by).reshape(-1)
    w = torch.gather(w, 1, by)
    got = torch.gather(rows, 0, torch.clamp(slot, max=m - 1)[:, None].expand(n * k, d))
    contrib = torch.where((slot < m)[:, None], got, 0).reshape(n, k, d).float() * w[..., None]
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def _data_group():
    """The data group of the mesh that ``launch.mesh.set_mesh`` made
    ambient, if it joins more than one rank; else None (no mesh, an abstract
    one, or one data rank), where ``moe_apply`` sees the whole batch."""
    g = getattr(get_mesh(), "data_group", None)
    return g if g is not None and dist.get_world_size(g) > 1 else None


def moe_apply(p, x, cfg: ModelConfig):
    """x: (B, S, D) -> (out, aux_loss).

    Ties follow the reference: ``ops.top_k`` picks the lower expert on equal
    probabilities, and the stable sort keeps each expert's assignments in
    token order, so the capacity drop removes exactly the reference's. No
    step reads a value back to the host (``capacity`` comes from the shapes).

    Over a mesh's data ranks (each passing its contiguous rows of the global
    batch) the layer computes the reference's function of the global batch:
    the capacity from the global token count, each expert's kept
    assignments its first C in global token order (this rank's offset by
    the lower data ranks' counts, one all-gather), and the aux loss from
    ``me`` and ``ce`` averaged over the data ranks (``pmean`` with
    ``partial``: the step's gradient mean completes their cotangent). A
    rank holds at most ``min(C, n)`` rows an expert, its own tokens'.

    Expert weights split over "model" (the rules' placement): by experts,
    each rank fills and runs only its experts' capacity rows; by their FFN
    width (``moe_ff``, where the experts do not divide the axis), each rank
    runs every row through its block of the width. Either way the routing,
    the capacity and the aux loss are computed whole on every rank from the
    replicated router, the dispatched rows and the combine weights enter
    through ``replicated`` (their cotangents are partial on each rank), and
    the ranks' combined outputs are summed.
    """
    b, s, d = x.shape
    n = b * s
    k = cfg.top_k
    e = cfg.n_experts
    xf = x.reshape(n, d)

    probs, w, idx = _route(xf, p["router"], k)  # (N, E), (N, K), (N, K)

    # Switch-style load-balance auxiliary loss (a fixed-order sum, no atomics).
    me = probs.mean(0)
    ce = ops.segment_sum(w.reshape(-1), idx.reshape(-1), e) / n
    data = _data_group()
    if data is not None:
        me, ce = C.pmean(me, data, partial=True), C.pmean(ce, data, partial=True)
    aux = cfg.aux_loss_coef * e * torch.sum(me * ce)

    # ---- sort-based dispatch with capacity ----
    # Kept in (token, k) order: an assignment's rank among its expert's is
    # found by the stable sort and carried back, so that each token's row goes
    # to its K slots as one broadcast (whose gradient is a sum over K, where
    # a gather of the row K times would scatter-add it back).
    if data is None:
        cap = capacity(cfg, n)
        slot = _slots(idx, e, cap)  # (N, K); e*cap: dropped
    else:
        flat = idx.reshape(-1).long()
        before = C.sum_before(torch.zeros(e, dtype=torch.int64, device=x.device)
                              .scatter_add_(0, flat, torch.ones_like(flat)), data)
        glob = capacity(cfg, n * dist.get_world_size(data))
        cap = min(glob, n)  # a token takes an expert once
        slot = _slots(idx, e, glob, before, cap)  # (N, K); e*cap: dropped

    e_loc = p["w_in"].shape[0]
    e_group = tensor.split_group(e_loc, e)
    group = e_group if e_group is not None else tensor.split_group(p["w_in"].shape[-1],
                                                                   cfg.moe_d_ff)
    xd = xf
    if group is not None:
        xd, w = C.replicated(xf, group), C.replicated(w, group)
    if e_group is not None:  # this rank's experts' rows; the others' dropped here
        lo = tensor.rank(e_group) * e_loc * cap
        slot = torch.where((slot >= lo) & (slot < lo + e_loc * cap), slot - lo, e_loc * cap)

    buf = ops.at_set(x.new_zeros((e_loc * cap, d)), slot, xd[:, None])
    yb = _experts(buf.reshape(e_loc, cap, d), p["w_in"], p["w_gate"], p["w_out"], x.dtype)

    # ---- combine: the reference scatter-adds in sorted (expert-id) order ----
    y = _combine(yb.reshape(e_loc * cap, d), slot, w, idx)
    if group is not None:
        y = C.psum(y, group)

    if cfg.n_shared_experts:
        y = y + L.mlp(p["shared"], xf, cfg.act, _shared_group(p, cfg)).float()
    return y.reshape(b, s, d).to(x.dtype), aux


def _shared_group(p, cfg: ModelConfig):
    """The "model" group where the shared experts' width is split, else None."""
    return tensor.mlp_group(p["shared"], cfg.moe_d_ff * cfg.n_shared_experts)


def moe_apply_ep(p, x, cfg: ModelConfig, mesh):
    """Expert-parallel dispatch over ``mesh``'s "model" axis (the
    reference's ``shard_map`` with two ``all_to_all``s out and one back),
    for a :class:`~repro_torch.launch.mesh.ProcessMesh`. x: (B, S, D) ->
    (out (B, S, D), aux_loss).

    Shapes are global over "model", as in and out of the reference's
    ``shard_map``: every model rank passes the same ``x`` and gets the whole
    output. Over the data axes each rank passes its own rows (the batch as
    ``parallel/sharding.py`` places it; the reference's ``P(dp, "model")``),
    and the parameters' gradients are left to the step's mean over them.
    Expert weights that the placement already split over "model" (E / tp
    each) are this rank's; whole ones are sliced here. Shared experts whose
    width is split run tensor-parallel on the whole sequence, and each rank
    adds its chunk of their output.

    Each model rank routes its chunk of the sequence and holds E / tp
    experts. Its assignments go to their expert's rank in a send buffer of
    ``cap_send`` rows per rank, and there into ``cap_e`` rows per expert;
    both keep their first assignments in order and drop the rest, so this
    equals ``moe_apply`` only where neither drops. ``aux`` is averaged over
    every mesh axis, replicated. The local products are plain batched
    matmuls, as the reference's are ``einsum``s: it runs no kernel here.
    """
    tp = mesh.shape["model"]
    gm = mesh.group("model")
    e, k = cfg.n_experts, cfg.top_k
    e_loc = e // tp

    x_loc = C.shard(x, gm, 1)
    b, s, d = x_loc.shape
    n = b * s
    xf = x_loc.reshape(n, d)
    router = C.replicated(p["router"], gm)
    w_in, w_gate, w_out = (p[name] if p[name].shape[0] == e_loc else C.shard(p[name], gm, 0)
                           for name in ("w_in", "w_gate", "w_out"))

    probs, w, idx = _route(xf, router, k)  # idx: (n, k) global expert ids

    # averaged over every mesh axis: the data axes first, each rank's loss its own
    # there (partial), then "model", over which the loss is replicated
    def mesh_mean(v):
        return C.pmean(C.pmean(v, mesh.data_group, partial=True), gm)

    me = mesh_mean(probs.mean(0))
    ce = mesh_mean(ops.segment_sum(w.reshape(-1), idx.reshape(-1), e) / n)
    aux = cfg.aux_loss_coef * e * torch.sum(me * ce)

    # pack the send buffer: cap_send rows per destination rank. Assignments
    # stay in (token, k) layout, so each token's row reaches its K slots as one
    # broadcast (its gradient a sum over K, not a scatter-add of K gathers).
    cap_send = -(-int(n * k * cfg.capacity_factor) // tp)
    cap_send = -(-cap_send // 8) * 8
    idx = idx.long()
    dest = idx // e_loc
    slot = _slots(dest, tp, cap_send)  # (n, k)
    send = ops.at_set(x_loc.new_zeros((tp * cap_send, d)), slot, xf[:, None])
    send_eid = ops.at_set(torch.full((tp * cap_send,), -1, dtype=torch.int64, device=x.device),
                          slot, idx % e_loc)

    rx = C.all_to_all(send.reshape(tp, cap_send, d), gm).reshape(tp * cap_send, d)
    re = C.all_to_all(send_eid.reshape(tp, cap_send), gm).reshape(tp * cap_send)

    # local grouped products over this rank's e_loc experts, cap_e rows each
    cap_e = -(-tp * cap_send // e_loc)
    cap_e = -(-cap_e // 8) * 8
    slot2 = _slots(torch.where(re >= 0, re, e_loc), e_loc, cap_e)
    buf = ops.at_set(x_loc.new_zeros((e_loc * cap_e, d)), slot2, rx)
    yb = _experts(buf.reshape(e_loc, cap_e, d), w_in, w_gate, w_out, x.dtype)
    yb = yb.reshape(e_loc * cap_e, d)

    # back to the received rows' order (zeros where dropped), home by all_to_all
    rows = torch.gather(yb, 0, torch.clamp(slot2, max=e_loc * cap_e - 1)[:, None]
                        .expand(tp * cap_send, d))
    out_rx = torch.where((slot2 < e_loc * cap_e)[:, None], rows.float(), 0.0)
    back = C.all_to_all(out_rx.reshape(tp, cap_send, d), gm).reshape(tp * cap_send, d)

    # combine: the reference scatter-adds in its send order (by destination rank)
    y = _combine(back, slot, w, dest)

    shared_group = _shared_group(p, cfg) if cfg.n_shared_experts else None
    if shared_group is not None:
        shared = L.mlp(p["shared"], x, cfg.act, shared_group)
        y = y + C.shard(shared, gm, 1).reshape(n, d).float()
    elif cfg.n_shared_experts:
        shared = tree_map(lambda v: C.replicated(v, gm), p["shared"])
        y = y + L.mlp(shared, xf, cfg.act).float()
    return C.unshard(y.reshape(b, s, d).to(x.dtype), gm, 1), aux


def _ambient_mesh():
    """The mesh ``launch.mesh.set_mesh`` made ambient, if it has a model axis
    above 1; None keeps ``moe_apply``."""
    m = get_mesh()
    if m is not None and "model" in m.axis_names and m.shape["model"] > 1:
        return m
    return None


def _moe_ffn(cfg: ModelConfig, p, xn):
    """Dispatch selector, the reference's: the expert-parallel dispatch under
    ``cfg.moe_hints`` and an ambient mesh whose model axis divides the
    experts and the sequence, else ``moe_apply``. The choice reads the
    config and the mesh only, as the reference's does, never the placement;
    each dispatch then takes the expert weights as the placement left them:
    ``moe_apply_ep`` this rank's E / tp experts (or slices whole ones), and
    ``moe_apply`` whole weights on one device, else this rank's experts or
    block of their width."""
    if cfg.moe_hints:
        mesh = _ambient_mesh()
        if (mesh is not None and cfg.n_experts % mesh.shape["model"] == 0
                and xn.shape[1] % mesh.shape["model"] == 0):
            return moe_apply_ep(p, xn, cfg, mesh)
    return moe_apply(p, xn, cfg)


# ---------------------------------------------------------------------------
# Full MoE decoder model (granite; deepseek-v3's dense-first layers, shared
# experts and MTP)
# ---------------------------------------------------------------------------
def _attn_specs(cfg: ModelConfig):
    return mla_mod.mla_specs(cfg) if cfg.mla else T.attn_specs(cfg)


def _attn_apply(cfg: ModelConfig, p, xn, positions):
    """Causal self-attention of a training forward (the flash kernel's
    autograd entry on the card)."""
    if cfg.mla:
        return mla_mod.mla_attention(p, xn, cfg, positions)
    return T.attn_block(p, xn, cfg, positions)


def moe_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": T.norm_specs(cfg),
        "attn": _attn_specs(cfg),
        "ln2": T.norm_specs(cfg),
        "moe": moe_specs(cfg),
    }


def dense_layer_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": T.norm_specs(cfg),
        "attn": _attn_specs(cfg),
        "ln2": T.norm_specs(cfg),
        "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff, gated=True),
    }


def specs(cfg: ModelConfig) -> dict:
    s = {
        "embed": L.embedding_specs(cfg.vocab, cfg.d_model),
        "moe_layers": [moe_layer_specs(cfg) for _ in range(cfg.n_layers - cfg.first_k_dense)],
        "ln_f": T.norm_specs(cfg),
    }
    if cfg.first_k_dense:
        s["dense_layers"] = [dense_layer_specs(cfg) for _ in range(cfg.first_k_dense)]
    if cfg.mtp_depth:
        s["mtp"] = {
            "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), ("embed", "embed"), "scaled"),
            "block": dense_layer_specs(cfg),
            "ln": T.norm_specs(cfg),
        }
    return s


def _dense_layer(cfg: ModelConfig, lp, x, positions):
    h = x + _attn_apply(cfg, lp["attn"], T.norm(cfg, lp["ln1"], x), positions)
    return h + L.mlp(lp["mlp"], T.norm(cfg, lp["ln2"], h), cfg.act,
                     tensor.mlp_group(lp["mlp"], cfg.d_ff))


def forward(params, batch, cfg: ModelConfig):
    """Returns (hidden (B, S, D), aux_loss)."""
    x = L.embed(params["embed"], batch["tokens"], T.vocab_group(params, cfg)).to(cfg.dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def dense_body(x, lp):
        return _dense_layer(cfg, lp, x, positions)

    def moe_body(x, aux, lp):
        h = x + _attn_apply(cfg, lp["attn"], T.norm(cfg, lp["ln1"], x), positions)
        y, a = _moe_ffn(cfg, lp["moe"], T.norm(cfg, lp["ln2"], h))
        return h + y, aux + a

    for lp in params.get("dense_layers", ()):
        x = L.remat(cfg.remat, dense_body, x, lp)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in params["moe_layers"]:
        x, aux = L.remat(cfg.remat, moe_body, x, aux, lp)
    return T.norm(cfg, params["ln_f"], x), aux


def loss_fn(params, batch, cfg: ModelConfig):
    x, aux = forward(params, batch, cfg)
    group = T.vocab_group(params, cfg)
    logits = L.lm_logits(params["embed"], x, cfg.vocab, group)
    loss = L.softmax_xent(logits, batch["labels"], group=group)
    if cfg.mtp_depth:
        # DeepSeek-V3 MTP (depth 1): predict token t+2 from [h_t ; emb(t+1)].
        nxt = batch["labels"]  # token at t+1
        emb_next = L.embed(params["embed"], torch.clamp(nxt, min=0), group).to(cfg.dtype)
        dt = torch.promote_types(x.dtype, emb_next.dtype)
        h2 = L.matmul(torch.cat([x.to(dt), emb_next.to(dt)], dim=-1), params["mtp"]["proj"])
        h2 = _dense_layer(cfg, params["mtp"]["block"], h2,
                          torch.arange(x.shape[1], device=x.device))
        h2 = T.norm(cfg, params["mtp"]["ln"], h2)
        logits2 = L.lm_logits(params["embed"], h2[:, :-1], cfg.vocab, group)
        mtp_labels = batch["labels"][:, 1:]  # token at t+2
        loss = loss + cfg.mtp_loss_coef * L.softmax_xent(logits2, mtp_labels, group=group)
    return loss + aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
# the layer groups in the order they run, each with its cache keys' prefix
GROUPS = (("dense", "dense_layers"), ("moe", "moe_layers"))


def _cache_names(cfg: ModelConfig):
    """The two cache tensors of a layer group, after its prefix: MLA's
    latents, or K and V."""
    return ("ckv", "krope") if cfg.mla else ("k", "v")


def init_cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    """{"moe_k", "moe_v"} (and "dense_k", "dense_v"): (L, B, S, Hk, Dh); with
    MLA {"moe_ckv", "moe_krope"} (and "dense_ckv", "dense_krope"): (L, B, S,
    KL) and (L, B, S, DR)."""
    s = T.cache_len(cfg, seq_len)
    if cfg.mla:
        tails = ((cfg.kv_lora_rank,), (cfg.rope_head_dim,))
        axes = (None,)
    else:
        tails = ((cfg.n_kv_heads, cfg.head_dim),) * 2
        axes = ("kv_heads", None)
    out = {}
    for prefix, n in (("moe", cfg.n_layers - cfg.first_k_dense), ("dense", cfg.first_k_dense)):
        if prefix == "moe" or n:
            for name, tail in zip(_cache_names(cfg), tails):
                out[f"{prefix}_{name}"] = ParamSpec((n, batch, s, *tail),
                                                    ("layers", None, None, *axes), "zeros",
                                                    cfg.dtype)
    return out


def _serve_ffn(cfg: ModelConfig, lp, h):
    """A layer's feed-forward block in a serving pass: the dense-first
    layers' MLP, or the experts (whose aux loss serving drops) through
    ``_moe_ffn``, as the reference's prefill dispatches them. Its decode step
    calls ``moe_apply``, which ``_moe_ffn`` is there too: one token does not
    split over a model axis above 1."""
    hn = T.norm(cfg, lp["ln2"], h)
    return h + (L.mlp(lp["mlp"], hn, cfg.act) if "mlp" in lp else _moe_ffn(cfg, lp["moe"], hn)[0])


def prefill(params, batch, cfg: ModelConfig):
    """Full-sequence pass that also materializes the KV cache.

    batch: {"tokens": (B, S) int}. Returns (last-position logits (B, 1, V),
    cache {"moe_k", "moe_v"} (and "dense_k", "dense_v"), each (L, B, S, Hk,
    Dh); with MLA {"moe_ckv", "moe_krope"} (and "dense_ckv",
    "dense_krope"), (L, B, S, KL) and (L, B, S, DR); exactly
    ``cache_len(cfg, S)`` long).
    """
    x = L.embed(params["embed"], batch["tokens"]).to(cfg.dtype)
    b, s = x.shape[:2]
    positions = torch.arange(s, device=x.device)

    def attend(lp, x):
        xn = T.norm(cfg, lp["ln1"], x)
        if cfg.mla:
            o, (ckv, krope) = mla_mod.mla_attention(lp["attn"], xn, cfg, positions,
                                                    return_cache=True,
                                                    attention=T.prefill_attention)
            return x + o, ckv, krope
        q, k, v = T.qkv(lp["attn"], xn, cfg, positions)
        o = T.prefill_attention(q, k, v, cfg)
        return x + L.matmul(o.reshape(b, s, -1), lp["attn"]["wo"]), k, v

    n1, n2 = _cache_names(cfg)
    cache = {}
    for prefix, key in GROUPS:
        if key not in params:
            continue
        c1s, c2s = [], []
        for lp in params[key]:
            h, c1, c2 = attend(lp, x)
            x = _serve_ffn(cfg, lp, h)
            c1s.append(c1)
            c2s.append(c2)
        cache[f"{prefix}_{n1}"], cache[f"{prefix}_{n2}"] = torch.stack(c1s), torch.stack(c2s)
    x = T.norm(cfg, params["ln_f"], x)
    logits = L.lm_logits(params["embed"], x[:, -1:], cfg.vocab)
    w = T.cache_len(cfg, s)
    return logits, {k: v[:, :, -w:] for k, v in cache.items()}


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: (B,) absolute positions; the
    write index is ``pos % S`` (rolling buffer). Returns (logits (B, 1, V),
    new cache)."""
    b = tokens.shape[0]
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    bidx = torch.arange(b, device=tokens.device)

    def attn_decode(lp, x, c1, c2):
        xn = T.norm(cfg, lp["ln1"], x)
        if cfg.mla:
            o, c1, c2 = mla_mod.mla_decode(lp["attn"], xn, cfg, pos, c1, c2)
            return x + o, c1, c2
        s_cache = c1.shape[1]
        widx = (pos % s_cache).long()
        q, k, v = T.qkv(lp["attn"], xn, cfg, pos[:, None])
        c1 = c1.index_put((bidx, widx), k[:, 0].to(c1.dtype))
        c2 = c2.index_put((bidx, widx), v[:, 0].to(c2.dtype))
        o = attn.decode_attention(q, c1, c2, torch.clamp(pos + 1, max=s_cache))
        return x + L.matmul(o.reshape(b, 1, -1), lp["attn"]["wo"]), c1, c2

    n1, n2 = _cache_names(cfg)
    new_cache = dict(cache)
    for prefix, key in GROUPS:
        if key not in params:
            continue
        c1s, c2s = [], []
        for i, lp in enumerate(params[key]):
            h, c1, c2 = attn_decode(lp, x, cache[f"{prefix}_{n1}"][i],
                                    cache[f"{prefix}_{n2}"][i])
            x = _serve_ffn(cfg, lp, h)
            c1s.append(c1)
            c2s.append(c2)
        new_cache[f"{prefix}_{n1}"], new_cache[f"{prefix}_{n2}"] = (torch.stack(c1s),
                                                                    torch.stack(c2s))
    x = T.norm(cfg, params["ln_f"], x)
    return L.lm_logits(params["embed"], x, cfg.vocab), new_cache
