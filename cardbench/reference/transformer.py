"""Plain reference of the benchmark's decoder-only transformers.

The same functions as the configurations state them, written from the
published equations in plain PyTorch, in float32 arithmetic (callers turn
TF32 off), with no kernels, cache manager or batching of their own:

* a llama-style block: RMSNorm, rotary positions (rotate-half), causal
  attention with grouped KV heads, a gated SiLU MLP, a tied head;
* granite-3.0's MoE block: an f32 router, top-k by probability (ties to the
  lower expert), weights renormalized over the k, each expert's capacity
  ``ceil8(int(N k / E * capacity_factor) + 1)`` filled in (token, k) order and
  the rest dropped, the experts' gated FFNs, the weighted sum of the kept
  outputs, and the switch load-balance loss;
* token-mean cross entropy (label -1 ignored) and AdamW with global-norm
  clipping, linear warmup and a cosine schedule, its moments in f32.

Parameters are stored between optimizer steps in the dtypes the
configuration states (bf16, the router f32): an update is computed in f32
and rounded to the stored dtype, as a bf16 training job stores it.

``Prec(lowered=True)`` is the control: every product that the
configuration states in bf16 takes its operands rounded to float8 e4m3 with
a per-tensor scale (the router, stated f32, stays f32). Gradients pass the
rounding unchanged (straight through).

Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

F8_MAX = 448.0  # largest finite float8 e4m3


def _f8(x):
    """x rounded to float8 e4m3 under a per-tensor scale, gradient unchanged."""
    xd = x.detach()
    scale = torch.clamp(xd.abs().amax(), min=1e-30) / F8_MAX
    q = (xd / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - xd)


class Prec:
    """The products' precision: f32, or the control's float8 operands."""

    def __init__(self, lowered: bool = False):
        self.lowered = lowered

    def op(self, x):
        return _f8(x) if self.lowered else x

    def mm(self, a, b):
        return self.op(a) @ self.op(b)


F32 = Prec(False)
FP8 = Prec(True)


# --------------------------------------------------------------------------
# the configuration's sizes
# --------------------------------------------------------------------------
def sizes(c: dict) -> dict:
    d, h = c["hidden_size"], c["num_attention_heads"]
    moe = c.get("num_local_experts", 0) > 0
    return dict(d=d, h=h, hk=c["num_key_value_heads"], dh=d // h, v=c["vocab_size"],
                layers=c["num_hidden_layers"], f=c["intermediate_size"], moe=moe,
                e=c.get("num_local_experts", 0), k=c.get("num_experts_per_tok", 0),
                eps=c["rms_norm_eps"], theta=float(c["rope_theta"]),
                cf=c["port"].get("capacity_factor", 1.0),
                aux=c.get("router_aux_loss_coef", 0.0),
                prefix="moe_layers" if moe else "layers")


def param_leaves(c: dict, table_rows: int | None = None) -> list[tuple]:
    """(name, shape, init, dtype name) of every parameter, in a fixed order.
    ``init``: "normal" (0.02), "scaled" (1 / sqrt(rows of the last two dims)),
    "ones". The embedding table has ``table_rows`` rows (the vocabulary, or
    more: rows past it are never read)."""
    z = sizes(c)
    d, h, hk, dh, f = z["d"], z["h"], z["hk"], z["dh"], z["f"]
    pdt = c["port"]["param_dtype"]
    out = [("embed.table", (table_rows or z["v"], d), "normal", pdt)]
    for i in range(z["layers"]):
        p = f"{z['prefix']}.{i}"
        out += [(f"{p}.ln1.scale", (d,), "ones", pdt),
                (f"{p}.attn.wq", (d, h * dh), "scaled", pdt),
                (f"{p}.attn.wk", (d, hk * dh), "scaled", pdt),
                (f"{p}.attn.wv", (d, hk * dh), "scaled", pdt),
                (f"{p}.attn.wo", (h * dh, d), "scaled", pdt),
                (f"{p}.ln2.scale", (d,), "ones", pdt)]
        if z["moe"]:
            e = z["e"]
            out += [(f"{p}.moe.router", (d, e), "scaled", c["port"]["router_dtype"]),
                    (f"{p}.moe.w_in", (e, d, f), "scaled", pdt),
                    (f"{p}.moe.w_gate", (e, d, f), "scaled", pdt),
                    (f"{p}.moe.w_out", (e, f, d), "scaled", pdt)]
        else:
            out += [(f"{p}.mlp.w_in", (d, f), "scaled", pdt),
                    (f"{p}.mlp.w_out", (f, d), "scaled", pdt),
                    (f"{p}.mlp.w_gate", (d, f), "scaled", pdt)]
    out.append(("ln_f.scale", (d,), "ones", pdt))
    return out


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x, theta):
    """x: (B, S, H, Dh) at positions 0..S-1; rotate-half pairs (i, i + Dh/2)."""
    s, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None, :], torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, prec: Prec, rows: int = 512):
    """Causal softmax attention. q: (B, S, H, Dh); k, v: (B, S, Hk, Dh); query
    head j reads KV head j // (H / Hk). Query rows in blocks of ``rows``."""
    b, s, h, dh = q.shape
    g = h // k.shape[2]
    k = prec.op(k).repeat_interleave(g, dim=2).transpose(1, 2)  # (B, H, S, Dh)
    v = prec.op(v).repeat_interleave(g, dim=2).transpose(1, 2)
    q = prec.op(q).transpose(1, 2) / math.sqrt(dh)
    outs = []
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        sc = q[:, :, r0:r1] @ k[:, :, :r1].transpose(-1, -2)  # (B, H, R, r1)
        mask = torch.arange(r1, device=q.device)[None, :] <= torch.arange(r0, r1,
                                                                          device=q.device)[:, None]
        p = torch.softmax(torch.where(mask, sc, -torch.inf), dim=-1)
        outs.append(prec.op(p) @ v[:, :, :r1])
    return torch.cat(outs, dim=2).transpose(1, 2)  # (B, S, H, Dh)


def qkv(w, x, z, prec: Prec):
    b, s, _ = x.shape
    q = prec.mm(x, w["wq"]).reshape(b, s, z["h"], z["dh"])
    k = prec.mm(x, w["wk"]).reshape(b, s, z["hk"], z["dh"])
    v = prec.mm(x, w["wv"]).reshape(b, s, z["hk"], z["dh"])
    return rope(q, z["theta"]), rope(k, z["theta"]), v


def capacity(n_tokens: int, z: dict) -> int:
    c = int(n_tokens * z["k"] / z["e"] * z["cf"]) + 1
    return -(-c // 8) * 8


def moe(w, x, z, prec: Prec):
    """x: (N, D) -> (out (N, D), aux loss)."""
    n, d = x.shape
    e, k = z["e"], z["k"]
    probs = torch.softmax(x @ w["router"], dim=-1)  # the router stays f32
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    wts = top / top.sum(-1, keepdim=True)
    aux = z["aux"] * e * torch.sum(
        probs.mean(0) * torch.zeros(e, device=x.device).index_add(0, idx.reshape(-1),
                                                                  wts.reshape(-1)) / n)
    cap = capacity(n, z)
    flat = idx.reshape(-1)  # assignments in (token, k) order
    onehot = F.one_hot(flat, e)
    rank = (torch.cumsum(onehot, 0) - 1).gather(1, flat[:, None])[:, 0]
    keep = rank < cap
    slot = flat * cap + rank
    tok = torch.arange(n, device=x.device).repeat_interleave(k)
    buf = torch.zeros(e * cap, d, device=x.device, dtype=x.dtype).index_put(
        (slot[keep],), x[tok[keep]])
    hb = buf.reshape(e, cap, d)
    hid = prec.mm(hb, w["w_in"]) * F.silu(prec.mm(hb, w["w_gate"]))
    out = prec.mm(hid, w["w_out"]).reshape(e * cap, d)
    got = torch.where(keep[:, None], out[torch.where(keep, slot, 0)], 0.0)
    y = (got.reshape(n, k, d) * wts[..., None]).sum(1)
    return y, aux


def layer(w, x, z, prec: Prec, kv_out=None):
    """One block; x: (B, S, D) -> (x, aux). ``kv_out``, a list, receives the
    layer's K (after rotary) and V."""
    b, s, d = x.shape
    q, k, v = qkv(w["attn"], rmsnorm(x, w["ln1"], z["eps"]), z, prec)
    if kv_out is not None:
        kv_out.append((k, v))
    h = x + prec.mm(attention(q, k, v, prec).reshape(b, s, -1), w["attn"]["wo"])
    hn = rmsnorm(h, w["ln2"], z["eps"])
    if z["moe"]:
        y, aux = moe(w["moe"], hn.reshape(b * s, d), z, prec)
        return h + y.reshape(b, s, d), aux
    m = w["mlp"]
    y = prec.mm(prec.mm(hn, m["w_in"]) * F.silu(prec.mm(hn, m["w_gate"])), m["w_out"])
    return h + y, torch.zeros((), device=x.device)


def layer_weights(params: dict, z: dict, i: int) -> dict:
    """Layer i's parameters, as f32 tensors, nested like the block reads them."""
    p = f"{z['prefix']}.{i}."
    out = {"ln1": params[p + "ln1.scale"].float(), "ln2": params[p + "ln2.scale"].float(),
           "attn": {n: params[p + "attn." + n].float() for n in ("wq", "wk", "wv", "wo")}}
    if z["moe"]:
        out["moe"] = {n: params[p + "moe." + n].float()
                      for n in ("router", "w_in", "w_gate", "w_out")}
    else:
        out["mlp"] = {n: params[p + "mlp." + n].float() for n in ("w_in", "w_gate", "w_out")}
    return out


# --------------------------------------------------------------------------
# training: loss, gradients, AdamW
# --------------------------------------------------------------------------
def loss_fn(params: dict, tokens, labels, z: dict, prec: Prec):
    """Token-mean cross entropy through the tied head, plus the MoE layers'
    load-balance losses. Each layer is recomputed in the backward, and the
    head row by row, so that the full model fits beside AdamW's moments.
    ``params`` holds f32 leaves."""
    table = params["embed.table"]
    x = table[tokens.long()]
    aux = torch.zeros((), device=x.device)
    for i in range(z["layers"]):
        w = layer_weights(params, z, i)
        x, a = checkpoint(lambda x, w=w: layer(w, x, z, prec), x, use_reentrant=False)
        aux = aux + a
    x = rmsnorm(x, params["ln_f.scale"], z["eps"])
    head = table[: z["v"]]

    def row_loss(xr, lr):
        logits = prec.mm(xr, head.t())
        return F.cross_entropy(logits, lr.long(), ignore_index=-1, reduction="sum")

    total = sum(checkpoint(row_loss, x[r], labels[r], use_reentrant=False)
                for r in range(x.shape[0]))
    count = torch.clamp((labels != -1).sum(), min=1)
    return total / count + aux


def schedule(ocfg: dict, step: int) -> float:
    warm = min(step / max(ocfg["warmup"], 1), 1.0)
    prog = min(max((step - ocfg["warmup"]) / max(ocfg["total_steps"] - ocfg["warmup"], 1), 0.0),
               1.0)
    return ocfg["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * prog))


def train(params: dict, dtypes: dict, batches, c: dict, ocfg: dict, prec: Prec):
    """AdamW steps over ``batches`` [(tokens, labels)], updating ``params``
    (name -> f32 leaf holding values of its stored dtype) in place. Returns
    each step's loss and the first step's clipped gradient norm per leaf."""
    z = sizes(c)
    names = list(params)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    losses, first = [], None
    for t, (tokens, labels) in enumerate(batches, start=1):
        leaves = {n: params[n].detach().requires_grad_() for n in names}
        loss = loss_fn(leaves, tokens, labels, z, prec)
        grads = list(torch.autograd.grad(loss, [leaves[n] for n in names]))
        losses.append(float(loss.detach()))
        gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(ocfg["clip_norm"] / torch.clamp(gnorm, min=1e-9), max=1.0)
        if first is None:
            first = torch.stack([torch.linalg.vector_norm(g * scale) for g in grads])
        lr = schedule(ocfg, t)
        b1c, b2c = 1.0 - ocfg["b1"] ** t, 1.0 - ocfg["b2"] ** t
        with torch.no_grad():
            for j, n in enumerate(names):
                g = grads[j] * scale
                grads[j] = None
                m[n].mul_(ocfg["b1"]).add_((1 - ocfg["b1"]) * g)
                v[n].mul_(ocfg["b2"]).add_((1 - ocfg["b2"]) * g * g)
                step = (m[n] / b1c) / (torch.sqrt(v[n] / b2c) + ocfg["eps"]) \
                    + ocfg["weight_decay"] * params[n]
                params[n].copy_((params[n] - lr * step).to(dtypes[n]))
        del grads, leaves, loss
    return losses, first


# --------------------------------------------------------------------------
# prefill
# --------------------------------------------------------------------------
@torch.no_grad()
def prefill(params: dict, prompts: list, positions: list, c: dict, prec: Prec,
            all_logits: bool = False):
    """The forward pass over each prompt (1-D token tensors), layer by layer
    across the prompts. Returns, per prompt, its logits over the vocabulary
    (the last position's (V,), or every position's (S, V) with
    ``all_logits``) and its K and V at ``positions`` (a 1-D index tensor per
    prompt), each (layers, P, Hk, Dh)."""
    z = sizes(c)
    table = params["embed.table"].float()
    xs = [table[p.long()][None] for p in prompts]
    ks = [[] for _ in prompts]
    vs = [[] for _ in prompts]
    for i in range(z["layers"]):
        w = layer_weights(params, z, i)
        for j, x in enumerate(xs):
            kv = []
            xs[j], _ = layer(w, x, z, prec, kv)
            ks[j].append(kv[0][0][0, positions[j]])
            vs[j].append(kv[0][1][0, positions[j]])
        del w
    head = table[: z["v"]]
    out = []
    for j, x in enumerate(xs):
        x = rmsnorm(x[0], params["ln_f.scale"].float(), z["eps"])
        logits = prec.mm(x if all_logits else x[-1:], head.t())
        out.append((logits if all_logits else logits[0], torch.stack(ks[j]), torch.stack(vs[j])))
    return out
