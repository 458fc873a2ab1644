"""Recurrent sequence mixers: xLSTM (mLSTM + sLSTM blocks) and Mamba2
(counterpart of ``repro.models.ssm``).

Where the reference runs each recurrence as a ``lax.scan`` over the
sequence, the port runs a Python loop over time. The elementwise work that
does not depend on the carry (the f32 casts, mLSTM's log forget gate and
scaled keys, Mamba2's decay ``exp(a·dt)`` and ``dt·x``) is computed for every
step at once before the loop: the same elementwise operations on the same
values, so the same results. Only the carry's update runs per step, each
step's output is kept in a list and stacked once: the one loop, ``_scan``,
of all three. Decode is one step of the same loop from the carried state;
there is no KV cache.

``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``_softplus`` computes it so
(``F.softplus`` takes a threshold shortcut and rounds otherwise). The scan's
outputs are rounded to ``x``'s dtype before the per-head group norm, as in
the reference, so in bf16 that norm runs in bf16.

On a mesh whose "model" axis splits the parameters (``launch.train.run``
places them by the sharding rules, ``parallel/tensor.py``), the recurrences
run whole on every rank, and each block's leaves are used so:

- gathered at their use (``tensor.gathered``), their blocks being no unit
  of independent work: mLSTM's ``w_up`` (its blocks straddle ``[u | z]``)
  and ``wq``/``wk``/``wv`` (split over their input features, while the
  scan reads every head); sLSTM's ``w`` (gate-major ``[i | f | z | o]``)
  and its recurrent ``r`` (split over heads, but head j's recurrent term
  feeds gate j of every channel, the reference's layout, kept); Mamba2's
  ``in_proj`` (``[z | x | B | C | dt]``);
- split over "ff" after the scan: mLSTM's and Mamba2's ``gn`` and their
  row-parallel ``w_down``/``out_proj`` take this rank's block of the group
  norm's output and of the gate z (``collectives.shard``: its backward
  all-gathers the blocks' cotangents, so the whole recurrence upstream gets
  them whole), and the ranks' partial outputs are summed;
- whole: the depthwise ``conv``, mLSTM's ``w_if``/``b_if``, Mamba2's
  ``a_log``/``dt_bias``/``d_skip``, the input norms, sLSTM's ``b``, ``gn``
  and ``w_down`` (the rules keep these whole).

No head-split tensor is read whole here (B and C of Mamba2 feed the whole
scan on each rank), so no partial cotangent needs a sum of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.base import ParamSpec
from repro_torch.parallel import collectives as C
from repro_torch.parallel import tensor


def _scan(step, carry, xs):
    """``carry, y = step(carry, x_t)`` for each t, ``x_t`` the t-th slice of
    every tensor of ``xs`` (time on dim 0; views shaped for a step's
    broadcasts, so that a step issues only its arithmetic). Returns (carry,
    the ys stacked on dim 1, the time dim of a (B, S, ...) output). A step
    broadcasts over any leading dims of its inputs and carry, which lets the
    dry run (``launch/dryrun.py``) count T steps through a batched stand-in."""
    ys = []
    for x_t in zip(*(x.unbind(0) for x in xs)):
        carry, y = step(carry, x_t)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _group_norm(y, heads: int):
    """Per-head normalization of y (B, S, C) over C // heads channels: the
    population variance (``jnp.var``), eps 1e-6, in y's dtype."""
    b, s, c = y.shape
    y = y.reshape(b, s, heads, c // heads)
    mu = y.mean(-1, keepdim=True)
    var = torch.var(y, dim=-1, keepdim=True, correction=0)
    return ((y - mu) * torch.rsqrt(var + 1e-6)).reshape(b, s, c)


def _causal_depthwise_conv(x, w, state=None):
    """x: (B, S, C); w: (K, C) depthwise causal. state: (B, K-1, C) carry-in.

    Returns (y (B, S, C), new_state (B, K-1, C)). The K taps are summed in
    order from a zero start, as Python's ``sum`` does in the reference."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return y, xp[:, -(k - 1):] if k > 1 else state


def _gated_down(y, z, gn, w_down, di: int):
    """``(y * gn * silu(z)) @ w_down`` for the group norm's output ``y`` and
    the gate ``z`` (B, S, di). Where ``gn`` and ``w_down`` hold this rank's
    block of the di features, over this rank's block of y and z,
    row-parallel."""
    group = tensor.split_group(gn.shape[0], di)
    if group is None:
        return L.matmul(y * gn * F.silu(z), w_down)
    y, z = C.shard(y, group, -1), C.shard(z, group, -1)
    return tensor.row(y * gn * F.silu(z), w_down, group)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block)
# ---------------------------------------------------------------------------
def mlstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.expand * d
    h = cfg.n_heads
    return {
        "ln": L.rmsnorm_specs(d),
        "w_up": ParamSpec((d, 2 * di), ("embed", "ff"), "scaled"),
        "conv": ParamSpec((cfg.d_conv, di), ("conv", None), "normal"),
        "wq": ParamSpec((di, di), ("ff", None), "scaled"),
        "wk": ParamSpec((di, di), ("ff", None), "scaled"),
        "wv": ParamSpec((di, di), ("ff", None), "scaled"),
        "w_if": ParamSpec((d, 2 * h), ("embed", None), "scaled", torch.float32),
        "b_if": ParamSpec((2 * h,), (None,), "zeros", torch.float32),
        "gn": ParamSpec((di,), ("ff",), "ones"),
        "w_down": ParamSpec((di, d), ("ff", "embed"), "scaled"),
    }


def mlstm_state_specs(cfg: ModelConfig, batch: int) -> dict:
    di = cfg.expand * cfg.d_model
    h = cfg.n_heads
    dh = di // h
    return {
        "C": ParamSpec((batch, h, dh, dh), (None, "heads", None, None), "zeros", torch.float32),
        "n": ParamSpec((batch, h, dh), (None, "heads", None), "zeros", torch.float32),
        "m": ParamSpec((batch, h), (None, "heads"), "zeros", torch.float32),
        "conv": ParamSpec((batch, cfg.d_conv - 1, di), (None, None, "ff"), "zeros", cfg.dtype),
    }


def _mlstm_scan(q32, k_s, v32, i_raw, log_f, C, n, m):
    """The mLSTM recurrence over S steps. q32, v32: (B, S, H, Dh) f32; k_s the
    f32 keys times Dh^-0.5; i_raw, log_f: (B, S, H). Returns (h (B, S, H,
    Dh) f32, (C, n, m)). Each step's inputs are views taken before the loop,
    shaped for their broadcasts, so that a step issues only its arithmetic."""

    def step(carry, xt):
        C, n, m = carry
        q_t, k_t, k_row, v_col, i_t, lf_t = xt
        lf_m = lf_t + m
        m_new = torch.maximum(lf_m, i_t)
        i_g = torch.exp(i_t - m_new)[..., None]
        f_g = torch.exp(lf_m - m_new)[..., None]
        C = f_g[..., None] * C + i_g[..., None] * (v_col * k_row)
        n = f_g * n + i_g * k_t
        denom = torch.clamp(torch.abs(n[..., None, :] @ q_t), min=1.0)
        return (C, n, m_new), (C @ q_t) / denom

    q_steps = q32.transpose(0, 1).contiguous()  # each step's q a contiguous (B, H, Dh)
    xs = (q_steps[..., None], *(t.transpose(0, 1) for t in (
        k_s, k_s[:, :, :, None, :], v32[..., None], i_raw, log_f)))
    (C, n, m), hs = _scan(step, (C, n, m), xs)
    return hs[..., 0], (C, n, m)


def mlstm_apply(p, x, cfg: ModelConfig, state=None):
    """x: (B, S, D). Returns (y, new_state {"C", "n", "m", "conv"})."""
    b, s, d = x.shape
    di = cfg.expand * d
    h = cfg.n_heads
    dh = di // h
    wq, wk, wv = (tensor.gathered(p[name], 0, di) for name in ("wq", "wk", "wv"))
    xn = L.rmsnorm(p["ln"], x)
    up = L.matmul(xn, tensor.gathered(p["w_up"], 1, 2 * di))
    u, z = up[..., :di], up[..., di:]
    uc, conv_new = _causal_depthwise_conv(u, p["conv"], None if state is None else state["conv"])
    uc = F.silu(uc)
    q = L.matmul(uc, wq).reshape(b, s, h, dh)
    k = L.matmul(uc, wk).reshape(b, s, h, dh)
    v = L.matmul(u, wv).reshape(b, s, h, dh)
    gates = L.matmul(xn.float(), p["w_if"]) + p["b_if"]
    i_raw, f_raw = gates[..., :h], gates[..., h:]

    if state is None:
        C0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
        n0 = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
        m0 = torch.zeros((b, h), dtype=torch.float32, device=x.device)
    else:
        C0, n0, m0 = state["C"], state["n"], state["m"]
    log_f = -_softplus(-f_raw)  # log sigmoid
    hs, (C, n, m) = _mlstm_scan(q.float(), k.float() * (dh**-0.5), v.float(), i_raw, log_f,
                                C0, n0, m0)
    hs = _group_norm(hs.reshape(b, s, di).to(x.dtype), h)
    y = _gated_down(hs, z, p["gn"], p["w_down"], di)
    return y, {"C": C, "n": n, "m": m, "conv": conv_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar-memory block)
# ---------------------------------------------------------------------------
def slstm_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    return {
        "ln": L.rmsnorm_specs(d),
        "w": ParamSpec((d, 4 * d), ("embed", "ff"), "scaled"),
        "r": ParamSpec((h, dh, 4 * dh), ("heads", None, None), "scaled"),
        "b": ParamSpec((4 * d,), (None,), "zeros", torch.float32),
        "gn": ParamSpec((d,), ("embed",), "ones"),
        "w_down": ParamSpec((d, d), ("embed", "embed"), "scaled"),
    }


def slstm_state_specs(cfg: ModelConfig, batch: int) -> dict:
    d = cfg.d_model
    leaf = ParamSpec((batch, d), (None, "embed"), "zeros", torch.float32)
    return {"c": leaf, "n2": leaf, "m2": leaf, "h": leaf}


def slstm_apply(p, x, cfg: ModelConfig, state=None):
    """x: (B, S, D). Returns (y, new_state {"c", "n2", "m2", "h"}); the
    stabilizer ``m2`` starts at 0, as in the reference."""
    b, s, d = x.shape
    heads = cfg.n_heads
    dh = d // heads
    xn = L.rmsnorm(p["ln"], x)
    wx = L.matmul(xn, tensor.gathered(p["w"], 1, 4 * d)).float()  # (B, S, 4d)

    if state is None:
        c, n, m, h_prev = (torch.zeros((b, d), dtype=torch.float32, device=x.device)
                           for _ in range(4))
    else:
        c, n, m, h_prev = state["c"], state["n2"], state["m2"], state["h"]
    r = tensor.gathered(p["r"], 0, heads).float()

    def step(carry, xt):
        c, n, m, h_prev = carry
        rec = torch.einsum("...hd,hde->...he", h_prev.unflatten(-1, (heads, dh)), r).flatten(-2)
        g = xt[0] + rec + p["b"]
        i_raw, f_raw, z_raw, o_raw = torch.split(g, d, dim=-1)
        lf_m = -_softplus(-f_raw) + m
        m_new = torch.maximum(lf_m, i_raw)
        i_g = torch.exp(i_raw - m_new)
        f_g = torch.exp(lf_m - m_new)
        c = f_g * c + i_g * torch.tanh(z_raw)
        n = f_g * n + i_g
        h_prev = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1.0)
        return (c, n, m_new, h_prev), h_prev

    (c, n, m, h_prev), hs = _scan(step, (c, n, m, h_prev), (wx.transpose(0, 1),))
    hs = _group_norm(hs.to(x.dtype), heads)
    y = L.matmul(hs * p["gn"], p["w_down"])
    return y, {"c": c, "n2": n, "m2": m, "h": h_prev}


# ---------------------------------------------------------------------------
# Mamba2 (SSD scalar-A recurrence): zamba2's backbone
# ---------------------------------------------------------------------------
def _mamba2_heads(cfg: ModelConfig) -> int:
    return max(cfg.expand * cfg.d_model // 64, 1)  # P = 64 head channels


def mamba2_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.expand * d
    n = cfg.d_state
    h = _mamba2_heads(cfg)
    return {
        "ln": L.rmsnorm_specs(d),
        "in_proj": ParamSpec((d, 2 * di + 2 * n + h), ("embed", "ff"), "scaled"),
        "conv": ParamSpec((cfg.d_conv, di + 2 * n), ("conv", None), "normal"),
        "a_log": ParamSpec((h,), (None,), "zeros", torch.float32),
        "dt_bias": ParamSpec((h,), (None,), "zeros", torch.float32),
        "d_skip": ParamSpec((h,), (None,), "ones", torch.float32),
        "gn": ParamSpec((di,), ("ff",), "ones"),
        "out_proj": ParamSpec((di, d), ("ff", "embed"), "scaled"),
    }


def mamba2_state_specs(cfg: ModelConfig, batch: int) -> dict:
    di = cfg.expand * cfg.d_model
    h = _mamba2_heads(cfg)
    return {
        "S": ParamSpec((batch, h, di // h, cfg.d_state), (None, None, None, None), "zeros",
                       torch.float32),
        "conv": ParamSpec((batch, cfg.d_conv - 1, di + 2 * cfg.d_state), (None, None, None),
                          "zeros", cfg.dtype),
    }


def mamba2_apply(p, x, cfg: ModelConfig, state=None):
    """x: (B, S, D). Returns (y, new_state {"S", "conv"})."""
    b, s, d = x.shape
    di = cfg.expand * d
    n = cfg.d_state
    h = _mamba2_heads(cfg)
    ph = di // h
    xn = L.rmsnorm(p["ln"], x)
    proj = L.matmul(xn, tensor.gathered(p["in_proj"], 1, 2 * di + 2 * n + h))
    z, xin, dt_raw = proj[..., :di], proj[..., di:2 * di], proj[..., 2 * di + 2 * n:]
    bc = proj[..., 2 * di:2 * di + 2 * n]
    conv_in = torch.cat([xin, bc], dim=-1)
    conv_out, conv_new = _causal_depthwise_conv(conv_in, p["conv"],
                                                None if state is None else state["conv"])
    conv_out = F.silu(conv_out)
    xc = conv_out[..., :di].reshape(b, s, h, ph)
    bmat = conv_out[..., di:di + n].float()
    cmat = conv_out[..., di + n:].float()

    a = -torch.exp(p["a_log"])  # (H,)
    dt = _softplus(dt_raw.float() + p["dt_bias"])  # (B, S, H)
    xc32 = xc.float()
    decay = torch.exp(a * dt)  # (B, S, H)
    dtx = dt[..., None] * xc32  # (B, S, H, P)
    S = (torch.zeros((b, h, ph, n), dtype=torch.float32, device=x.device) if state is None
         else state["S"])

    # the read-out S·c is one (B, H·P, N) @ (B, N, 1) product (a broadcast of
    # c over the heads would copy it every step)
    def step(carry, xt):
        decay_t, dtx_t, b_t, c_t = xt
        S = decay_t * carry[0] + dtx_t * b_t
        return (S,), S.flatten(-3, -2) @ c_t

    xs = tuple(t.transpose(0, 1) for t in (decay[..., None, None], dtx[..., None],
                                           bmat[:, :, None, None, :], cmat[..., None]))
    (S,), ys = _scan(step, (S,), xs)
    y = ys.view(b, s, h, ph)
    y = y + p["d_skip"][:, None] * xc32
    y = _group_norm(y.reshape(b, s, di).to(x.dtype), h)
    return _gated_down(y, z, p["gn"], p["out_proj"], di), {"S": S, "conv": conv_new}
