"""Shared layer primitives: norms, rotary and sinusoidal positions, MLPs,
embeddings.

Counterpart of ``repro.models.layers``. Parameters are dicts of tensors in
the reference's layout (``x @ W``). Mixed dtypes follow JAX's promotion:
``bf16 * f32`` is f32 in both frameworks, but torch refuses a ``bf16 @ f32``
product, so :func:`matmul` casts both sides to the promoted dtype first.

The MLP, the embedding, the tied head and the cross-entropies take a
``group``: the mesh's "model" process group where their parameters are
split over it (``parallel/tensor.py``), None where they are whole, which is
the one-device path unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.base import ParamSpec
from repro_torch.parallel import collectives as C


def matmul(x, w):
    """``x @ w`` in the dtype JAX's promotion gives the pair."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps: float = 1e-6):
    """Normalized in f32, rounded back to x's dtype, then times the scale
    (which promotes: a bf16 x with f32 params comes out f32)."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * p["scale"]


def layernorm_specs(d: int) -> dict:
    return {
        "scale": ParamSpec((d,), ("embed",), init="ones"),
        "bias": ParamSpec((d,), ("embed",), init="zeros"),
    }


def layernorm(p, x, eps: float = 1e-5):
    dt = x.dtype
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(dt) * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float = 10000.0, device=None):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exps)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)  # (Dh/2,)
    ang = positions[..., None].float() * freqs  # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2 :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sinusoidal_freqs(d: int, device: torch.device):
    """The reference's float64 numpy frequencies, rounded to f32 once (as JAX
    takes a float64 array without x64) and kept on ``device``, so that a
    decode step copies nothing from the host."""
    half = d // 2
    freqs = np.exp(-np.log(10000.0) * np.arange(half) / max(half - 1, 1))
    return torch.tensor(freqs, dtype=torch.float32, device=device)


def sinusoidal(positions, d: int):
    """positions: (...,) int -> (..., d) f32: sin of each angle, then cos."""
    ang = positions[..., None].float() * _sinusoidal_freqs(d, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_specs(d: int, f: int, gated: bool = True) -> dict:
    s = {
        "w_in": ParamSpec((d, f), ("embed", "ff"), init="scaled"),
        "w_out": ParamSpec((f, d), ("ff", "embed"), init="scaled"),
    }
    if gated:
        s["w_gate"] = ParamSpec((d, f), ("embed", "ff"), init="scaled")
    return s


def _act(x, act: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if act == "silu" else F.gelu(x, approximate="tanh")


def mlp(p, x, act: str = "silu", group=None):
    """With ``group``, ``w_in`` and ``w_gate`` hold this rank's columns of the
    width and ``w_out`` its rows (Megatron's MLP): the replicated ``x`` in,
    the ranks' partial outputs summed."""
    if group is not None:
        x = C.replicated(x, group)
    h = matmul(x, p["w_in"])
    if "w_gate" in p:
        h = h * _act(matmul(x, p["w_gate"]), act)
    else:
        h = _act(h, act)
    out = matmul(h, p["w_out"])
    return out if group is None else C.psum(out, group)


# ---------------------------------------------------------------------------
# Embedding / LM head (padded vocab, as the reference pads for sharding)
# ---------------------------------------------------------------------------
def padded_vocab(vocab: int, multiple: int = 256) -> int:
    return -(-vocab // multiple) * multiple


def embedding_specs(vocab: int, d: int) -> dict:
    return {"table": ParamSpec((padded_vocab(vocab), d), ("vocab", "embed"))}


def embed(p, tokens, group=None):
    """The tokens' rows. With ``group`` the table holds this rank's block of
    the vocabulary: tokens outside it take zeros, and the ranks' rows are
    summed."""
    if group is None:
        return p["table"][tokens]
    rows = p["table"].shape[0]
    local = tokens - dist.get_rank(group) * rows
    inside = (local >= 0) & (local < rows)
    out = p["table"][torch.where(inside, local, 0)]
    return C.psum(torch.where(inside[..., None], out, 0), group)


def lm_logits(p, x, true_vocab: int, group=None):
    """Tied-embedding head; padded tail masked to -1e9. With ``group`` the
    table holds this rank's block of the vocabulary: the replicated ``x`` to
    this rank's columns of the logits, the mask on the global columns past
    ``true_vocab``, wherever they fall."""
    if group is None:
        logits, start = matmul(x, p["table"].T), 0
    else:
        logits = matmul(C.replicated(x, group), p["table"].T)
        start = dist.get_rank(group) * logits.shape[-1]
    pad = start + logits.shape[-1] - true_vocab
    if pad > 0:
        mask = torch.zeros(logits.shape[-1], dtype=logits.dtype, device=logits.device)
        mask[max(true_vocab - start, 0):] = -1e9
        logits = logits + mask
    return logits


def _token_xent(logits, labels, ignore: int = -1, group=None):
    """Per-token cross entropy in f32 and the mask of counted tokens. With
    ``group`` the logits are this rank's block of the vocabulary: the
    log-sum-exp takes the ranks' max and sums their exponentials, and the
    target's logit comes from the rank that holds it."""
    logits = logits.float()
    mask = labels != ignore
    lab = torch.clamp(labels, min=0).long()
    if group is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, lab[..., None])[..., 0]
        return (lse - ll) * mask, mask
    n = logits.shape[-1]
    m = C.pmax(logits.amax(dim=-1), group)
    lse = torch.log(C.psum(torch.exp(logits - m[..., None]).sum(-1), group)) + m
    local = lab - dist.get_rank(group) * n
    inside = (local >= 0) & (local < n)
    ll = torch.gather(logits, -1, torch.clamp(local, 0, n - 1)[..., None])[..., 0]
    ll = C.psum(torch.where(inside, ll, 0.0), group)
    return (lse - ll) * mask, mask


def remat(on: bool, fn, *args):
    """``fn(*args)`` (one layer); with ``on`` (a config's ``remat``) it keeps
    only its inputs and recomputes the rest in the backward (``checkpoint``,
    where the reference has ``jax.checkpoint``). No randomness inside, so no
    RNG state to keep."""
    if on:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def tied_xent_chunked(embed_params, x, labels, true_vocab: int, chunk: int, group=None):
    """Sequence-chunked tied-embedding cross-entropy.

    Live logits are capped at (B, chunk, V): each chunk's logits are dropped
    after its forward and recomputed in the backward (``checkpoint``, where
    the reference has ``jax.checkpoint`` over a ``lax.scan``). The chunks'
    sums are added in order, as the scan's carry adds them. ``group`` as
    ``lm_logits`` takes it: each rank's live logits are (B, chunk, V / tp).
    """
    b, s, d = x.shape
    n = s // chunk
    if n * chunk != s:
        raise ValueError(f"sequence {s} is not a multiple of xent_chunk {chunk}")

    def body(xc, lc):
        loss, mask = _token_xent(lm_logits(embed_params, xc, true_vocab, group), lc,
                                 group=group)
        return loss.sum(), mask.sum(dtype=torch.int32)

    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        # no randomness inside, so no RNG state to keep for the recompute
        l, c = checkpoint(body, x[:, sl], labels[:, sl], use_reentrant=False,
                          preserve_rng_state=False)
        loss, cnt = loss + l, cnt + c
    return loss / torch.clamp(cnt, min=1)


def softmax_xent(logits, labels, ignore: int = -1, group=None):
    """Token-mean cross entropy in f32; ``ignore`` labels are masked. With
    ``group`` the logits are this rank's block of the vocabulary."""
    loss, mask = _token_xent(logits, labels, ignore, group)
    return loss.sum() / torch.clamp(mask.sum(), min=1)
