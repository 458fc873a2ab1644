"""Flash-attention backward: the training entry's gradient.

The reference has no backward kernel: its training gradient is XLA's
autodiff of the plain ``blockwise_attention`` (f32 throughout). Here it is
``csrc/flash_attention_bwd.cu``, kernels without atomics, so that the
gradients are the same bits from run to run: Δ = rowsum(dO ∘ O); dK and dV,
a block owning a key tile and walking the query heads of its group and the
query tiles the mask leaves; dQ, a block owning a query tile and walking the
key tiles. Each recomputes P = exp(S·scale − lse) from the forward's
log-sum-exp (``flash_attention.flash_attention_fwd_lse``). Both routes run
on the tensor cores with a producer warpgroup, consumer warpgroups and
persistent blocks: bf16 on ``wgmma`` fed by TMA from the caller's strides;
f32 as 3xTF32, from tiles that two preparation kernels first split and
transpose into a scratch buffer (``scratch_bytes``). Same layouts and
masks as the forward: (B, S, H, D) read in place through strides, GQA by
``h // (H / Hk)``, causal top-left aligned, keys from ``sk_valid`` on
masked, (D, Dv) in ``HEAD_DIMS``. CUDA tensors go to the kernels; CPU
tensors to the plain version below; meta tensors get the gradients' shapes
and the operation count (``flash_bwd_flops``); any other device raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.flash_attention import _check

_lib_handle = None


def kernel_bwd_block(d_qk: int, dtype: torch.dtype) -> int:
    """The key tile over which the dQ kernel sums at this q/k head dim and
    input type (csrc/flash_attention_bwd.cu): bf16 (``QCfg::BN``) 128, or
    64 above D 64; f32 (``QF32Cfg::BN``) 64 at D 16, 32 at D 32 and 64, 8
    above, where the resident tile leaves less shared memory. The plain
    version takes it as ``block_k``; it changes the result only by
    rounding."""
    if dtype == torch.bfloat16:
        return 128 if d_qk <= 64 else 64
    return {16: 64, 32: 32, 64: 32}.get(d_qk, 8)


SCRATCH_PAD = 128  # the f32 route's scratch rounds Sq and Sk up to this


def scratch_layout(b: int, h: int, hk: int, sq: int, sk: int, d: int,
                   dv: int) -> dict[str, tuple[int, int]]:
    """The f32 route's scratch (``f32_scratch`` in csrc/flash_attention_bwd.cu)
    as {array: (first word, words)}, in order: Δ and lse in log2 units, (B, H,
    Sqp) each; Q and dO as rows and as tiles, (B, H, Sqp, D or Dv); K as rows,
    V as rows, K as tiles, (B, Hk, Skp, D or Dv); each of the last seven a big
    and then a small tf32 part. Sqp and Skp are Sq and Sk rounded up to
    ``SCRATCH_PAD``, so that a copy of a whole tile stays in its (batch,
    head)."""
    sqp, skp = (-(-n // SCRATCH_PAD) * SCRATCH_PAD for n in (sq, sk))
    rq, rk = b * h * sqp, b * hk * skp
    sizes = {"delta": rq, "lse2": rq, "qr": 2 * rq * d, "dor": 2 * rq * dv, "qt": 2 * rq * d,
             "dot": 2 * rq * dv, "kr": 2 * rk * d, "vr": 2 * rk * dv, "kt": 2 * rk * d}
    out, at = {}, 0
    for name, n in sizes.items():
        out[name] = (at, n)
        at += n
    return out


def scratch_bytes(b: int, h: int, hk: int, sq: int, sk: int, d: int, dv: int,
                  dtype: torch.dtype) -> int:
    """The kernels' scratch, which the launch takes as ``delta``
    (``flash_attention_bwd_scratch_bytes`` in csrc/flash_attention_bwd.cu):
    bf16, Δ, (B, H, Sq) f32; f32, ``scratch_layout``'s words."""
    if dtype == torch.bfloat16:
        return 4 * b * h * sq
    return 4 * sum(n for _, n in scratch_layout(b, h, hk, sq, sk, d, dv).values())


def flash_attention_bwd_plain(q, k, v, o, lse, do, *, causal, sk_valid=None, block_k=64):
    """Plain PyTorch version of the kernels, over key blocks of ``block_k``.
    q, o, do: (B, Sq, H, D or Dv); k, v: (B, Sk, Hk, D or Dv); lse: (B, H,
    Sq) f32. S = q·k, P = exp(S·scale − lse), 0 where masked; dV =
    Pᵀ·dO, dP = dO·Vᵀ, dS = P ∘ (dP − Δ), Δ = rowsum(dO ∘ O), dK = scale
    dSᵀ·Q, dQ = scale dS·K. bf16 inputs: P and dS are rounded to bf16
    before their products, as the kernels round them, and the products are
    summed in f32. f32 inputs: nothing is rounded, and everything is taken
    in f64, so that this is the gradient the kernels' f32 sums approach (a
    sum over 16,384 queries in f32 strays by ~1e-4 in any order). Returns
    dq, dk, dv in q's dtype."""
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    g, dv_ = h // hk, v.shape[-1]
    sk_valid = sk if sk_valid is None else sk_valid
    scale = d**-0.5

    low = q.dtype == torch.bfloat16
    work = torch.float32 if low else torch.float64

    def rnd(x):  # the kernels' rounding of an operand of a product
        return x.to(torch.bfloat16).float() if low else x

    qg = q.to(work).reshape(b, sq, hk, g, d)
    dog = do.to(work).reshape(b, sq, hk, g, dv_)
    delta = (dog * o.to(work).reshape(b, sq, hk, g, dv_)).sum(-1)
    lse_g = lse.to(work).transpose(1, 2).reshape(b, sq, hk, g)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    dq = torch.zeros((b, sq, hk, g, d), dtype=work, device=q.device)
    dk = torch.zeros((b, sk, hk, d), dtype=work, device=q.device)
    dv = torch.zeros((b, sk, hk, dv_), dtype=work, device=q.device)
    for j0 in range(0, sk, block_k):
        kj, vj = k[:, j0:j0 + block_k].to(work), v[:, j0:j0 + block_k].to(work)
        k_pos = j0 + torch.arange(kj.shape[1], device=q.device)[None, :]
        mask = k_pos < sk_valid
        if causal:
            mask = mask & (q_pos >= k_pos)
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kj)
        p = torch.where(mask[None, :, None, None, :], torch.exp(s * scale - lse_g[..., None]),
                        0.0)
        dv[:, j0:j0 + block_k] = torch.einsum("bqhgk,bqhgd->bkhd", rnd(p), dog)
        dp = torch.einsum("bqhgd,bkhd->bqhgk", dog, vj)
        ds = rnd(p * (dp - delta[..., None]))
        dk[:, j0:j0 + block_k] = torch.einsum("bqhgk,bqhgd->bkhd", ds, qg) * scale
        dq += torch.einsum("bqhgk,bkhd->bqhgd", ds, kj)
    return (dq.reshape(b, sq, h, d) * scale).to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def flash_bwd_flops(q_shape, v_shape, sk_valid: int, causal: bool) -> int:
    """Operations the backward needs: per (query, key) pair the mask keeps,
    the five products S, dP = dO·Vᵀ, dV, dQ and dK, 2 (3D + 2Dv) operations.
    Shapes on the (B, Sq, H, D) layout."""
    b, sq, h, d = q_shape
    dv, m = v_shape[-1], min(sq, sk_valid)
    pairs = m * (m + 1) // 2 + (sq - m) * sk_valid if causal else sq * sk_valid
    return 2 * (3 * d + 2 * dv) * b * h * pairs


def _lib():
    """The kernel library, its entry point typed."""
    global _lib_handle
    if _lib_handle is None:
        lib = build.load("flash_attention_bwd")
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 10
            + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
            lse: torch.Tensor, do: torch.Tensor, sk_valid: int,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' launch on CUDA tensors (checked by ``flash_attention_bwd``),
    counted once in ``flash_attention_bwd.launches``."""
    dq, dk, dv = (torch.empty(t.shape, dtype=q.dtype, device=q.device) for t in (q, k, v))
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    # Δ = rowsum(dO ∘ O), and for f32 the prepared tiles
    scratch = torch.empty(scratch_bytes(b, h, hk, sq, sk, d, v.shape[3], q.dtype),
                          dtype=torch.uint8, device=q.device)
    ops = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(st for t in ops for st in t.stride()[:3]))
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_bwd_launch(
            *(t.data_ptr() for t in (q, k, v, o, lse, do, dq, dk, dv, scratch)), strides, b, h, hk,
            sq, sk, d, v.shape[3], sk_valid, int(causal), int(q.dtype == torch.bfloat16),
            d**-0.5, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


# the launch as an operator, so that dispatch modes see it: on the meta device
# it gives the gradients' shapes, and FlopCounterMode counts it by
# flash_bwd_flops on the card and on meta alike
_bwd_op = torch.library.custom_op("repro_torch::flash_attention_bwd", _launch, mutates_args=(),
                                  device_types="cuda")


@_bwd_op.register_fake
def _bwd_shape(q, k, v, o, lse, do, sk_valid, causal):
    return tuple(q.new_empty(t.shape) for t in (q, k, v))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_op_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, sk_valid, causal,
                  *args, **kwargs) -> int:
    return flash_bwd_flops(q_shape, v_shape, sk_valid, causal)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal, sk_valid=None):
    """dq, dk, dv of ``flash_attention_fwd_lse``'s output ``o`` under the
    cotangent ``do``. q, o, do: (B, Sq, H, D or Dv); k, v: (B, Sk, Hk, D or
    Dv), read in place as the forward reads them; lse: (B, H, Sq) f32, the
    forward's. The gradients come in q's dtype, contiguous; keys from
    ``sk_valid`` (default Sk) on get zeros. ``flash_attention_bwd.launches``
    counts calls on the card, one each (three kernels)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, sk_valid=sk_valid,
                                         block_k=kernel_bwd_block(q.shape[-1], q.dtype))
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu (or meta), not {q.device}")
    if any(t.dim() != 4 for t in (q, k, v, o, do)):
        raise ValueError("need q, k, v, o and do all (B, S, H, D)")
    sk_valid = k.shape[1] if sk_valid is None else sk_valid
    _check(q, k, v, sk_valid)
    want = q.shape[:3] + (v.shape[3],)
    if o.shape != want or do.shape != want or lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"o and do must be {tuple(want)} and lse (B, H, Sq); got "
                         f"{tuple(o.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be contiguous f32")
    # the cotangent comes as autograd hands it over: give the kernels rows
    # of 16-byte aligned, contiguous heads, as q's
    o, do = (t if t.dtype == q.dtype and t.stride(-1) == 1 and t.data_ptr() % 16 == 0
             and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3])
             else t.to(q.dtype).contiguous() for t in (o, do))
    return _bwd_op(q, k, v, o, lse, do, sk_valid, causal)


flash_attention_bwd.launches = 0
