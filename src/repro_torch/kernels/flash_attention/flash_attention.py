"""Flash-attention forward: the prefill's attention.

Counterpart of ``repro.kernels.flash_attention.flash_attention``; the kernel
is ``csrc/flash_attention.cu``. Online softmax in f32 over KV blocks, an
optional causal mask (top-left aligned: query i sees keys 0..i), a tail mask
at ``sk_valid``, and GQA by ``h // g`` on the flat head index. The value
head may be narrower than the query and key heads (MLA: 192 over 128). CUDA
tensors go to the kernel; CPU tensors to the plain version below; meta
tensors (the dry run) get the output's shape and the kernel's operation count
(``flash_flops``); any other device raises.

Two layouts are taken: the reference kernel's (B·H, S, D), and the model's
(B, S, H, D), which the kernel reads in place through strides (``ops.py``).
The training entry's forward (``flash_attention_fwd_lse``) also writes each
query row's log-sum-exp, which the backward (``flash_attention_bwd.py``)
recomputes the probabilities from.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

NEG_INF = -1e30
# the (q and k, v) head dims the kernel is compiled for: square, and MLA's
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (192, 128))

_lib_handle = None


def kernel_block_k(d_qk: int, dtype) -> int:
    """The keys of one KV tile of the kernel at this q/k head dim and dtype
    (``Bf16Cfg::BK`` and ``Cfg::BK`` in csrc/flash_attention.cu): the plain
    version takes the same ``block_k`` to round p and each block's P·V at
    the same points. bf16 takes the reference's default of 128 at every
    pair."""
    if dtype == torch.bfloat16:
        return 128
    if d_qk <= 64:
        return 64
    return 16 if d_qk > 128 else 32


def _heads_first(x):
    """(B, S, H, D) -> (B·H, S, D)."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def flash_attention_fwd_plain(q, k, v, *, sk_valid=None, causal=True, block_q=128, block_k=128,
                              lse=False):
    """Plain PyTorch version of the kernel, with the Pallas kernel's roundings:
    q cast to f32 and then scaled by D^-0.5, masked scores -1e30, ``p`` cast to
    v's dtype before P·V (whose product is in v's dtype, as the reference's
    ``lax.dot``), the finalize dividing by max(l, 1e-30), the output in q's
    dtype. The online softmax is carried over KV blocks of ``block_k``; query
    rows are independent, so ``block_q`` does not change the result. With
    ``lse``, also each row's log-sum-exp m + log(l) of the masked, scaled
    scores in f32, (B, H, Sq) (or (B·H, Sq) on the reference's layout)."""
    if q.dim() == 4:
        b, sq, h, _ = q.shape
        out = flash_attention_fwd_plain(_heads_first(q), _heads_first(k), _heads_first(v),
                                        sk_valid=sk_valid, causal=causal, block_q=block_q,
                                        block_k=block_k, lse=lse)
        o = (out[0] if lse else out).reshape(b, h, sq, -1).transpose(1, 2)
        return (o, out[1].reshape(b, h, sq)) if lse else o
    bh, sq, d = q.shape
    bh_kv, sk, _ = k.shape
    g = bh // bh_kv
    dv = v.shape[-1]
    sk_valid = sk if sk_valid is None else sk_valid
    bk = min(block_k, sk)
    qg = (q.float() * d**-0.5).reshape(bh_kv, g, sq, d)  # flat head h reads KV head h // g
    q_pos = torch.arange(sq, device=q.device)[:, None]
    m = torch.full((bh_kv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh_kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh_kv, g, sq, dv), dtype=torch.float32, device=q.device)
    for j0 in range(0, sk, bk):
        kj, vj = k[:, None, j0:j0 + bk], v[:, None, j0:j0 + bk]
        s = qg @ kj.float().transpose(-1, -2)  # (BH_kv, G, Sq, bk)
        k_pos = j0 + torch.arange(kj.shape[2], device=q.device)[None, :]
        mask = k_pos < sk_valid
        if causal:
            mask = mask & (q_pos >= k_pos)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + (p.to(v.dtype) @ vj).float()
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).reshape(bh, sq, dv).to(q.dtype)
    return (out, (m + torch.log(l)).reshape(bh, sq)) if lse else out


def _lib():
    """The kernel library, its entry points typed."""
    global _lib_handle
    if _lib_handle is None:
        lib = build.load("flash_attention")
        args = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)]
                + [ctypes.c_int] * 10 + [ctypes.c_float])
        lib.flash_attention_fwd_launch.argtypes = args + [ctypes.c_void_p]
        lib.flash_attention_fwd_launch.restype = ctypes.c_int
        # the same, and the log-sum-exp's output before the stream
        lib.flash_attention_fwd_lse_launch.argtypes = args + [ctypes.c_void_p] * 2
        lib.flash_attention_fwd_lse_launch.restype = ctypes.c_int
        lib.flash_attention_scratch_bytes.argtypes = [ctypes.c_int] * 6
        lib.flash_attention_scratch_bytes.restype = ctypes.c_longlong
        _lib_handle = lib
    return _lib_handle


def _check(q, k, v, sk_valid):
    """q, k, v as the kernel sees them: (B, Sq, H, D), (B, Sk, Hk, D) and
    (B, Sk, Hk, Dv), (D, Dv) one of HEAD_DIMS."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q {q.dtype} on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the kernel takes f32 or bf16, got {q.dtype}")
    b, sq, h, d = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, Sk, Hk, D) and (B, Sk, Hk, Dv) beside q "
                         f"{tuple(q.shape)}; got {tuple(k.shape)}, {tuple(v.shape)}")
    if (d, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims (q and k {d}, v {v.shape[3]}) are not one of {HEAD_DIMS}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of {k.shape[2]} KV heads")
    if sq == 0 or not 1 <= sk_valid <= k.shape[1]:
        raise ValueError(f"need Sq >= 1 and 1 <= sk_valid ({sk_valid}) <= Sk ({k.shape[1]})")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    # the kernel copies 16-byte chunks: every operand and row starts on 16 bytes
    if any(t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in t.stride()[:3])
           for t in (q, k, v)):
        raise ValueError("q, k and v and each of their rows must be 16-byte aligned")


def flash_flops(q_shape, v_shape, sk_valid: int, causal: bool) -> int:
    """Operations one launch needs: per (query, key) pair the mask keeps, D
    multiply-adds for the score and Dv for P·V, 2 operations each. Shapes
    in either layout, (B·H, Sq, D) or (B, Sq, H, D); keys from ``sk_valid``
    on are masked, and with ``causal`` query i keeps keys 0..i."""
    sq, d, dv = q_shape[1], q_shape[-1], v_shape[-1]
    rows = q_shape[0] * (q_shape[2] if len(q_shape) == 4 else 1)
    m = min(sq, sk_valid)
    pairs = m * (m + 1) // 2 + (sq - m) * sk_valid if causal else sq * sk_valid
    return 2 * (d + dv) * rows * pairs


def _kernel_view(t):
    """The kernel's view of an operand, (B, S, H, D); (B·H, S, D) is B = 1."""
    return t if t.dim() == 4 else t.unsqueeze(0).transpose(1, 2)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sk_valid: int,
            causal: bool) -> torch.Tensor:
    """The prefill's launch on CUDA tensors (checked by ``_check``)."""
    return _run(q, k, v, sk_valid, causal)


def _launch_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sk_valid: int,
                causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``_launch`` that also writes each query row's log-sum-exp, (B, H, Sq)
    in f32 (q, k, v on the (B, S, H, D) layout)."""
    lse = torch.empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32, device=q.device)
    return _run(q, k, v, sk_valid, causal, lse), lse


def _run(q, k, v, sk_valid, causal, lse=None):
    """The kernel's launch, counted in ``flash_attention_fwd.launches``; it
    writes ``lse`` where one is given."""
    o = torch.empty(q.shape[:-1] + (v.shape[-1],), dtype=q.dtype, device=q.device)
    views = [_kernel_view(t) for t in (q, k, v, o)]
    b, sq, h, d = views[0].shape
    _, sk, hk, _ = views[1].shape
    dv = views[2].shape[3]
    strides = (ctypes.c_longlong * 12)(*(st for t in views for st in t.stride()[:3]))
    lib = _lib()
    is_bf16 = int(q.dtype == torch.bfloat16)
    # f32: the KV tiles as the kernel prepares them (split, transposed, in its
    # layout); bf16 reads K and V in place and asks for none
    n_scratch = lib.flash_attention_scratch_bytes(b, hk, sk_valid, d, dv, is_bf16)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), scratch.data_ptr(), n_scratch,
            strides, b, h, hk, sq, sk, d, dv, sk_valid, int(causal), is_bf16, d**-0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if lse is None:  # the prefill's launch
            rc = lib.flash_attention_fwd_launch(*args, stream)
        else:
            rc = lib.flash_attention_fwd_lse_launch(*args, lse.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA error {rc}")
    flash_attention_fwd.launches += 1
    return o


# the launch as an operator of its own, so that dispatch modes see it: on the
# meta device it gives the output's shape, and FlopCounterMode counts it by
# flash_flops on the card and on meta alike
_flash_op = torch.library.custom_op("repro_torch::flash_attention_fwd", _launch, mutates_args=(),
                                    device_types="cuda")


@_flash_op.register_fake
def _flash_shape(q, k, v, sk_valid, causal):
    return q.new_empty(q.shape[:-1] + (v.shape[-1],))


# the training forward's launch, which also gives the log-sum-exp; one more
# operator, so that the prefill's stays as it is
_flash_lse_op = torch.library.custom_op("repro_torch::flash_attention_fwd_lse", _launch_lse,
                                        mutates_args=(), device_types="cuda")


@_flash_lse_op.register_fake
def _flash_lse_shape(q, k, v, sk_valid, causal):
    return (q.new_empty(q.shape[:-1] + (v.shape[-1],)),
            q.new_empty((q.shape[0], q.shape[2], q.shape[1]), dtype=torch.float32))


@register_flop_formula([torch.ops.repro_torch.flash_attention_fwd,
                        torch.ops.repro_torch.flash_attention_fwd_lse])
def _flash_op_flops(q_shape, k_shape, v_shape, sk_valid, causal, *args, **kwargs) -> int:
    return flash_flops(q_shape, v_shape, sk_valid, causal)


def flash_attention_fwd(q, k, v, *, sk_valid=None, causal=True, block_q=128, block_k=128):
    """Flash-attention forward.

    q: (B·H, Sq, D); k: (B·Hk, Sk, D); v: (B·Hk, Sk, Dv) -> (B·H, Sq, Dv),
    the reference's layout; or q: (B, Sq, H, D); k: (B, Sk, Hk, D); v:
    (B, Sk, Hk, Dv) -> (B, Sq, H, Dv), read in place. f32 or bf16, (D, Dv)
    in HEAD_DIMS on the card; the output is in q's dtype. Keys at positions
    >= ``sk_valid`` (default Sk) are masked. Sq and Sk are any lengths: the
    kernel masks its ragged tiles itself. On the meta device (the dry run)
    it checks the same and gives the output's shape.

    On the card the kernel's tiles are its own (128 query rows by
    ``kernel_block_k`` keys); ``block_q`` and ``block_k`` are the plain
    version's blocks, as they were the Pallas grid's, and change the result
    only by rounding.
    ``flash_attention_fwd.launches`` counts kernel launches.

    The output is not tracked by autograd, so this raises where q, k or v
    requires grad under grad mode; training takes
    ``ops.flash_attention_train``, whose backward is the kernels of
    ``flash_attention_bwd.py``.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_fwd has no gradient: q, k or v requires grad. Use "
            "repro_torch.kernels.flash_attention.ops.flash_attention_train (FlashAttentionFn), "
            "or call it under torch.no_grad()")
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, sk_valid=sk_valid, causal=causal,
                                         block_q=block_q, block_k=block_k)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu (or meta), not {q.device}")
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError(f"need q, k, v all (B·H, S, D) or all (B, S, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    sk_valid = k.shape[1] if sk_valid is None else sk_valid
    _check(*(_kernel_view(t) for t in (q, k, v)), sk_valid)
    return _flash_op(q, k, v, sk_valid, causal)


flash_attention_fwd.launches = 0


def flash_attention_fwd_lse(q, k, v, *, causal=True):
    """The training forward: ``flash_attention_fwd`` on the (B, S, H, D)
    layout that also gives each query row's log-sum-exp, (B, H, Sq) in f32,
    the natural log of the sum of exp of the masked, scaled scores. Counted
    in ``flash_attention_fwd.launches`` with the prefill's launches. Called
    under no grad (by ``ops.FlashAttentionFn``)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal, lse=True)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_fwd_lse runs on cuda or cpu (or meta), not {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need q, k, v all (B, S, H, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _check(q, k, v, k.shape[1])
    return _flash_lse_op(q, k, v, k.shape[1], causal)
