"""Parity of the port's flash attention (kernels/flash_attention) and
``blockwise_attention`` with the JAX package's, on the CPU, where the wrapper
takes the plain version.

Tolerances: ``ops.flash_attention`` against the JAX one (its Pallas kernel in
interpret mode, blocks of 32) at the shapes of ``tests/test_kernels.py``,
2e-6 in f32 and 2e-2 in bf16, as the reference's own kernel test holds it
(both round p to bf16 before P·V at bf16; the sums are taken in another
order). ``blockwise_attention`` and the oracles within 1e-5.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.flash_attention.ops import flash_attention as j_flash_attention
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.models import attention as j_attn
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import attention
from test_torch_parity import to_np

# tests/test_kernels.py::TestFlashAttention.SHAPES: (B, Sq, Sk, H, Hk, D, causal)
SHAPES = [
    (2, 64, 64, 4, 4, 32, True),
    (1, 128, 128, 8, 2, 64, True),
    (2, 33, 95, 4, 1, 16, False),
    (1, 257, 300, 2, 2, 128, True),
]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-6),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def qkv_inputs(seed, b, sq, sk, h, hk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:6])))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_matches_reference(shape, dtype):
    b, sq, sk, h, hk, d, causal = shape
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v = qkv_inputs(0, b, sq, sk, h, hk, d)
    oj = j_flash_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), causal=causal,
                           block_q=32, block_k=32)
    ot = flash_attention(*(torch.tensor(x).to(tdt) for x in (q, k, v)), causal=causal,
                         block_q=32, block_k=32)
    assert ot.shape == (b, sq, h, d) and ot.dtype == tdt
    np.testing.assert_allclose(to_np(ot), to_np(oj), atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s[:6])))
def test_plain_layouts_and_blocks_agree_with_oracle(shape):
    """The (B·H, S, D) layout, the (B, S, H, D) one and any block size give the
    oracle's attention; ``sk_valid`` masks the keys beyond it."""
    b, sq, sk, h, hk, d, causal = shape
    q, k, v = (torch.tensor(x) for x in qkv_inputs(1, b, sq, sk, h, hk, d))
    ref = flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(to_np(ref), np.asarray(j_flash_ref(q.numpy(), k.numpy(), v.numpy(),
                                                                  causal=causal)),
                               atol=1e-5, rtol=1e-5)
    for bq, bk in ((128, 128), (16, 48)):
        o4 = fa.flash_attention_fwd(q, k, v, causal=causal, block_q=bq, block_k=bk)
        o3 = fa.flash_attention_fwd(fa._heads_first(q), fa._heads_first(k), fa._heads_first(v),
                                    causal=causal, block_q=bq, block_k=bk)
        np.testing.assert_allclose(to_np(o4), to_np(ref), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(to_np(fa._heads_first(o4)), to_np(o3))
    sv = sk - 7
    o = fa.flash_attention_fwd(q, k, v, sk_valid=sv, causal=causal, block_k=32)
    r = flash_attention_ref(q, k[:, :sv], v[:, :sv], causal=causal)
    np.testing.assert_allclose(to_np(o), to_np(r), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_with_a_narrower_v_head_matches_reference_blockwise(causal):
    """MLA's head pair at smoke width: q and k heads of 48 (nope 32 + rope 16)
    beside v heads of 32, as MLA's prefill hands them over (v a strided slice
    of the expanded latent). The plain version, on both layouts and with a
    tail mask, against the reference's ``blockwise_attention`` (the function
    MLA's prefill calls) and its oracle, within 1e-5."""
    rng = np.random.default_rng(6)
    b, sq, h, dqk, dv = 2, 40, 4, 48, 32
    q = rng.standard_normal((b, sq, h, dqk)).astype(np.float32)
    k = rng.standard_normal((b, sq, h, dqk)).astype(np.float32)
    kv = rng.standard_normal((b, sq, h, 32 + dv)).astype(np.float32)
    v = kv[..., 32:]
    want = np.asarray(j_attn.blockwise_attention(q, k, v, causal=causal, block=8))
    np.testing.assert_allclose(want, np.asarray(j_attn.reference_attention(q, k, v, causal=causal)),
                               atol=1e-5, rtol=1e-5)
    qt, kt, vt = torch.tensor(q), torch.tensor(k), torch.tensor(kv)[..., 32:]
    o4 = fa.flash_attention_fwd(qt, kt, vt, causal=causal, block_k=16)
    assert o4.shape == (b, sq, h, dv)
    np.testing.assert_allclose(to_np(o4), want, atol=1e-5, rtol=1e-5)
    o3 = fa.flash_attention_fwd(fa._heads_first(qt), fa._heads_first(kt), fa._heads_first(vt),
                                causal=causal)
    assert o3.shape == (b * h, sq, dv)
    np.testing.assert_allclose(to_np(o3), to_np(fa._heads_first(o4)), atol=1e-5, rtol=1e-5)
    o = fa.flash_attention_fwd(qt, kt, vt, sk_valid=sq - 9, causal=causal)
    cut = np.asarray(j_attn.reference_attention(q, k[:, :sq - 9], v[:, :sq - 9], causal=causal))
    np.testing.assert_allclose(to_np(o), cut, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(to_np(attention.blockwise_attention(qt, kt, vt, causal=causal)),
                               want, atol=1e-5, rtol=1e-5)


def test_kernel_block_k_follows_the_kernels_tiles():
    assert [fa.kernel_block_k(d, torch.bfloat16) for d, _ in fa.HEAD_DIMS] == [128] * 5
    assert [fa.kernel_block_k(d, torch.float32) for d, _ in fa.HEAD_DIMS] == [64, 64, 64, 32, 16]


# bf16 at the kernel's tiles: (B, Sq, Sk, H, Hk, D, causal), one causal with
# GQA, one ragged (Sq, Sk not multiples of 128) without the mask
KERNEL_TILE_SHAPES = [(1, 256, 256, 4, 2, 64, True), (2, 200, 300, 4, 4, 128, False)]


@pytest.mark.parametrize("shape", KERNEL_TILE_SHAPES, ids=lambda s: "x".join(map(str, s[:6])))
def test_plain_at_the_kernels_bf16_tiles_matches_reference(shape):
    """The plain version at ``kernel_block_k(d, bf16)`` (the oracle that
    ``chip_smoke.py`` holds the card's bf16 kernel to) against the reference's
    Pallas kernel in interpret mode at the same ``block_k``: both round p and
    each block's P·V to bf16 at the same keys. Tolerance: check_flash's, rtol
    2e-2 and atol min(2e-2, 2^-6 max|o|)."""
    b, sq, sk, h, hk, d, causal = shape
    bk = fa.kernel_block_k(d, torch.bfloat16)
    q, k, v = qkv_inputs(7, b, sq, sk, h, hk, d)
    oj = np.asarray(j_flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                                      causal=causal, block_q=128, block_k=bk), np.float32)
    ot = fa.flash_attention_fwd(*(torch.tensor(x).to(torch.bfloat16) for x in (q, k, v)),
                                causal=causal, block_k=bk)
    assert ot.shape == (b, sq, h, d) and ot.dtype == torch.bfloat16
    atol = min(2e-2, 2.0**-6 * float(np.abs(oj).max()))
    np.testing.assert_allclose(to_np(ot), oj, atol=atol, rtol=2e-2)


def round_tf32(x):
    """f32 to the nearest tf32 (10 mantissa bits), ties away from zero, on the
    bit pattern: what ``cvt.rna.tf32.f32`` gives."""
    bits = x.contiguous().numpy().view(np.uint32)
    return torch.from_numpy(((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def split_tf32(x):
    big = round_tf32(x)
    return big, round_tf32(x - big)


def tf32_products(a, b, passes):
    """a @ b from tf32 parts, summed in f32: 3 passes are big.big + big.small +
    small.big (the kernel's 3xTF32; each product of two tf32 values is exact in
    f32), 1 pass is big.big alone."""
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    if passes == 1:
        return ab @ bb
    return (as_ @ bb + ab @ bs) + ab @ bb


def tf32_attention(q, k, v, *, causal, passes, block_k=64):
    """The plain version's algebra on (B, S, H, D) f32, with both products
    taken by ``tf32_products``: the arithmetic of the kernel's f32 path."""
    b, sq, h, d = q.shape
    qh, kh, vh = (fa._heads_first(t) for t in (q, k, v))
    g = h // k.shape[2]
    sk = kh.shape[1]
    qg = (qh * d**-0.5).reshape(-1, g * sq, d)  # flat head h reads KV head h // g
    q_pos = torch.arange(sq).repeat(g)[:, None]
    m = torch.full((qg.shape[0], g * sq), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape)
    for j0 in range(0, sk, block_k):
        kj, vj = kh[:, j0:j0 + block_k], vh[:, j0:j0 + block_k]
        s = tf32_products(qg, kj.transpose(-1, -2).contiguous(), passes)
        k_pos = j0 + torch.arange(kj.shape[1])[None, :]
        if causal:
            s = torch.where(q_pos >= k_pos, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + tf32_products(p, vj.contiguous(), passes)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, sq, d).transpose(1, 2)


TF32_SHAPES = SHAPES + [(1, 2048, 2048, 1, 1, 64, True)]


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=lambda s: "x".join(map(str, s[:6])))
def test_3xtf32_products_hold_the_f32_tolerance(shape):
    """The kernel's f32 arithmetic, emulated: 3xTF32 products keep the output
    within 1e-5 of the f32 oracle, where one TF32 pass misses it; so the split
    is what lets the tensor cores take f32 inputs."""
    b, sq, sk, h, hk, d, causal = shape
    q, k, v = (torch.tensor(x) for x in qkv_inputs(5, b, sq, sk, h, hk, d))
    ref = flash_attention_ref(q, k, v, causal=causal)
    three = tf32_attention(q, k, v, causal=causal, passes=3)
    np.testing.assert_allclose(to_np(three), to_np(ref), atol=1e-5, rtol=1e-5)
    one = tf32_attention(q, k, v, causal=causal, passes=1)
    assert float((one - ref).abs().max()) > 1e-5


def test_round_tf32_rounds_to_nearest_ties_away():
    ulp = 2.0**-10  # tf32's spacing in [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2**-23, 1 + 0.75 * ulp])
    want = torch.tensor([1.0, 1 + ulp, -(1 + ulp), 1.0, 1 + ulp])
    assert torch.equal(round_tf32(x), want)
    big, small = split_tf32(torch.tensor([np.pi], dtype=torch.float32))
    assert float((big + small - np.float32(np.pi)).abs()) <= 2.0**-21


def blockwise_inputs():
    rng = np.random.default_rng(2)
    b, sq, sk, h, hk, d = 2, 9, 14, 4, 2, 16
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k, v = rng.standard_normal((2, b, sk, hk, d)).astype(np.float32)
    return q, k, v, np.array([11, 14], np.int32)


BLOCKWISE_CASES = {"causal": dict(causal=True),
                   "offset_kv_len": dict(causal=True, q_offset=5, kv_len=True),
                   "kv_len": dict(causal=False, kv_len=True)}


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("block", [1024, 7, 4])
@pytest.mark.parametrize("case", list(BLOCKWISE_CASES))
def test_blockwise_attention_matches_reference(window, block, case):
    """Against the JAX oracle ``reference_attention`` always, and against the
    JAX ``blockwise_attention`` where its block divides Sk (14): there the
    reference pads nothing, and its padded-tail fault (next test) cannot show."""
    q, k, v, kv_len = blockwise_inputs()
    kw = dict(BLOCKWISE_CASES[case], window=window)
    if kw.pop("kv_len", False):
        kw["kv_len"] = kv_len
    tkw = {n: torch.tensor(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
    ot = attention.blockwise_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                       block=block, **tkw)
    np.testing.assert_allclose(to_np(ot), np.asarray(j_attn.reference_attention(q, k, v, **kw)),
                               atol=1e-5, rtol=1e-5)
    if k.shape[1] % min(block, k.shape[1]) == 0:
        oj = j_attn.blockwise_attention(q, k, v, block=block, **kw)
        np.testing.assert_allclose(to_np(ot), np.asarray(oj), atol=1e-5, rtol=1e-5)


def test_reference_blockwise_masks_its_padded_tail():
    """A fault of the reference, which the port does not copy: where Sk is not
    a multiple of the block, the JAX ``blockwise_attention`` masks keys at
    ``k_pos >= Sk - pad`` (pad = the zeros it appends), so the last ``pad``
    real keys drop out. It equals the oracle over the first Sk - pad keys."""
    q, k, v, _ = blockwise_inputs()
    sk, pad = k.shape[1], -k.shape[1] % 4
    oj = np.asarray(j_attn.blockwise_attention(q, k, v, causal=False, block=4))
    cut = np.asarray(j_attn.reference_attention(q, k[:, :sk - pad], v[:, :sk - pad], causal=False))
    np.testing.assert_allclose(oj, cut, atol=1e-5, rtol=1e-5)
    ot = attention.blockwise_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                       causal=False, block=4)
    full = np.asarray(j_attn.reference_attention(q, k, v, causal=False))
    np.testing.assert_allclose(to_np(ot), full, atol=1e-5, rtol=1e-5)
    assert np.abs(full - cut).max() > 1e-2


def test_blockwise_attention_keeps_q_dtype():
    q, k, v = (torch.tensor(x).to(torch.bfloat16) for x in qkv_inputs(3, 1, 8, 8, 2, 1, 16))
    o = attention.blockwise_attention(q, k, v, causal=True, block=3)
    assert o.dtype == torch.bfloat16 and o.shape == q.shape
    np.testing.assert_allclose(to_np(o), to_np(attention.reference_attention(q, k, v, causal=True)),
                               atol=1e-2)


def test_cuda_tensors_reach_the_kernel(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel (mocked here: fake CUDA
    tensors, recording stand-ins for the library's ctypes functions) with the
    strides of the (B, S, H, D) layout read in place, both head dims (q and k,
    then v) and the scratch the library asks for, and never the plain version.
    MLA's pair (192, 128) reaches the entry with v a strided slice of the
    expanded latent, read in place; a pair the kernel lacks, such as (48, 32),
    raises."""
    calls, asked = [], []

    def fake_launch(*args):
        calls.append(args)
        return 0

    def fake_scratch_bytes(*args):
        asked.append(args)
        return 4096

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    lib = type("Lib", (), {"flash_attention_fwd_launch": staticmethod(fake_launch),
                           "flash_attention_scratch_bytes": staticmethod(fake_scratch_bytes)})
    monkeypatch.setattr(fa, "_lib", lambda: lib)
    monkeypatch.setattr(fa, "flash_attention_fwd_plain", no_plain)
    # the fake CUDA tensors would take the launch operator's shape stand-in:
    # call the launch it wraps
    monkeypatch.setattr(fa, "_flash_op", fa._launch)
    monkeypatch.setattr(torch.cuda, "device", lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = fa.flash_attention_fwd.launches
    b, sq, sk, h, hk, d = 2, 40, 40, 8, 2, 64
    with FakeTensorMode():
        q = torch.empty(b, sq, h, d, device="cuda")
        k = torch.empty(b, sk, hk, d, device="cuda")
        o = flash_attention(q, k, k.clone(), causal=True)
        assert o.device.type == "cuda" and o.shape == q.shape
        o3 = fa.flash_attention_fwd(fa._heads_first(q).contiguous(),
                                    fa._heads_first(k).contiguous(),
                                    fa._heads_first(k).contiguous(), causal=False, sk_valid=31)
        assert o3.shape == (b * h, sq, d)
        q192 = torch.empty(b, sq, h, 192, device="cuda")
        kv = torch.empty(b, sk, h, 256, device="cuda")  # MLA's (nope k | v) per head
        k192 = torch.empty(b, sk, h, 192, device="cuda")
        o192 = flash_attention(q192, k192, kv.narrow(3, 128, 128), causal=True)
        assert o192.shape == (b, sq, h, 128)
        q48 = torch.empty(b, sq, h, 48, device="cuda")
        k48 = torch.empty(b, sk, hk, 48, device="cuda")
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(q48, k48, k48)
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(q48, k48, k48.narrow(3, 0, 32))
    assert fa.flash_attention_fwd.launches == before + 3 and len(calls) == 3
    assert asked == [(b, hk, sk, d, d, 0), (1, b * hk, 31, d, d, 0), (b, h, sk, 192, 128, 0)]
    assert all(len(c) == 19 for c in calls)
    (_, _, _, _, _, n4, st4, *ints4, scale, stream), (_, _, _, _, _, n3, st3, *ints3, _, _), \
        (_, _, _, _, _, _, st_mla, *ints_mla, scale_mla, _) = calls
    assert n4 == n3 == 4096
    assert isinstance(st4, ctypes.Array) and list(st4) == [
        sq * h * d, h * d, d, sk * hk * d, hk * d, d, sk * hk * d, hk * d, d, sq * h * d, h * d, d]
    assert ints4 == [b, h, hk, sq, sk, d, d, sk, 1, 0] and stream == 7
    assert scale == pytest.approx(d**-0.5)
    # (B·H, S, D) is read as B = 1 with the flat head index as H
    assert list(st3)[1:3] == [d, sq * d] and ints3 == [1, b * h, b * hk, sq, sk, d, d, 31, 0, 0]
    # MLA: v's rows are 256 apart (the latent's nope k and v), the output's 128
    assert list(st_mla) == [sq * h * 192, h * 192, 192, sk * h * 192, h * 192, 192,
                            sk * h * 256, h * 256, 256, sq * h * 128, h * 128, 128]
    assert ints_mla == [b, h, h, sq, sk, 192, 128, sk, 1, 0]
    assert scale_mla == pytest.approx(192**-0.5)


def test_other_devices_raise():
    """A device other than the card, the CPU and meta raises; on meta (the
    dry run) the entry gives the output's shape, and the v head's width."""
    with FakeTensorMode():
        q = torch.empty(1, 4, 2, 16, device="xpu")
        with pytest.raises(ValueError, match="cuda or cpu"):
            flash_attention(q, q, q)
    q = torch.empty(1, 4, 2, 192, device="meta")
    o = flash_attention(q, q, torch.empty(1, 4, 2, 128, device="meta"))
    assert o.device.type == "meta" and o.shape == (1, 4, 2, 128)


def test_shape_stand_in_counts_no_launch(monkeypatch):
    """Fake CUDA tensors take the launch operator's shape stand-in, as meta
    tensors do: no kernel runs, so ``launches`` stays as it was."""
    def no_lib():
        raise AssertionError("the kernel's library was reached")

    monkeypatch.setattr(fa, "_lib", no_lib)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    before = fa.flash_attention_fwd.launches
    with FakeTensorMode():
        q = torch.empty(2, 40, 8, 64, device="cuda")
        k = torch.empty(2, 40, 2, 64, device="cuda")
        o = flash_attention(q, k, k.clone())
    assert o.device.type == "cuda" and o.shape == q.shape
    q = torch.empty(2, 40, 8, 64, device="meta")
    assert flash_attention(q, q, q).shape == q.shape
    assert fa.flash_attention_fwd.launches == before
