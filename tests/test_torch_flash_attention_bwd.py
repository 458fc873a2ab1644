"""The port's flash-attention backward (kernels/flash_attention/
flash_attention_bwd.py) and the training entry's forward with its
log-sum-exp, on the CPU, where the wrappers take the plain versions.

The reference has no backward kernel: its training gradient is
``jax.vjp`` of ``repro.models.attention.blockwise_attention``, f32
throughout. ``FlashAttentionFn`` (plain forward, plain backward) is held
against it within 1e-5 (rtol and atol) in f32, and within 2e-2 in bf16
(``FLASH_TOL``'s value: the port rounds P and dS to bf16 before their
products, as its kernels do, the reference rounds only its outputs). Sk
stays below the reference's block of 1024, so that its padded-tail masking
fault (ROADMAP.md, queue 3) does not enter.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.models import attention as j_attn
from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import flash_attention_bwd as fb
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn, flash_attention_train
from repro_torch.launch import dryrun
from repro_torch.models import attention
from test_torch_parity import to_np

# (B, Sq, Sk, H, Hk, D, Dv, causal)
CASES = {
    "gqa_causal": (2, 40, 40, 4, 2, 16, 16, True),
    "gqa": (2, 40, 40, 4, 2, 16, 16, False),
    "cross_24_over_40": (2, 24, 40, 4, 2, 16, 16, False),
    "ragged_37": (1, 37, 37, 4, 1, 32, 32, True),
    "mla_192_128": (1, 40, 40, 2, 2, 192, 128, True),
}
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def case_inputs(name):
    b, sq, sk, h, hk, d, dv, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, dv), (b, sq, h, dv))]


@pytest.fixture(scope="module")
def reference_grads():
    """Each case's output and (dq, dk, dv) from the JAX package, once."""
    out = {}
    for name, case in CASES.items():
        causal = case[-1]
        for dname, (_, jdt, _) in DTYPES.items():
            q, k, v, do = (jnp.asarray(x, jdt) for x in case_inputs(name))
            o, vjp = jax.vjp(lambda *a: j_attn.blockwise_attention(*a, causal=causal), q, k, v)
            out[name, dname] = [to_np(x) for x in (o, *vjp(do))]
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_entry_gradients_match_reference_vjp(reference_grads, name, dtype):
    tdt, _, tol = DTYPES[dtype]
    causal = CASES[name][-1]
    q, k, v, do = (torch.tensor(x).to(tdt) for x in case_inputs(name))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention_train(*leaves, causal=causal)
    got = [o.detach(), *torch.autograd.grad(o, leaves, do)]
    for what, a, r in zip(("o", "dq", "dk", "dv"), got, reference_grads[name, dtype]):
        assert a.dtype == tdt and a.shape == r.shape
        np.testing.assert_allclose(to_np(a), r, atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_lse_is_logsumexp_of_masked_scaled_scores(name):
    b, sq, sk, h, hk, d, dv, causal = CASES[name]
    q, k, v, _ = (torch.tensor(x) for x in case_inputs(name))
    for bk in (128, 16):
        o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal, block_k=bk, lse=True)
        assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
        torch.testing.assert_close(o, fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                                   block_k=bk))
        kh = k.repeat_interleave(h // hk, dim=2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kh) * d**-0.5
        if causal:
            s = s.masked_fill(torch.arange(sk)[None, :] > torch.arange(sq)[:, None], -torch.inf)
        torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6, atol=1e-6)
    o3, lse3 = fa.flash_attention_fwd_plain(fa._heads_first(q), fa._heads_first(k),
                                            fa._heads_first(v), causal=causal, block_k=16,
                                            lse=True)
    torch.testing.assert_close(lse3, lse.reshape(b * h, sq), rtol=0, atol=0)


@pytest.mark.parametrize("tile_of", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["gqa_causal", "cross_24_over_40", "mla_192_128"])
def test_plain_backward_blocks_and_tail_mask(name, tile_of):
    """The kernels' key tile for either route's type (``kernel_bwd_block``)
    gives the same gradients as a small block within f32 rounding; keys from
    ``sk_valid`` on get zero gradients and leave the rest as if cut away."""
    b, sq, sk, h, hk, d, dv, causal = CASES[name]
    q, k, v, do = (torch.tensor(x) for x in case_inputs(name))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal, lse=True)
    tile = fb.kernel_bwd_block(d, DTYPES[tile_of][0])
    g_tile = fb.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, block_k=tile)
    g8 = fb.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, block_k=8)
    for a, r in zip(g_tile, g8):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-6)
    sv = sk - 7
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=causal, sk_valid=sv, lse=True)
    dq, dk, dv_ = fb.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, sk_valid=sv)
    assert not dk[:, sv:].any() and not dv_[:, sv:].any()
    leaves = [t.clone().requires_grad_() for t in (q, k[:, :sv], v[:, :sv])]
    out = attention.reference_attention(*leaves, causal=causal)
    want = torch.autograd.grad(out, leaves, do)
    for a, r in zip((dq, dk[:, :sv], dv_[:, :sv]), want):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5)


def test_kernel_bwd_block_gives_each_route_its_tile():
    """The dQ kernel's key tile: bf16 128, or 64 above D 64; f32 64 at D 16,
    32 at D 32 and 64, 8 above."""
    assert [fb.kernel_bwd_block(d, torch.bfloat16) for d in (16, 32, 64, 128, 192)] == [
        128, 128, 128, 64, 64]
    assert [fb.kernel_bwd_block(d, torch.float32) for d in (16, 32, 64, 128, 192)] == [
        64, 32, 32, 8, 8]


@pytest.mark.parametrize("shape", [(4, 32, 4, 2048, 2048, 64, 64), (2, 8, 8, 300, 333, 192, 128),
                                   (1, 4, 2, 37, 40, 16, 16), (16, 4, 2, 128, 128, 32, 32)])
def test_f32_scratch_layout_covers_every_tile_once(shape):
    """The f32 route's scratch: its arrays follow one another from word 0 to
    the end of ``scratch_bytes`` with no gap and no overlap; each is one (or,
    with a small part, two) (batch, head) slices after another; and the
    tiles the kernels copy from a slice (the 128 rows a block owns up to D
    64, else 64, and the rows of a turn, 8 to 64) cover its rows from 0
    without a gap or an overlap and stay inside it."""
    b, h, hk, sq, sk, d, dv = shape
    lay = fb.scratch_layout(b, h, hk, sq, sk, d, dv)
    at = 0
    for name, (first, words) in lay.items():
        assert first == at and words > 0, name
        at += words
    assert 4 * at == fb.scratch_bytes(b, h, hk, sq, sk, d, dv, torch.float32)
    sqp, skp = (-(-n // fb.SCRATCH_PAD) * fb.SCRATCH_PAD for n in (sq, sk))
    assert sqp >= sq and skp >= sk and sqp % 128 == skp % 128 == 0
    slices = {"delta": (b * h, sqp), "lse2": (b * h, sqp), "qr": (2 * b * h, sqp * d),
              "dor": (2 * b * h, sqp * dv), "qt": (2 * b * h, sqp * d),
              "dot": (2 * b * h, sqp * dv), "kr": (2 * b * hk, skp * d),
              "vr": (2 * b * hk, skp * dv), "kt": (2 * b * hk, skp * d)}
    for name, (n, words) in slices.items():
        assert lay[name][1] == n * words, name
    bm = 128 if d <= 64 else 64
    for rows, owned in [(n, t) for n in (sq, sk) for t in (bm, 64, 32, 16, 8)]:
        seen = np.zeros(max(sqp, skp), dtype=int)
        for r0 in range(0, rows, owned):
            seen[r0:r0 + owned] += 1
        covered = -(-rows // owned) * owned
        assert (seen[:covered] == 1).all() and not seen[covered:].any()
        assert covered <= (sqp if rows == sq else skp)


def test_plain_backward_rounds_p_and_ds_in_bf16():
    """bf16 inputs: the plain backward rounds P and dS to bf16 before their
    products (as the kernels' mma operands are): it parts from the same
    function on the same bf16 values in f32 by more than the output's own
    rounding, and stays within FLASH_TOL of it."""
    q, k, v, do = (torch.tensor(x).to(torch.bfloat16) for x in case_inputs("gqa_causal"))
    o, lse = fa.flash_attention_fwd_plain(q, k, v, causal=True, lse=True)
    low = fb.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    full = fb.flash_attention_bwd_plain(*(t.float() for t in (q, k, v, o)), lse, do.float(),
                                        causal=True)
    gaps = [float((a.float() - r.to(torch.bfloat16).float()).abs().max())
            for a, r in zip(low, full)]
    assert max(gaps) > 0
    for a, r in zip(low, full):
        torch.testing.assert_close(a.float(), r, rtol=2e-2, atol=2e-2)


def test_cuda_tensors_reach_the_backward_kernels(monkeypatch):
    """On CUDA tensors the training entry launches the forward with its
    log-sum-exp and then the backward kernels (mocked: fake CUDA tensors,
    recording stand-ins for the libraries' ctypes functions), with the
    strides of the (B, S, H, D) layout read in place, MLA's v a strided
    slice of the expanded latent; never the plain attention, nor either plain
    version. One call of the backward is one launch."""
    fwd_calls, bwd_calls = [], []

    def fail(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    fwd_lib = type("Lib", (), {
        "flash_attention_fwd_lse_launch": staticmethod(lambda *a: fwd_calls.append(a) or 0),
        "flash_attention_scratch_bytes": staticmethod(lambda *a: 0)})
    bwd_lib = type("Lib", (), {
        "flash_attention_bwd_launch": staticmethod(lambda *a: bwd_calls.append(a) or 0)})
    monkeypatch.setattr(fa, "_lib", lambda: fwd_lib)
    monkeypatch.setattr(fb, "_lib", lambda: bwd_lib)
    for mod, name in ((fa, "flash_attention_fwd_plain"), (fb, "flash_attention_bwd_plain"),
                      (attention, "reference_attention"), (attention, "blockwise_attention")):
        monkeypatch.setattr(mod, name, fail)
    # the fake CUDA tensors would take the operators' shape stand-ins: call
    # the launches they wrap
    monkeypatch.setattr(fa, "_flash_lse_op", fa._launch_lse)
    monkeypatch.setattr(fb, "_bwd_op", fb._launch)
    monkeypatch.setattr(torch.cuda, "device", lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: type("S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda self: 0)
    fwd0, bwd0 = fa.flash_attention_fwd.launches, fb.flash_attention_bwd.launches

    class Ctx:  # the autograd context (CPU-only torch has no CUDA autograd engine to run)
        def save_for_backward(self, *t):
            self.saved_tensors = t

    b, s, h, hk = 2, 40, 8, 2
    with FakeTensorMode():
        q = torch.empty(b, s, h, 64, device="cuda")
        k = torch.empty(b, s, hk, 64, device="cuda")
        v = torch.empty(b, s, hk, 64, device="cuda")
        ctx = Ctx()
        o = FlashAttentionFn.forward(ctx, q, k, v, True)
        dq, dk, dv, _ = FlashAttentionFn.backward(ctx, torch.empty_like(o))
        assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
        assert ctx.saved_tensors[4].shape == (b, h, s)  # the log-sum-exp
        q2 = torch.empty(b, s, h, 192, device="cuda")
        k2 = torch.empty(b, s, h, 192, device="cuda")
        kv = torch.empty(b, s, h, 256, device="cuda")
        o2 = FlashAttentionFn.forward(ctx, q2, k2, kv.narrow(3, 128, 128), False)
        assert o2.shape == (b, s, h, 128)
        _, _, dv2, _ = FlashAttentionFn.backward(ctx, torch.empty_like(o2))
        assert dv2.shape == (b, s, h, 128)
    assert fa.flash_attention_fwd.launches == fwd0 + 2 and len(fwd_calls) == 2
    assert fb.flash_attention_bwd.launches == bwd0 + 2 and len(bwd_calls) == 2
    assert all(len(c) == 20 for c in fwd_calls) and all(len(c) == 23 for c in bwd_calls)
    (*_, st, b_, h_, hk_, sq_, sk_, d_, dv_, skv, causal, bf16, scale, stream) = bwd_calls[0]
    assert isinstance(st, ctypes.Array) and list(st) == [
        s * h * 64, h * 64, 64, s * hk * 64, hk * 64, 64, s * hk * 64, hk * 64, 64,
        s * h * 64, h * 64, 64, s * h * 64, h * 64, 64,
        s * h * 64, h * 64, 64, s * hk * 64, hk * 64, 64, s * hk * 64, hk * 64, 64]
    assert [b_, h_, hk_, sq_, sk_, d_, dv_, skv, causal, bf16] == [b, h, hk, s, s, 64, 64, s, 1, 0]
    assert scale == pytest.approx(64**-0.5) and stream == 7
    st_mla, ints_mla = list(bwd_calls[1][10]), list(bwd_calls[1][11:21])
    # v's rows are 256 apart (the latent's nope k and v); dv comes contiguous
    assert st_mla[6:9] == [s * h * 256, h * 256, 256] and st_mla[21:] == [s * h * 128, h * 128, 128]
    assert ints_mla == [b, h, h, s, s, 192, 128, s, 0, 0]


def test_backward_checks_its_arguments():
    q = torch.empty(1, 8, 2, 48, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="head dim"):
        fb.flash_attention_bwd(q, q, q, q, lse, q, causal=True)
    q = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="lse"):
        fb.flash_attention_bwd(q, q, q, q, lse.transpose(1, 2), q, causal=True)
    dq, dk, dv = fb.flash_attention_bwd(q, q, q, q, lse, q.transpose(1, 2).transpose(1, 2),
                                        causal=True)
    assert dq.shape == dk.shape == dv.shape == q.shape and dq.device.type == "meta"
    with FakeTensorMode():
        x = torch.empty(1, 8, 2, 64, device="xpu")
        with pytest.raises(ValueError, match="cuda or cpu"):
            fb.flash_attention_bwd(x, x, x, x, x, x, causal=True)


def test_train_step_counts_the_backward_by_its_flops_on_meta():
    """On the meta device a training step's attention is the forward with
    its log-sum-exp, once a layer and again in remat's recompute, and one
    backward a layer, counted by flash_bwd_flops (causal pairs, five
    products)."""
    cfg = smoke_variant(ARCHS["tinyllama-1.1b"])
    shape = ShapeConfig("t", 96, 2, "train")
    args = dryrun.abstract_args(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        dryrun.run_step(cfg, shape, args)
    counts = fc.get_flop_counts()["Global"]
    q = (2, 96, cfg.n_heads, cfg.head_dim)
    fwd = counts[torch.ops.repro_torch.flash_attention_fwd_lse]
    assert fwd == cfg.n_layers * (2 if cfg.remat else 1) * fa.flash_flops(q, q, 96, True)
    assert counts[torch.ops.repro_torch.flash_attention_bwd] == (
        cfg.n_layers * fb.flash_bwd_flops(q, q, 96, True))
    d = cfg.head_dim
    assert fb.flash_bwd_flops(q, q, 96, True) == 2 * 5 * d * 2 * cfg.n_heads * 96 * 97 // 2
    assert fb.flash_bwd_flops((3, 9, 1, 8), (3, 7, 1, 4), 7, True) == 2 * 32 * 3 * (28 + 2 * 7)


def test_dry_run_counts_delta_inside_the_backward():
    """The backward's wrapper allocates its scratch inside its operator,
    where no dispatch mode sees it: Delta (B·H·Sq f32) in bf16, Delta and the
    f32 route's prepared tiles in f32. The dry run's tracker adds it to the
    peak while the operator runs."""
    op = torch.ops.repro_torch.flash_attention_bwd.default
    for dt, want in ((torch.bfloat16, 256),
                     (torch.float32, 4 * (2 * 4 * 128 * (2 + 4 * 16 + 4 * 16)
                                          + 2 * 2 * 128 * (4 * 16 + 2 * 16)))):
        q = torch.empty(2, 8, 4, 16, device="meta", dtype=dt)
        lse = torch.empty(2, 4, 8, device="meta")
        args = (q, q[:, :, :2], q[:, :, :2], q, lse, q, 8, True)
        assert dryrun.inside_bytes(op, args) == want == fb.scratch_bytes(2, 4, 2, 8, 8, 16, 16, dt)
