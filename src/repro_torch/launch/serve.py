"""Batched serving driver with the RARO-tiered KV cache (counterpart of
``repro.launch.serve``).

Decodes a batch of sequences with the tiered paged cache (the CUDA
``tiered_decode_partial`` and ``quantize_pages`` kernels on the card),
running the RARO controller between steps. Reports throughput, tier
occupancy / KV bytes, and output-quality drift against a dense f32 cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --steps 64 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.tiered_attention.ops import tiered_decode_attention
from repro_torch.kvcache import paged, tiers
from repro_torch.models import base, layers as L, registry, transformer as T


def serve_cfg(vocab=512, d_model=128, n_layers=4, n_heads=4, n_kv=2):
    return ModelConfig(arch="serve-demo", family="dense", n_layers=n_layers,
                       d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
                       d_ff=256, vocab=vocab, dtype=torch.float32, remat=False)


def tiered_decode_step(params, caches, cache_cfg, rcfg, tokens, pos, cfg):
    """decode_step variant whose attention reads the tiered paged cache.
    ``caches`` is a list of TieredKV, one per layer. Returns (logits
    (B, 1, V), new caches)."""
    b = tokens.shape[0]
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    new_caches = []
    for lp, c in zip(params["layers"], caches):
        xn = T.norm(cfg, lp["ln1"], x)
        q, k, v = T.qkv(lp["attn"], xn, cfg, pos[:, None])
        ct = tiers.commit_tier(c, cache_cfg, rcfg)
        c = paged.append(c, cache_cfg, k[:, 0], v[:, 0], ct)
        o, mass = tiered_decode_attention(q[:, 0], c, cache_cfg)
        c, _ = tiers.raro_step(c, cache_cfg, rcfg, mass)
        h = x + L.matmul(o.reshape(b, 1, -1).to(cfg.dtype), lp["attn"]["wo"])
        x = h + L.mlp(lp["mlp"], T.norm(cfg, lp["ln2"], h), cfg.act)
        new_caches.append(c)
    x = T.norm(cfg, params["ln_f"], x)
    return L.lm_logits(params["embed"], x, cfg.vocab), new_caches


def cache_config(cfg: ModelConfig, steps: int, batch: int) -> paged.CacheConfig:
    return paged.CacheConfig(n_seqs=batch, max_pages=max(steps // 8 + 2, 4), page_size=8,
                             n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                             pool_pages=(8, 16, 256), migrate_per_step=4)


def run(steps=64, batch=4, raro_enabled=True, seed=0, cfg=None, params=None, quiet=False,
        device=None):
    """Decode ``steps`` tokens for ``batch`` sequences from random weights
    (made from ``seed``) on ``device`` (CUDA unless given)."""
    device = resolve_device(device)
    cfg = cfg or serve_cfg()
    api = registry.get_api(cfg)
    if params is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = base.materialize(api.specs(), gen, torch.float32, device)

    hk, dh = cfg.n_kv_heads, cfg.head_dim
    ccfg = cache_config(cfg, steps, batch)
    rcfg = tiers.RAROConfig(enabled=raro_enabled)
    caches = [paged.init(ccfg, torch.float32, device) for _ in range(cfg.n_layers)]

    # reference: exact f32 dense cache decode for quality comparison
    ref_cache = {k: torch.zeros((cfg.n_layers, batch, steps + 1, hk, dh), dtype=torch.float32,
                                device=device) for k in ("k", "v")}

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen, dtype=torch.int32, device=device)
    ref_tok = tok
    drift = []
    t0 = time.time()
    for t in range(steps):
        pos = torch.full((batch,), t, dtype=torch.int32, device=device)
        logits, caches = tiered_decode_step(params, caches, ccfg, rcfg, tok, pos, cfg)
        ref_logits, ref_cache = T.decode_step(params, ref_cache, ref_tok, pos, cfg)
        d = torch.mean(torch.abs(torch.softmax(logits[:, -1].float(), dim=-1)
                                 - torch.softmax(ref_logits[:, -1].float(), dim=-1)))
        drift.append(float(d))
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        ref_tok = torch.argmax(ref_logits[:, -1], dim=-1).to(torch.int32)[:, None]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0

    mem = sum(paged.memory_bytes(c, ccfg) for c in caches)
    committed = sum(int((c.tier >= 0).sum()) for c in caches)
    bf16_equiv = committed * 2 * ccfg.page_size * hk * dh * 2
    tier_hist = np.zeros(3, int)
    for c in caches:
        tt = c.tier.cpu().numpy()
        for i in range(3):
            tier_hist[i] += (tt == i).sum()
    out = {
        "tok_per_s": batch * steps / dt,
        "mean_prob_drift": float(np.mean(drift)),
        "final_prob_drift": float(drift[-1]),
        "kv_bytes": mem,
        "kv_bytes_bf16_equiv": bf16_equiv,
        "capacity_saving": 1.0 - mem / max(bf16_equiv, 1),
        "tier_pages": tier_hist.tolist(),
    }
    if not quiet:
        for k, v in out.items():
            print(f"  {k}: {v}")
    return out


def main(argv=None):
    """The command line (``argv``, else ``sys.argv``): RARO, then the static
    int4 baseline. Returns both runs' results, keyed by RARO on or off."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: cuda")
    a = ap.parse_args(argv)
    print("== RARO tiered KV serving ==")
    raro = run(steps=a.steps, batch=a.batch, raro_enabled=True, device=a.device)
    print("== static int4-only baseline (QLC analogue) ==")
    static = run(steps=a.steps, batch=a.batch, raro_enabled=False, device=a.device)
    return {True: raro, False: static}


if __name__ == "__main__":
    main()
