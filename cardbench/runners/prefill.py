"""Prefill cells: ``serving/serve_step.py::make_prefill`` of the program,
one client in a closed loop, one prompt a request.

Prompt lengths are the mix's fixed strata, each cycle in an order drawn from
the seed (``traffic.schedule``); the window runs whole cycles and ends with
the first cycle that finishes after ``--seconds``. A request's time to
first token runs from taking it (its prompt made) to its first token on the
host. Set-up runs each length once. For the sampled requests of the first
cycle (``traffic.sample``) the served token and the returned cache's K and V
at the sampled positions are kept, in buffers made in set-up.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from cardbench import harness, traffic, weights
from cardbench.reference import transformer as ref


@dataclass
class State:
    params: object
    prefill: object
    cdf: torch.Tensor
    sample: dict  # request index -> positions
    pos: dict  # request index -> positions on the device
    kept: dict  # request index -> {cache key: (layers, P, ...)}
    served: dict = field(default_factory=dict)


def setup(ctx, mark=lambda name: None) -> State:
    from repro_torch.serving import serve_step

    c, t = ctx.cell.config, ctx.cell.traffic
    cfg = harness.port_config(c).with_(kv_bits=t["kv_bits"])
    leaves = ref.param_leaves(c, harness.table_rows(cfg))
    params = harness.program_params(cfg, weights.make(leaves, ctx.seed, ctx.device),
                                    c["port"]["param_dtype"])
    prefill = serve_step.make_prefill(cfg)
    cdf = traffic.zipf_cdf(t["tokens"], c["vocab_size"], ctx.device)
    sample = traffic.sample(t, ctx.seed)
    lens = traffic.strata(t["prompt"])
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    mark("weights")
    cache = None
    for j, n in enumerate(sorted(set(lens))):  # every length of the mix, once
        tok = traffic.prompt(t, cdf, ctx.seed, -1 - j, n, ctx.device)
        nxt, cache = prefill(params, {"tokens": tok[None]})
        int(nxt[0])
    p = len(next(iter(sample.values())))
    kept = {i: {k: torch.zeros((v.shape[0], p, *v.shape[3:]), dtype=v.dtype, device=ctx.device)
                for k, v in cache.items()} for i in sample}
    pos = {i: torch.tensor(ps, dtype=torch.long, device=ctx.device) for i, ps in sample.items()}
    for i in sample:  # the keeping copies too, from the longest prompt's cache
        for k, v in cache.items():
            kept[i][k].copy_(v[:, 0].index_select(1, pos[i]))
    del cache
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    return State(params, prefill, cdf, sample, pos, kept)


def window(ctx, st: State, seconds: float, traced: bool) -> harness.Window:
    t = ctx.cell.traffic
    n_pool = t["prompt"]["strata"]
    cap = t["trace"]["cycles"] if traced else None
    ttft, lens = [], []
    t0 = time.perf_counter()
    for i, n in traffic.schedule(t["prompt"], ctx.seed):
        tok = traffic.prompt(t, st.cdf, ctx.seed, i, n, ctx.device)
        ta = time.perf_counter()
        nxt, cache = st.prefill(st.params, {"tokens": tok[None]})
        first = int(nxt[0])
        ttft.append(time.perf_counter() - ta)
        lens.append(n)
        if i in st.sample:
            st.served[i] = first if ctx.fault != "token_altered" else first + 1
            for k, v in cache.items():
                st.kept[i][k].copy_(v[:, 0].index_select(1, st.pos[i]))
        del cache, nxt
        if (i + 1) % n_pool == 0:
            cycles = (i + 1) // n_pool
            if (cap is not None and cycles >= cap) or (cap is None
                                                       and time.perf_counter() - t0 >= seconds):
                break
    s = time.perf_counter() - t0
    cyc = [sum(ttft[k:k + n_pool]) for k in range(0, len(ttft), n_pool)]
    print(f"window: {len(cyc)} cycles of {n_pool} requests, seconds of time to first token "
          f"a cycle {[round(x, 4) for x in cyc]}", file=sys.stderr)
    return harness.Window(units=len(lens), seconds=s, lengths=lens,
                          end_to_end={"prompt_tokens_per_s": sum(lens) / s,
                                      "ttft_p95_ms": float(np.percentile(ttft, 95)) * 1e3})


def keep(ctx, st: State, win) -> dict:
    return {"served": dict(st.served), "kept": st.kept}


def prompts(ctx, indices) -> list:
    """The sampled requests' prompts, made again from the seed."""
    t, c = ctx.cell.traffic, ctx.cell.config
    lens = traffic.strata(t["prompt"])
    order = traffic.cycle_order(ctx.seed, 0, len(lens))
    cdf = traffic.zipf_cdf(t["tokens"], c["vocab_size"], ctx.device)
    return [traffic.prompt(t, cdf, ctx.seed, i, lens[order[i]], ctx.device) for i in indices]


def reference(ctx, all_logits=False, precs=(ref.F32,)) -> dict:
    """The reference over the sampled prompts at each precision of
    ``precs``: [(logits, K, V) per request] for each."""
    c = ctx.cell.config
    cfg = harness.port_config(c)
    leaves = ref.param_leaves(c, harness.table_rows(cfg))
    params = weights.make(leaves, ctx.seed, ctx.device)
    sample = traffic.sample(ctx.cell.traffic, ctx.seed)
    idx = sorted(sample)
    ps = prompts(ctx, idx)
    pos = [torch.tensor(sample[i], dtype=torch.long, device=ctx.device) for i in idx]
    out = {p.lowered: ref.prefill(params, ps, pos, c, p, all_logits) for p in precs}
    del params
    harness.free(ctx.device)
    return {"indices": idx, "out": out}


def kv_gap(k, v, rk, rv) -> float:
    """The widest relative error of one request's K or V, layer by layer."""
    worst = 0.0
    for a, b in ((k, rk), (v, rv)):
        for layer in range(b.shape[0]):
            ref_l = b[layer].double()
            worst = max(worst, float(torch.linalg.vector_norm(a[layer].double() - ref_l)
                                     / torch.linalg.vector_norm(ref_l)))
    return worst


def numbers(kept: dict, refr: dict) -> dict:
    """The widest gap by which a served token's logit lies below the
    reference's best, and the widest relative error of the kept K and V."""
    token, kv = 0.0, 0.0
    for i, (logits, rk, rv) in zip(refr["indices"], refr["out"][False]):
        last = logits if logits.dim() == 1 else logits[-1]
        served = kept["served"][i]
        token = max(token, float(last.max() - last[served]) if served < last.numel()
                    else float("inf"))
        cache = kept["kept"][i]
        k = next(v for key, v in cache.items() if key.endswith("k"))
        v = next(v for key, v in cache.items() if key.endswith("v"))
        kv = max(kv, kv_gap(k, v, rk, rv))
    return {"token_gap": token, "kv_gap": kv}


def check(ctx, kept: dict) -> dict:
    return numbers(kept, reference(ctx))
