"""The general traffic generator: every mix is a data file under
``cardbench/traffic/`` whose parameters this module reads.

Token ids follow a Zipf law over ``[first_id, vocab)`` (rank r has weight
1 / (r + 1)^s, id ``first_id + r``), drawn on the device by inverse CDF so
that no draw waits on the host. Lengths come from a lognormal law (median,
sigma, clipped to [min, max]): documents packed into training rows draw
them freely; prompts take the law's ``strata`` equal-probability quantiles,
so every seed serves the same set of lengths, each cycle in an order of its
own.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from cardbench import weights


def zipf_cdf(tokens: dict, vocab: int, device) -> torch.Tensor:
    n = vocab - tokens["first_id"]
    w = 1.0 / torch.arange(1, n + 1, dtype=torch.float64, device=device) ** tokens["s"]
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


def draw_tokens(cdf, tokens: dict, shape, gen) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=cdf.device)
    r = torch.clamp(torch.searchsorted(cdf, u, right=True), max=cdf.numel() - 1)
    return (r + tokens["first_id"]).to(torch.int32)


def generator(seed: int, stream: int, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(weights._seed(seed, 100 + stream, index))


# --------------------------------------------------------------------------
# training: documents packed into rows
# --------------------------------------------------------------------------
def packed_batches(t: dict, vocab: int, seed: int, device):
    """(tokens, labels), each (steps, batch, seq) int32: rows of ``seq + 1``
    tokens, documents of lognormal length each ending in ``eos_id``, packed
    back to back and cut at the row's end. Labels are the next tokens; the
    position of an end-of-document predicts the next document's first token
    and is masked (-1)."""
    n, b, s = t["steps"], t["batch"], t["seq"]
    doc = t["documents"]
    gen = generator(seed, 0, 0, device)
    k = -(-(s + 1) // doc["min"]) + 1  # enough documents to fill any row
    z = torch.randn((n, b, k), generator=gen, device=device)
    lens = torch.clamp(torch.round(torch.exp(math.log(doc["median"]) + doc["sigma"] * z)),
                       doc["min"], doc["max"]).long()
    ends = torch.clamp(torch.cumsum(lens, -1) - 1, max=s + 1)  # s + 1: past the row
    eos = torch.zeros((n, b, s + 2), dtype=torch.bool, device=device)
    eos.scatter_(-1, ends, True)
    eos = eos[..., : s + 1]
    cdf = zipf_cdf(t["tokens"], vocab, device)
    row = draw_tokens(cdf, t["tokens"], (n, b, s + 1), gen)
    row = torch.where(eos, torch.full_like(row, t["eos_id"]), row)
    labels = torch.where(eos[..., :s], -1, row[..., 1:])
    return row[..., :s].contiguous(), labels.to(torch.int32).contiguous()


# --------------------------------------------------------------------------
# serving: a closed loop over a fixed set of prompt lengths
# --------------------------------------------------------------------------
def strata(p: dict) -> list[int]:
    """The prompt lengths: the lognormal law's ``strata`` quantiles at
    (i + 0.5) / strata, clipped to [min, max]."""
    nd = statistics.NormalDist()
    out = []
    for i in range(p["strata"]):
        x = math.exp(math.log(p["median"]) + p["sigma"] * nd.inv_cdf((i + 0.5) / p["strata"]))
        out.append(int(min(max(round(x), p["min"]), p["max"])))
    return out


def cycle_order(seed: int, cycle: int, n: int) -> list[int]:
    """The order of the lengths' indices in one cycle."""
    return [int(i) for i in np.random.default_rng((seed, 1, cycle)).permutation(n)]


def schedule(p: dict, seed: int):
    """Yield (request index, prompt length) for ever: cycle after cycle."""
    lens = strata(p)
    i, cycle = 0, 0
    while True:
        for j in cycle_order(seed, cycle, len(lens)):
            yield i, lens[j]
            i += 1
        cycle += 1


def prompt(t: dict, cdf, seed: int, index: int, length: int, device) -> torch.Tensor:
    """Request ``index``'s prompt, (length,) int32 (warm-up prompts take
    negative indices)."""
    gen = generator(seed, 1 if index >= 0 else 2, abs(index), device)
    return draw_tokens(cdf, t["tokens"], (length,), gen)


def sample(t: dict, seed: int) -> dict:
    """The requests whose outputs are checked, all in the first cycle:
    ``check.requests`` drawn from the seed, and the longest prompt. Returns
    {request index: sorted positions of its prompt whose K and V are
    compared} (``check.positions`` of them, the first and last included)."""
    p, chk = t["prompt"], t["check"]
    lens = strata(p)
    order = cycle_order(seed, 0, len(lens))
    rng = np.random.default_rng((seed, 2))
    picks = set(int(i) for i in rng.choice(len(lens), chk["requests"], replace=False))
    picks.add(max(range(len(lens)), key=lambda i: (lens[order[i]], -i)))
    out = {}
    for i in sorted(picks):
        n = lens[order[i]]
        inner = rng.choice(np.arange(1, n - 1), min(chk["positions"] - 2, n - 2), replace=False)
        out[i] = sorted({0, n - 1, *(int(x) for x in inner)})
    return out
