"""FIO-like workload generation (paper §V-A): Zipf-distributed random reads
over an 8 GiB dataset, plus sequential and mixed read/write traces for the
motivation figures. Host-side numpy; the engine consumes padded
(n_chunks, chunk) arrays. A copy of ``repro.ssdsim.workload``: the same
seed gives the same trace.

Open-loop arrivals: every builder can attach per-request arrival timestamps
(``arrival_rate`` in IOPS, Poisson or constant-rate interarrivals). A trace
carrying an ``"arrival_ms"`` array drives the engine's queueing-aware
service loop; ``arrival_rate=None`` (the default) keeps the classic
closed-loop trace, where requests are serviced back-to-back.
"""

from __future__ import annotations

import numpy as np

from repro_torch.ssdsim import geometry
from repro_torch.ssdsim.engine import OP_READ, OP_WRITE


def _pack(cfg: geometry.SimConfig, lpn: np.ndarray, op: np.ndarray,
          arrival_ms: np.ndarray | None = None):
    c = cfg.chunk
    n = len(lpn)
    n_chunks = -(-n // c)
    pad = n_chunks * c - n
    lpn = np.concatenate([lpn, np.full(pad, -1, np.int32)])
    op = np.concatenate([op, np.full(pad, OP_READ, np.int32)])
    tr = {
        "lpn": lpn.reshape(n_chunks, c).astype(np.int32),
        "op": op.reshape(n_chunks, c).astype(np.int32),
    }
    if arrival_ms is not None:
        # padding lanes inherit the last real arrival so the chunk's clock
        # never jumps past the payload
        last = arrival_ms[-1] if n else 0.0
        arr = np.concatenate([arrival_ms, np.full(pad, last, np.float64)])
        tr["arrival_ms"] = arr.reshape(n_chunks, c).astype(np.float32)
    return tr


def poisson_arrival_ms(n_requests: int, rate_iops: float, seed: int = 0) -> np.ndarray:
    """Poisson-process arrival timestamps (ms): exponential interarrivals at
    ``rate_iops`` requests/second, starting from t=0."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1000.0 / rate_iops, size=n_requests)
    t = np.cumsum(gaps)
    return t - gaps[0] if n_requests else t


def constant_arrival_ms(n_requests: int, rate_iops: float) -> np.ndarray:
    """Constant-rate arrival timestamps (ms) at ``rate_iops`` requests/s."""
    return np.arange(n_requests, dtype=np.float64) * (1000.0 / rate_iops)


def build_arrivals(n_requests: int, rate_iops: float, dist: str = "poisson",
                   seed: int = 0) -> np.ndarray:
    if dist == "poisson":
        return poisson_arrival_ms(n_requests, rate_iops, seed=seed)
    if dist == "constant":
        return constant_arrival_ms(n_requests, rate_iops)
    raise ValueError(f"unknown arrival distribution {dist!r}")


def attach_arrivals(cfg: geometry.SimConfig, trace: dict, rate_iops: float,
                    dist: str = "poisson", seed: int = 0) -> dict:
    """Attach open-loop arrival timestamps to an already-packed trace.

    Works on any engine trace (scenario library, MSR replay with the
    timestamp column stripped, ...); the arrival stream covers every lane
    including padding, which is harmless since padded lanes are inactive.
    """
    n = trace["lpn"].size
    arr = build_arrivals(n, rate_iops, dist=dist, seed=seed)
    out = dict(trace)
    out["arrival_ms"] = arr.reshape(trace["lpn"].shape).astype(np.float32)
    return out


def zipf_probs(n: int, theta: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks**-theta
    return w / w.sum()


def zipf_read_trace(cfg: geometry.SimConfig, n_requests: int, theta: float,
                    seed: int = 0, hot_fraction_cap: float = 1.0,
                    arrival_rate: float | None = None,
                    arrival_dist: str = "poisson"):
    """Random reads with Zipf(theta) popularity. Hot ranks are scattered
    over the logical space by a fixed permutation (FIO's zipf behaves the
    same way: popularity rank is decoupled from LBA locality)."""
    rng = np.random.default_rng(seed)
    L = cfg.n_logical
    n_ranked = max(int(L * hot_fraction_cap), 1)
    p = zipf_probs(n_ranked, theta)
    ranks = rng.choice(n_ranked, size=n_requests, p=p)
    perm = rng.permutation(L)[:n_ranked]
    lpn = perm[ranks].astype(np.int32)
    arr = None if arrival_rate is None else build_arrivals(
        n_requests, arrival_rate, dist=arrival_dist, seed=seed)
    return _pack(cfg, lpn, np.full(n_requests, OP_READ, np.int32), arr)


def seq_read_trace(cfg: geometry.SimConfig, n_requests: int, start: int = 0):
    lpn = (start + np.arange(n_requests)) % cfg.n_logical
    return _pack(cfg, lpn.astype(np.int32), np.full(n_requests, OP_READ, np.int32))


def uniform_read_trace(cfg: geometry.SimConfig, n_requests: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    lpn = rng.integers(0, cfg.n_logical, size=n_requests).astype(np.int32)
    return _pack(cfg, lpn, np.full(n_requests, OP_READ, np.int32))


def mixed_trace(cfg: geometry.SimConfig, n_requests: int, theta: float,
                read_frac: float = 0.7, seed: int = 0,
                arrival_rate: float | None = None,
                arrival_dist: str = "poisson",
                write_theta: float | None = None):
    """Zipf reads interleaved with random overwrites (paper §V-A).

    Reads follow Zipf(theta) popularity over a fixed permutation; write
    targets default to uniform over the whole logical space, independent of
    the read popularity ranking. ``write_theta`` opts into Zipf-skewed
    writes over an independent permutation instead — hot pages are
    overwritten repeatedly, concentrating invalid pages in recently written
    blocks, which is the workload shape that produces worthwhile GC victims
    (the ``gc_pressure`` benchmark section uses this).
    """
    rng = np.random.default_rng(seed)
    L = cfg.n_logical
    p = zipf_probs(L, theta)
    ranks = rng.choice(L, size=n_requests, p=p)
    perm = rng.permutation(L)
    r_lpn = perm[ranks]
    if write_theta is None:
        w_lpn = rng.integers(0, L, size=n_requests)
    else:
        w_ranks = rng.choice(L, size=n_requests, p=zipf_probs(L, write_theta))
        w_lpn = rng.permutation(L)[w_ranks]
    is_read = rng.random(n_requests) < read_frac
    lpn = np.where(is_read, r_lpn, w_lpn).astype(np.int32)
    op = np.where(is_read, OP_READ, OP_WRITE).astype(np.int32)
    arr = None if arrival_rate is None else build_arrivals(
        n_requests, arrival_rate, dist=arrival_dist, seed=seed)
    return _pack(cfg, lpn, op, arr)
