"""A traced window: torch.profiler over the device and the host, and the
host syncs the program makes, counted by source line.

The syncs are counted as ``chip_smoke.py`` counts them:
``torch.cuda.set_sync_debug_mode("warn")`` turns each into a warning whose
frame names the line that made it. Only lines in the program
(``src/repro_torch``) are kept; the benchmark's own waits are not the
program's.
"""

from __future__ import annotations

import bisect
import os
import re
import warnings
from dataclasses import dataclass, field
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = ROOT / "src" / "repro_torch"
WINDOW_SPAN = "cardbench.window"


@dataclass
class Profile:
    kernels: list = field(default_factory=list)  # (name, start s, end s), device work
    host: list = field(default_factory=list)  # (start s, end s, name), host ops
    window: tuple = (0.0, 0.0)  # the window's span on the profiler's clock, s
    syncs: list = field(default_factory=list)  # "file:line" of each sync the program made

    def busy_s(self) -> float:
        """Seconds of the window in which some device work ran."""
        lo, hi = self.window
        busy, end = 0.0, lo
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]):
            a, b = max(a, end), min(b, hi)
            if b > a:
                busy += b - a
                end = b
        return busy

    def device_s_by_name(self) -> dict:
        out: dict = {}
        for name, a, b in self.kernels:
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def idle_by_host(self) -> dict:
        """Idle seconds of the device in the window, by the innermost host op
        running at each gap's middle ("host: between ops" where none)."""
        lo, hi = self.window
        starts = [h[0] for h in self.host]
        out: dict = {}
        end = lo
        for _, a, b in sorted(self.kernels, key=lambda k: k[1]) + [("", hi, hi)]:
            if a > end:
                gap_end = min(a, hi)
                if gap_end > end:
                    mid = 0.5 * (end + gap_end)
                    name = "host: between ops"
                    i = bisect.bisect_right(starts, mid) - 1
                    for j in range(i, max(i - 400, -1), -1):
                        if self.host[j][1] >= mid:
                            name = self.host[j][2]
                            break
                    out[name] = out.get(name, 0.0) + (gap_end - end)
            end = max(end, b)
        return out


def traced(fn, device):
    """Run ``fn`` under the profiler and the sync counter; returns (fn's
    result, Profile). On the CPU (tests) only the host is traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with profile(activities=acts) as prof:
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                with record_function(WINDOW_SPAN):
                    out = fn()
            finally:
                if cuda:
                    torch.cuda.set_sync_debug_mode("default")
    prog = str(PROGRAM) + os.sep
    syncs = [f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in seen
             if "called a synchronizing" in str(w.message) and str(w.filename).startswith(prog)]
    p = Profile(syncs=syncs)
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            if e.name != WINDOW_SPAN:  # the span's own mark on the device's timeline
                p.kernels.append((e.name, a, b))
        elif e.name == WINDOW_SPAN:
            p.window = (a, b)
        else:
            p.host.append((a, b, e.name))
    p.host.sort()
    return out, p


def port_kernels() -> set:
    """Names of the program's own CUDA kernels (``__global__`` functions of
    its sources)."""
    names = set()
    for f in sorted((PROGRAM / "csrc").glob("*.cu")):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                f.read_text()))
    return names


def top(table: dict, n: int = 10) -> list:
    return [[k[:160], v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]
