"""Device ms per training step in work that is neither a library GEMM nor
one of the port's own kernels: norms, rotary, the MoE layer's routing,
dispatch and combine, the loss, AdamW, copies."""

from cardbench import kernels


def read(r):
    if r.runner != "train" or not r.window.units:
        return None
    s = sum(b - a for n, a, b in r.profile.kernels
            if not kernels.is_gemm(n, r.port_kernels) and not kernels.named(n, r.port_kernels))
    return s * 1e3 / r.window.units if s else None
