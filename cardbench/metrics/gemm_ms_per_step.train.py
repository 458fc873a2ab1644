"""Device ms per training step in library GEMM kernels (cuBLAS, CUTLASS)."""

from cardbench import kernels


def read(r):
    if r.runner != "train" or not r.window.units:
        return None
    s = sum(b - a for n, a, b in r.profile.kernels if kernels.is_gemm(n, r.port_kernels))
    return s * 1e3 / r.window.units if s else None
