"""Device work by kind, from the kernel names of a profiler trace.

A GEMM is a library product kernel (cuBLAS and CUTLASS names); the port's
own kernels are the ``__global__`` functions of its CUDA sources
(``tracing.port_kernels``); everything else is other device work
(elementwise passes, reductions, sorts, copies).
"""

from __future__ import annotations

import re

_GEMM = re.compile(r"gemm|nvjet|xmma|cutlass|cublas|s16816|s1688", re.I)
FLASH_FWD = ("flash_attention_bf16_kernel", "flash_attention_fwd_kernel")
FLASH_FWD_AUX = ("flash_prepare_kv_kernel",)
FLASH_BWD = ("flash_bwd_dkdv_bf16_kernel", "flash_bwd_dkdv_f32_kernel")
FLASH_BWD_AUX = ("flash_bwd_delta_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                 "flash_bwd_prep_q_kernel", "flash_bwd_prep_kv_kernel", "flash_bwd_dq_f32_kernel")


def named(name: str, bases) -> bool:
    return any(re.search(rf"\b{b}\b", name) for b in bases)


def is_gemm(name: str, port: set) -> bool:
    return not named(name, port) and bool(_GEMM.search(name))


def calls_and_seconds(kernels, main, aux=()) -> tuple[int, float]:
    """(launches of the call's main kernel, seconds of all its kernels)."""
    calls = sum(1 for n, _, _ in kernels if named(n, main))
    secs = sum(b - a for n, a, b in kernels if named(n, main) or named(n, aux))
    return calls, secs
