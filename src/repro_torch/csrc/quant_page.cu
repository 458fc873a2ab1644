// Page (re)quantization for the RARO-tiered KV cache, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel `quantize_pages` (body `_quant_kernel`) of
// src/repro/kernels/quant_page/quant_page.py. For each page x (P, Hk, D) in
// f32 or bf16: a per-head symmetric scale max(absmax over (P, D), 1e-8) / qmax
// (qmax 127 for int8, 7 for int4), codes rint(x / scale) clipped to
// [-qmax, qmax] (int8, or int4 packed two per byte with the even index in the
// low nibble), and the page's relative RMS dequantization error.
//
// What bounds it: bytes. It does a handful of operations per element, and at
// the serve path's shapes (pages of 8 x 4 x 64) one launch moves tens of KB,
// so it is bound by launch latency, not by the card's memory rate. The simple
// design does nothing more than keep one pass: one block per page (the error
// is a whole-page reduction), the per-head absmax by atomicMax on the float
// bits in shared memory (the bits of non-negative floats order like the
// floats, and a max is exact in any order), then codes and the two error sums
// in one sweep, reduced across the block by warp shuffles.
//
// Built without --use_fast_math; divisions are __fdiv_rn and rounding is rintf
// (half to even), so codes and scales equal the plain PyTorch version bit for
// bit. The error is a float sum taken in another order: rtol 1e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHeads = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float code(float x, float s, float qmax) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, s)), -qmax), qmax);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) t += red[w];
  return t;  // valid in thread 0 only
}

template <typename T, bool kInt4>
__global__ void __launch_bounds__(kThreads)
quant_pages_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                   float* __restrict__ err, int P, int Hk, int D, float qmax) {
  __shared__ unsigned int amax_bits[kMaxHeads];
  __shared__ float scale_sh[kMaxHeads];
  __shared__ float red_num[kThreads / 32], red_den[kThreads / 32];

  const long page = blockIdx.x;
  const long n = (long)P * Hk * D;
  const T* xp = x + page * n;

  for (int h = threadIdx.x; h < Hk; h += kThreads) amax_bits[h] = 0u;
  __syncthreads();
  for (long e = threadIdx.x; e < n; e += kThreads) {
    const int h = (int)((e / D) % Hk);
    atomicMax(&amax_bits[h], __float_as_uint(fabsf(to_f32(xp[e]))));
  }
  __syncthreads();
  for (int h = threadIdx.x; h < Hk; h += kThreads) {
    const float s = __fdiv_rn(fmaxf(__uint_as_float(amax_bits[h]), 1e-8f), qmax);
    scale_sh[h] = s;
    scales[page * Hk + h] = s;
  }
  __syncthreads();

  float num = 0.f, den = 0.f;
  if (kInt4) {
    // one thread per output byte: elements 2i (low nibble) and 2i+1 (high);
    // D is even, so both lie in the same head
    int8_t* qp = q + page * (n / 2);
    for (long i = threadIdx.x; i < n / 2; i += kThreads) {
      const long e = 2 * i;
      const float s = scale_sh[(e / D) % Hk];
      const float x0 = to_f32(xp[e]), x1 = to_f32(xp[e + 1]);
      const float c0 = code(x0, s, qmax), c1 = code(x1, s, qmax);
      const int byte = ((int)c0 & 0xF) | (((int)c1 & 0xF) << 4);
      qp[i] = (int8_t)(byte >= 128 ? byte - 256 : byte);
      const float d0 = x0 - __fmul_rn(c0, s), d1 = x1 - __fmul_rn(c1, s);
      num += d0 * d0 + d1 * d1;
      den += x0 * x0 + x1 * x1;
    }
  } else {
    int8_t* qp = q + page * n;
    for (long e = threadIdx.x; e < n; e += kThreads) {
      const float s = scale_sh[(e / D) % Hk];
      const float x0 = to_f32(xp[e]);
      const float c0 = code(x0, s, qmax);
      qp[e] = (int8_t)c0;
      const float d0 = x0 - __fmul_rn(c0, s);
      num += d0 * d0;
      den += x0 * x0;
    }
  }
  num = block_sum(num, red_num);
  den = block_sum(den, red_den);
  if (threadIdx.x == 0) {
    const float cnt = (float)n;
    err[page] = __fdiv_rn(sqrtf(num / cnt), sqrtf(den / cnt) + 1e-8f);
  }
}

template <typename T>
void launch(const void* x, void* q, void* scales, void* err, int N, int P, int Hk, int D,
            int int4, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  float* et = static_cast<float*>(err);
  if (int4)
    quant_pages_kernel<T, true><<<N, kThreads, 0, stream>>>(xt, qt, st, et, P, Hk, D, 7.f);
  else
    quant_pages_kernel<T, false><<<N, kThreads, 0, stream>>>(xt, qt, st, et, P, Hk, D, 127.f);
}

}  // namespace

// x: (N, P, Hk, D) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), contiguous.
// q: (N, P, Hk, D) int8, or (N, P, Hk, D/2) packed when int4 = 1.
// scales: (N, Hk) f32. err: (N,) f32. Returns cudaGetLastError() after the launch.
extern "C" int quant_pages_launch(const void* x, void* q, void* scales, void* err, int N, int P,
                                  int Hk, int D, int x_bf16, int int4, void* stream) {
  if (Hk > kMaxHeads || (int4 && (D % 2))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch<__nv_bfloat16>(x, q, scales, err, N, P, Hk, D, int4, s);
  else
    launch<float>(x, q, scales, err, N, P, Hk, D, int4, s);
  return (int)cudaGetLastError();
}
