// Page (re)quantization for the RARO-tiered KV cache, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel `quantize_pages` (body `_quant_kernel`) of
// src/repro/kernels/quant_page/quant_page.py. For each page x (P, Hk, D) in
// f32 or bf16: a per-head symmetric scale max(absmax over (P, D), 1e-8) / qmax
// (qmax 127 for int8, 7 for int4), codes rint(x / scale) clipped to
// [-qmax, qmax] (int8, or int4 packed two per byte with the even index in the
// low nibble), and the page's relative RMS dequantization error.
//
// Two entries share one body:
//   quant_pages_launch        contiguous pages in, codes, scales and errors out;
//   quant_store_pages_launch  the K and V pages of B lanes, each with its own
//                             tier and pool slot, stored straight into the tier
//                             pools: codes and scales for tiers 1 and 2, the page
//                             cast to the pool's dtype for tier 0. A lane whose
//                             slot is negative or out of range, or whose tier is
//                             not in `allowed`, is skipped; no error is computed.
// The store entry reads the lanes' tiers and slots on the device, so its caller
// needs no host-side decision, and so no host sync, to route pages to pools.
//
// What bounds it: launch latency. At the serve path's shape (pages of
// 8 x 4 x 64, 8 pages a launch) one launch moves ~80 KB: ~25 ns at the card's
// memory rate, far below the ~5 us any launch costs. So the design keeps the
// chain of dependent steps after the launch short:
//   * one warp per (page, head), Hk warps per block, one block per page;
//   * where a head's P * D elements split into 32 chunks of 8, 16 or 32 that
//     each lie in one row (the serve path: 16 per lane), every lane loads its
//     chunk once into registers with 16-byte loads, and stores its codes with
//     one vector store (16 int8 codes or 8 packed int4 bytes at 16 a lane);
//     other shapes take a streaming path that reads the head twice;
//   * the head's absmax is one __reduce_max_sync on the float bits (the bits of
//     non-negative floats order like the floats, and a max is exact in any
//     order): no shared-memory atomics;
//   * index arithmetic within a page is 32-bit; the page's error sums are
//     shuffle-reduced per warp and added over the heads in order by one thread,
//     after the block's only barrier.
//
// Built without --use_fast_math; divisions are __fdiv_rn and rounding is rintf
// (half to even), so codes and scales equal the plain PyTorch version bit for
// bit, and the tier-0 cast to bf16 rounds to nearest even as PyTorch does. The
// error is a float sum taken in another order: rtol 1e-5.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxHeads = 64;
constexpr int kMaxWarps = 32;  // above 32 heads a warp takes a second head

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float code(float x, float s, float qmax) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, s)), -qmax), qmax);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// E contiguous elements, 16-byte aligned, into registers as f32
template <int E>
__device__ __forceinline__ void load_chunk(const float* __restrict__ p, float (&r)[E]) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    r[4 * i] = v.x;
    r[4 * i + 1] = v.y;
    r[4 * i + 2] = v.z;
    r[4 * i + 3] = v.w;
  }
}
template <int E>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* __restrict__ p, float (&r)[E]) {
#pragma unroll
  for (int i = 0; i < E / 8; ++i) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[i];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // the lower address is the low half
      r[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      r[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
}

// W 32-bit words to dst with the widest store its alignment (W * 4 bytes) allows
template <int W>
__device__ __forceinline__ void store_words(int8_t* __restrict__ dst, const uint32_t (&w)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i)
      reinterpret_cast<uint4*>(dst)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W / 2; ++i)
      reinterpret_cast<uint2*>(dst)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) reinterpret_cast<uint32_t*>(dst)[i] = w[i];
  }
}

__device__ __forceinline__ float head_scale(unsigned bits, float qmax) {
  const float amax = __uint_as_float(__reduce_max_sync(0xffffffffu, bits));
  return __fdiv_rn(fmaxf(amax, 1e-8f), qmax);
}

// One warp quantizes head h of one page: xp and qp point at the page, sp at
// its scale. Adds the lane's share of the error sums to num and den when kErr.
// E > 0: the register path (lane l holds head-local elements [l E, (l+1) E),
// one row's run); E = 0: the streaming path, any shape.
template <typename T, bool kInt4, int E, bool kErr>
__device__ __forceinline__ void quant_head(const T* __restrict__ xp, int8_t* __restrict__ qp,
                                           float* __restrict__ sp, int h, int Hk, int P, int D,
                                           float qmax, int lane, float& num, float& den) {
  if constexpr (E > 0) {
    const int e0 = lane * E;
    const int p = e0 / D;
    const int off = (p * Hk + h) * D + (e0 - p * D);
    float r[E];
    load_chunk<E>(xp + off, r);
    unsigned bits = 0u;
#pragma unroll
    for (int i = 0; i < E; ++i) bits = max(bits, __float_as_uint(fabsf(r[i])));
    const float s = head_scale(bits, qmax);
    if (lane == 0) *sp = s;
    float c[E];
#pragma unroll
    for (int i = 0; i < E; ++i) c[i] = code(r[i], s, qmax);
    if constexpr (kInt4) {
      uint32_t w[E / 8];
#pragma unroll
      for (int i = 0; i < E / 8; ++i) {
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int k = 8 * i + 2 * b;
          const uint32_t byte = ((int)c[k] & 0xF) | (((int)c[k + 1] & 0xF) << 4);
          word |= byte << (8 * b);
        }
        w[i] = word;
      }
      store_words<E / 8>(qp + off / 2, w);
    } else {
      uint32_t w[E / 4];
#pragma unroll
      for (int i = 0; i < E / 4; ++i) {
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b) word |= (uint32_t)((int)c[4 * i + b] & 0xFF) << (8 * b);
        w[i] = word;
      }
      store_words<E / 4>(qp + off, w);
    }
    if constexpr (kErr) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float d = r[i] - __fmul_rn(c[i], s);
        num += d * d;
        den += r[i] * r[i];
      }
    }
  } else {
    const int n = P * D;
    unsigned bits = 0u;
    for (int i = lane; i < n; i += 32) {
      const int p = i / D;
      bits = max(bits, __float_as_uint(fabsf(to_f32(xp[(p * Hk + h) * D + (i - p * D)]))));
    }
    const float s = head_scale(bits, qmax);
    if (lane == 0) *sp = s;
    if constexpr (kInt4) {
      // one lane per output byte: elements 2j (low nibble) and 2j + 1 (high);
      // D is even, so both lie in one row
      for (int j = lane; j < n / 2; j += 32) {
        const int p = (2 * j) / D;
        const int off = (p * Hk + h) * D + (2 * j - p * D);
        const float x0 = to_f32(xp[off]), x1 = to_f32(xp[off + 1]);
        const float c0 = code(x0, s, qmax), c1 = code(x1, s, qmax);
        qp[off / 2] = (int8_t)(((int)c0 & 0xF) | (((int)c1 & 0xF) << 4));
        if constexpr (kErr) {
          const float d0 = x0 - __fmul_rn(c0, s), d1 = x1 - __fmul_rn(c1, s);
          num += d0 * d0 + d1 * d1;
          den += x0 * x0 + x1 * x1;
        }
      }
    } else {
      for (int i = lane; i < n; i += 32) {
        const int p = i / D;
        const int off = (p * Hk + h) * D + (i - p * D);
        const float x0 = to_f32(xp[off]);
        const float c0 = code(x0, s, qmax);
        qp[off] = (int8_t)c0;
        if constexpr (kErr) {
          const float d0 = x0 - __fmul_rn(c0, s);
          num += d0 * d0;
          den += x0 * x0;
        }
      }
    }
  }
}

template <typename T, bool kInt4, int E>
__global__ void quant_pages_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                   float* __restrict__ scales, float* __restrict__ err, int P,
                                   int Hk, int D, float qmax) {
  __shared__ float sh_num[kMaxHeads], sh_den[kMaxHeads];
  const int page = blockIdx.x;
  const int n = P * Hk * D;
  const T* xp = x + (size_t)page * n;
  int8_t* qp = q + (size_t)page * (kInt4 ? n / 2 : n);
  float* sp = scales + (size_t)page * Hk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int h = warp; h < Hk; h += nwarps) {
    float num = 0.f, den = 0.f;
    quant_head<T, kInt4, E, true>(xp, qp, sp + h, h, Hk, P, D, qmax, lane, num, den);
    num = warp_sum(num);
    den = warp_sum(den);
    if (lane == 0) {
      sh_num[h] = num;
      sh_den[h] = den;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float num = 0.f, den = 0.f;
    for (int h = 0; h < Hk; ++h) {
      num += sh_num[h];
      den += sh_den[h];
    }
    const float cnt = (float)n;
    err[page] = __fdiv_rn(sqrtf(__fdiv_rn(num, cnt)), sqrtf(__fdiv_rn(den, cnt)) + 1e-8f);
  }
}

// 4 elements, 4-element aligned, in and out
__device__ __forceinline__ void load4(const float* p, float (&r)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&r)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  r[0] = __uint_as_float(v.x << 16), r[1] = __uint_as_float(v.x & 0xFFFF0000u);
  r[2] = __uint_as_float(v.y << 16), r[3] = __uint_as_float(v.y & 0xFFFF0000u);
}
__device__ __forceinline__ void store4(float* p, const float (&r)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&r)[4]) {
  const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(r[0])) |
                      ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(r[1])) << 16);
  const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(r[2])) |
                      ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(r[3])) << 16);
  *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
}

struct Pools {
  void* k16;
  void* v16;
  int8_t* k8;
  int8_t* v8;
  float* sk8;
  float* sv8;
  int8_t* k4;
  int8_t* v4;
  float* sk4;
  float* sv4;
  int n0, n1, n2;
};

// One block per (lane, K or V): blockIdx.x = 2 * lane + is_v.
template <typename T, typename T0, int E>
__global__ void quant_store_kernel(const T* __restrict__ k, const T* __restrict__ v,
                                   const int* __restrict__ tier, const int* __restrict__ slot,
                                   Pools pools, int P, int Hk, int D, int allowed) {
  const int b = blockIdx.x >> 1, is_v = blockIdx.x & 1;
  const int t = tier[b], s = slot[b];
  const int n_t = t == 0 ? pools.n0 : t == 1 ? pools.n1 : pools.n2;
  if (t < 0 || t > 2 || !((allowed >> t) & 1) || s < 0 || s >= n_t) return;
  const int n = P * Hk * D;
  const T* xp = (is_v ? v : k) + (size_t)b * n;
  if (t == 0) {
    T0* dst = static_cast<T0*>(is_v ? pools.v16 : pools.k16) + (size_t)s * n;
    if (n % 4 == 0) {
      for (int i = 4 * threadIdx.x; i < n; i += 4 * blockDim.x) {
        float r[4];
        load4(xp + i, r);
        store4(dst + i, r);
      }
    } else {
      for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = from_f32<T0>(to_f32(xp[i]));
    }
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  float num = 0.f, den = 0.f;  // unused: the store entry computes no error
  if (t == 1) {
    int8_t* qp = (is_v ? pools.v8 : pools.k8) + (size_t)s * n;
    float* sp = (is_v ? pools.sv8 : pools.sk8) + (size_t)s * Hk;
    for (int h = warp; h < Hk; h += nwarps)
      quant_head<T, false, E, false>(xp, qp, sp + h, h, Hk, P, D, 127.f, lane, num, den);
  } else {
    int8_t* qp = (is_v ? pools.v4 : pools.k4) + (size_t)s * (n / 2);
    float* sp = (is_v ? pools.sv4 : pools.sk4) + (size_t)s * Hk;
    for (int h = warp; h < Hk; h += nwarps)
      quant_head<T, true, E, false>(xp, qp, sp + h, h, Hk, P, D, 7.f, lane, num, den);
  }
}

// Elements per lane of the register path for a head of P x D, or 0 for the
// streaming path: 32 chunks of 8, 16 or 32 that each lie in one row.
int chunk(int P, int D) {
  const int n = P * D;
  if (n % 32) return 0;
  const int e = n / 32;
  return (e == 8 || e == 16 || e == 32) && D % e == 0 ? e : 0;
}

int threads(int Hk) { return 32 * (Hk < kMaxWarps ? Hk : kMaxWarps); }

template <typename T, bool kInt4>
void launch_pages(const void* x, void* q, void* scales, void* err, int N, int P, int Hk, int D,
                  cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st = static_cast<float*>(scales);
  float* et = static_cast<float*>(err);
  const float qmax = kInt4 ? 7.f : 127.f;
  const int nt = threads(Hk);
  switch (chunk(P, D)) {
    case 8:
      quant_pages_kernel<T, kInt4, 8><<<N, nt, 0, stream>>>(xt, qt, st, et, P, Hk, D, qmax);
      break;
    case 16:
      quant_pages_kernel<T, kInt4, 16><<<N, nt, 0, stream>>>(xt, qt, st, et, P, Hk, D, qmax);
      break;
    case 32:
      quant_pages_kernel<T, kInt4, 32><<<N, nt, 0, stream>>>(xt, qt, st, et, P, Hk, D, qmax);
      break;
    default:
      quant_pages_kernel<T, kInt4, 0><<<N, nt, 0, stream>>>(xt, qt, st, et, P, Hk, D, qmax);
  }
}

template <typename T, typename T0>
void launch_store(const void* k, const void* v, const int* tier, const int* slot, const Pools& pools,
                  int B, int P, int Hk, int D, int allowed, cudaStream_t stream) {
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int nt = threads(Hk);
  switch (chunk(P, D)) {
    case 8:
      quant_store_kernel<T, T0, 8><<<2 * B, nt, 0, stream>>>(kt, vt, tier, slot, pools, P, Hk, D, allowed);
      break;
    case 16:
      quant_store_kernel<T, T0, 16><<<2 * B, nt, 0, stream>>>(kt, vt, tier, slot, pools, P, Hk, D, allowed);
      break;
    case 32:
      quant_store_kernel<T, T0, 32><<<2 * B, nt, 0, stream>>>(kt, vt, tier, slot, pools, P, Hk, D, allowed);
      break;
    default:
      quant_store_kernel<T, T0, 0><<<2 * B, nt, 0, stream>>>(kt, vt, tier, slot, pools, P, Hk, D, allowed);
  }
}

}  // namespace

// x: (N, P, Hk, D) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), contiguous, 16-byte aligned.
// q: (N, P, Hk, D) int8, or (N, P, Hk, D/2) packed when int4 = 1, 16-byte aligned.
// scales: (N, Hk) f32. err: (N,) f32. Returns cudaGetLastError() after the launch.
extern "C" int quant_pages_launch(const void* x, void* q, void* scales, void* err, int N, int P,
                                  int Hk, int D, int x_bf16, int int4, void* stream) {
  if (Hk < 1 || Hk > kMaxHeads || (int4 && (D % 2))) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    int4 ? launch_pages<__nv_bfloat16, true>(x, q, scales, err, N, P, Hk, D, s)
         : launch_pages<__nv_bfloat16, false>(x, q, scales, err, N, P, Hk, D, s);
  else
    int4 ? launch_pages<float, true>(x, q, scales, err, N, P, Hk, D, s)
         : launch_pages<float, false>(x, q, scales, err, N, P, Hk, D, s);
  return (int)cudaGetLastError();
}

// k, v: (B, P, Hk, D) pages, f32 (x_bf16 = 0) or bf16, contiguous, 16-byte aligned.
// tier, slot: (B,) int32 on the device. Pools, contiguous and 16-byte aligned:
// k16, v16 (n0, P, Hk, D) f32 (pool0_bf16 = 0) or bf16; k8, v8 (n1, P, Hk, D)
// int8 with sk8, sv8 (n1, Hk) f32; k4, v4 (n2, P, Hk, D/2) packed with sk4, sv4
// (n2, Hk) f32. Bit t of `allowed` lets lanes of tier t be stored. Returns
// cudaGetLastError() after the launch.
extern "C" int quant_store_pages_launch(const void* k, const void* v, const void* tier,
                                        const void* slot, void* k16, void* v16, void* k8, void* v8,
                                        void* sk8, void* sv8, void* k4, void* v4, void* sk4,
                                        void* sv4, int B, int P, int Hk, int D, int n0, int n1,
                                        int n2, int x_bf16, int pool0_bf16, int allowed,
                                        void* stream) {
  if (B < 1 || Hk < 1 || Hk > kMaxHeads || (D % 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pools pools{k16,
                    v16,
                    static_cast<int8_t*>(k8),
                    static_cast<int8_t*>(v8),
                    static_cast<float*>(sk8),
                    static_cast<float*>(sv8),
                    static_cast<int8_t*>(k4),
                    static_cast<int8_t*>(v4),
                    static_cast<float*>(sk4),
                    static_cast<float*>(sv4),
                    n0,
                    n1,
                    n2};
  const int* ti = static_cast<const int*>(tier);
  const int* sl = static_cast<const int*>(slot);
  if (x_bf16)
    pool0_bf16 ? launch_store<__nv_bfloat16, __nv_bfloat16>(k, v, ti, sl, pools, B, P, Hk, D, allowed, s)
               : launch_store<__nv_bfloat16, float>(k, v, ti, sl, pools, B, P, Hk, D, allowed, s);
  else
    pool0_bf16 ? launch_store<float, __nv_bfloat16>(k, v, ti, sl, pools, B, P, Hk, D, allowed, s)
               : launch_store<float, float>(k, v, ti, sl, pools, B, P, Hk, D, allowed, s);
  return (int)cudaGetLastError();
}
