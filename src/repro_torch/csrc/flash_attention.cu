// Flash-attention forward, CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel `flash_attention_fwd` (body `_fwd_kernel`) of
// src/repro/kernels/flash_attention/flash_attention.py. For each query row:
// scores q . k with q cast to f32 and scaled by D^-0.5, masked to -1e30 where
// the key lies at or beyond sk_valid or, when causal, after the query (top-left
// aligned: query i sees keys 0..i); an online softmax in f32 carried over KV
// tiles; P.V with p rounded to v's type first (bf16 at bf16 inputs) and the
// tile's product rounded to v's type, as the reference's `lax.dot` of two bf16
// operands gives bf16; the finalize divides by max(l, 1e-30) and writes q's
// type. GQA: query head h reads KV head h / (H / Hk).
//
// Grid: the TPU version walks (B*H, Sq/BQ, Sk/BK) with the KV axis innermost
// and in order, carrying m, l and acc in scratch memory across it. Blocks here
// run in no order, so each block owns one (batch, head, 64-row query tile) and
// walks the KV tiles in order itself: K and V tiles of 64 keys staged in shared
// memory, the scores, m, l and the (64, D) accumulator in registers. Tiles that
// the causal mask empties are not visited; they would add p = 0. Tiles are
// scheduled longest first (the last query tile of a causal row has the most).
// Operands are read through (batch, seq, head) strides, so the model's
// (B, S, H, D) layout needs no transposes, and the ragged tails of Sq and Sk
// are masked here, so nothing is padded.
//
// Threads: 256 as a 16 x 16 grid. Thread (ty, tx) holds query rows 4ty..4ty+3
// of the tile; for the scores it takes keys tx + 16j (j < 4), and for the
// output columns tx*D/16 .. +D/16. A row's 64 scores thus lie on the 16 lanes
// of one half-warp, which reduce its max and sum with shuffles.
//
// What bounds it: operations. At the prefill shape (B 4, S 2048, H 32, Hk 4,
// D 64, causal) it does ~7e10 f32 multiply-adds-as-two against ~150 MB of
// operands, ~450 operations per byte, so the card's f32 rate (no tensor
// cores: f32 inputs) is the bound. This first design keeps every intermediate
// on chip and feeds the FMAs from 16-byte shared-memory loads (rows padded by
// 4 floats, so a half-warp's loads fall in distinct banks). No wgmma, TMA or
// copy pipelining: that is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per KV tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's sentinel, not -inf

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v as T holds it: the identity for f32, a round to nearest even for bf16
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

struct Strides {  // in elements; the head dim is contiguous
  long long b, s, h;
};

// n consecutive floats of shared memory (n = 1, 2, 4 or 8; 4n-byte aligned)
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&out)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      out[c] = t.x;
      out[c + 1] = t.y;
      out[c + 2] = t.z;
      out[c + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x;
    out[1] = t.y;
  } else {
    out[0] = p[0];
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
                           Strides vs, Strides os, int H, int Hk, int Sq, int Sk, int sk_valid,
                           int causal, float scale) {
  constexpr int LD = D + 4;     // row of the Q, K and V tiles
  constexpr int LDP = kBK + 4;  // row of the P tile
  constexpr int CD = D / 16;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* q_sh = reinterpret_cast<float*>(smem4);  // (BQ, LD), q * scale
  float* k_sh = q_sh + kBQ * LD;                  // (BK, LD)
  float* v_sh = k_sh + kBK * LD;                  // (BK, LD)
  float* p_sh = v_sh + kBK * LD;                  // (BQ, LDP), p as v's type holds it

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Hk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * kBQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qp = q0 + r;
    q_sh[r * LD + d] = qp < Sq ? __fmul_rn(to_f32(qb[qp * qs.s + d]), scale) : 0.f;
  }

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int n_kt = (sk_valid + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, q_last / kBK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last tile's K, V and P are read; Q is written
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int kp = k0 + r;
      const bool in = kp < Sk;
      k_sh[r * LD + d] = in ? to_f32(kb[kp * ks.s + d]) : 0.f;
      v_sh[r * LD + d] = in ? to_f32(vb[kp * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_sh + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_sh + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = fmaf(qv[i].x, kv[j].x, s[i][j]);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          s[i][j] = fmaf(qv[i].w, kv[j].w, a);
        }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qp = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < sk_valid && (!causal || qp >= kp);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        p_sh[r * LDP + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + ps;
      m[i] = m_new;
    }
    __syncthreads();

    float pv[4][CD];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) pv[i][c] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(p_sh + (ty * 4 + i) * LDP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vv[CD];
        load_row<CD>(v_sh + (kk + u) * LD + tx * CD, vv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < CD; ++c) pv[i][c] = fmaf(p, vv[c], pv[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] = acc[i][c] * corr[i] + round_to<T>(pv[i][c]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* ob = o + b * os.b + qp * os.s + h * os.h + tx * CD;
#pragma unroll
    for (int c = 0; c < CD; ++c) ob[c] = from_f32<T>(acc[i][c] / denom);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
           int H, int Hk, int Sq, int Sk, int sk_valid, int causal, float scale,
           cudaStream_t stream) {
  constexpr int LD = D + 4;
  const size_t smem = sizeof(float) * (size_t)((kBQ + 2 * kBK) * LD + kBQ * (kBK + 4));
  auto kernel = flash_attention_fwd_kernel<D, T>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, H, Hk, Sq, Sk, sk_valid, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
             int H, int Hk, int Sq, int Sk, int D, int sk_valid, int causal, float scale,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, T>(q, k, v, o, st, B, H, Hk, Sq, Sk, sk_valid, causal, scale, s);
    case 32: return launch<32, T>(q, k, v, o, st, B, H, Hk, Sq, Sk, sk_valid, causal, scale, s);
    case 64: return launch<64, T>(q, k, v, o, st, B, H, Hk, Sq, Sk, sk_valid, causal, scale, s);
    case 128: return launch<128, T>(q, k, v, o, st, B, H, Hk, Sq, Sk, sk_valid, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (B, Sq, H, D); k, v: (B, Sk, Hk, D); o: (B, Sq, H, D); all f32 (is_bf16 = 0)
// or all bf16 (is_bf16 = 1), each addressed by its (batch, seq, head) strides in
// elements, strides[3 * operand + axis] for operands q, k, v, o; the head dim is
// contiguous. D is 16, 32, 64 or 128; H is a multiple of Hk; 1 <= sk_valid <= Sk.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          const long long* strides, int B, int H, int Hk, int Sq,
                                          int Sk, int D, int sk_valid, int causal, int is_bf16,
                                          float scale, void* stream) {
  if (B <= 0 || Hk <= 0 || H % Hk || Sq <= 0 || sk_valid < 1 || sk_valid > Sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, o, strides, B, H, Hk, Sq, Sk, D, sk_valid, causal,
                                   scale, s);
  return launch_d<float>(q, k, v, o, strides, B, H, Hk, Sq, Sk, D, sk_valid, causal, scale, s);
}
