// Per-tier paged flash-decoding partial for the RARO-tiered KV cache,
// CUDA C++ for sm_90a.
//
// Replaces the Pallas kernel `tiered_decode_partial` (bodies `_decode_kernel`
// and `_dequant_block`) of src/repro/kernels/tiered_attention/tiered_attention.py.
// One query token per sequence attends over the pages of ONE tier: the page of
// logical index j lives at pool slot slot_table[b, j], and -1 means "not in
// this tier", so the page is skipped. Pages are dequantized by tier: tier 0 as
// stored (f32 or bf16), int8 times a per-(page, head) scale, int4 from two
// sign-extended nibbles per byte (even index in the low nibble) times the scale.
// GQA scores use q * D^-0.5, with an online softmax in f32. Outputs: the
// unnormalized accumulator o (B, H, D), the running max m and sum l (B, H), and
// per page the exp-sum page_p and the running max page_m it was taken against
// (B, MaxP, H); a skipped page writes page_p = 0 and page_m = NEG_INF.
//
// Grid: the TPU version walks a (B, MaxPages) grid in order and carries the
// softmax state in scratch memory across the page axis. Blocks here run in no
// order, so there is one block per (sequence, KV head): it reads its own
// slot_table row and loops over the MaxP pages itself, carrying m, l and the
// (G, D) accumulator of its G query heads in shared memory.
//
// What bounds it: bytes. Each page is read once and used for G query heads,
// a few operations per byte; at the serve path's shapes (B 4, Hk 4, P 8, D 64,
// MaxP 6) one launch moves tens of KB, so it is bound by launch latency and
// by the serial page loop, not by the card's memory rate. The simple design
// keeps every intermediate on chip (one dequantized page of K and V, the
// scores and the accumulator in shared memory) and writes each output once.
// No wgmma and no TMA: making it fast is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // the reference's sentinel, not -inf

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// kTier: 0 = stored values (T float or bf16), 1 = int8 * scale, 2 = packed int4 * scale.
template <int kTier, typename T>
__global__ void __launch_bounds__(kThreads)
tiered_decode_partial_kernel(const float* __restrict__ q, const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool, const float* __restrict__ sk,
                             const float* __restrict__ sv, const int* __restrict__ slot_table,
                             float* __restrict__ o, float* __restrict__ m_out,
                             float* __restrict__ l_out, float* __restrict__ page_p,
                             float* __restrict__ page_m, int H, int D, int N, int P, int Hk,
                             int MaxP, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hk;
  const int b = blockIdx.x, kh = blockIdx.y, h0 = kh * G;
  const int tid = threadIdx.x;
  float* q_sh = smem;          // (G, D)
  float* acc = q_sh + G * D;   // (G, D)
  float* k_sh = acc + G * D;   // (P, D)
  float* v_sh = k_sh + P * D;  // (P, D)
  float* s_sh = v_sh + P * D;  // (G, P) scores, then probabilities
  float* m_sh = s_sh + G * P;  // (G,)
  float* l_sh = m_sh + G;      // (G,)
  float* c_sh = l_sh + G;      // (G,) correction of this page

  const float* qb = q + ((long)b * H + h0) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_sh[i] = __fmul_rn(qb[i], scale);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_sh[g] = kNegInf;
    l_sh[g] = 0.f;
  }
  __syncthreads();

  const int Dp = kTier == 2 ? D / 2 : D;
  for (int j = 0; j < MaxP; ++j) {
    int slot = slot_table[(long)b * MaxP + j];  // the same for every thread
    float* pp = page_p + ((long)b * MaxP + j) * H + h0;
    float* pm = page_m + ((long)b * MaxP + j) * H + h0;
    if (slot < 0) {
      for (int g = tid; g < G; g += kThreads) {
        pp[g] = 0.f;
        pm[g] = kNegInf;
      }
      continue;
    }
    slot = min(slot, N - 1);  // an out-of-range slot reads the last page, as Pallas clamps
    float ks = 1.f, vs = 1.f;
    if (kTier != 0) {
      ks = sk[(long)slot * Hk + kh];
      vs = sv[(long)slot * Hk + kh];
    }
    for (int i = tid; i < P * Dp; i += kThreads) {
      const int p = i / Dp, dd = i - p * Dp;
      const long src = (((long)slot * P + p) * Hk + kh) * Dp + dd;
      if (kTier == 2) {
        const int kb = (int)k_pool[src], vb = (int)v_pool[src];
        k_sh[p * D + 2 * dd] = __fmul_rn((float)(((kb & 0xF) ^ 8) - 8), ks);
        k_sh[p * D + 2 * dd + 1] = __fmul_rn((float)(kb >> 4), ks);
        v_sh[p * D + 2 * dd] = __fmul_rn((float)(((vb & 0xF) ^ 8) - 8), vs);
        v_sh[p * D + 2 * dd + 1] = __fmul_rn((float)(vb >> 4), vs);
      } else if (kTier == 1) {
        k_sh[p * D + dd] = __fmul_rn((float)k_pool[src], ks);
        v_sh[p * D + dd] = __fmul_rn((float)v_pool[src], vs);
      } else {
        k_sh[p * D + dd] = to_f32(k_pool[src]);
        v_sh[p * D + dd] = to_f32(v_pool[src]);
      }
    }
    __syncthreads();

    for (int i = tid; i < G * P; i += kThreads) {
      const int g = i / P, p = i - g * P;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(q_sh[g * D + d], k_sh[p * D + d], s);
      s_sh[i] = s;
    }
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      float smax = s_sh[g * P];
      for (int p = 1; p < P; ++p) smax = fmaxf(smax, s_sh[g * P + p]);
      const float m_prev = m_sh[g];
      const float m_new = fmaxf(m_prev, smax);
      float psum = 0.f;
      for (int p = 0; p < P; ++p) {
        const float e = expf(s_sh[g * P + p] - m_new);
        s_sh[g * P + p] = e;
        psum += e;
      }
      const float corr = expf(m_prev - m_new);
      l_sh[g] = l_sh[g] * corr + psum;
      m_sh[g] = m_new;
      c_sh[g] = corr;
      pp[g] = psum;
      pm[g] = m_new;  // the running max after this page, not the page's own
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      float a = acc[i] * c_sh[g];
      for (int p = 0; p < P; ++p) a = fmaf(s_sh[g * P + p], v_sh[p * D + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  float* ob = o + ((long)b * H + h0) * D;
  for (int i = tid; i < G * D; i += kThreads) ob[i] = acc[i];
  for (int g = tid; g < G; g += kThreads) {
    m_out[(long)b * H + h0 + g] = m_sh[g];
    l_out[(long)b * H + h0 + g] = l_sh[g];
  }
}

template <int kTier, typename T>
int launch(const void* q, const void* kp, const void* vp, const void* sk, const void* sv,
           const void* slots, void* o, void* m, void* l, void* pp, void* pm, int B, int H,
           int D, int N, int P, int Hk, int MaxP, float scale, cudaStream_t stream) {
  const int G = H / Hk;
  const size_t smem = sizeof(float) * (size_t)(2 * G * D + 2 * P * D + G * P + 3 * G);
  auto kernel = tiered_decode_partial_kernel<kTier, T>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B, Hk), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const float*>(sk), static_cast<const float*>(sv),
      static_cast<const int*>(slots), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(pp), static_cast<float*>(pm), H, D, N, P, Hk,
      MaxP, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, D) f32. k_pool/v_pool: (N, P, Hk, D') with D' = D (tier 0: f32 when
// pool_bf16 = 0, bf16 when 1; tier 1: int8) or D/2 (tier 2: packed int4).
// sk/sv: (N, Hk) f32 (read for tiers 1 and 2). slot_table: (B, MaxP) int32.
// o: (B, H, D), m/l: (B, H), page_p/page_m: (B, MaxP, H), all f32. All contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int tiered_decode_partial_launch(const void* q, const void* k_pool, const void* v_pool,
                                            const void* sk, const void* sv, const void* slot_table,
                                            void* o, void* m, void* l, void* page_p,
                                            void* page_m, int B, int H, int D, int N, int P,
                                            int Hk, int MaxP, int tier, int pool_bf16,
                                            float scale, void* stream) {
  if (Hk <= 0 || H % Hk || (tier == 2 && D % 2)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* a[] = {q, k_pool, v_pool, sk, sv, slot_table};
  if (tier == 0 && pool_bf16)
    return launch<0, __nv_bfloat16>(a[0], a[1], a[2], a[3], a[4], a[5], o, m, l, page_p, page_m,
                                    B, H, D, N, P, Hk, MaxP, scale, s);
  if (tier == 0)
    return launch<0, float>(a[0], a[1], a[2], a[3], a[4], a[5], o, m, l, page_p, page_m, B, H,
                            D, N, P, Hk, MaxP, scale, s);
  if (tier == 1)
    return launch<1, int8_t>(a[0], a[1], a[2], a[3], a[4], a[5], o, m, l, page_p, page_m, B, H,
                             D, N, P, Hk, MaxP, scale, s);
  return launch<2, int8_t>(a[0], a[1], a[2], a[3], a[4], a[5], o, m, l, page_p, page_m, B, H, D,
                           N, P, Hk, MaxP, scale, s);
}
