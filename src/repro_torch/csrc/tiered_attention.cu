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
// GQA scores use q * D^-0.5, with a softmax in f32. Outputs: the unnormalized
// accumulator o (B, H, D), the max m and sum l (B, H), and per page the
// exp-sum page_p and the running max page_m it was taken against (B, MaxP, H);
// a skipped page writes page_p = 0 and page_m = NEG_INF.
//
// Grid: the TPU version walks a (B, MaxPages) grid in order and carries the
// online-softmax state across the page axis. Here one block per (sequence, KV
// head) takes its pages in parallel, one warp per page (a warp loops when
// MaxP exceeds the warps). Each warp takes its own copy of q, loads its page
// of K and V with 16-byte loads, dequantizes in registers, and computes the
// page's own max mu_j, its own exp-sum sigma_j = sum exp(s - mu_j) and its own
// P.V acc_j for the block's G query heads; a warp with a second page folds it
// into its running (m, l, acc) as the online softmax does. mu_j and sigma_j
// stay in shared memory. After one block barrier, one short in-order pass per
// query head gives what the serial walk gives: pm_j = max(pm_{j-1}, mu_j) over
// the valid pages, page_p_j = sigma_j exp(mu_j - pm_j), m = the last pm, and l
// and o sum each warp's part times exp(m_warp - m). The maxima are exact; the
// sums differ from the serial walk by rounding only.
//
// What bounds it: bytes. Each page is read once and used for G query heads, a
// few operations per byte; at the serve path's shapes (B 4, Hk 4, P 8, D 64,
// MaxP 6) one launch moves tens of KB, so it is bound by latency, not by the
// card's memory rate. This design shortens the chain: a block's page loads
// are all in flight at once (a lane issues all its loads of a page before it
// uses one), and there are two block barriers per launch (after the pages,
// after the final weights), none per page. A score is one lane's dot
// product over D from 16-byte shared loads with four independent partial sums,
// the per-head max and exp-sum are short loops over P, and a lane's share of
// P.V is four adjacent columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;
constexpr float kNegInf = -1e30f;  // the reference's sentinel, not -inf

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// one stored element x into dst (two values for a packed int4 byte)
template <int kTier, typename T>
__device__ __forceinline__ void dequant1(T x, float sc, float* dst) {
  if constexpr (kTier == 0) {
    dst[0] = to_f32(x);
  } else if constexpr (kTier == 1) {
    dst[0] = __fmul_rn((float)x, sc);
  } else {
    const int b = (int)x;
    dst[0] = __fmul_rn((float)(((b & 0xF) ^ 8) - 8), sc);
    dst[1] = __fmul_rn((float)(b >> 4), sc);
  }
}

// 16 stored bytes into dst: 4 f32, 8 bf16, 16 int8 or 32 int4 values
template <int kTier, typename T>
__device__ __forceinline__ void dequant16(uint4 w, float sc, float* dst) {
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (kTier == 0 && sizeof(T) == 4) {
      dst[i] = __uint_as_float(ws[i]);
    } else if constexpr (kTier == 0) {
      dst[2 * i] = __uint_as_float(ws[i] << 16);
      dst[2 * i + 1] = __uint_as_float(ws[i] & 0xffff0000u);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dequant1<kTier, int8_t>((int8_t)(ws[i] >> (8 * c)), sc,
                                dst + (kTier == 2 ? 2 : 1) * (4 * i + c));
    }
  }
}

// A page's K and V, P rows of Dp stored elements each (rows `stride` elements
// apart), into k_dst (P, ldk) and v_dst (P, ldv) as f32, by the 32 lanes of a
// warp: each lane issues all its loads of a round (up to 4 of K and 4 of V, 16
// bytes each) before it uses any, so that their latencies overlap.
template <int kTier, typename T>
__device__ __forceinline__ void load_page(const T* k_src, const T* v_src, long stride, int P,
                                          int Dp, float ks, float vs, float* k_dst, int ldk,
                                          float* v_dst, int ldv, bool vec16, int lane) {
  constexpr int kOut = kTier == 2 ? 2 : 1;  // values per stored element
  if (vec16) {
    constexpr int kPer = 16 / sizeof(T);  // stored elements per 16 bytes
    const int upr = Dp / kPer, n = P * upr;
    for (int u0 = 0; u0 < n; u0 += 128) {
      uint4 kw[4], vw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = u0 + lane + 32 * i, p = u / upr, c = u - p * upr;
        if (u < n) {
          kw[i] = *reinterpret_cast<const uint4*>(k_src + p * stride + c * kPer);
          vw[i] = *reinterpret_cast<const uint4*>(v_src + p * stride + c * kPer);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = u0 + lane + 32 * i, p = u / upr, c = u - p * upr;
        if (u < n) {
          dequant16<kTier, T>(kw[i], ks, k_dst + p * ldk + c * kPer * kOut);
          dequant16<kTier, T>(vw[i], vs, v_dst + p * ldv + c * kPer * kOut);
        }
      }
    }
  } else {
    for (int i = lane; i < P * Dp; i += 32) {
      const int p = i / Dp, e = i - p * Dp;
      dequant1<kTier, T>(k_src[p * stride + e], ks, k_dst + p * ldk + e * kOut);
      dequant1<kTier, T>(v_src[p * stride + e], vs, v_dst + p * ldv + e * kOut);
    }
  }
}

// One warp's floats of shared memory, in order: q (G, LD) scaled; the page's K
// (P, LD) and V (P, D); the accumulator (G, D); the scores, then exp(s - mu)
// (G, P, rounded up to 4); the running max, sum, and the two factors of this
// page's fold (4 x G). LD = D + 4 keeps rows 16-byte aligned, with lanes on
// different rows in different banks.
__host__ __device__ inline int warp_floats(int G, int D, int P) {
  return G * (D + 4) + P * (D + 4) + P * D + G * D + ((G * P + 3) & ~3) + 4 * G;
}

// kTier: 0 = stored values (T float or bf16), 1 = int8 * scale, 2 = packed int4 * scale.
template <int kTier, typename T>
__global__ void tiered_decode_partial_kernel(
    const float* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const float* __restrict__ sk, const float* __restrict__ sv, const int* __restrict__ slot_table,
    float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ page_p, float* __restrict__ page_m, int H, int D, int N, int P, int Hk,
    int MaxP, float scale, int vec16) {
  extern __shared__ float4 smem4[];
  const int G = H / Hk;
  const int b = blockIdx.x, kh = blockIdx.y, h0 = kh * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const int LD = D + 4, D4 = D / 4;
  const int ws = warp_floats(G, D, P);
  const int at_acc = (G + P) * LD + P * D, at_m = ws - 4 * G;  // in a warp's floats
  float* warps = reinterpret_cast<float*>(smem4);  // n_warps times ws floats
  float* mu_sh = warps + n_warps * ws;             // (MaxP, G) each page's own max
  float* sg_sh = mu_sh + MaxP * G;                 // (MaxP, G) and own exp-sum
  float* wgt = sg_sh + MaxP * G;                   // (n_warps, G) final weights
  float* q_sh = warps + warp * ws;
  float* k_sh = q_sh + G * LD;
  float* v_sh = k_sh + P * LD;
  float* acc_w = q_sh + at_acc;
  float* e_sh = acc_w + G * D;
  float* m_w = q_sh + at_m;
  float* l_w = m_w + G;
  float* c_old = l_w + G;  // factor of the warp's accumulator
  float* c_pg = c_old + G;  // factor of this page's P.V

  // the warp's first slot, read before q so that the two loads overlap
  int next_slot = warp < MaxP ? slot_table[(long)b * MaxP + warp] : -1;
  // every warp takes its own copy of q, so no block barrier comes before the
  // pages; a lane's loads of a round are all issued before any is used
  const float4* qb = reinterpret_cast<const float4*>(q + ((long)b * H + h0) * D);
  for (int i0 = 0; i0 < G * D4; i0 += 128) {
    float4 x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (i0 + lane + 32 * r < G * D4) x[r] = qb[i0 + lane + 32 * r];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + lane + 32 * r, g = i / D4;
      if (i >= G * D4) break;
      const float4 y = make_float4(__fmul_rn(x[r].x, scale), __fmul_rn(x[r].y, scale),
                                   __fmul_rn(x[r].z, scale), __fmul_rn(x[r].w, scale));
      reinterpret_cast<float4*>(q_sh + g * LD)[i - g * D4] = y;
    }
  }
  for (int i = lane; i < G * D; i += 32) acc_w[i] = 0.f;
  for (int g = lane; g < G; g += 32) {
    m_w[g] = kNegInf;
    l_w[g] = 0.f;
  }

  const int Dp = kTier == 2 ? D / 2 : D;
  const long row_stride = (long)Hk * Dp;
  for (int j = warp; j < MaxP; j += n_warps) {
    int slot = next_slot;
    if (j + n_warps < MaxP) next_slot = slot_table[(long)b * MaxP + j + n_warps];
    if (slot < 0) continue;  // the final pass writes its 0 and NEG_INF
    slot = min(slot, N - 1);  // an out-of-range slot reads the last page, as Pallas clamps
    float ks = 1.f, vs = 1.f;
    if (kTier != 0) {
      ks = sk[(long)slot * Hk + kh];
      vs = sv[(long)slot * Hk + kh];
    }
    __syncwarp();  // q is written; the last page's K, V and e are read
    const long base = ((long)slot * P * Hk + kh) * Dp;
    load_page<kTier, T>(k_pool + base, v_pool + base, row_stride, P, Dp, ks, vs, k_sh, LD, v_sh,
                        D, vec16, lane);
    __syncwarp();

    for (int i = lane; i < G * P; i += 32) {
      const int g = i / P, p = i - g * P;
      const float4* qr = reinterpret_cast<const float4*>(q_sh + g * LD);
      const float4* kr = reinterpret_cast<const float4*>(k_sh + p * LD);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
      for (int c = 0; c < D4; ++c) {
        const float4 x = qr[c], y = kr[c];
        a0 = fmaf(x.x, y.x, a0);
        a1 = fmaf(x.y, y.y, a1);
        a2 = fmaf(x.z, y.z, a2);
        a3 = fmaf(x.w, y.w, a3);
      }
      e_sh[i] = (a0 + a1) + (a2 + a3);
    }
    __syncwarp();

    for (int g = lane; g < G; g += 32) {
      float* e = e_sh + g * P;
      float mu = e[0];
#pragma unroll 4
      for (int p = 1; p < P; ++p) mu = fmaxf(mu, e[p]);
      float sigma = 0.f;
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        e[p] = expf(e[p] - mu);
        sigma += e[p];
      }
      mu_sh[j * G + g] = mu;
      sg_sh[j * G + g] = sigma;
      const float m_new = fmaxf(m_w[g], mu);
      c_old[g] = expf(m_w[g] - m_new);
      c_pg[g] = expf(mu - m_new);
      l_w[g] = l_w[g] * c_old[g] + sigma * c_pg[g];
      m_w[g] = m_new;
    }
    __syncwarp();

    for (int i = lane; i < G * D4; i += 32) {
      const int g = i / D4, c = i - g * D4;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        const float w = e_sh[g * P + p];
        const float4 x = reinterpret_cast<const float4*>(v_sh + p * D)[c];
        a.x = fmaf(w, x.x, a.x);
        a.y = fmaf(w, x.y, a.y);
        a.z = fmaf(w, x.z, a.z);
        a.w = fmaf(w, x.w, a.w);
      }
      float4* acc = reinterpret_cast<float4*>(acc_w + g * D) + c;
      float4 r = *acc;
      r.x = r.x * c_old[g] + c_pg[g] * a.x;
      r.y = r.y * c_old[g] + c_pg[g] * a.y;
      r.z = r.z * c_old[g] + c_pg[g] * a.z;
      r.w = r.w * c_old[g] + c_pg[g] * a.w;
      *acc = r;
    }
  }
  __syncthreads();

  // in page order, per query head: the running max and each page's exp-sum
  // against it; m and l from every warp's part
  for (int g = tid; g < G; g += blockDim.x) {
    float m = kNegInf;
    for (int w = 0; w < n_warps; ++w) m = fmaxf(m, warps[w * ws + at_m + g]);
    float l = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float* mw = warps + w * ws + at_m;  // warp w's m_w, then its l_w
      const float wt = expf(mw[g] - m);
      wgt[w * G + g] = wt;
      l += mw[G + g] * wt;
    }
    float pm = kNegInf;
    for (int j = 0; j < MaxP; ++j) {
      const long idx = ((long)b * MaxP + j) * H + h0 + g;
      if (slot_table[(long)b * MaxP + j] < 0) {
        page_p[idx] = 0.f;
        page_m[idx] = kNegInf;
        continue;
      }
      const float mu = mu_sh[j * G + g];
      pm = fmaxf(pm, mu);
      page_p[idx] = sg_sh[j * G + g] * expf(mu - pm);
      page_m[idx] = pm;  // the running max after this page, not the page's own
    }
    m_out[(long)b * H + h0 + g] = m;
    l_out[(long)b * H + h0 + g] = l;
  }
  __syncthreads();

  float* ob = o + ((long)b * H + h0) * D;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D;
    float a = 0.f;
    for (int w = 0; w < n_warps; ++w)
      a = fmaf(warps[w * ws + at_acc + i], wgt[w * G + g], a);  // warp w's acc_w
    ob[i] = a;
  }
}

template <int kTier, typename T>
int launch(const void* q, const void* kp, const void* vp, const void* sk, const void* sv,
           const void* slots, void* o, void* m, void* l, void* pp, void* pm, int B, int H,
           int D, int N, int P, int Hk, int MaxP, float scale, cudaStream_t stream) {
  const int G = H / Hk;
  const int n_warps = MaxP < 1 ? 1 : (MaxP < kMaxWarps ? MaxP : kMaxWarps);
  const size_t floats = (size_t)n_warps * warp_floats(G, D, P) + 2 * (size_t)MaxP * G +
                        (size_t)n_warps * G;
  const size_t smem = sizeof(float) * floats;
  const int row_bytes = (kTier == 2 ? D / 2 : D) * (int)sizeof(T);
  const int vec16 = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(kp) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(vp) % 16 == 0;
  auto kernel = tiered_decode_partial_kernel<kTier, T>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(B, Hk), 32 * n_warps, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const float*>(sk), static_cast<const float*>(sv),
      static_cast<const int*>(slots), static_cast<float*>(o), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<float*>(pp), static_cast<float*>(pm), H, D, N, P, Hk,
      MaxP, scale, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, D) f32. k_pool/v_pool: (N, P, Hk, D') with D' = D (tier 0: f32 when
// pool_bf16 = 0, bf16 when 1; tier 1: int8) or D/2 (tier 2: packed int4).
// sk/sv: (N, Hk) f32 (read for tiers 1 and 2). slot_table: (B, MaxP) int32.
// o: (B, H, D), m/l: (B, H), page_p/page_m: (B, MaxP, H), all f32. All contiguous,
// q 16-byte aligned; D a multiple of 4. Returns cudaGetLastError() after the launch.
extern "C" int tiered_decode_partial_launch(const void* q, const void* k_pool, const void* v_pool,
                                            const void* sk, const void* sv, const void* slot_table,
                                            void* o, void* m, void* l, void* page_p,
                                            void* page_m, int B, int H, int D, int N, int P,
                                            int Hk, int MaxP, int tier, int pool_bf16,
                                            float scale, void* stream) {
  if (Hk <= 0 || H % Hk || D % 4 || MaxP < 0) return (int)cudaErrorInvalidValue;
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
