// Flash-attention backward, CUDA C++ for sm_90a.
//
// Replaces no Pallas kernel: the reference's flash kernel is forward only
// (src/repro/kernels/flash_attention/ops.py), and its training gradient is
// XLA's autodiff of the plain blockwise attention
// (src/repro/models/attention.py, blockwise_attention), f32 throughout. This
// computes that gradient for the training entry's kernel forward
// (flash_attention.cu), which writes each query row's log-sum-exp lse (the
// natural log, of the scaled scores). With S = q . k (raw), scale = DQK^-0.5:
//   P = exp(S scale - lse), 0 where masked     dV = P^T dO
//   dP = dO V^T                                dS = P o (dP - Delta)
//   Delta = rowsum(dO o O)                     dK = scale dS^T Q, dQ = scale dS K
// Masks as the forward's: keys at or past sk_valid, and with `causal` keys
// after the query (top-left aligned). GQA: query head h reads KV head h / (H
// / Hk), so dK and dV sum over the H / Hk query heads of a group. Operands are
// read through (batch, seq, head) strides, as the model lays them out (B, S, H,
// D); the ragged tails of Sq and Sk are zero-filled and masked here.
//
// What bounds it: operations. The five products are 2 (3 DQK + 2 DV) per kept
// (query, key) pair; at tinyllama-1.1b's training shape (B 4, S 2048, H 32 over
// 4, D 64, causal, bf16) that is 1.72e11 operations, 0.174 ms on the bf16
// tensor cores (989e12 a second), against 152 MB read and written once (q, k, v,
// O, dO and lse in, dq, dk and dv out: 0.045 ms at 3.35e12 bytes a second).
//
// Design: three kernels and no atomics, so that every gradient is summed in one
// fixed order and two runs give the same bits.
// (a) flash_bwd_delta_kernel: Delta, a warp a row.
// (b) flash_bwd_dkdv_kernel: a block per (batch, KV head, 64-key tile), a warp
//     per 16 keys. K and V of the tile stay in shared memory; the block walks
//     the group's query heads and, for each, the query tiles the mask leaves
//     (BN rows), in order, Q, dO, lse and Delta double-buffered by cp.async.
//     Each turn recomputes S^T and P^T, then dV += P^T dO, dP^T = V dO^T, dS^T
//     and dK += dS^T Q; dK and dV are summed in registers and written once.
// (c) flash_bwd_dq_kernel: a block per (batch, head, 64-query tile), a warp
//     per 16 queries, Q and dO in shared memory, walking the key tiles (BN
//     keys) with K and V double-buffered: S, P, dP, dS again, dQ += dS K.
// So the design takes seven products a pair where the bound counts five (S and
// dP twice): its own floor is ~0.24 ms at the shape above.
// Two routes on one tiling, by input type:
// - bf16: tensor cores, mma.sync m16n8k16 bf16 with f32 sums. Operands come from
//   shared memory by ldmatrix (.trans where the product reads a tile's columns);
//   rows are padded by 16 bytes, so the eight rows of an 8x8 matrix fall in
//   different banks. An accumulator fragment (row g and g + 8, columns 2t and
//   2t + 1 of each 8) is the A fragment of the next product as it stands, so P
//   and dS are rounded to bf16 into A fragments in registers and move nowhere.
// - f32: the same fragments, summed with FMAs on the CUDA cores (no TF32, so a
//   training step in f32 stays within 1e-5 of the CPU's); P and dS pass through
//   a warp's 16 rows of shared memory to reach the products that read them.
//   dK, dV and dQ take each tile's sum on its own before adding it: one chain
//   of FMAs over a head group's 16,384 queries (tinyllama's shape) strays
//   ~sqrt(16,384) ulps of the running sum, ~1e-4 at |dV| ~10, as far as f32
//   blockwise attention's autograd lies from the exact gradient, where the
//   checks hold 1e-5.
// BN, the tile a block walks, is 64 at DQK <= 64 and 32 above it, where the
// accumulators (dK is DQK / 2 registers a thread, 96 at MLA's 192) leave no
// room for 64 columns of scores. exp is ex2.approx of S c - lse log2(e), c =
// scale log2(e), in one multiply-add.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 16 * kWarps;  // the rows a block owns: keys in (b), queries in (c)
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {  // in elements; the head dim is contiguous
  long long b, s, h;
};

template <typename T, int DQK, int DV>
struct BwdCfg {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int BN = DQK <= 64 ? 64 : 32;  // the tile a block walks
  static constexpr int kPad = 16 / (int)sizeof(T);  // 16 bytes of padding a row
  static constexpr int PQ = DQK + kPad, PV = DV + kPad;  // row pitches, in elements
  static constexpr int PS = BN + 4;  // the f32 route's staging of P or dS, a warp's 16 rows
  // (b): K and V (BM rows); then two stages of Q and dO (BN rows), lse and Delta
  static constexpr size_t kOwn = (size_t)BM * (PQ + PV) * sizeof(T);
  static constexpr size_t kStageB = (size_t)BN * (PQ + PV) * sizeof(T) + 2 * BN * 4;
  static constexpr size_t kStaging = kBf16 ? 0 : (size_t)kWarps * 16 * PS * 4;
  static constexpr size_t kSmemB = kOwn + 2 * kStageB + kStaging;
  // (c): Q and dO (BM rows); then two stages of K and V (BN rows)
  static constexpr size_t kStageC = (size_t)BN * (PQ + PV) * sizeof(T);
  static constexpr size_t kSmemC = kOwn + 2 * kStageC + kStaging;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes from global to shared, zeros where !ok (src then unread)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows row0 .. row0 + ROWS - 1 of one (batch, head) of an operand W wide,
// `base` its row 0, into shared memory at pitch P; rows from n_valid on zeros
template <typename T, int W, int P, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* base, long long stride, int row0,
                                          int n_valid, int tid) {
  constexpr int kPer = 16 / (int)sizeof(T), kChunks = W / kPer;
  for (int c = tid; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, x = (c % kChunks) * kPer;
    const bool ok = row0 + r < n_valid;
    cp16(dst + r * P + x, ok ? base + (row0 + r) * stride + x : base, ok);
  }
}
// n f32 values row[i0 ..] into shared memory, zeros from `n_valid` on
__device__ __forceinline__ void load_vec(float* dst, const float* row, int i0, int n, int n_valid,
                                         int tid) {
  for (int i = tid; i < n; i += kThreads) {
    const bool ok = i0 + i < n_valid;
    cp4(dst + i, ok ? row + i0 + i : row, ok);
  }
}

__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// d += a b, m16n8k16, bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The fragment every product below sums into, as mma.sync's accumulator: a
// warp's 16 rows by NT n-tiles of 8 columns; lane (g = lane / 4, t = lane % 4)
// holds acc[j][e], row g + 8 (e / 2), column 8 j + 2 t + e % 2.

// acc += A B^T: A the warp's 16 rows, B NT * 8 rows, both K wide, row-major in
// shared memory at pitches PA and PB. bf16: ldmatrix then mma; f32: FMAs.
template <int NT, int K, int PA, int PB>
__device__ __forceinline__ void product_nt(float (&acc)[NT][4], const __nv_bfloat16* a,
                                           const __nv_bfloat16* b, int lane) {
  // lanes 8i..8i+7 give the rows of matrix i: A's (rows +8 (i & 1), k +8 (i >> 1)),
  // B's (rows +8 (i >> 1), k +8 (i & 1)), so that B's x4 is two n-tiles
  const uint32_t a0 = smem_u32(a + ((lane & 7) + ((lane >> 3) & 1) * 8) * PA + (lane >> 4) * 8);
  const uint32_t b0 =
      smem_u32(b + ((lane & 7) + ((lane >> 4) & 1) * 8) * PB + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, a0 + kk * 32);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t bf[4];
      ldsm_x4(bf, b0 + jp * 16 * PB * 2 + kk * 32);
      mma_bf16(acc[2 * jp], af, bf[0], bf[1]);
      mma_bf16(acc[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
}
template <int NT, int K, int PA, int PB>
__device__ __forceinline__ void product_nt(float (&acc)[NT][4], const float* a, const float* b,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * PA;
  const float* a1 = a0 + 8 * PA;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
    const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 y = *reinterpret_cast<const float4*>(b + (8 * j + 2 * t + c) * PB + k);
        float s0 = acc[j][c], s1 = acc[j][2 + c];
        s0 = fmaf(x0.x, y.x, s0);
        s1 = fmaf(x1.x, y.x, s1);
        s0 = fmaf(x0.y, y.y, s0);
        s1 = fmaf(x1.y, y.y, s1);
        s0 = fmaf(x0.z, y.z, s0);
        s1 = fmaf(x1.z, y.z, s1);
        s0 = fmaf(x0.w, y.w, s0);
        s1 = fmaf(x1.w, y.w, s1);
        acc[j][c] = s0;
        acc[j][2 + c] = s1;
      }
  }
}

// acc += A B, bf16: A in registers as KT A fragments (k-steps of 16), B KT * 16
// rows of NT * 8 columns in shared memory at pitch PB, read by ldmatrix.trans
template <int NT, int KT, int PB>
__device__ __forceinline__ void product_rn(float (&acc)[NT][4], const uint32_t (&a)[KT][4],
                                           const __nv_bfloat16* b, int lane) {
  // lanes 8i..8i+7 give the rows of matrix i: k +8 (i & 1), columns +8 (i >> 1)
  const uint32_t b0 = smem_u32(b + ((lane & 7) + ((lane >> 3) & 1) * 8) * PB + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4_t(bf, b0 + (kk * 16 * PB + np * 16) * 2);
      mma_bf16(acc[2 * np], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], a[kk], bf[2], bf[3]);
    }
}
// acc += A B, f32: A the warp's 16 rows of K in shared memory at pitch PA (its
// staging), B K rows of NT * 8 columns at pitch PB. Each n-tile's sum over the
// tile is taken on its own, in four chains, and then added to acc: acc sums a
// tile at a time, so that its chain over a head group's queries (16,384 at
// tinyllama's training shape) is as many adds as tiles, not as many as terms.
template <int NT, int K, int PA, int PB>
__device__ __forceinline__ void product_rn(float (&acc)[NT][4], const float* a, const float* b,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * PA;
  const float* a1 = a0 + 8 * PA;
  const float* b0 = b + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float s[4][4];  // [k % 4][element]
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; k += 4) {
      const float4 x0 = *reinterpret_cast<const float4*>(a0 + k);
      const float4 x1 = *reinterpret_cast<const float4*>(a1 + k);
      const float xs0[4] = {x0.x, x0.y, x0.z, x0.w}, xs1[4] = {x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float2 y = *reinterpret_cast<const float2*>(b0 + (k + c) * PB + 8 * n);
        s[c][0] = fmaf(xs0[c], y.x, s[c][0]);
        s[c][1] = fmaf(xs0[c], y.y, s[c][1]);
        s[c][2] = fmaf(xs1[c], y.x, s[c][2]);
        s[c][3] = fmaf(xs1[c], y.y, s[c][3]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += (s[0][e] + s[1][e]) + (s[2][e] + s[3][e]);
  }
}

// an accumulator of NT n-tiles as the next product's A operand: bf16 A
// fragments (k-steps of 16 = n-tiles 2i and 2i + 1, in the fragment's own order)
template <int NT>
__device__ __forceinline__ void to_a(uint32_t (&a)[NT / 2][4], const float (&x)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    a[i][0] = pack_bf16(x[2 * i][0], x[2 * i][1]);
    a[i][1] = pack_bf16(x[2 * i][2], x[2 * i][3]);
    a[i][2] = pack_bf16(x[2 * i + 1][0], x[2 * i + 1][1]);
    a[i][3] = pack_bf16(x[2 * i + 1][2], x[2 * i + 1][3]);
  }
}
// f32: the warp's 16 rows into its staging (pitch P)
template <int NT, int P>
__device__ __forceinline__ void to_staging(float* s, const float (&x)[NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store2(s + g * P + 8 * j + 2 * t, x[j][0], x[j][1]);
    store2(s + (g + 8) * P + 8 * j + 2 * t, x[j][2], x[j][3]);
  }
}

// acc += X B, X an accumulator (P or dS, the warp's 16 rows by NT * 8) and B
// its NT * 8 rows of N columns in shared memory at pitch PB: by A fragments in
// bf16, through the warp's staging in f32
template <typename T, int NT, int N, int PB, int PS>
__device__ __forceinline__ void product_acc(float (&acc)[N / 8][4], const float (&x)[NT][4],
                                            const T* b, float* staging, int lane) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    uint32_t a[NT / 2][4];
    to_a<NT>(a, x);
    product_rn<N / 8, NT / 2, PB>(acc, a, b, lane);
  } else {
    to_staging<NT, PS>(staging, x, lane);
    __syncwarp();
    product_rn<N / 8, NT * 8, PS, PB>(acc, staging, b, lane);
    __syncwarp();
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// (a) Delta = rowsum(dO o O) in f32, one warp a row, the rows in (batch, head,
// query) order as lse; lanes sum columns lane, lane + 32, ..., then a fixed tree
template <typename T, int DV>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, Strides os, Strides dos, int B, int H, int Sq) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * H * Sq) return;
  const int s = (int)(row % Sq), h = (int)(row / Sq % H), b = (int)(row / Sq / H);
  const T* orow = o + b * os.b + s * os.s + h * os.h;
  const T* drow = dout + b * dos.b + s * dos.s + h * dos.h;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < DV; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[row] = acc;
}

// (b) dK and dV of one (batch, KV head, BM-key tile): the source note above.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                      Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
                      int H, int Hk, int Sq, int Sk, int sk_valid, int causal, float scale_log2,
                      float scale) {
  using C = BwdCfg<T, DQK, DV>;
  constexpr int BN = C::BN, PQ = C::PQ, PV = C::PV;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BM;  // longest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = H / Hk;
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + BM * PQ;
  auto q_s = [&](int st) { return reinterpret_cast<T*>(smem + C::kOwn + st * C::kStageB); };
  auto do_s = [&](int st) { return q_s(st) + BN * PQ; };
  auto lse_s = [&](int st) { return reinterpret_cast<float*>(do_s(st) + BN * PV); };
  auto dl_s = [&](int st) { return lse_s(st) + BN; };
  float* staging = reinterpret_cast<float*>(smem + C::kOwn + 2 * C::kStageB) + warp * 16 * C::PS;

  // turns: each query head of the group, and in it the query tiles from the one
  // that holds query k0 (causal: the earlier see none of these keys) to the last
  const int n_qt = (Sq + BN - 1) / BN;
  const int qt0 = causal ? min(k0 / BN, n_qt) : 0;
  const int per_head = k0 < sk_valid ? n_qt - qt0 : 0;
  const int n_turns = G * per_head;
  auto load_turn = [&](int i, int st) {
    const int h = hk * G + i / per_head, q0 = (qt0 + i % per_head) * BN;
    load_rows<T, DQK, PQ, BN>(q_s(st), q + b * qs.b + h * qs.h, qs.s, q0, Sq, tid);
    load_rows<T, DV, PV, BN>(do_s(st), dout + b * dos.b + h * dos.h, dos.s, q0, Sq, tid);
    const long long row = ((long long)b * H + h) * Sq;
    load_vec(lse_s(st), lse + row, q0, BN, Sq, tid);
    load_vec(dl_s(st), delta + row, q0, BN, Sq, tid);
  };
  if (n_turns > 0) {
    load_rows<T, DQK, PQ, BM>(k_s, k + b * ks.b + hk * ks.h, ks.s, k0, Sk, tid);
    load_rows<T, DV, PV, BM>(v_s, v + b * vs.b + hk * vs.h, vs.s, k0, Sk, tid);
    load_turn(0, 0);
  }
  cp_commit();

  float dk_acc[DQK / 8][4], dv_acc[DV / 8][4];
  zero(dk_acc);
  zero(dv_acc);
  const int key0 = k0 + 16 * warp + g;  // this thread's keys: key0 and key0 + 8
  for (int i = 0; i < n_turns; ++i) {
    const int st = i & 1, q0 = (qt0 + i % per_head) * BN;
    if (i + 1 < n_turns) load_turn(i + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    // S^T = K Q^T, then P^T
    float p[BN / 8][4];
    zero(p);
    product_nt<BN / 8, DQK, PQ, PQ>(p, k_s + 16 * warp * PQ, q_s(st), lane);
    const float* ls = lse_s(st);
    const bool edge = k0 + BM > sk_valid || q0 + BN > Sq || (causal && q0 < k0 + BM);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1), query = q0 + col, key = key0 + 8 * (e >> 1);
        const float x = exp2_approx(fmaf(p[j][e], scale_log2, -ls[col] * kLog2e));
        p[j][e] = edge && (key >= sk_valid || query >= Sq || (causal && query < key)) ? 0.f : x;
      }
    // dV += P^T dO
    product_acc<T, BN / 8, DV, PV, C::PS>(dv_acc, p, do_s(st), staging, lane);
    // dP^T = V dO^T, then dS^T = P^T o (dP^T - Delta) in place
    float ds[BN / 8][4];
    zero(ds);
    product_nt<BN / 8, DV, PV, PV>(ds, v_s + 16 * warp * PV, do_s(st), lane);
    const float* dl = dl_s(st);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dl[8 * j + 2 * t + (e & 1)]);
    // dK += dS^T Q (scaled at the end)
    product_acc<T, BN / 8, DQK, PQ, C::PS>(dk_acc, ds, q_s(st), staging, lane);
    __syncthreads();  // the next turn's copies refill this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Sk) continue;
    T* dkr = dk + b * dks.b + key * dks.s + hk * dks.h + 2 * t;
    T* dvr = dv + b * dvs.b + key * dvs.s + hk * dvs.h + 2 * t;
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n)
      store2(dkr + 8 * n, dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) store2(dvr + 8 * n, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
  }
}

// (c) dQ of one (batch, head, BM-query tile): the source note above.
template <typename T, int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks,
                    Strides vs, Strides dos, Strides dqs, int H, int Hk, int Sq, int sk_valid,
                    int causal, float scale_log2, float scale) {
  using C = BwdCfg<T, DQK, DV>;
  constexpr int BN = C::BN, PQ = C::PQ, PV = C::PV;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest causal tiles first
  const int kh = h / (H / Hk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = q_s + BM * PQ;
  auto k_s = [&](int st) { return reinterpret_cast<T*>(smem + C::kOwn + st * C::kStageC); };
  auto v_s = [&](int st) { return k_s(st) + BN * PQ; };
  float* staging = reinterpret_cast<float*>(smem + C::kOwn + 2 * C::kStageC) + warp * 16 * C::PS;

  int n_kt = (sk_valid + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (min(q0 + BM, Sq) - 1) / BN + 1);
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  auto load_tile = [&](int kt, int st) {
    load_rows<T, DQK, PQ, BN>(k_s(st), kb, ks.s, kt * BN, sk_valid, tid);
    load_rows<T, DV, PV, BN>(v_s(st), vb, vs.s, kt * BN, sk_valid, tid);
  };
  load_rows<T, DQK, PQ, BM>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, Sq, tid);
  load_rows<T, DV, PV, BM>(do_s, dout + b * dos.b + h * dos.h, dos.s, q0, Sq, tid);
  load_tile(0, 0);
  cp_commit();

  // this thread's rows r0 and r0 + 8: lse in log2 units, and Delta
  const int r0 = q0 + 16 * warp + g;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const long long at = ((long long)b * H + h) * Sq + r;
    lse2[i] = r < Sq ? lse[at] * kLog2e : 0.f;
    dl[i] = r < Sq ? delta[at] : 0.f;
  }
  float dq_acc[DQK / 8][4];
  zero(dq_acc);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1, k0 = kt * BN;
    if (kt + 1 < n_kt) load_tile(kt + 1, st ^ 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    // S = Q K^T, then P
    float p[BN / 8][4];
    zero(p);
    product_nt<BN / 8, DQK, PQ, PQ>(p, q_s + 16 * warp * PQ, k_s(st), lane);
    const bool edge = k0 + BN > sk_valid || (causal && k0 + BN - 1 > q0 + 16 * warp);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1), row = r0 + 8 * (e >> 1);
        const float x = exp2_approx(fmaf(p[j][e], scale_log2, -lse2[e >> 1]));
        p[j][e] = edge && (key >= sk_valid || (causal && row < key)) ? 0.f : x;
      }
    // dP = dO V^T, then dS = P o (dP - Delta) in place
    float ds[BN / 8][4];
    zero(ds);
    product_nt<BN / 8, DV, PV, PV>(ds, do_s + 16 * warp * PV, v_s(st), lane);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = p[j][e] * (ds[j][e] - dl[e >> 1]);
    // dQ += dS K (scaled at the end)
    product_acc<T, BN / 8, DQK, PQ, C::PS>(dq_acc, ds, k_s(st), staging, lane);
    __syncthreads();  // the next tile's copies refill this stage
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Sq) continue;
    T* dqr = dq + b * dqs.b + r * dqs.s + h * dqs.h + 2 * t;
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n)
      store2(dqr + 8 * n, dq_acc[n][2 * i] * scale, dq_acc[n][2 * i + 1] * scale);
  }
}

template <typename T, int DQK, int DV>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, void* dq, void* dk, void* dv, float* delta, const long long* st,
           int B, int H, int Hk, int Sq, int Sk, int sk_valid, int causal, float scale,
           cudaStream_t stream) {
  using C = BwdCfg<T, DQK, DV>;
  auto S = [&](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  const T *tq = static_cast<const T*>(q), *tk = static_cast<const T*>(k),
          *tv = static_cast<const T*>(v), *to = static_cast<const T*>(o),
          *tdo = static_cast<const T*>(dout);
  const long long rows = (long long)B * H * Sq;
  flash_bwd_delta_kernel<T, DV><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      to, tdo, delta, S(3), S(4), B, H, Sq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * kLog2e;
  auto kv = flash_bwd_dkdv_kernel<T, DQK, DV>;
  if ((e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)C::kSmemB)) != cudaSuccess)
    return (int)e;
  kv<<<dim3(Hk, B, (Sk + BM - 1) / BM), kThreads, C::kSmemB, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S(0), S(1), S(2),
      S(4), S(6), S(7), H, Hk, Sq, Sk, sk_valid, causal, scale_log2, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  auto qk = flash_bwd_dq_kernel<T, DQK, DV>;
  if ((e = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)C::kSmemC)) != cudaSuccess)
    return (int)e;
  qk<<<dim3(H, B, (Sq + BM - 1) / BM), kThreads, C::kSmemC, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), S(0), S(1), S(2), S(4), S(5), H, Hk, Sq,
      sk_valid, causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

// f(DQK, DV and the element type as template arguments) for a compiled pair of
// head dims and a type, or -1
template <typename F>
long long dispatch(int D, int DV, int is_bf16, F f) {
  auto by_d = [&](auto tag) -> long long {
    using I16 = std::integral_constant<int, 16>;
    using I32 = std::integral_constant<int, 32>;
    using I64 = std::integral_constant<int, 64>;
    using I128 = std::integral_constant<int, 128>;
    using I192 = std::integral_constant<int, 192>;
    if (D == 16 && DV == 16) return f(I16{}, I16{}, tag);
    if (D == 32 && DV == 32) return f(I32{}, I32{}, tag);
    if (D == 64 && DV == 64) return f(I64{}, I64{}, tag);
    if (D == 128 && DV == 128) return f(I128{}, I128{}, tag);
    if (D == 192 && DV == 128) return f(I192{}, I128{}, tag);
    return -1;
  };
  return is_bf16 ? by_d(__nv_bfloat16{}) : by_d(float{});
}

}  // namespace

// q: (B, Sq, H, D); k: (B, Sk, Hk, D); v: (B, Sk, Hk, DV); o and dout (the
// output's cotangent): (B, Sq, H, DV); dq, dk, dv as q, k, v; all f32
// (is_bf16 = 0) or all bf16, each addressed by its (batch, seq, head) strides in
// elements, strides[3 * operand + axis] for operands q, k, v, o, dout, dq, dk,
// dv; the head dim contiguous, every pointer and row 16-byte aligned. lse: (B,
// H, Sq) f32, the forward's log-sum-exp; delta: (B, H, Sq) f32 scratch. (D, DV)
// is (16, 16), (32, 32), (64, 64), (128, 128) or (192, 128); H is a multiple of
// Hk; 1 <= sk_valid <= Sk. Runs three kernels on the stream; returns
// cudaGetLastError() after them, or cudaErrorInvalidValue for arguments it
// does not take.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* lse, const void* dout,
                                          void* dq, void* dk, void* dv, void* delta,
                                          const long long* strides, int B, int H, int Hk, int Sq,
                                          int Sk, int D, int DV, int sk_valid, int causal,
                                          int is_bf16, float scale, void* stream) {
  if (B <= 0 || Hk <= 0 || H % Hk || Sq <= 0 || sk_valid < 1 || sk_valid > Sk)
    return (int)cudaErrorInvalidValue;
  const int elem = is_bf16 ? 2 : 4;
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 24; ++i)
    if (strides[i] * elem % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rc = dispatch(D, DV, is_bf16, [&](auto d, auto dv_, auto tag) -> long long {
    using T = decltype(tag);
    return launch<T, decltype(d)::value, decltype(dv_)::value>(
        q, k, v, o, static_cast<const float*>(lse), dout, dq, dk, dv, static_cast<float*>(delta),
        strides, B, H, Hk, Sq, Sk, sk_valid, causal, scale, s);
  });
  return rc < 0 ? (int)cudaErrorInvalidValue : (int)rc;
}

// The dynamic shared memory, in bytes, of the dK/dV kernel (which = 0) or the
// dQ kernel (which = 1) at head dims (D, DV), or -1.
extern "C" int flash_attention_bwd_smem_bytes(int D, int DV, int is_bf16, int which) {
  return (int)dispatch(D, DV, is_bf16, [&](auto d, auto dv, auto tag) -> long long {
    using C = BwdCfg<decltype(tag), decltype(d)::value, decltype(dv)::value>;
    return which ? (long long)C::kSmemC : (long long)C::kSmemB;
  });
}
