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
// Three kernels and no atomics, so that every gradient is summed in one fixed
// order and two runs give the same bits: Delta (flash_bwd_delta_kernel, a warp
// a row, in f32; flash_bwd_delta_bf16_kernel, 8 lanes a row of 64 by 16-byte
// loads); then dK and dV, a block owning a key tile and walking the group's
// query heads and query tiles in order; then dQ, a block owning a query tile
// and walking the key tiles. dQ in a kernel of its own recomputes S and dP, so
// the design takes seven products a pair where the bound counts five: its own
// floor is ~0.24 ms at the shape above. A fused dQ would need its sums across
// key tiles in a fixed order (a second pass over f32 partials) to stay
// deterministic; the seven-product floor is still 2.5x under SDPA's backward.
// Two routes, by input type.
//
// The bf16 route, as the forward's bf16 route (flash_attention.cu):
// - TMA in. Tensor maps over the caller's strides (hopper.cuh's tensor_map,
//   boxes of 64 along the head with the 128-byte swizzle; D 16 and 32 one box
//   of the head's width with the 32- and 64-byte swizzles) bring every tile
//   into shared memory as wgmma reads it; rows past Sq and Sk come zero-filled.
//   flash_bwd_dkdv_bf16_kernel keeps its 128 keys of K and V resident and
//   streams Q and dO through a ring of stages, BN queries of one head a stage;
//   flash_bwd_dq_bf16_kernel keeps its 128 queries of Q and dO resident and
//   streams K and V, BN keys a stage. Each stage completes on its "full"
//   mbarrier and is handed back on its "empty" one; no block barrier runs per
//   tile. lse and Delta, rows of (B, H, Sq) f32 whose starts need not be 16-byte
//   aligned, reach dK/dV's stages by the producer warp's loads (lse times
//   log2(e)), which arrive on the stage's full barrier beside the TMA's bytes;
//   dQ's rows keep theirs in registers.
// - Warp specialisation: a producer warpgroup, of whose threads one issues
//   every copy (and dK/dV's first warp also loads lse and Delta), and two
//   consumer warpgroups of 64 rows each; setmaxnreg gives the consumers 232
//   registers a thread and the producer 40.
// - wgmma m64nNk16 bf16 with f32 sums; every product takes its operands in a
//   form wgmma reads without staging. dK/dV (rows = keys): S^T = K Q^T and
//   dP^T = V dO^T with both operands K-major from shared memory; dV += P^T dO
//   and dK += dS^T Q with A the scores' accumulator fragment rounded to bf16 in
//   registers (an accumulator's n-tiles 2i and 2i + 1 are the A fragment of
//   k-step i as they stand) and B, dO or Q, MN-major through the transpose
//   bit. dQ (rows = queries): S = Q K^T and dP = dO V^T K-major; dQ += dS K
//   with dS from registers and K MN-major, the same stage read both ways.
// - Tiles: 128 keys (dK/dV) or 128 queries (dQ) a block. A consumer thread
//   holds dK and dV (DQK / 2 + DV / 2 floats: 64 at D 64, 160 at MLA's (192,
//   128)), the scores and dP^T (BN / 2 each) and their bf16 fragments (BN / 4
//   each), so dK/dV walks BN = 128 queries a turn at D <= 64 and 32 above; dQ
//   holds dQ (DQK / 2), S and dP (BN / 2 each) and dS in bf16, so it walks BN =
//   128 keys a turn at D <= 64 and 64 above. The wider the scores' products (N
//   = BN), the closer wgmma comes to its rate: on the H100 dK/dV ran markedly
//   faster with 128 queries a turn than with 64 or 96.
// - A warpgroup's turn: its scores' products, one wait, the exps and dS, then
//   the products that sum dV and dK (or dQ). Where the registers hold both
//   turns' operands (dK/dV at BN 32; dQ), those products and the next turn's
//   scores go as one wgmma group, so a warpgroup waits once a turn; dK/dV at
//   BN 128 holds no room for that and waits twice. The two consumer
//   warpgroups run free: on the H100, handing the tensor cores from one to
//   the other (once a group was issued, or once it was done) was slower, and
//   K and V held as register A fragments gained nothing.
// - The mask runs on the tiles it touches only (the causal diagonal and the
//   ragged tails), by a uniform branch: the exps, not the products, bound a
//   turn, and index arithmetic on every element had made them slower still.
// - The causal tail: the grid is persistent, one block a multiprocessor, block
//   c of G taking the work items c, c + G, ...; under the causal mask, with
//   more tiles than blocks, an item is a pair of tiles of one head, the
//   longest and the shortest left, so that every item holds the same number of
//   turns and the blocks finish together (dK/dV: key tiles p and n - 1 - p,
//   the first the longest; dQ: query tiles n - 1 - p and p). Items of one head
//   are neighbours, so the blocks at work at a time share their streamed tiles
//   in L2. A block's K and V (or Q and dO) are handed back as soon as its last
//   turn's scores are in, so the next item's copies overlap its last products
//   and its stores.
// - dK and dV sum a whole item (G x Sq queries: 16,384 at the shape above) in
//   the tensor cores' f32 accumulators, as dQ sums its keys; the bf16 checks
//   (2^-6 of each gradient's largest entry) leave room for their rounding.
// - The exp is ex2.approx of S c - lse log2(e), c = scale log2(e), in one
//   multiply-add.
//
// The f32 route, on the CUDA cores (no TF32, so a training step in f32 stays
// within 1e-5 of the CPU's): flash_bwd_dkdv_kernel, a block per (batch, KV
// head, 64-key tile), a warp per 16 keys, K and V of the tile in shared memory
// and Q, dO, lse and Delta double-buffered by cp.async (BN rows a turn); each
// turn recomputes S^T and P^T, then dV += P^T dO, dP^T = V dO^T, dS^T and dK +=
// dS^T Q. flash_bwd_dq_kernel, a block per (batch, head, 64-query tile), Q and
// dO in shared memory, walking the key tiles, K and V in two cp.async stages.
// The fragments take the layout of the tensor cores' m16n8 accumulator (a
// warp's 16 rows, lane g = lane / 4 holding rows g and g + 8), summed with
// FMAs; P and dS pass through a warp's 16 rows of shared memory to reach the
// products that read them. dK,
// dV and dQ take each tile's sum on its own before adding it: one chain of FMAs
// over a head group's 16,384 queries (tinyllama's shape) strays ~sqrt(16,384)
// ulps of the running sum, ~1e-4 at |dV| ~10, as far as f32 blockwise
// attention's autograd lies from the exact gradient, where the checks hold
// 1e-5. BN is 64 at DQK <= 64 and 32 above it, where the accumulators (dK is
// DQK / 2 registers a thread, 96 at MLA's 192) leave no room for 64 columns of
// scores.

#include <type_traits>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// The f32 route
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int BM = 16 * kWarps;  // the rows a block owns: keys in dK/dV, queries in dQ

template <int DQK, int DV>
struct F32Cfg {
  static constexpr int BN = DQK <= 64 ? 64 : 32;  // the tile a block walks
  static constexpr int kPad = 4;  // 16 bytes of padding a row
  static constexpr int PQ = DQK + kPad, PV = DV + kPad;  // row pitches, in elements
  static constexpr int PS = BN + 4;  // the staging of P or dS, a warp's 16 rows
  // dK/dV: K and V (BM rows); then two stages of Q and dO (BN rows), lse and Delta
  static constexpr size_t kOwn = (size_t)BM * (PQ + PV) * 4;
  static constexpr size_t kStageB = (size_t)BN * (PQ + PV) * 4 + 2 * BN * 4;
  static constexpr size_t kStaging = (size_t)kWarps * 16 * PS * 4;
  static constexpr size_t kSmemB = kOwn + 2 * kStageB + kStaging;
  // dQ: Q and dO (BM rows); then two stages of K and V (BN rows)
  static constexpr size_t kStageC = (size_t)BN * (PQ + PV) * 4;
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
template <int W, int P, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* base, long long stride,
                                          int row0, int n_valid, int tid) {
  constexpr int kPer = 4, kChunks = W / kPer;
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

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The fragment every product below sums into: a warp's 16 rows by NT n-tiles
// of 8 columns; lane (g = lane / 4, t = lane % 4) holds acc[j][e], row g + 8
// (e / 2), column 8 j + 2 t + e % 2.

// acc += A B^T: A the warp's 16 rows, B NT * 8 rows, both K wide, row-major in
// shared memory at pitches PA and PB, by FMAs
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

// acc += A B: A the warp's 16 rows of K in shared memory at pitch PA (its
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

// acc += X B, X an accumulator (P or dS, the warp's 16 rows by NT * 8) and B
// its NT * 8 rows of N columns in shared memory at pitch PB, through the
// warp's 16 rows of staging (pitch PS)
template <int NT, int N, int PB, int PS>
__device__ __forceinline__ void product_acc(float (&acc)[N / 8][4], const float (&x)[NT][4],
                                            const float* b, float* staging, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store2(staging + g * PS + 8 * j + 2 * t, x[j][0], x[j][1]);
    store2(staging + (g + 8) * PS + 8 * j + 2 * t, x[j][2], x[j][3]);
  }
  __syncwarp();
  product_rn<N / 8, NT * 8, PS, PB>(acc, staging, b, lane);
  __syncwarp();
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// The f32 route's Delta = rowsum(dO o O), one warp a row, the rows in
// (batch, head, query) order as lse; lanes sum columns lane, lane + 32, ...,
// then a fixed tree
template <int DV>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, Strides os, Strides dos, int B, int H, int Sq) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)B * H * Sq) return;
  const int s = (int)(row % Sq), h = (int)(row / Sq % H), b = (int)(row / Sq / H);
  const float* orow = o + b * os.b + s * os.s + h * os.h;
  const float* drow = dout + b * dos.b + s * dos.s + h * dos.h;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < DV; c += 32) acc = fmaf(orow[c], drow[c], acc);
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[row] = acc;
}

// The bf16 route's Delta: DV / 8 lanes a row, each summing 8 columns (one
// 16-byte load of O and of dO), then a fixed tree over the row's lanes
template <int DV>
__global__ void __launch_bounds__(256)
flash_bwd_delta_bf16_kernel(const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                            Strides os, Strides dos, int B, int H, int Sq) {
  constexpr int L = DV / 8;  // lanes a row
  const long long row = ((long long)blockIdx.x * 256 + threadIdx.x) / L;
  const int c = 8 * (threadIdx.x % L);
  if (row >= (long long)B * H * Sq) return;
  const int s = (int)(row % Sq), h = (int)(row / Sq % H), b = (int)(row / Sq / H);
  const uint4 x = *reinterpret_cast<const uint4*>(o + b * os.b + s * os.s + h * os.h + c);
  const uint4 y = *reinterpret_cast<const uint4*>(dout + b * dos.b + s * dos.s + h * dos.h + c);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(a.y, d.y, fmaf(a.x, d.x, acc));
  }
#pragma unroll
  for (int m = L / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (threadIdx.x % L == 0) delta[row] = acc;
}

// The f32 route's dK and dV of one (batch, KV head, BM-key tile): the source
// note above.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, Strides qs, Strides ks,
                      Strides vs, Strides dos, Strides dks, Strides dvs, int H, int Hk, int Sq,
                      int Sk, int sk_valid, int causal, float scale_log2, float scale) {
  using C = F32Cfg<DQK, DV>;
  constexpr int BN = C::BN, PQ = C::PQ, PV = C::PV;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BM;  // longest causal tiles first
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int G = H / Hk;
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + BM * PQ;
  auto q_s = [&](int st) { return reinterpret_cast<float*>(smem + C::kOwn + st * C::kStageB); };
  auto do_s = [&](int st) { return q_s(st) + BN * PQ; };
  auto lse_s = [&](int st) { return do_s(st) + BN * PV; };
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
    load_rows<DQK, PQ, BN>(q_s(st), q + b * qs.b + h * qs.h, qs.s, q0, Sq, tid);
    load_rows<DV, PV, BN>(do_s(st), dout + b * dos.b + h * dos.h, dos.s, q0, Sq, tid);
    const long long row = ((long long)b * H + h) * Sq;
    load_vec(lse_s(st), lse + row, q0, BN, Sq, tid);
    load_vec(dl_s(st), delta + row, q0, BN, Sq, tid);
  };
  if (n_turns > 0) {
    load_rows<DQK, PQ, BM>(k_s, k + b * ks.b + hk * ks.h, ks.s, k0, Sk, tid);
    load_rows<DV, PV, BM>(v_s, v + b * vs.b + hk * vs.h, vs.s, k0, Sk, tid);
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
    product_acc<BN / 8, DV, PV, C::PS>(dv_acc, p, do_s(st), staging, lane);
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
    product_acc<BN / 8, DQK, PQ, C::PS>(dk_acc, ds, q_s(st), staging, lane);
    __syncthreads();  // the next turn's copies refill this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + 8 * i;
    if (key >= Sk) continue;
    float* dkr = dk + b * dks.b + key * dks.s + hk * dks.h + 2 * t;
    float* dvr = dv + b * dvs.b + key * dvs.s + hk * dvs.h + 2 * t;
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n)
      store2(dkr + 8 * n, dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) store2(dvr + 8 * n, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
  }
}

// The f32 route's dQ of one (batch, head, BM-query tile): the source note above.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, Strides qs, Strides ks, Strides vs, Strides dos,
                    Strides dqs, int H, int Hk, int Sq, int sk_valid, int causal,
                    float scale_log2, float scale) {
  using C = F32Cfg<DQK, DV>;
  constexpr int BN = C::BN, PQ = C::PQ, PV = C::PV;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // longest causal tiles first
  const int kh = h / (H / Hk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* q_s = reinterpret_cast<float*>(smem);
  float* do_s = q_s + BM * PQ;
  auto k_s = [&](int st) { return reinterpret_cast<float*>(smem + C::kOwn + st * C::kStageC); };
  auto v_s = [&](int st) { return k_s(st) + BN * PQ; };
  float* staging = reinterpret_cast<float*>(smem + C::kOwn + 2 * C::kStageC) + warp * 16 * C::PS;

  int n_kt = (sk_valid + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (min(q0 + BM, Sq) - 1) / BN + 1);
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  auto load_tile = [&](int kt, int st) {
    load_rows<DQK, PQ, BN>(k_s(st), kb, ks.s, kt * BN, sk_valid, tid);
    load_rows<DV, PV, BN>(v_s(st), vb, vs.s, kt * BN, sk_valid, tid);
  };
  load_rows<DQK, PQ, BM>(q_s, q + b * qs.b + h * qs.h, qs.s, q0, Sq, tid);
  load_rows<DV, PV, BM>(do_s, dout + b * dos.b + h * dos.h, dos.s, q0, Sq, tid);
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
    product_acc<BN / 8, DQK, PQ, C::PS>(dq_acc, ds, k_s(st), staging, lane);
    __syncthreads();  // the next tile's copies refill this stage
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Sq) continue;
    float* dqr = dq + b * dqs.b + r * dqs.s + h * dqs.h + 2 * t;
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n)
      store2(dqr + 8 * n, dq_acc[n][2 * i] * scale, dq_acc[n][2 * i + 1] * scale);
  }
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, void* dq, void* dk, void* dv, float* delta, const long long* st,
               int B, int H, int Hk, int Sq, int Sk, int sk_valid, int causal, float scale,
               cudaStream_t stream) {
  using C = F32Cfg<DQK, DV>;
  auto S = [&](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  const float *tq = static_cast<const float*>(q), *tk = static_cast<const float*>(k),
              *tv = static_cast<const float*>(v), *to = static_cast<const float*>(o),
              *tdo = static_cast<const float*>(dout);
  const long long rows = (long long)B * H * Sq;
  flash_bwd_delta_kernel<DV><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      to, tdo, delta, S(3), S(4), B, H, Sq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const float scale_log2 = scale * kLog2e;
  auto kv = flash_bwd_dkdv_kernel<DQK, DV>;
  if ((e = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)C::kSmemB)) != cudaSuccess)
    return (int)e;
  kv<<<dim3(Hk, B, (Sk + BM - 1) / BM), kThreads, C::kSmemB, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), S(0), S(1),
      S(2), S(4), S(6), S(7), H, Hk, Sq, Sk, sk_valid, causal, scale_log2, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  auto qk = flash_bwd_dq_kernel<DQK, DV>;
  if ((e = cudaFuncSetAttribute(qk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)C::kSmemC)) != cudaSuccess)
    return (int)e;
  qk<<<dim3(H, B, (Sq + BM - 1) / BM), kThreads, C::kSmemC, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<float*>(dq), S(0), S(1), S(2), S(4), S(5), H, Hk,
      Sq, sk_valid, causal, scale_log2, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 route
// ---------------------------------------------------------------------------
constexpr int kBf16Threads = 3 * 128;  // the producer warpgroup, then two consumers
constexpr int kConsumers = 256;  // the consumers' threads: every "empty" barrier's count
constexpr int kConsumerRegs = 232, kProducerRegs = 40;  // setmaxnreg's shares
constexpr int kSmemMax = 232448;  // what a block may take
// A bf16 operand's tile as TMA lands it and wgmma reads it: boxes of kRow
// bytes a row, which is also the swizzle span, 64 elements (128 bytes) of a
// head, or the whole head at widths 16 and 32; a tile of `rows` rows is kNb
// boxes across the head, each rows x kRow bytes, one after another.
template <int D>
struct Head {
  static constexpr int kRow = D >= 64 ? 128 : 2 * D;
  static constexpr int kBox = kRow / 2;  // elements of a box row
  static constexpr int kNb = D / kBox;
};

// dK/dV: 128 resident keys of K and V; stages of BN queries of Q and dO, then
// each stage's lse (times log2 e) and Delta, then the mbarriers
template <int DQK, int DV>
struct KvCfg {
  static constexpr int BM = 128, BN = DQK <= 64 ? 128 : 32;
  // a turn's dV and dK in one wgmma group with the next turn's scores where
  // the registers hold both turns' operands (BN 32), else two groups
  static constexpr bool kMerge = BN <= 64;
  static constexpr uint32_t kK = BM * DQK * 2, kV = BM * DV * 2;
  static constexpr uint32_t kQ = BN * DQK * 2, kDO = BN * DV * 2, kVec = 2 * BN * 4;
  static constexpr int kFit = (kSmemMax - 1024 - 256 - (int)(kK + kV)) / (int)(kQ + kDO + kVec);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kTiles = kK + kV + (size_t)kStages * (kQ + kDO);
  static constexpr size_t kBars = kTiles + (size_t)kStages * kVec;
  static constexpr size_t kSmem = 1024 + kBars + (2 + 2 * kStages) * 8;
  static_assert(kStages >= 2, "two stages of Q and dO must fit beside K and V");
};

// dQ: 128 resident queries of Q and dO; stages of BN keys of K and V, then the
// mbarriers
template <int DQK, int DV>
struct QCfg {
  static constexpr int BM = 128, BN = DQK <= 64 ? 128 : 64;
  static constexpr uint32_t kQ = BM * DQK * 2, kDO = BM * DV * 2;
  static constexpr uint32_t kK = BN * DQK * 2, kV = BN * DV * 2;
  static constexpr int kFit = (kSmemMax - 1024 - 256 - (int)(kQ + kDO)) / (int)(kK + kV);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kBars = kQ + kDO + (size_t)kStages * (kK + kV);
  static constexpr size_t kSmem = 1024 + kBars + (2 + 2 * kStages) * 8;
  static_assert(kStages >= 2, "two stages of K and V must fit beside Q and dO");
};

// The persistent blocks' work: block c of G takes items c, c + G, ...; item w
// is tile slot p = w % n_per of head w / n_per % heads of batch w / n_per /
// heads. Its first tile is the longer of slot p's pair, and with `pair` (the
// causal mask, more tiles than blocks) its second the shorter, so that every
// item holds as many turns: the longest tile is the last one of a head where
// `last_longest` (dQ's query tiles), else the first (dK/dV's key tiles).
struct Items {
  int n_tiles, heads, pair, n_per, n_items;
  bool last_longest;
  __device__ Items(int n_tiles_, int heads_, int B, int pair_, bool last_longest_)
      : n_tiles(n_tiles_), heads(heads_), pair(pair_), last_longest(last_longest_) {
    n_per = pair ? (n_tiles + 1) / 2 : n_tiles;
    n_items = n_per * heads * B;
  }
  __device__ int halves(int w) const { return pair && 2 * (w % n_per) + 1 != n_tiles ? 2 : 1; }
  // the tile, head and batch of item w's half
  __device__ void at(int w, int half, int& tile, int& head, int& b) const {
    const int p = w % n_per, hb = w / n_per;
    const int from_longest = half ? n_tiles - 1 - p : p;
    tile = last_longest ? n_tiles - 1 - from_longest : from_longest;
    head = hb % heads;
    b = hb / heads;
  }
};

// The items and the blocks of a persistent launch over n_tiles tiles of
// `heads` heads of B batches
struct Grid {
  int pair, blocks;
};
Grid persistent_grid(long long n_tiles, long long heads, long long B, int causal, int n_sm) {
  const int pair = causal && n_tiles * heads * B > n_sm;
  const long long n_items = (pair ? (n_tiles + 1) / 2 : n_tiles) * heads * B;
  return Grid{pair, (int)(n_items < n_sm ? n_items : n_sm)};
}

// an accumulator of NT n-tiles as bf16 A fragments of the next product:
// k-step i is n-tiles 2i and 2i + 1, in the fragment's own order
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

// acc (+)= A B^T over the head (k-steps of 16 along D): A `a_rows` (a
// warpgroup's 64 rows of a tile of RA rows), B a tile of N rows, both as TMA
// lands them, K-major; issued, not waited for
template <int D, int N, int RA>
__device__ __forceinline__ void product_ss(float (&acc)[N / 8][4], const char* a_rows,
                                           const char* b_tile) {
  using HD = Head<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / (HD::kBox / 16), off = 32 * (kk % (HD::kBox / 16));
    const uint64_t a = sw_desc<HD::kRow>(a_rows + box * RA * HD::kRow + off, 16, 8 * HD::kRow);
    const uint64_t b = sw_desc<HD::kRow>(b_tile + box * N * HD::kRow + off, 16, 8 * HD::kRow);
    wgmma_bf16_ss<N>(acc, a, b, kk > 0);
  }
}
// acc += A B: A in registers (K / 16 k-steps of fragments), B a tile of K rows
// by D columns as TMA lands it, read MN-major (16 rows a k-step, its boxes
// K x kRow bytes apart); issued, not waited for
template <int D, int K>
__device__ __forceinline__ void product_rs(float (&acc)[D / 8][4], const uint32_t (&a)[K / 16][4],
                                           const char* b_tile) {
  using HD = Head<D>;
#pragma unroll
  for (int i = 0; i < K / 16; ++i) {
    const uint64_t b = sw_desc<HD::kRow>(b_tile + i * 16 * HD::kRow, K * HD::kRow, 8 * HD::kRow);
    wgmma_bf16_rs<D>(acc, a[i], b, 1);
  }
}

// a TMA tile of `rows` rows at (s0, head, b) of `map`: its kNb boxes
template <int D>
__device__ __forceinline__ void tma_tile(char* dst, const CUtensorMap* map, uint64_t* bar,
                                         int rows, int s0, int head, int b) {
  using HD = Head<D>;
#pragma unroll
  for (int j = 0; j < HD::kNb; ++j)
    tma_load(dst + j * rows * HD::kRow, map, bar, j * HD::kBox, s0, head, b);
}

// The bf16 route's dK and dV (the source note above): 128 keys of one (batch,
// KV head) an item, a consumer warpgroup's 64 rows each; a turn is BN queries
// of one query head of the group, the heads in order and in each the query
// tiles the mask leaves.
template <int DQK, int DV>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                           const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, Strides dks, Strides dvs, int B, int H,
                           int Hk, int Sq, int Sk, int sk_valid, int causal, int pair,
                           float scale_log2, float scale) {
  using C = KvCfg<DQK, DV>;
  using HQ = Head<DQK>;
  using HV = Head<DV>;
  constexpr int BM = C::BM, BN = C::BN, NS = C::kStages;
  extern __shared__ float4 smem4[];
  // tiles on 1 KB, the period of the 128-byte swizzle that TMA and wgmma share
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem4);
  char* smem = reinterpret_cast<char*>(smem4) + ((1024 - (raw & 1023)) & 1023);
  char* k_tile = smem;
  char* v_tile = smem + C::kK;
  auto q_tile = [&](int st) { return smem + C::kK + C::kV + st * (size_t)(C::kQ + C::kDO); };
  auto do_tile = [&](int st) { return q_tile(st) + C::kQ; };
  auto lse_s = [&](int st) { return reinterpret_cast<float*>(smem + C::kTiles) + st * 2 * BN; };
  auto dl_s = [&](int st) { return lse_s(st) + BN; };
  // kv_full: the item's K and V have landed; kv_empty: every consumer is done
  // with them; full[s]: stage s's Q, dO, lse and Delta are in; empty[s]: every
  // consumer is done with stage s
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_full + 2;
  uint64_t* empty = full + NS;

  const int G = H / Hk;
  const int n_qt = (Sq + BN - 1) / BN;
  const Items items((Sk + BM - 1) / BM, Hk, B, pair, false);
  struct Work {
    int k0, hk, b, qt0, per_head, n_turns;
  };
  // turns: each query head of the group, and in it the query tiles from the
  // one that holds query k0 (causal: the earlier see none of these keys)
  auto work = [&](int w, int half) {
    Work u;
    int kt;
    items.at(w, half, kt, u.hk, u.b);
    u.k0 = kt * BM;
    u.qt0 = causal ? min(u.k0 / BN, n_qt) : 0;
    u.per_head = u.k0 < sk_valid ? n_qt - u.qt0 : 0;
    u.n_turns = G * u.per_head;
    return u;
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(kv_full, 1);
    bar_init(kv_empty, kConsumers);
    for (int i = 0; i < NS; ++i) {
      // the TMA's arrival, with its bytes, and the producer warp's 32 lanes',
      // each after its stores of lse and Delta
      bar_init(full + i, 33);
      bar_init(empty + i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer warpgroup: its first warp fills the stages, lane 0 issuing
    // the copies, every lane loading its share of lse and Delta
    regs_down<kProducerRegs>();
    if (tid < 32) {
      const int lane = tid;
      int it = 0, wi = 0;  // the ring's turns and the items' halves so far
      for (int w = blockIdx.x; w < items.n_items; w += gridDim.x)
        for (int half = 0; half < items.halves(w); ++half, ++wi) {
          const Work u = work(w, half);
          if (lane == 0) {
            if (wi > 0) bar_wait(kv_empty, (wi - 1) & 1);
            bar_expect(kv_full, C::kK + C::kV);
            tma_tile<DQK>(k_tile, &tk, kv_full, BM, u.k0, u.hk, u.b);
            tma_tile<DV>(v_tile, &tv, kv_full, BM, u.k0, u.hk, u.b);
          }
          for (int i = 0; i < u.n_turns; ++i, ++it) {
            const int h = u.hk * G + i / u.per_head, q0 = (u.qt0 + i % u.per_head) * BN;
            const long long row = ((long long)u.b * H + h) * Sq;
            float l[BN / 32], d[BN / 32];  // loaded before the wait for the stage
#pragma unroll
            for (int c = 0; c < BN / 32; ++c) {
              const int qi = q0 + lane + 32 * c;
              l[c] = qi < Sq ? lse[row + qi] * kLog2e : 0.f;
              d[c] = qi < Sq ? delta[row + qi] : 0.f;
            }
            const int st = it % NS;
            if (it >= NS) bar_wait(empty + st, (it / NS - 1) & 1);
            if (lane == 0) {
              bar_expect(full + st, C::kQ + C::kDO);
              tma_tile<DQK>(q_tile(st), &tq, full + st, BN, q0, h, u.b);
              tma_tile<DV>(do_tile(st), &tdo, full + st, BN, q0, h, u.b);
            }
#pragma unroll
            for (int c = 0; c < BN / 32; ++c) {
              lse_s(st)[lane + 32 * c] = l[c];
              dl_s(st)[lane + 32 * c] = d[c];
            }
            bar_arrive(full + st);
          }
        }
    }
    return;
  }

  regs_up<kConsumerRegs>();
  const int ct = tid - 128, cw = ct >> 7, warp = (ct >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and column pair
  const char* k_rows = k_tile + cw * 64 * HQ::kRow;  // this warpgroup's keys of each box
  const char* v_rows = v_tile + cw * 64 * HV::kRow;

  float dk_acc[DQK / 8][4], dv_acc[DV / 8][4];
  float s[BN / 8][4], dp[BN / 8][4];  // S^T then P^T; dP^T then dS^T
  uint32_t pa[BN / 16][4], da[BN / 16][4];  // P^T and dS^T in bf16, as A fragments
  // S^T = K Q^T and dP^T = V dO^T of the turn in stage `st`, once it is in
  auto issue_scores = [&](int st, int it_) {
    bar_wait(full + st, (it_ / NS) & 1);
    product_ss<DQK, BN, BM>(s, k_rows, q_tile(st));
    product_ss<DV, BN, BM>(dp, v_rows, do_tile(st));
  };
  int it = 0, wi = 0;
  for (int w = blockIdx.x; w < items.n_items; w += gridDim.x)
    for (int half = 0; half < items.halves(w); ++half, ++wi) {
      const Work u = work(w, half);
      const int key0 = u.k0 + 64 * cw + 16 * warp + g;  // this thread's keys: key0, key0 + 8
      zero(dk_acc);
      zero(dv_acc);
      bar_wait(kv_full, wi & 1);
      if (u.n_turns == 0) bar_arrive(kv_empty);
      // Turn i's dV and dK, then turn i + 1's scores: one wgmma group where
      // kMerge, so that a warpgroup waits once a turn and the tensor cores
      // take its products back to back, else two; the first turn's scores go
      // alone.
      if (u.n_turns > 0) {
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        issue_scores(it % NS, it);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
      }
      for (int i = 0; i < u.n_turns; ++i, ++it) {
        const int st = it % NS, q0 = (u.qt0 + i % u.per_head) * BN;
        const bool next = i + 1 < u.n_turns;
        if (!next) bar_arrive(kv_empty);  // K and V are read no more

        // P^T, then dS^T = P^T o (dP^T - Delta); element (j, e) is key key0 +
        // 8 (e >> 1) and query q0 + 8 j + 2 t + (e & 1). The mask runs on the
        // tiles it touches only: there a row keeps the columns c = 8 j + (e &
        // 1) from lo (causal: its key) to below hi (Sq), none at or past
        // sk_valid.
        const float* ls = lse_s(st);
        const float* dl = dl_s(st);
        auto alu = [&](auto masked) {
          int lo[2], hi = Sq - q0 - 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int key = key0 + 8 * r;
            lo[r] = key >= sk_valid ? BN : (causal ? key - q0 - 2 * t : -BN);
          }
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
            const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = exp2_approx(fmaf(s[j][e], scale_log2, -(e & 1 ? l2.y : l2.x)));
              if constexpr (decltype(masked)::value) {
                const int c = 8 * j + (e & 1);
                if (c < lo[e >> 1] || c >= hi) p = 0.f;
              }
              s[j][e] = p;
              dp[j][e] = p * (dp[j][e] - (e & 1 ? d2.y : d2.x));
            }
          }
        };
        if (u.k0 + BM > sk_valid || q0 + BN > Sq || (causal && q0 < u.k0 + BM))
          alu(std::true_type{});
        else
          alu(std::false_type{});
        to_a<BN / 8>(pa, s);
        to_a<BN / 8>(da, dp);

        // dV += P^T dO and dK += dS^T Q (scaled at the end), then the next
        // turn's S^T and dP^T
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(pa);
        fence_regs(da);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        product_rs<DV, BN>(dv_acc, pa, do_tile(st));
        product_rs<DQK, BN>(dk_acc, da, q_tile(st));
        if (!C::kMerge) {
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          wgmma_fence();
        }
        if (next) issue_scores((it + 1) % NS, it + 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        fence_regs(s);
        fence_regs(dp);
        bar_arrive(empty + st);
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * i;
        if (key >= Sk) continue;
        __nv_bfloat16* dkr = dk + u.b * dks.b + key * dks.s + u.hk * dks.h + 2 * t;
        __nv_bfloat16* dvr = dv + u.b * dvs.b + key * dvs.s + u.hk * dvs.h + 2 * t;
#pragma unroll
        for (int n = 0; n < DQK / 8; ++n)
          store2(dkr + 8 * n, dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
#pragma unroll
        for (int n = 0; n < DV / 8; ++n)
          store2(dvr + 8 * n, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
}

// The bf16 route's dQ (the source note above): 128 queries of one (batch,
// head) an item, a consumer warpgroup's 64 rows each; a turn is BN keys.
template <int DQK, int DV>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                         const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                         Strides dqs, int B, int H, int Hk, int Sq, int sk_valid, int causal,
                         int pair, float scale_log2, float scale) {
  using C = QCfg<DQK, DV>;
  using HQ = Head<DQK>;
  using HV = Head<DV>;
  constexpr int BM = C::BM, BN = C::BN, NS = C::kStages;
  extern __shared__ float4 smem4[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem4);
  char* smem = reinterpret_cast<char*>(smem4) + ((1024 - (raw & 1023)) & 1023);
  char* q_tile = smem;
  char* do_tile = smem + C::kQ;
  auto k_tile = [&](int st) { return smem + C::kQ + C::kDO + st * (size_t)(C::kK + C::kV); };
  auto v_tile = [&](int st) { return k_tile(st) + C::kK; };
  // q_full: the item's Q and dO have landed; q_empty: every consumer is done
  // with them; full[s], empty[s]: stage s's K and V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full = q_full + 2;
  uint64_t* empty = full + NS;

  const Items items((Sq + BM - 1) / BM, H, B, pair, true);
  struct Work {
    int q0, h, b, kh, n_kt;
  };
  auto work = [&](int w, int half) {
    Work u;
    int qt;
    items.at(w, half, qt, u.h, u.b);
    u.q0 = qt * BM;
    u.kh = u.h / (H / Hk);
    u.n_kt = (sk_valid + BN - 1) / BN;
    if (causal) u.n_kt = min(u.n_kt, (min(u.q0 + BM, Sq) - 1) / BN + 1);
    return u;
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(q_full, 1);
    bar_init(q_empty, kConsumers);
    for (int i = 0; i < NS; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer warpgroup: its first thread issues every copy, a stage's K
    // and V once the consumers are done with its last, an item's Q and dO once
    // they are done with the last item's
    regs_down<kProducerRegs>();
    if (tid == 0) {
      int it = 0, wi = 0;
      for (int w = blockIdx.x; w < items.n_items; w += gridDim.x)
        for (int half = 0; half < items.halves(w); ++half, ++wi) {
          const Work u = work(w, half);
          for (int kt = 0; kt < u.n_kt; ++kt, ++it) {
            const int st = it % NS;
            if (it >= NS) bar_wait(empty + st, (it / NS - 1) & 1);
            bar_expect(full + st, C::kK + C::kV);
            tma_tile<DQK>(k_tile(st), &tk, full + st, BN, kt * BN, u.kh, u.b);
            tma_tile<DV>(v_tile(st), &tv, full + st, BN, kt * BN, u.kh, u.b);
            if (kt == 0) {
              if (wi > 0) bar_wait(q_empty, (wi - 1) & 1);
              bar_expect(q_full, C::kQ + C::kDO);
              tma_tile<DQK>(q_tile, &tq, q_full, BM, u.q0, u.h, u.b);
              tma_tile<DV>(do_tile, &tdo, q_full, BM, u.q0, u.h, u.b);
            }
          }
        }
    }
    return;
  }

  regs_up<kConsumerRegs>();
  const int ct = tid - 128, cw = ct >> 7, warp = (ct >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const char* q_rows = q_tile + cw * 64 * HQ::kRow;  // this warpgroup's queries of each box
  const char* do_rows = do_tile + cw * 64 * HV::kRow;

  float dq_acc[DQK / 8][4];
  float s[BN / 8][4], dp[BN / 8][4];  // S; dP then dS
  uint32_t da[BN / 16][4];  // dS in bf16, as A fragments
  // S = Q K^T and dP = dO V^T of the key tile in stage `st`, once it is in
  auto issue_scores = [&](int st, int it_) {
    bar_wait(full + st, (it_ / NS) & 1);
    product_ss<DQK, BN, BM>(s, q_rows, k_tile(st));
    product_ss<DV, BN, BM>(dp, do_rows, v_tile(st));
  };
  int it = 0, wi = 0;
  for (int w = blockIdx.x; w < items.n_items; w += gridDim.x)
    for (int half = 0; half < items.halves(w); ++half, ++wi) {
      const Work u = work(w, half);
      const int w0 = u.q0 + 64 * cw + 16 * warp;  // this warp's first query
      const int r0 = w0 + g;  // this thread's rows: r0, r0 + 8
      // lse in log2 units, and Delta, of the thread's two rows
      float lse2[2], dl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const long long at = ((long long)u.b * H + u.h) * Sq + r;
        lse2[i] = r < Sq ? lse[at] * kLog2e : 0.f;
        dl[i] = r < Sq ? delta[at] : 0.f;
      }
      zero(dq_acc);
      bar_wait(q_full, wi & 1);
      // one wgmma group a turn, as in dK/dV: key tile kt's dQ with tile kt +
      // 1's scores
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_scores(it % NS, it);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      for (int kt = 0; kt < u.n_kt; ++kt, ++it) {
        const int st = it % NS, k0 = kt * BN;
        const bool next = kt + 1 < u.n_kt;
        if (!next) bar_arrive(q_empty);  // Q and dO are read no more

        // P, then dS = P o (dP - Delta); element (j, e) is row r0 + 8 (e >> 1)
        // and key k0 + 8 j + 2 t + (e & 1). The mask runs on the tiles it
        // touches only: there a row keeps the columns c = 8 j + (e & 1) below
        // min(sk_valid, its row + 1 if causal), relative to k0 + 2 t.
        auto alu = [&](auto masked) {
          int keep[2];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            keep[r] = (causal ? min(sk_valid, r0 + 8 * r + 1) : sk_valid) - k0 - 2 * t;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float p = exp2_approx(fmaf(s[j][e], scale_log2, -lse2[e >> 1]));
              if constexpr (decltype(masked)::value)
                if (8 * j + (e & 1) >= keep[e >> 1]) p = 0.f;
              dp[j][e] = p * (dp[j][e] - dl[e >> 1]);
            }
        };
        if (k0 + BN > sk_valid || (causal && k0 + BN - 1 > w0))
          alu(std::true_type{});
        else
          alu(std::false_type{});
        to_a<BN / 8>(da, dp);

        // dQ += dS K (scaled at the end), K read MN-major; then the next key
        // tile's S and dP
        fence_regs(dq_acc);
        fence_regs(da);
        fence_regs(s);
        fence_regs(dp);
        wgmma_fence();
        product_rs<DQK, BN>(dq_acc, da, k_tile(st));
        if (next) issue_scores((it + 1) % NS, it + 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
        fence_regs(s);
        fence_regs(dp);
        bar_arrive(empty + st);
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        if (r >= Sq) continue;
        __nv_bfloat16* dqr = dq + u.b * dqs.b + r * dqs.s + u.h * dqs.h + 2 * t;
#pragma unroll
        for (int n = 0; n < DQK / 8; ++n)
          store2(dqr + 8 * n, dq_acc[n][2 * i] * scale, dq_acc[n][2 * i + 1] * scale);
      }
    }
}

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, const void* o, const float* lse,
                const void* dout, void* dq, void* dk, void* dv, float* delta, const long long* st,
                int B, int H, int Hk, int Sq, int Sk, int sk_valid, int causal, float scale,
                cudaStream_t stream) {
  using KC = KvCfg<DQK, DV>;
  using QC = QCfg<DQK, DV>;
  using HQ = Head<DQK>;
  using HV = Head<DV>;
  auto S = [&](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  const long long rows = (long long)B * H * Sq;
  flash_bwd_delta_bf16_kernel<DV><<<(unsigned)((rows * (DV / 8) + 255) / 256), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta, S(3),
      S(4), B, H, Sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dK/dV's maps: Q and dO in stages of KC::BN rows, K and V in 128; dQ's: Q
  // and dO in 128, K and V in stages of QC::BN
  CUtensorMap kq, kk, kv, kdo, qq, qk, qv, qdo;
  int e = tensor_map(&kq, q, DQK, Sq, H, B, st, HQ::kBox, KC::BN, HQ::kRow);
  if (!e) e = tensor_map(&kdo, dout, DV, Sq, H, B, st + 12, HV::kBox, KC::BN, HV::kRow);
  if (!e) e = tensor_map(&kk, k, DQK, Sk, Hk, B, st + 3, HQ::kBox, KC::BM, HQ::kRow);
  if (!e) e = tensor_map(&kv, v, DV, Sk, Hk, B, st + 6, HV::kBox, KC::BM, HV::kRow);
  if (!e) e = tensor_map(&qq, q, DQK, Sq, H, B, st, HQ::kBox, QC::BM, HQ::kRow);
  if (!e) e = tensor_map(&qdo, dout, DV, Sq, H, B, st + 12, HV::kBox, QC::BM, HV::kRow);
  if (!e) e = tensor_map(&qk, k, DQK, Sk, Hk, B, st + 3, HQ::kBox, QC::BN, HQ::kRow);
  if (!e) e = tensor_map(&qv, v, DV, Sk, Hk, B, st + 6, HV::kBox, QC::BN, HV::kRow);
  if (e) return e;
  int dev, n_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const float scale_log2 = scale * kLog2e;

  auto kv_kernel = flash_bwd_dkdv_bf16_kernel<DQK, DV>;
  if ((err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)KC::kSmem)) != cudaSuccess)
    return (int)err;
  const Grid gk = persistent_grid((Sk + KC::BM - 1) / KC::BM, Hk, B, causal, n_sm);
  kv_kernel<<<gk.blocks, kBf16Threads, KC::kSmem, stream>>>(
      kq, kk, kv, kdo, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S(6), S(7), B, H, Hk, Sq, Sk, sk_valid, causal, gk.pair,
      scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto q_kernel = flash_bwd_dq_bf16_kernel<DQK, DV>;
  if ((err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)QC::kSmem)) != cudaSuccess)
    return (int)err;
  const Grid gq = persistent_grid((Sq + QC::BM - 1) / QC::BM, H, B, causal, n_sm);
  q_kernel<<<gq.blocks, kBf16Threads, QC::kSmem, stream>>>(
      qq, qk, qv, qdo, lse, delta, static_cast<__nv_bfloat16*>(dq), S(5), B, H, Hk, Sq, sk_valid,
      causal, gq.pair, scale_log2, scale);
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

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

}  // namespace

// q: (B, Sq, H, D); k: (B, Sk, Hk, D); v: (B, Sk, Hk, DV); o and dout (the
// output's cotangent): (B, Sq, H, DV); dq, dk, dv as q, k, v; all f32
// (is_bf16 = 0) or all bf16, each addressed by its (batch, seq, head) strides in
// elements, strides[3 * operand + axis] for operands q, k, v, o, dout, dq, dk,
// dv; the head dim contiguous, every pointer and row 16-byte aligned. lse: (B,
// H, Sq) f32, the forward's log-sum-exp; delta: (B, H, Sq) f32 scratch. (D, DV)
// is (16, 16), (32, 32), (64, 64), (128, 128) or (192, 128); H is a multiple of
// Hk; 1 <= sk_valid <= Sk. Runs three kernels on the stream; returns
// cudaGetLastError() after them, the error of a tensor map that could not be
// made, or cudaErrorInvalidValue for arguments it does not take.
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
    constexpr int DQK_ = decltype(d)::value, DV_ = decltype(dv_)::value;
    auto launch = kIsBf16<decltype(tag)> ? launch_bf16<DQK_, DV_> : launch_f32<DQK_, DV_>;
    return launch(q, k, v, o, static_cast<const float*>(lse), dout, dq, dk, dv,
                  static_cast<float*>(delta), strides, B, H, Hk, Sq, Sk, sk_valid, causal, scale,
                  s);
  });
  return rc < 0 ? (int)cudaErrorInvalidValue : (int)rc;
}

// The dynamic shared memory, in bytes, of the dK/dV kernel (which = 0) or the
// dQ kernel (which = 1) at head dims (D, DV), or -1.
extern "C" int flash_attention_bwd_smem_bytes(int D, int DV, int is_bf16, int which) {
  return (int)dispatch(D, DV, is_bf16, [&](auto d, auto dv, auto tag) -> long long {
    constexpr int DQK_ = decltype(d)::value, DV_ = decltype(dv)::value;
    if constexpr (kIsBf16<decltype(tag)>)
      return which ? (long long)QCfg<DQK_, DV_>::kSmem : (long long)KvCfg<DQK_, DV_>::kSmem;
    else
      return which ? (long long)F32Cfg<DQK_, DV_>::kSmemC : (long long)F32Cfg<DQK_, DV_>::kSmemB;
  });
}
