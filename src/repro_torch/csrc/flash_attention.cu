// Flash-attention forward, CUDA C++ for sm_90a, on the tensor cores.
//
// Replaces the Pallas kernel `flash_attention_fwd` (body `_fwd_kernel`) of
// src/repro/kernels/flash_attention/flash_attention.py. For each query row:
// scores q . k with q cast to f32 and scaled by D^-0.5, masked to -1e30 where
// the key lies at or beyond sk_valid or, when causal, after the query (top-left
// aligned: query i sees keys 0..i); an online softmax in f32 carried over KV
// tiles; P.V with p rounded to v's type first (bf16 at bf16 inputs) and the
// tile's product rounded to v's type, as the reference's `lax.dot` of two bf16
// operands gives bf16; the finalize divides by max(l, 1e-30) and writes q's
// type. GQA: query head h reads KV head h / (H / Hk). The query and key heads
// are DQK wide and the value head DV wide: the pairs (d, d) for d in 16, 32, 64
// and 128, and (192, 128), MLA's (nope 128 + rope 64 over v 128); the scale is
// DQK^-0.5. The training forward's launch (flash_attention_fwd_lse_launch) also
// writes each row's log-sum-exp m + log(l) of the scaled scores, f32, from which
// the backward (flash_attention_bwd.cu) recomputes P; the prefill's writes none.
//
// Grid: the TPU version walks (B*H, Sq/BQ, Sk/BK) with the KV axis innermost
// and in order, carrying m, l and acc in scratch memory across it. Blocks here
// run in no order, so each block owns one (batch, head, 128-row query tile)
// and walks the KV tiles in order itself. Tiles that the causal mask empties
// are not visited (they would add p = 0); the longest query tiles go first.
// Operands are read through (batch, seq, head) strides, so the model's
// (B, S, H, D) layout needs no transposes, and the ragged tails of Sq and Sk
// are masked here, so nothing is padded. Two routes, one per input type.
//
// The f32 route. What bounds it: operations. At the prefill shape (B 4, S
// 2048, H 32, Hk 4, D 64, causal, f32) it does ~6.9e10 operations against
// ~150 MB of operands. On the CUDA cores (67 TFLOP/s of f32) that is 1.03 ms
// at best. The TF32 tensor cores are 7x faster but keep 10 mantissa bits,
// ~1e-3 off in one pass. So the f32 products are taken as 3xTF32: each operand
// x splits once into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big),
// and a product is big.big + big.small + small.big with f32 sums (small.small,
// ~2^-22 of it, is dropped). That is three TF32 products, 3 x 6.9e10 / 495e12
// = 0.42 ms at best, and agrees with f32 to ~1e-6. The f32 instance at (192,
// 128) keeps Q's big and small parts in registers (192 a thread beside acc's
// 64), so it spills; it is right, not fast, and serves the card-against-CPU
// checks.
//
// Its instructions: wgmma m64nNk8 tf32, a warpgroup (4 warps, 64 query rows) at
// a time, A (Q, then P) from registers and B (K, then V) from shared memory;
// two warpgroups to a block. A warp's accumulator fragment holds 16 rows, a row
// on one quad of lanes, so the online softmax runs on the scores in registers
// (a row max or sum is two shuffles), and the scores are P.V's A operand with
// no data movement: the C fragment holds keys 2t and 2t+1 of an 8-key group
// where the tf32 A fragment wants columns t and t+4, so the k-step's keys are
// taken in the order (0, 2, 4, 6, 1, 3, 5, 7), and V is stored in that order.
// tf32 wgmma reads B K-major only, so V is stored transposed.
//
// Its copies: a first kernel prepares each KV tile of each (batch, KV head)
// once, into a scratch buffer that the wrapper allocates: K and V split into
// big and small, V transposed, all in wgmma's unswizzled K-major layout of core
// matrices (8 rows by 16 bytes, 128 contiguous bytes). So an element is split
// once, not once in each of the 16 query tiles and 8 query heads that read it.
// In the attention kernel, one thread brings whole tiles into a ring of three
// shared-memory slots with cp.async.bulk (the copy engine, one copy a tile),
// completing on the slot's mbarrier, two tiles ahead of their use; every thread
// arrives on the slot's other mbarrier when it is done with the tile. No block
// barrier runs per tile. The two warpgroups take turns at the tensor cores
// through two named barriers, so that one's softmax runs while the other's
// products do. Q is scaled, split and kept in registers. The softmax's exp is
// ex2.approx of x log2(e) (a few ulp; the 1e-5 tolerance holds with room), and
// each tile's P.V is summed on its own before it is added to the output: the
// tensor cores' f32 sums round less exactly than an add, so their chains stay
// short.
//
// The bf16 route. What bounds it: operations, at 989e12 a second, wherever a
// query row sees more than ~300 keys (each row's q and o are 2(D + DV) bytes
// against 2(D + DV) operations a key it sees; K and V are shared by the rows of
// a head group). At the main path's shapes, as bound ms by operations / by
// bytes at 3.35e12: tinyllama's training (B 4, S 2048, H 32/4, (64, 64),
// causal) 0.0695 / 0.0225; granite's (H 24/8) 0.0521 / 0.0200; MLA's prefill
// (H 128/128, (192, 128)) 0.695 / 0.401; whisper's encoder (1500 x 1500, H 16,
// (64, 64)) 0.0373 / 0.0147 and cross-attention (416 x 1500) 0.0103 / 0.0094;
// its causal decoder (416 x 416) is bound by bytes, 0.0014 / 0.0041. (128, 128)
// and D 16 and 32 reach the kernel at test shapes only; the narrower the head,
// the fewer operations a score (2 (D + DV)) beside its one exp, so at D <= 64
// the softmax rather than the products sets the time. At D 64 the exp is as
// costly as the products: a 128 x 128 tile is 1,024 cycles of the SM's tensor
// cores and as many of its 16 exp units. So the design keeps the tensor
// cores, the exp units and the copies busy at once:
// - One kernel, no preparation. TMA tensor maps over the caller's (B, S, H, D)
//   strides (built on the host by cuTensorMapEncodeTiled, reached through the
//   runtime's driver entry point) bring Q and K and V tiles of 128 keys, the
//   reference's block_k, into a ring of shared-memory stages (2 at DQK 192,
//   3 at 128, 4 below: what 227 KB holds beside Q's 128 rows), as wgmma reads
//   them: boxes of 64 along the head with the 128-byte swizzle (D 16 and 32
//   take one box of the head's width with the 32- and 64-byte swizzles). Rows
//   past Sq and keys past Sk come zero-filled; sk_valid and the causal mask
//   are applied in registers. MLA's V, a strided slice, is read in place.
// - Warp specialisation: a producer warpgroup, of which one thread issues
//   every copy, each completing on its stage's K or V mbarrier; K's and V's
//   slots are handed back apart ("empty" mbarriers), K's as soon as the
//   scores are in, so the next copies start early. Two consumer warpgroups of
//   64 query rows take turns at the tensor cores through two named barriers,
//   so that one's softmax runs under the other's products. setmaxnreg gives
//   the consumers 232 registers a thread (240 at DV 128) and the producer 40
//   (24).
// - Persistent: one block a multiprocessor walks work items, each a query
//   tile of one head or, under the causal mask with more tiles than blocks, a
//   pair of them, the longest and the shortest left, so that every item holds
//   the same number of KV tiles and the blocks finish together; neighbouring
//   items share a head, so the blocks at work at a time share K and V in L2.
//   The ring runs on across query tiles: the next tile's copies overlap the
//   current one's last products.
// - S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//   K-major as stored. P.V is m64nDVk16 with P from registers: for 16-bit
//   types the S accumulator's fragment (row g and g+8, keys 2t, 2t+1 of each 8)
//   is the A fragment, so rounding p to bf16 moves no data; V is read MN-major
//   as stored, through the instruction's transpose bit.
// - Each tile's P.V goes to a fresh accumulator (scale-d 0), is rounded to bf16
//   and then added to acc, where the reference rounds. At DV <= 64 a
//   warpgroup's turn issues tile j's S with tile j-1's P V, and its softmax of
//   tile j runs under that P V: a thread then holds the scores (64 f32), the
//   previous p (32) and P V (DV / 2) and acc (DV / 2). At DV 128 that would
//   spill, so a tile's S, softmax and P V follow each other (acc 64, scores
//   64, then p 32 and P V 64).
// - The exp is ex2.approx of s c - m c in one multiply-add, c = DQK^-0.5
//   log2(e) (s is the raw q . k; the max commutes with the positive scale);
//   the row max and sum run as four chains a row. The finalize multiplies by
//   the rounded reciprocal of max(l, 1e-30), and a row's quad of threads swap
//   words so that each writes 16-byte pieces of the output row.

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;  // the f32 route's block, and the bf16 route's consumers
constexpr int kBQ = 16 * kWarps;  // query rows per block: 16 a warp
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // the reference's sentinel, not -inf
constexpr float kLn2 = 0.6931471805599453f;  // log(x) = log2(x) ln(2)

// The f32 route's tiles.
template <int DQK, int DV>
struct Cfg {
  // keys per KV tile; DQK 192 takes 16, so that three ring slots of split K
  // and V^T (40 KB each) fit the block's shared memory
  static constexpr int BK = DQK <= 64 ? 64 : (DQK > 128 ? 16 : 32);
  // one tile as prepared and as the ring holds it: K big, K small, V^T big,
  // V^T small
  static constexpr size_t kKs = 2 * (size_t)BK * DQK * 4;
  static constexpr size_t kVs = 2 * (size_t)BK * DV * 4;
  static constexpr size_t kTile = kKs + kVs;
  static constexpr int kSlots = 3;  // tiles in the ring
  static constexpr size_t kBars = kSlots * kTile;  // then 2 x kSlots mbarriers
  static constexpr size_t kSmem = kBars + 2 * kSlots * 8;
};

// Named barrier `id` over the two (consumer) warpgroups' threads: they take
// turns at the tensor cores, each passing the turn once its products are issued.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
// The f32 route: the attention kernel, over tiles that the next kernel prepared.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_fwd_kernel(const float* __restrict__ q, const char* __restrict__ tiles,
                           float* __restrict__ o, float* __restrict__ lse, Strides qs, Strides os,
                           int H, int Hk, int Sq, int n_kv, int sk_valid, int causal, float scale) {
  using C = Cfg<DQK, DV>;
  constexpr int BK = C::BK;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / Hk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and column pair
  const int q0 = qt * kBQ;
  const int w0 = q0 + 16 * warp;  // this warp's first query row
  const int r0 = w0 + g, r1 = r0 + 8;
  const float* qb = q + b * qs.b + h * qs.h;
  const char* tb = tiles + ((size_t)b * Hk + kh) * n_kv * C::kTile;  // this KV head's

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int n_kt = (sk_valid + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, q_last / BK + 1);

  // ring slot `s`: K, then V^T (each big, then small). full[s] completes when
  // the slot's tile has landed, empty[s] when every thread is done with it.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + C::kSlots;
  auto ks_buf = [&](int slot) { return reinterpret_cast<float*>(smem + slot * C::kTile); };
  auto vs_buf = [&](int slot) {
    return reinterpret_cast<float*>(smem + slot * C::kTile + C::kKs);
  };
  // tile kt into its slot, by the copy engine in one copy (the producer)
  auto produce = [&](int kt) {
    const int slot = kt % C::kSlots;
    bar_expect(full + slot, (uint32_t)C::kTile);
    bulk_copy(smem + slot * C::kTile, tb + kt * C::kTile, (uint32_t)C::kTile, full + slot);
  };

  // Q fragments, kept in registers, in the A fragment's own order: tf32 (k-step
  // of 8 d's) columns t and t+4
  constexpr int KQ = DQK / 8;
  uint32_t qa[KQ][4], qsm[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    const int d = 8 * kk + t;
    auto scaled = [&](int r, int dd) {
      return r < Sq ? __fmul_rn(qb[r * qs.s + dd], scale) : 0.f;
    };
    split(scaled(r0, d), qa[kk][0], qsm[kk][0]);
    split(scaled(r1, d), qa[kk][1], qsm[kk][1]);
    split(scaled(r0, d + 4), qa[kk][2], qsm[kk][2]);
    split(scaled(r1, d + 4), qa[kk][3], qsm[kk][3]);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (tid == 0) {
    for (int i = 0; i < C::kSlots; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // the producer: the second warpgroup's first thread, which trails the first
  // warpgroup, so its waits for a slot's last readers are short
  const bool producer = tid == kThreads / 2;
  if (producer) {
    produce(0);
    if (n_kt > 1) produce(1);
  }
  // the turn barriers' ids: warpgroup 0 goes first
  const int my_turn = 1 + (warp >> 2), other_turn = 3 - my_turn;
  if (my_turn == 2) turn_pass(1);

  for (int kt = 0; kt < n_kt; ++kt) {
    // tile kt+2 into the slot of tile kt-1 once every thread is done with that:
    // two tiles in flight, and a warpgroup may run a tile ahead of the other
    if (producer && kt + 2 < n_kt) {
      const int next = kt + 2;
      if (next >= C::kSlots)
        bar_wait(empty + next % C::kSlots, (next / C::kSlots - 1) & 1);
      produce(next);
    }
    const int k0 = kt * BK, slot = kt % C::kSlots;
    bar_wait(full + slot, (kt / C::kSlots) & 1);
    // rows past Sq, or all before the tile's first key (causal), add nothing; a
    // warpgroup takes the tile all the same to keep its turns (its rows' p are
    // exactly 0 there, their running max being finite)
    const float* kbig = ks_buf(slot);
    const float* vbig = vs_buf(slot);
    float s[BK / 8][4];  // element e of n-tile j: row (e < 2 ? r0 : r1), key 8j + 2t + (e & 1)
    float pv[DV / 8][4];  // the tile's P V

    // S = Q K^T
    turn_wait(my_turn);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {  // k-step: 2 core matrices, 256 bytes
      const uint64_t big = smem_desc(kbig + 64 * kk, 128, 128 * (DQK / 4));
      const uint64_t small = smem_desc(kbig + BK * DQK + 64 * kk, 128, 128 * (DQK / 4));
      wgmma_tf32<BK>(s, qsm[kk], big, kk > 0);
      wgmma_tf32<BK>(s, qa[kk], small, 1);
      wgmma_tf32<BK>(s, qa[kk], big, 1);
    }
    wgmma_commit();
    turn_pass(other_turn);
    wgmma_wait();
    fence_regs(s);

    // mask, then the online softmax on the fragments
    const bool masked = k0 + BK > sk_valid || (causal && k0 + BK - 1 > w0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          if (key >= sk_valid || (causal && row < key)) s[j][e] = kNegInf;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(m[i], mx[i]);  // the new running max
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx((s[j][e] - mx[e >> 1]) * kLog2e);
        ps[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 1);
      ps[i] += __shfl_xor_sync(0xffffffffu, ps[i], 2);
      corr[i] = exp2_approx((m[i] - mx[i]) * kLog2e);
      l[i] = l[i] * corr[i] + ps[i];
      m[i] = mx[i];
    }

    // O = O * corr + P V; A columns t, t+4 = keys 8j + 2t, 8j + 2t + 1: the C
    // fragment as it is
    uint32_t pb[BK / 8][4], psm[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      split(s[j][0], pb[j][0], psm[j][0]);
      split(s[j][2], pb[j][1], psm[j][1]);
      split(s[j][1], pb[j][2], psm[j][2]);
      split(s[j][3], pb[j][3], psm[j][3]);
    }
    turn_wait(my_turn);
    fence_regs(pv);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {  // k-step: keys 8j..8j+7, 256 bytes
      const uint64_t big = smem_desc(vbig + 64 * j, 128, 128 * (BK / 4));
      const uint64_t small = smem_desc(vbig + BK * DV + 64 * j, 128, 128 * (BK / 4));
      wgmma_tf32<DV>(pv, psm[j], big, j > 0);
      wgmma_tf32<DV>(pv, pb[j], small, 1);
      wgmma_tf32<DV>(pv, pb[j], big, 1);
    }
    wgmma_commit();
    if (my_turn == 1 || kt + 1 < n_kt) turn_pass(other_turn);  // none owed at the end
    wgmma_wait();
    fence_regs(pv);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = acc[n][e] * corr[e >> 1] + pv[n][e];
    bar_arrive(empty + slot);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r1 : r0;
    if (r >= Sq) continue;
    // the training forward's log-sum-exp: m is of the scaled scores here
    if (lse && t == 0) lse[((size_t)b * H + h) * Sq + r] = m[i] + logf(l[i]);
    const float den = fmaxf(l[i], 1e-30f);
    float* ob = o + b * os.b + r * os.s + h * os.h + 2 * t;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<float2*>(ob + 8 * n) =
          make_float2(acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
  }
}

// Each KV tile of each (batch, KV head) once, in the layout the ring takes
// (split, transposed, in core matrices), into `tiles`: the main kernel's
// blocks then copy tiles as they are, and the split of a K or V element, which
// 16 query tiles and 8 query heads share, is taken once instead of in each.
// Keys at or past Sk are zeros. K is read DQK wide, V DV wide.
template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
flash_prepare_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                        char* __restrict__ tiles, Strides ks, Strides vs, int Hk, int Sk,
                        int n_kv) {
  using C = Cfg<DQK, DV>;
  constexpr int BK = C::BK;
  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int k0 = kt * BK;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;
  char* tile = tiles + (((size_t)b * Hk + kh) * n_kv + kt) * C::kTile;
  uint4* kd = reinterpret_cast<uint4*>(tile);  // core matrix rows of 16 bytes
  uint4* vd = reinterpret_cast<uint4*>(tile + C::kKs);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // K: 4 d's of a key are one row of core matrix (key / 8, d / 4)
  for (int c = tid; c < BK * DQK / 4; c += kThreads) {
    const int key = c / (DQK / 4), ck = c % (DQK / 4);
    const float4 x =
        k0 + key < Sk ? *reinterpret_cast<const float4*>(kb + (k0 + key) * ks.s + 4 * ck) : zero;
    uint4 bg, sm;
    split(x.x, bg.x, sm.x);
    split(x.y, bg.y, sm.y);
    split(x.z, bg.z, sm.z);
    split(x.w, bg.w, sm.w);
    const int row = 8 * ((key >> 3) * (DQK / 4) + ck) + (key & 7);
    kd[row] = bg;
    kd[row + BK * DQK / 4] = sm;
  }
  // V^T: keys 8j + p + 2i (i < 4) of a d are one row of core matrix (d / 8,
  // 2j + p), the k-order of the P.V step (a group's even keys first)
  for (int u = tid; u < BK * DV / 16; u += kThreads) {
    const int cv = u % (DV / 4), jp = u / (DV / 4);
    float4 x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 8 * (jp >> 1) + (jp & 1) + 2 * i;
      x[i] = key < Sk ? *reinterpret_cast<const float4*>(vb + key * vs.s + 4 * cv) : zero;
    }
    const float xs[4][4] = {{x[0].x, x[1].x, x[2].x, x[3].x}, {x[0].y, x[1].y, x[2].y, x[3].y},
                            {x[0].z, x[1].z, x[2].z, x[3].z}, {x[0].w, x[1].w, x[2].w, x[3].w}};
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const int d = 4 * cv + dd;
      uint4 bg, sm;
      split(xs[dd][0], bg.x, sm.x);
      split(xs[dd][1], bg.y, sm.y);
      split(xs[dd][2], bg.z, sm.z);
      split(xs[dd][3], bg.w, sm.w);
      const int row = 8 * ((d >> 3) * (BK / 4) + jp) + (d & 7);
      vd[row] = bg;
      vd[row + BK * DV / 4] = sm;
    }
  }
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, void* tiles,
               const long long* st, int B, int H, int Hk, int Sq, int Sk, int sk_valid,
               int causal, float scale, cudaStream_t stream) {
  using C = Cfg<DQK, DV>;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  const int n_kv = (sk_valid + C::BK - 1) / C::BK;
  flash_prepare_kv_kernel<DQK, DV><<<dim3(n_kv, Hk, B), kThreads, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), static_cast<char*>(tiles), ks,
      vs, Hk, Sk, n_kv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kernel = flash_attention_fwd_kernel<DQK, DV>;
  if (C::kSmem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(static_cast<const float*>(q),
                                                static_cast<const char*>(tiles),
                                                static_cast<float*>(o), lse, qs, os, H, Hk, Sq,
                                                n_kv, sk_valid, causal, scale);
  return (int)cudaGetLastError();
}

// The bf16 route's tiles: two consumer warpgroups of 64 query rows, by 128
// keys, the reference's block_k. A TMA box is `kRow*` bytes a row, which is
// also its swizzle span: 64 elements (128 bytes) of the head, or the whole head
// at D 16 and 32; a tile is kNb* boxes across the head, each rows x kRow*.
template <int DQK, int DV>
struct Bf16Cfg {
  static constexpr int BQ = 128, BK = 128;
  // a warpgroup's turn issues a tile's S with the previous tile's P V, so that
  // its softmax runs under its own P V, where the registers allow: the scores,
  // the previous p and P V and acc are 64 + 32 + 2 x DV / 2 a thread, which at
  // DV 128 would spill
  static constexpr bool kPipe = DV <= 64;
  // setmaxnreg's shares of the 64 K registers, the producer warpgroup's and
  // each consumer's: 128 x 40 + 256 x 232, and at DV 128, whose consumers hold
  // the most, 128 x 24 + 256 x 240
  static constexpr int kConsumerRegs = DV > 64 ? 240 : 232, kProducerRegs = DV > 64 ? 24 : 40;
  static constexpr int kRowQ = DQK >= 64 ? 128 : 2 * DQK;  // Q and K
  static constexpr int kRowV = DV >= 64 ? 128 : 2 * DV;
  static constexpr int kBoxQ = kRowQ / 2, kBoxV = kRowV / 2;  // elements of a box row
  static constexpr int kNbQ = DQK / kBoxQ, kNbV = DV / kBoxV;
  static constexpr uint32_t kQ = BQ * DQK * 2, kK = BK * DQK * 2, kV = BK * DV * 2;
  // ring stages: what the block's 227 KB hold beside Q, the barriers and the
  // 1 KB that aligns the tiles, at most 4
  static constexpr int kStagesFit = (232448 - 1024 - 256 - (int)kQ) / (int)(kK + kV);
  static constexpr int kStages = kStagesFit < 4 ? kStagesFit : 4;
  static constexpr size_t kBars = kQ + kStages * (size_t)(kK + kV);  // then the mbarriers
  static constexpr size_t kSmem = 1024 + kBars + (2 + 4 * kStages) * 8;
  static constexpr int kThreads = 3 * 128;  // the producer warpgroup, then two consumers
  static_assert(kStages >= 2, "two stages of K and V must fit beside Q");
};

// The bf16 route: one persistent kernel, reading Q, K and V in place through
// tensor maps over the (B, S, H, D) views (the source note above). Block c of
// G takes the work items c, c + G, c + 2G, ...; an item is one 128-row query
// tile of one (batch, head), or with `pair` (causal, and more tiles than
// blocks) two: the longest and the shortest left, so that every item holds
// the same number of KV tiles and the blocks finish together. The items of
// one head are neighbours, so that the blocks at work at a time share K and V
// in L2. The K and V ring runs on across the query tiles, so the next one's
// copies overlap the current one's last products and its stores.
template <int DQK, int DV>
__global__ void __launch_bounds__(Bf16Cfg<DQK, DV>::kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, Strides os,
                            int B, int H, int Hk, int Sq, int sk_valid, int causal, int pair,
                            float scale_log2) {
  using C = Bf16Cfg<DQK, DV>;
  constexpr int BK = C::BK, NS = C::kStages;
  extern __shared__ float4 smem4[];
  // tiles on 1 KB, the period of the 128-byte swizzle that TMA and wgmma share
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem4);
  char* smem = reinterpret_cast<char*>(smem4) + ((1024 - (raw & 1023)) & 1023);
  char* q_tile = smem;
  auto k_tile = [&](int st) { return smem + C::kQ + st * (size_t)(C::kK + C::kV); };
  auto v_tile = [&](int st) { return k_tile(st) + C::kK; };
  // q_full: the query tile's Q has landed; q_empty: every consumer is done
  // with it; full_k[s], full_v[s]: stage s's K, V have landed; empty_k[s],
  // empty_v[s]: every consumer is done with stage s's K, V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* q_empty = q_full + 1;
  uint64_t* full_k = q_full + 2;
  uint64_t* full_v = full_k + NS;
  uint64_t* empty_k = full_v + NS;
  uint64_t* empty_v = empty_k + NS;

  // item w: p = w % n_per of head w / n_per % H of batch w / n_per / H; its
  // first half is query tile n_qt - 1 - p (the longest causal tiles first),
  // and a pair's second tile p, where that is another tile
  const int n_qt = (Sq + C::BQ - 1) / C::BQ, n_per = pair ? (n_qt + 1) / 2 : n_qt;
  const int n_items = n_per * H * B;
  auto halves = [&](int w) { return pair && 2 * (w % n_per) + 1 != n_qt ? 2 : 1; };
  struct Work {
    int q0, h, b, kh, n_kt;
  };
  auto work = [&](int w, int half) {
    Work u;
    const int p = w % n_per, hb = w / n_per;
    u.q0 = (half ? p : n_qt - 1 - p) * C::BQ;
    u.h = hb % H;
    u.b = hb / H;
    u.kh = u.h / (H / Hk);
    u.n_kt = (sk_valid + BK - 1) / BK;
    if (causal) u.n_kt = min(u.n_kt, (min(u.q0 + C::BQ, Sq) - 1) / BK + 1);
    return u;
  };

  const int tid = threadIdx.x;
  if (tid == 0) {  // the "empty" barriers count the consumers' kThreads (256) threads
    bar_init(q_full, 1);
    bar_init(q_empty, kThreads);
    for (int i = 0; i < NS; ++i) {
      bar_init(full_k + i, 1);
      bar_init(full_v + i, 1);
      bar_init(empty_k + i, kThreads);
      bar_init(empty_v + i, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer warpgroup: its first thread issues every copy, K and V of a
    // stage each as soon as the consumers are done with the stage's last, and
    // a work tile's Q once they are done with the last one's
    regs_down<C::kProducerRegs>();
    if (tid == 0) {
      int it = 0, wi = 0;  // the ring's tiles and the query tiles so far
      for (int w = blockIdx.x; w < n_items; w += gridDim.x)
        for (int half = 0; half < halves(w); ++half, ++wi) {
          const Work u = work(w, half);
          for (int kt = 0; kt < u.n_kt; ++kt, ++it) {
            const int st = it % NS, parity = (it / NS - 1) & 1;
            if (it >= NS) bar_wait(empty_k + st, parity);
            bar_expect(full_k + st, C::kK);
            for (int j = 0; j < C::kNbQ; ++j)
              tma_load(k_tile(st) + j * BK * C::kRowQ, &tk, full_k + st, j * C::kBoxQ, kt * BK,
                       u.kh, u.b);
            if (kt == 0) {
              if (wi > 0) bar_wait(q_empty, (wi - 1) & 1);
              bar_expect(q_full, C::kQ);
              for (int j = 0; j < C::kNbQ; ++j)
                tma_load(q_tile + j * C::BQ * C::kRowQ, &tq, q_full, j * C::kBoxQ, u.q0, u.h, u.b);
            }
            if (it >= NS) bar_wait(empty_v + st, parity);
            bar_expect(full_v + st, C::kV);
            for (int j = 0; j < C::kNbV; ++j)
              tma_load(v_tile(st) + j * BK * C::kRowV, &tv, full_v + st, j * C::kBoxV, kt * BK,
                       u.kh, u.b);
          }
        }
    }
    return;
  }

  // the consumers: warpgroup cw takes query rows q0 + 64 cw .. + 63 of each
  // query tile
  regs_up<C::kConsumerRegs>();
  const int ct = tid - 128, cw = ct >> 7, warp = (ct >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and column pair
  const char* q_rows = q_tile + cw * 64 * C::kRowQ;  // this warpgroup's rows of each Q box

  int w0, r0, r1;  // this warp's first query row, and this thread's two rows
  float m[2], l[2], acc[DV / 8][4];
  float s[BK / 8][4];  // element e of n-tile j: row (e < 2 ? r0 : r1), key 8j + 2t + (e & 1)
  float pv[DV / 8][4];  // a tile's P V
  uint32_t pa[BK / 16][4];  // a tile's p in bf16: P.V's A fragment
  float corr[2], corr_pv[2];  // the rescale of acc by the newest tile, and by pv's

  // S = Q K^T of the tile in stage `st`: k-steps of 16 along the head, 32
  // bytes into a box row (issued, not waited for)
  auto issue_s = [&](int st) {
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      const int box = kk / (C::kBoxQ / 16), off = 32 * (kk % (C::kBoxQ / 16));
      const uint64_t a = sw_desc<C::kRowQ>(q_rows + box * C::BQ * C::kRowQ + off, 16,
                                           8 * C::kRowQ);
      const uint64_t bk = sw_desc<C::kRowQ>(k_tile(st) + box * BK * C::kRowQ + off, 16,
                                            8 * C::kRowQ);
      wgmma_bf16_ss<BK>(s, a, bk, kk > 0);
    }
  };
  // the tile's P V into a fresh accumulator: k-steps of 16 keys, 16 rows of each
  // V box apart
  auto issue_pv = [&](int st) {
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) {
      const uint64_t bv = sw_desc<C::kRowV>(v_tile(st) + i * 16 * C::kRowV, BK * C::kRowV,
                                            8 * C::kRowV);
      wgmma_bf16_rs<DV>(pv, pa[i], bv, i > 0);
    }
  };
  // mask the raw scores of the tile at key k0, then the online softmax on the
  // fragments: s becomes p, m and l move on, corr rescales acc. The scale is
  // folded into the exponent (it is positive, so the max commutes with it):
  // p = 2^(s c - m c), c = D^-0.5 log2(e); tile 0 holds key 0, which every row
  // sees, so m is finite from then on and a masked score gives p = 0. The row
  // max and sum run as four chains a row, so that two dependent operations
  // seldom follow each other.
  auto softmax = [&](int k0) {
    if (k0 + BK > sk_valid || (causal && k0 + BK - 1 > w0)) {
      // a row keeps keys below min(sk_valid, row + 1 if causal); element (j, e)
      // is key k0 + 2t + 8j + (e & 1), so one compare with a constant each
      int keep[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        keep[i] = (causal ? min(sk_valid, (i ? r1 : r0) + 1) : sk_valid) - k0 - 2 * t;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + (e & 1) >= keep[e >> 1]) s[j][e] = kNegInf;
    }
    float part[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      part[e >> 1][e & 1] = s[0][e];
      part[e >> 1][2 + (e & 1)] = s[1][e];
    }
#pragma unroll
    for (int j = 2; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[e >> 1][(e & 1) + 2 * (j & 1)] = fmaxf(part[e >> 1][(e & 1) + 2 * (j & 1)], s[j][e]);
    float mx[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(fmaxf(part[i][0], part[i][1]), fmaxf(part[i][2], part[i][3]));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(m[i], mx[i]);  // the new running max
      mc[i] = -mx[i] * scale_log2;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) part[i][q] = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx(__fmaf_rn(s[j][e], scale_log2, mc[e >> 1]));
        part[e >> 1][(e & 1) + 2 * (j & 1)] += s[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float ps = (part[i][0] + part[i][1]) + (part[i][2] + part[i][3]);
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      corr[i] = exp2_approx(__fmaf_rn(m[i], scale_log2, mc[i]));
      l[i] = l[i] * corr[i] + ps;
      m[i] = mx[i];
    }
  };
  // p, rounded to bf16 into P.V's A fragment: keys 16i..16i+15 are n-tiles 2i
  // and 2i+1 of the scores, in the fragment's own order
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < BK / 16; ++i) {
      pa[i][0] = pack_bf16(s[2 * i][0], s[2 * i][1]);
      pa[i][1] = pack_bf16(s[2 * i][2], s[2 * i][3]);
      pa[i][2] = pack_bf16(s[2 * i + 1][0], s[2 * i + 1][1]);
      pa[i][3] = pack_bf16(s[2 * i + 1][2], s[2 * i + 1][3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) corr_pv[i] = corr[i];
  };
  // O = O * corr + bf16(P V), the reference's rounding of each tile's product
  // (two values a conversion)
  auto add_pv = [&]() {
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const float2 r = __bfloat1622float2(__floats2bfloat162_rn(pv[n][e], pv[n][e + 1]));
        acc[n][e] = acc[n][e] * corr_pv[e >> 1] + r.x;
        acc[n][e + 1] = acc[n][e + 1] * corr_pv[e >> 1] + r.y;
      }
  };

  // The two warpgroups take turns at the tensor cores through named barriers
  // 1 and 2: warpgroup cw waits on 1 + cw and passes the turn on once its
  // products are issued (in the pipelined schedule, once its scores are in);
  // the second passes the first turn, and owes none after its last of the
  // block.
  const int my_turn = 1 + cw, other_turn = 2 - cw;
  if (cw == 1) turn_pass(1);
  int it = 0, wi = 0;  // the ring's tiles and the query tiles so far
  for (int w = blockIdx.x; w < n_items; w += gridDim.x)
    for (int half = 0; half < halves(w); ++half, ++wi) {
      const Work u = work(w, half);
      const int n_kt = u.n_kt;
      // a pass after the last turn, owed but by the second warpgroup at its last
      const bool owe_last = cw == 0 || w + (int)gridDim.x < n_items || half + 1 < halves(w);
      w0 = u.q0 + 64 * cw + 16 * warp;
      r0 = w0 + g;
      r1 = r0 + 8;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
      bar_wait(q_full, wi & 1);

      if constexpr (C::kPipe) {
        // a turn issues tile kt's S and tile kt-1's P V together, and passes on
        // once the scores are in (then the other warpgroup's products run under
        // this one's softmax); the softmax of tile kt runs while that P V does
        bar_wait(full_k + it % NS, (it / NS) & 1);
        turn_wait(my_turn);
        fence_regs(s);
        wgmma_fence();
        issue_s(it % NS);
        wgmma_commit();
        wgmma_wait<0>();
        turn_pass(other_turn);
        fence_regs(s);
        bar_arrive(empty_k + it % NS);
        if (n_kt == 1) bar_arrive(q_empty);
        softmax(0);
        pack();
        for (int kt = 1; kt < n_kt; ++kt) {
          const int st = (it + kt) % NS, prev = (it + kt - 1) % NS;
          bar_wait(full_k + st, ((it + kt) / NS) & 1);
          bar_wait(full_v + prev, ((it + kt - 1) / NS) & 1);
          turn_wait(my_turn);
          fence_regs(s);
          fence_regs(pv);
          wgmma_fence();
          issue_s(st);
          wgmma_commit();
          issue_pv(prev);
          wgmma_commit();
          wgmma_wait<1>();  // the scores; P V may still run
          turn_pass(other_turn);
          fence_regs(s);
          bar_arrive(empty_k + st);
          if (kt + 1 == n_kt) bar_arrive(q_empty);
          softmax(kt * BK);
          // the softmax's results before the wait, or the compiler sinks its
          // arithmetic below it and the softmax no longer runs under P V
          fence_regs(s);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            asm volatile("" : "+f"(m[i]), "+f"(l[i]), "+f"(corr[i])::"memory");
          wgmma_wait<0>();
          fence_regs(pv);
          bar_arrive(empty_v + prev);
          add_pv();
          pack();
        }
        const int last = (it + n_kt - 1) % NS;
        bar_wait(full_v + last, ((it + n_kt - 1) / NS) & 1);
        turn_wait(my_turn);
        fence_regs(pv);
        wgmma_fence();
        issue_pv(last);
        wgmma_commit();
        wgmma_wait<0>();
        if (owe_last) turn_pass(other_turn);
        fence_regs(pv);
        bar_arrive(empty_v + last);
        add_pv();
      } else {
        // a tile's S, its softmax, then its P V: two turns a tile
        for (int kt = 0; kt < n_kt; ++kt) {
          const int st = (it + kt) % NS, parity = ((it + kt) / NS) & 1;
          bar_wait(full_k + st, parity);
          turn_wait(my_turn);
          fence_regs(s);
          wgmma_fence();
          issue_s(st);
          wgmma_commit();
          turn_pass(other_turn);
          wgmma_wait<0>();
          fence_regs(s);
          bar_arrive(empty_k + st);
          if (kt + 1 == n_kt) bar_arrive(q_empty);
          softmax(kt * BK);
          pack();
          bar_wait(full_v + st, parity);
          turn_wait(my_turn);
          fence_regs(pv);
          wgmma_fence();
          issue_pv(st);
          wgmma_commit();
          if (kt + 1 < n_kt || owe_last) turn_pass(other_turn);
          wgmma_wait<0>();
          fence_regs(pv);
          bar_arrive(empty_v + st);
          add_pv();
        }
      }
      it += n_kt;

      // acc / max(l, 1e-30) as acc times the rounded reciprocal: a row's values
      // part from the quotient by an ulp of f32 at most, below bf16's rounding
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = i ? r1 : r0;
        const float inv = __frcp_rn(fmaxf(l[i], 1e-30f));
        // the training forward's log-sum-exp, natural log: m is of the raw scores
        if (lse && t == 0 && r < Sq)
          lse[((size_t)u.b * H + u.h) * Sq + r] = (m[i] * scale_log2 + log2f(l[i])) * kLn2;
        __nv_bfloat16* ob = o + u.b * os.b + r * os.s + u.h * os.h;
        uint32_t word[DV / 8];  // columns 8n + 2t, 8n + 2t + 1 of the row, in bf16
#pragma unroll
        for (int n = 0; n < DV / 8; ++n)
          word[n] = pack_bf16(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
        if constexpr (DV >= 64) {
          // the quad's four threads hold the row; swap words among them so that
          // thread t holds 16 whole columns of each group of 64, 16t.., and
          // writes them as two 16-byte stores
          auto pick = [&](uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, int x) {
            return x == 0 ? a0 : (x == 1 ? a1 : (x == 2 ? a2 : a3));
          };
#pragma unroll
          for (int kb = 0; kb < DV / 16; kb += 4) {
            uint32_t got[4][2];  // got[d][hh]: thread t ^ d's words of n-tile 2 (kb + t) + hh
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const uint32_t* wv = word + 2 * kb + hh;
#pragma unroll
              for (int d = 0; d < 4; ++d) {
                const uint32_t mine = pick(wv[0], wv[2], wv[4], wv[6], t ^ d);
                got[d][hh] = d ? __shfl_xor_sync(0xffffffffu, mine, d) : mine;
              }
            }
            if (r < Sq) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh)
                *reinterpret_cast<uint4*>(ob + 16 * (kb + t) + 8 * hh) =
                    make_uint4(pick(got[0][hh], got[1][hh], got[2][hh], got[3][hh], t),
                               pick(got[0][hh], got[1][hh], got[2][hh], got[3][hh], t ^ 1),
                               pick(got[0][hh], got[1][hh], got[2][hh], got[3][hh], t ^ 2),
                               pick(got[0][hh], got[1][hh], got[2][hh], got[3][hh], t ^ 3));
            }
          }
        } else if (r < Sq) {
#pragma unroll
          for (int n = 0; n < DV / 8; ++n)
            *reinterpret_cast<uint32_t*>(ob + 8 * n + 2 * t) = word[n];
        }
      }
    }
}

template <int DQK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                const long long* st, int B, int H, int Hk, int Sq, int Sk, int sk_valid,
                int causal, float scale, cudaStream_t stream) {
  using C = Bf16Cfg<DQK, DV>;
  CUtensorMap tq, tk, tv;
  int e = tensor_map(&tq, q, DQK, Sq, H, B, st, C::kBoxQ, C::BQ, C::kRowQ);
  if (!e) e = tensor_map(&tk, k, DQK, Sk, Hk, B, st + 3, C::kBoxQ, C::BK, C::kRowQ);
  if (!e) e = tensor_map(&tv, v, DV, Sk, Hk, B, st + 6, C::kBoxV, C::BK, C::kRowV);
  if (e) return e;
  auto kernel = flash_attention_bf16_kernel<DQK, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const Strides os{st[9], st[10], st[11]};
  // one block a multiprocessor, or one a work tile where there are fewer
  int dev, n_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  // pairs of causal query tiles where there are more tiles than blocks; where
  // they fit in one wave, each tile is an item (the longest sets the time)
  const long long n_qt = (Sq + C::BQ - 1) / C::BQ;
  const int pair = causal && n_qt * H * B > n_sm;
  const long long n_items = (pair ? (n_qt + 1) / 2 : n_qt) * H * B;
  const int grid = (int)(n_items < n_sm ? n_items : n_sm);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse,
                                                  os, B, H, Hk, Sq, sk_valid, causal, pair,
                                                  scale * kLog2e);
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

// q: (B, Sq, H, D); k: (B, Sk, Hk, D); v: (B, Sk, Hk, DV); o: (B, Sq, H, DV); all
// f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), each addressed by its (batch, seq,
// head) strides in elements, strides[3 * operand + axis] for operands q, k, v, o;
// the head dim is contiguous, and every pointer and row (each stride times the
// element size) is 16-byte aligned. (D, DV) is (16, 16), (32, 32), (64, 64),
// (128, 128) or (192, 128); H is a multiple of Hk; 1 <= sk_valid <= Sk. scratch:
// flash_attention_scratch_bytes(B, Hk, sk_valid, D, DV, is_bf16) bytes, 16-byte
// aligned, for f32's prepared KV tiles (none at bf16). f32 runs two kernels on
// the stream, bf16 one; returns cudaGetLastError() after the launches, or the
// error of a tensor map that could not be made.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          void* scratch, long long scratch_bytes,
                                          const long long* strides, int B, int H, int Hk, int Sq,
                                          int Sk, int D, int DV, int sk_valid, int causal,
                                          int is_bf16, float scale, void* stream);

// The same launch that also writes each query row's log-sum-exp, the natural
// log of the sum of exp of its masked, scaled scores, to lse: (B, H, Sq) f32,
// contiguous (the training forward; the backward recomputes P from it).
extern "C" int flash_attention_fwd_lse_launch(const void* q, const void* k, const void* v,
                                              void* o, void* scratch, long long scratch_bytes,
                                              const long long* strides, int B, int H, int Hk,
                                              int Sq, int Sk, int D, int DV, int sk_valid,
                                              int causal, int is_bf16, float scale, void* lse,
                                              void* stream);

// The scratch bytes a launch needs, or -1 for a pair of head dims the kernel lacks.
extern "C" long long flash_attention_scratch_bytes(int B, int Hk, int sk_valid, int D, int DV,
                                                   int is_bf16) {
  return dispatch(D, DV, is_bf16, [&](auto d, auto dv, auto tag) -> long long {
    using C = Cfg<decltype(d)::value, decltype(dv)::value>;
    if (kIsBf16<decltype(tag)>) return 0;
    return (long long)B * Hk * ((sk_valid + C::BK - 1) / C::BK) * (long long)C::kTile;
  });
}

extern "C" int flash_attention_fwd_lse_launch(const void* q, const void* k, const void* v,
                                              void* o, void* scratch, long long scratch_bytes,
                                              const long long* strides, int B, int H, int Hk,
                                              int Sq, int Sk, int D, int DV, int sk_valid,
                                              int causal, int is_bf16, float scale, void* lse,
                                              void* stream) {
  const long long need = flash_attention_scratch_bytes(B, Hk, sk_valid, D, DV, is_bf16);
  if (B <= 0 || Hk <= 0 || H % Hk || Sq <= 0 || sk_valid < 1 || sk_valid > Sk || need < 0 ||
      scratch_bytes < need)
    return (int)cudaErrorInvalidValue;
  const int elem = is_bf16 ? 2 : 4;
  const void* ptrs[] = {q, k, v, o, scratch};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  for (int i = 0; i < 12; ++i)
    if (strides[i] * elem % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return (int)dispatch(D, DV, is_bf16, [&](auto d, auto dv, auto tag) -> long long {
    constexpr int DQK_ = decltype(d)::value, DV_ = decltype(dv)::value;
    if constexpr (kIsBf16<decltype(tag)>)
      return launch_bf16<DQK_, DV_>(q, k, v, o, l, strides, B, H, Hk, Sq, Sk, sk_valid, causal,
                                    scale, s);
    else
      return launch_f32<DQK_, DV_>(q, k, v, o, l, scratch, strides, B, H, Hk, Sq, Sk, sk_valid,
                                   causal, scale, s);
  });
}

extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          void* scratch, long long scratch_bytes,
                                          const long long* strides, int B, int H, int Hk, int Sq,
                                          int Sk, int D, int DV, int sk_valid, int causal,
                                          int is_bf16, float scale, void* stream) {
  return flash_attention_fwd_lse_launch(q, k, v, o, scratch, scratch_bytes, strides, B, H, Hk, Sq,
                                        Sk, D, DV, sk_valid, causal, is_bf16, scale, nullptr,
                                        stream);
}

// The dynamic shared memory, in bytes, that a launch at head dims (D, DV) takes.
extern "C" int flash_attention_smem_bytes(int D, int DV, int is_bf16) {
  return (int)dispatch(D, DV, is_bf16, [](auto d, auto dv, auto tag) -> long long {
    constexpr int DQK_ = decltype(d)::value, DV_ = decltype(dv)::value;
    if constexpr (kIsBf16<decltype(tag)>)
      return (long long)Bf16Cfg<DQK_, DV_>::kSmem;
    else
      return (long long)Cfg<DQK_, DV_>::kSmem;
  });
}
