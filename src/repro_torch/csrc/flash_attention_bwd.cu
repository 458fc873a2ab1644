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
// No atomics, so that every gradient is summed in one fixed order and two
// runs give the same bits: Delta first (bf16: flash_bwd_delta_bf16_kernel, 8
// lanes a row of 64 by 16-byte loads; f32: inside flash_bwd_prep_q_kernel, a
// warp a row); then dK and dV, a block owning a key tile and walking the
// group's query heads and query tiles in order; then dQ, a block owning a
// query tile and walking the key tiles. dQ in a kernel of its own recomputes S
// and dP, so the design takes seven products a pair where the bound counts
// five: its own floor is ~0.24 ms at the shape above (bf16). A fused dQ would
// need its sums across key tiles in a fixed order (a second pass over f32
// partials) to stay deterministic; the seven-product floor is still 2.5x under
// SDPA's backward.
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
// The f32 route, on the tensor cores as 3xTF32, as the forward's f32 route
// (flash_attention.cu): each operand x splits once into big = cvt.rna.tf32(x)
// and small = cvt.rna.tf32(x - big) (hopper.cuh's split), and a product is
// big.big + big.small + small.big on wgmma m64nNk8 tf32 with f32 sums. At the
// training shape in f32 its bound is 1.72e11 x 3 / 495e12 = 1.04 ms; its own
// floor, seven products a pair, 1.46 ms. The design follows the bf16 route's
// shape: a producer warpgroup, of whose threads one issues every copy;
// consumer warpgroups of 64 owned rows each; a ring of stages on "full" and
// "empty" mbarriers, no block barrier per turn; persistent blocks over work
// items that pair the longest and the shortest causal tile of one head (the
// Items above); dK/dV and dQ apart.
// - Operands as tf32 wgmma reads them. It reads B K-major only: it has no
//   transpose bit for 32-bit types. So two kernels first prepare every operand
//   once into the scratch the wrapper allocates (f32_scratch below), split and
//   in core matrices: flash_bwd_prep_q_kernel writes Q and dO as rows (the B
//   operands of S^T = K Q^T and dP^T = V dO^T, and dQ's resident A operands)
//   and transposed in tiles of dK/dV's BN queries (the B operands of dV +=
//   P^T dO and dK += dS^T Q), with Delta and lse log2(e); flash_bwd_prep_kv_kernel
//   writes K and V as rows (dK/dV's resident A operands, the B operands of S =
//   Q K^T and dP = dO V^T) and K transposed in tiles of dQ's BN keys (the B
//   operand of dQ += dS K). A transposed tile keeps each 8 rows in the order
//   (0, 2, 4, 6, 1, 3, 5, 7), so that the accumulator of P^T, dS^T or dS,
//   split in registers, is the A fragment of the product that reads it (the
//   forward's key order). The main kernels then bring whole tiles with
//   cp.async.bulk, one copy a part. This rather than tensor maps over the
//   caller's strides (the bf16 route's), because then every block would split
//   and transpose each tile it reads in shared memory: Q and dO are read by
//   every key tile of their head group (32 at the training shape), K and V by
//   every query tile and head of theirs. The cost: the scratch, four words
//   for every word of Q and dO and three for every word of K and V (0.59 GB at
//   the training shape, freed after the call), written once and read through
//   L2 at four times the bytes of the f32 operands.
// - Shared memory bounds the tiles. dK/dV keeps K and V of its BM keys
//   resident (big and small: BM (D + DV) 8 bytes) and streams stages of BN
//   queries, each Q and dO as rows and as a tile (16 BN (D + DV) bytes, then
//   lse and Delta); dQ keeps Q and dO of its BM queries and streams K (rows
//   and a tile) and V (rows), 8 BN (2 D + DV) bytes a stage. Up to D 64 a
//   block owns BM = 128 rows, two consumer warpgroups; above, 64, one
//   warpgroup (the block's 256 threads then have 255 registers each without
//   setmaxnreg). BN at D 16, 32, 64 and above: dK/dV 64, 32, 16, 8; dQ 64,
//   32, 32, 8. The stages (at most 4) are what 227 KB holds beside the
//   resident tile: dK/dV 4, 4, 3, 3 and 1 at (16, 16), (32, 32), (64, 64),
//   (128, 128) and (192, 128); dQ 4, 4, 2, 4 and 2
//   (flash_attention_bwd_smem_bytes gives each kernel's bytes). MLA's (192,
//   128) dK/dV thus runs one stage and one warpgroup, and spills: no copy
//   overlaps its products; it is right, not fast, and serves the checks.
// - Shared memory's bandwidth bounds the scores' products. At N = BN (16
//   queries a turn in dK/dV at D 64) a k-step's three products read the
//   resident 64-row A operand (2 KB a part) for 8 x 16 x 64 MACs each, more
//   than the SM's 128 bytes a cycle. So up to D 64 each consumer holds the
//   big part of its resident rows (K and V, or Q and dO) in registers as A
//   fragments, loaded once an item: two of a k-step's three products then
//   read only B from shared memory. On the H100 this took the training
//   shape from 4.26 to 3.72 ms, dQ's 32 keys a turn (from 16) to 3.21.
// - The accuracy of long sums. The tensor cores' f32 sums round less exactly
//   than an add, and dK and dV sum a head group's queries (16,384 at the
//   training shape), dQ its keys, where the f32 checks hold 1e-5 of the exact
//   gradient. So each turn's gradient product goes to a fresh accumulator
//   (scale-d 0), at most 64 columns at a time, and is added to the total in
//   registers: the tensor cores' chains stay BN / 8 k-steps long, and the
//   totals take one round-to-nearest add a turn. A turn: the scores'
//   products, one wait, the exps and dS, then each gradient product and its
//   wait; the two consumer warpgroups run free, so that one's exps run under
//   the other's products. Issuing the next turn's scores in one group with
//   this turn's gradient products (the bf16 route's way) was slower on the
//   H100, and with one stage (MLA's dK/dV) it would wait for a stage that it
//   has not handed back yet.
// - The mask and the exp are the bf16 route's: a uniform branch on the tiles
//   the mask touches, ex2.approx of S c - lse log2(e) in one multiply-add.

#include <type_traits>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// Shared by both routes
// ---------------------------------------------------------------------------
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int R>
__device__ __forceinline__ void zero(float (&x)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// ---------------------------------------------------------------------------
// The bf16 route
// ---------------------------------------------------------------------------
constexpr int kBf16Threads = 3 * 128;  // the producer warpgroup, then two consumers
constexpr int kConsumers = 256;  // the consumers' threads: every "empty" barrier's count
constexpr int kConsumerRegs = 232, kProducerRegs = 40;  // setmaxnreg's shares
constexpr int kSmemMax = 232448;  // what a block may take

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

// ---------------------------------------------------------------------------
// The f32 route
// ---------------------------------------------------------------------------
// The scratch the wrapper allocates (the launch's `delta`), in f32 words:
// Delta and lse log2(e), then Q, dO, K and V prepared for wgmma, each in a big
// and a small part (the small part of an array right after its big part).
// Sq and Sk are rounded up to 128 (kPad), so that every copy of a tile stays
// inside its (batch, head); rows past Sq or Sk are zeros. A rows array holds
// an operand as it is, K-major in core matrices (8 rows x 16 bytes, 128
// contiguous bytes): core matrix (r / 8, c / 4) of a (batch, head) at word
// 32 ((r / 8) (W / 4) + c / 4). A tile array holds it transposed, a tile of T
// rows at a time (word T W for each tile before it): core matrix (c / 8,
// chunk) at word 32 ((c / 8) (T / 4) + chunk), where the chunks 2 j and 2 j +
// 1 hold the tile's rows 8 j + (0, 2, 4, 6) and 8 j + (1, 3, 5, 7): the k
// order in which an accumulator's fragment is the A fragment of the next
// product.
constexpr int kPad = 128;

struct F32Scratch {
  float *delta, *lse2;  // (B, H, sqp)
  float *qr, *dor, *qt, *dot;  // (B, H, sqp, D or DV), each then its small part
  float *kr, *vr, *kt;  // (B, Hk, skp, D or DV), each then its small part
  long long nq, ndo, nk, nv;  // the words of one part: qr and qt, dor and dot, kr and kt, vr
  int sqp, skp;
};

__host__ __device__ inline int round_pad(int n) { return (n + kPad - 1) / kPad * kPad; }

// The scratch's words at these shapes (f32_scratch's layout, which the
// wrapper mirrors to allocate it)
long long f32_scratch_words(int B, int H, int Hk, int Sq, int Sk, int D, int DV) {
  return (long long)B * H * round_pad(Sq) * (2 + 4 * D + 4 * DV) +
         (long long)B * Hk * round_pad(Sk) * (4 * D + 2 * DV);
}

F32Scratch f32_scratch(float* base, int B, int H, int Hk, int Sq, int Sk, int D, int DV) {
  F32Scratch s;
  s.sqp = round_pad(Sq);
  s.skp = round_pad(Sk);
  const long long rows_q = (long long)B * H * s.sqp, rows_k = (long long)B * Hk * s.skp;
  s.nq = rows_q * D;
  s.ndo = rows_q * DV;
  s.nk = rows_k * D;
  s.nv = rows_k * DV;
  s.delta = base;
  s.lse2 = s.delta + rows_q;
  s.qr = s.lse2 + rows_q;
  s.dor = s.qr + 2 * s.nq;
  s.qt = s.dor + 2 * s.ndo;
  s.dot = s.qt + 2 * s.nq;
  s.kr = s.dot + 2 * s.ndo;
  s.vr = s.kr + 2 * s.nk;
  s.kt = s.vr + 2 * s.nv;
  return s;
}

// Rows r0 .. r0 + 63 of one (batch, head) of an operand W wide (row r at src
// + r stride; rows from n on zeros), split once into big and small: into the
// rows array `rows` (the (batch, head)'s row 0; its small part `part` words
// on) and, where TILE, into the tile array `tiles` of tiles of T rows.
template <int W, int T, bool TILE>
__device__ __forceinline__ void prep_rows(const float* src, long long stride, int r0, int n,
                                          float* rows, float* tiles, long long part, int tid) {
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int r, int c4) {
    return r < n ? *reinterpret_cast<const float4*>(src + r * stride + 4 * c4) : zero4;
  };
  // rows: 4 columns of a row are one row of a core matrix
  for (int c = tid; c < 64 * W / 4; c += 256) {
    const int r = r0 + c / (W / 4), c4 = c % (W / 4);
    const float4 x = load(r, c4);
    uint4 bg, sm;
    split(x.x, bg.x, sm.x);
    split(x.y, bg.y, sm.y);
    split(x.z, bg.z, sm.z);
    split(x.w, bg.w, sm.w);
    uint4* d = reinterpret_cast<uint4*>(rows) + 8 * ((r >> 3) * (W / 4) + c4) + (r & 7);
    d[0] = bg;
    d[part / 4] = sm;
  }
  if constexpr (TILE) {
    // tiles: rows 8 j + p + 2 i (i < 4) of a column are one row of core matrix
    // (column / 8, 2 j + p)
    for (int u = tid; u < 4 * W; u += 256) {
      const int c4 = u % (W / 4), jp = u / (W / 4);
      const int r8 = r0 + 8 * (jp >> 1);  // the 8 rows' first
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = load(r8 + (jp & 1) + 2 * i, c4);
      const float xs[4][4] = {{x[0].x, x[1].x, x[2].x, x[3].x}, {x[0].y, x[1].y, x[2].y, x[3].y},
                              {x[0].z, x[1].z, x[2].z, x[3].z}, {x[0].w, x[1].w, x[2].w, x[3].w}};
      uint4* tile = reinterpret_cast<uint4*>(tiles + (long long)(r8 / T) * T * W);
      const int chunk = 2 * ((r8 % T) >> 3) + (jp & 1);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int col = 4 * c4 + cc;
        uint4 bg, sm;
        split(xs[cc][0], bg.x, sm.x);
        split(xs[cc][1], bg.y, sm.y);
        split(xs[cc][2], bg.z, sm.z);
        split(xs[cc][3], bg.w, sm.w);
        uint4* d = tile + 8 * ((col >> 3) * (T / 4) + chunk) + (col & 7);
        d[0] = bg;
        d[part / 4] = sm;
      }
    }
  }
}

// The query side of one (batch, head), 64 rows a block: Q and dO as rows and
// as tiles of T (dK/dV's turn), Delta = rowsum(dO o O) (a warp a row, lanes
// over columns lane, lane + 32, ..., then a fixed tree), and lse log2(e)
template <int DQK, int DV, int T>
__global__ void __launch_bounds__(256)
flash_bwd_prep_q_kernel(const float* __restrict__ q, const float* __restrict__ o,
                        const float* __restrict__ dout, const float* __restrict__ lse,
                        F32Scratch sc, Strides qs, Strides os, Strides dos, int H, int Sq) {
  const int r0 = blockIdx.x * 64, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const long long slice = (long long)b * H + h, row0 = slice * sc.sqp;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* ob = o + b * os.b + h * os.h;
  const float* db = dout + b * dos.b + h * dos.h;
  prep_rows<DQK, T, true>(qb, qs.s, r0, Sq, sc.qr + row0 * DQK, sc.qt + row0 * DQK, sc.nq, tid);
  prep_rows<DV, T, true>(db, dos.s, r0, Sq, sc.dor + row0 * DV, sc.dot + row0 * DV, sc.ndo, tid);
  const int warp = tid >> 5, lane = tid & 31;
  for (int i = warp; i < 64; i += 8) {
    const int r = r0 + i;
    float acc = 0.f;
    if (r < Sq)
#pragma unroll
      for (int c = lane; c < DV; c += 32) acc = fmaf(ob[r * os.s + c], db[r * dos.s + c], acc);
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == 0) {
      sc.delta[row0 + r] = acc;
      sc.lse2[row0 + r] = r < Sq ? lse[slice * Sq + r] * kLog2e : 0.f;
    }
  }
}

// The key side of one (batch, KV head), 64 rows a block: K as rows and as
// tiles of T (dQ's turn), V as rows
template <int DQK, int DV, int T>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kv_kernel(const float* __restrict__ k, const float* __restrict__ v, F32Scratch sc,
                         Strides ks, Strides vs, int Hk, int Sk) {
  const int r0 = blockIdx.x * 64, hk = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const long long row0 = ((long long)b * Hk + hk) * sc.skp;
  prep_rows<DQK, T, true>(k + b * ks.b + hk * ks.h, ks.s, r0, Sk, sc.kr + row0 * DQK,
                          sc.kt + row0 * DQK, sc.nk, tid);
  prep_rows<DV, T, false>(v + b * vs.b + hk * vs.h, vs.s, r0, Sk, sc.vr + row0 * DV, nullptr,
                          sc.nv, tid);
}

// The f32 route's turns: BN rows of the walked operand a turn (queries in
// dK/dV, keys in dQ), narrower at wider heads, where the resident tile takes
// more of the shared memory; two consumer warpgroups of 64 owned rows each
// up to D 64, one above.
template <int DQK>
struct F32Turn {
  static constexpr int kWG = DQK <= 64 ? 2 : 1;
  static constexpr int BM = 64 * kWG;  // rows a block owns: keys in dK/dV, queries in dQ
  static constexpr int kThreads = 128 * (1 + kWG);  // the producer warpgroup, then the consumers
  static constexpr int kConsumers = 128 * kWG;  // every "empty" barrier's count
};

// dK/dV: K and V of BM keys resident (big, small each), then stages of BN
// queries: Q, dO (rows), Q, dO (a tile), each big then small, lse log2(e) and
// Delta; then the mbarriers
template <int DQK, int DV>
struct KvF32Cfg : F32Turn<DQK> {
  using T = F32Turn<DQK>;
  static constexpr int BN = DQK <= 16 ? 64 : (DQK <= 32 ? 32 : (DQK <= 64 ? 16 : 8));
  static constexpr uint32_t kK = T::BM * DQK * 4, kV = T::BM * DV * 4;  // one part
  static constexpr uint32_t kQ = BN * DQK * 4, kDO = BN * DV * 4;
  static constexpr uint32_t kIn = 4 * (kQ + kDO) + 2 * BN * 4;  // a stage's bytes
  static constexpr uint32_t kStage = (kIn + 127) / 128 * 128;
  static constexpr int kFit = (kSmemMax - 256 - 2 * (int)(kK + kV)) / (int)kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kBars = 2 * (size_t)(kK + kV) + (size_t)kStages * kStage;
  static constexpr size_t kSmem = kBars + (2 + 2 * kStages) * 8;
  static_assert(kStages >= 1, "a stage of Q and dO must fit beside K and V");
};

// dQ: Q and dO of BM queries resident (big, small each), then stages of BN
// keys: K (rows), K (a tile), V (rows), each big then small; then the
// mbarriers
template <int DQK, int DV>
struct QF32Cfg : F32Turn<DQK> {
  using T = F32Turn<DQK>;
  static constexpr int BN = DQK <= 16 ? 64 : (DQK <= 64 ? 32 : 8);
  static constexpr uint32_t kQ = T::BM * DQK * 4, kDO = T::BM * DV * 4;  // one part
  static constexpr uint32_t kK = BN * DQK * 4, kV = BN * DV * 4;
  static constexpr uint32_t kIn = 2 * (2 * kK + kV);  // a stage's bytes
  static constexpr uint32_t kStage = (kIn + 127) / 128 * 128;
  static constexpr int kFit = (kSmemMax - 256 - 2 * (int)(kQ + kDO)) / (int)kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr size_t kBars = 2 * (size_t)(kQ + kDO) + (size_t)kStages * kStage;
  static constexpr size_t kSmem = kBars + (2 + 2 * kStages) * 8;
  static_assert(kStages >= 1, "a stage of K and V must fit beside Q and dO");
};

// acc = A B^T over W columns in 3xTF32: A a warpgroup's 64 rows, B a tile of N
// rows, both rows arrays in shared memory (big, small); issued, not waited for
template <int W, int N>
__device__ __forceinline__ void scores_f32(float (&acc)[N / 8][4], const char* a_big,
                                           const char* a_small, const char* b_big,
                                           const char* b_small) {
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {  // a k-step: two core matrices, 256 bytes
    const uint64_t ab = smem_desc(a_big + 256 * kk, 128, 32 * W);
    const uint64_t as = smem_desc(a_small + 256 * kk, 128, 32 * W);
    const uint64_t bb = smem_desc(b_big + 256 * kk, 128, 32 * W);
    const uint64_t bs = smem_desc(b_small + 256 * kk, 128, 32 * W);
    wgmma_tf32_ss<N>(acc, as, bb, kk > 0);
    wgmma_tf32_ss<N>(acc, ab, bs, 1);
    wgmma_tf32_ss<N>(acc, ab, bb, 1);
  }
}

// The big part of a warpgroup's 64 rows of a rows array W wide (`rows`, its
// first row) as tf32 A fragments: k-step kk's rows g and g + 8 of each warp's
// 16, columns 8 kk + t and 8 kk + t + 4
template <int W>
__device__ __forceinline__ void load_a(uint32_t (&a)[W / 8][4], const char* rows, int warp,
                                       int lane) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(rows) + 4 * (lane >> 2) + (lane & 3);
  const int g0 = 2 * warp * (W / 4), g1 = g0 + W / 4;  // the row groups' first core matrices
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    a[kk][0] = p[32 * (g0 + 2 * kk)];
    a[kk][1] = p[32 * (g1 + 2 * kk)];
    a[kk][2] = p[32 * (g0 + 2 * kk + 1)];
    a[kk][3] = p[32 * (g1 + 2 * kk + 1)];
  }
}
// scores_f32 with A's big part from registers (load_a's): two of a k-step's
// three products then read no A from shared memory, whose bandwidth the
// narrow turns' products (N = BN) would otherwise exceed
template <int W, int N>
__device__ __forceinline__ void scores_f32(float (&acc)[N / 8][4], const uint32_t (&a_big)[W / 8][4],
                                           const char* a_small, const char* b_big,
                                           const char* b_small) {
#pragma unroll
  for (int kk = 0; kk < W / 8; ++kk) {
    const uint64_t as = smem_desc(a_small + 256 * kk, 128, 32 * W);
    const uint64_t bb = smem_desc(b_big + 256 * kk, 128, 32 * W);
    const uint64_t bs = smem_desc(b_small + 256 * kk, 128, 32 * W);
    wgmma_tf32_ss<N>(acc, as, bb, kk > 0);
    wgmma_tf32<N>(acc, a_big[kk], bs, 1);
    wgmma_tf32<N>(acc, a_big[kk], bb, 1);
  }
}

// an accumulator of NT n-tiles, split into the tf32 A fragments of the next
// product: k-step j is n-tile j, its keys in the order of a tile array
template <int NT>
__device__ __forceinline__ void split_a(uint32_t (&big)[NT][4], uint32_t (&small)[NT][4],
                                        const float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split(x[j][0], big[j][0], small[j][0]);
    split(x[j][2], big[j][1], small[j][1]);
    split(x[j][1], big[j][2], small[j][2]);
    split(x[j][3], big[j][3], small[j][3]);
  }
}

// tot += X B over the W columns of a tile array of K rows, X from registers
// (split_a's), 64 columns at a time (from column C0 on), each in a fresh
// accumulator of at most 32 registers beside the totals: the tensor cores'
// f32 sums round less exactly than an add, so each turn's product is summed
// on its own and then added to the total
template <int W, int K, int C0 = 0>
__device__ __forceinline__ void grad_f32(float (&tot)[W / 8][4], uint32_t (&x_big)[K / 8][4],
                                         uint32_t (&x_small)[K / 8][4], const char* b_big,
                                         const char* b_small) {
  constexpr int NC = W - C0 < 64 ? W - C0 : 64;
  float f[NC / 8][4];
  fence_regs(f);
  fence_regs(x_big);
  fence_regs(x_small);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < K / 8; ++j) {  // a k-step: columns C0 .. of the tile, 8 of its rows
    const uint64_t bb = smem_desc(b_big + 4 * K * C0 + 256 * j, 128, 32 * K);
    const uint64_t bs = smem_desc(b_small + 4 * K * C0 + 256 * j, 128, 32 * K);
    wgmma_tf32<NC>(f, x_small[j], bb, j > 0);
    wgmma_tf32<NC>(f, x_big[j], bs, 1);
    wgmma_tf32<NC>(f, x_big[j], bb, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(f);
#pragma unroll
  for (int n = 0; n < NC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[C0 / 8 + n][e] += f[n][e];
  if constexpr (C0 + 64 < W) grad_f32<W, K, C0 + 64>(tot, x_big, x_small, b_big, b_small);
}

// The f32 route's dK and dV (the source note above): BM keys of one (batch,
// KV head) an item, 64 to a consumer warpgroup; a turn is BN queries of one
// query head of the group, the heads in order and in each the query tiles the
// mask leaves.
template <int DQK, int DV>
__global__ void __launch_bounds__(F32Turn<DQK>::kThreads, 1)
flash_bwd_dkdv_f32_kernel(F32Scratch sc, float* __restrict__ dk, float* __restrict__ dv,
                          Strides dks, Strides dvs, int B, int H, int Hk, int Sq, int Sk,
                          int sk_valid, int causal, int pair, float scale_log2, float scale) {
  using C = KvF32Cfg<DQK, DV>;
  constexpr int BM = C::BM, BN = C::BN, NS = C::kStages;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  auto stage = [&](int st) { return smem + 2 * (C::kK + C::kV) + (size_t)st * C::kStage; };
  // kv_full: the item's K and V have landed; kv_empty: every consumer is done
  // with them; full[s]: stage s has landed; empty[s]: every consumer is done
  // with it
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
    bar_init(kv_empty, C::kConsumers);
    for (int i = 0; i < NS; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    // the producer warpgroup: its first thread issues every copy, an item's K
    // and V once the consumers are done with the last item's, a stage once
    // they are done with its last turn
    if constexpr (C::kWG == 2) regs_down<kProducerRegs>();
    if (tid == 0) {
      int it = 0, wi = 0;
      for (int w = blockIdx.x; w < items.n_items; w += gridDim.x)
        for (int half = 0; half < items.halves(w); ++half, ++wi) {
          const Work u = work(w, half);
          if (wi > 0) bar_wait(kv_empty, (wi - 1) & 1);
          bar_expect(kv_full, 2 * (C::kK + C::kV));
          const long long kw = (((long long)u.b * Hk + u.hk) * sc.skp + u.k0);
          bulk_copy(smem, sc.kr + kw * DQK, C::kK, kv_full);
          bulk_copy(smem + C::kK, sc.kr + sc.nk + kw * DQK, C::kK, kv_full);
          bulk_copy(smem + 2 * C::kK, sc.vr + kw * DV, C::kV, kv_full);
          bulk_copy(smem + 2 * C::kK + C::kV, sc.vr + sc.nv + kw * DV, C::kV, kv_full);
          for (int i = 0; i < u.n_turns; ++i, ++it) {
            const int h = u.hk * G + i / u.per_head, q0 = (u.qt0 + i % u.per_head) * BN;
            const int st = it % NS;
            if (it >= NS) bar_wait(empty + st, (it / NS - 1) & 1);
            bar_expect(full + st, C::kIn);
            const long long qw = ((long long)u.b * H + h) * sc.sqp + q0;
            char* s = stage(st);
            bulk_copy(s, sc.qr + qw * DQK, C::kQ, full + st);
            bulk_copy(s + C::kQ, sc.qr + sc.nq + qw * DQK, C::kQ, full + st);
            bulk_copy(s + 2 * C::kQ, sc.dor + qw * DV, C::kDO, full + st);
            bulk_copy(s + 2 * C::kQ + C::kDO, sc.dor + sc.ndo + qw * DV, C::kDO, full + st);
            s += 2 * (C::kQ + C::kDO);
            bulk_copy(s, sc.qt + qw * DQK, C::kQ, full + st);
            bulk_copy(s + C::kQ, sc.qt + sc.nq + qw * DQK, C::kQ, full + st);
            bulk_copy(s + 2 * C::kQ, sc.dot + qw * DV, C::kDO, full + st);
            bulk_copy(s + 2 * C::kQ + C::kDO, sc.dot + sc.ndo + qw * DV, C::kDO, full + st);
            s += 2 * (C::kQ + C::kDO);
            bulk_copy(s, sc.lse2 + qw, BN * 4, full + st);
            bulk_copy(s + BN * 4, sc.delta + qw, BN * 4, full + st);
          }
        }
    }
    return;
  }

  if constexpr (C::kWG == 2) regs_up<kConsumerRegs>();
  const int ct = tid - 128, cw = ct >> 7, warp = (ct >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and column pair
  // this warpgroup's 64 keys of K and V, big and small
  const char* k_big = smem + cw * 64 * DQK * 4;
  const char* k_small = k_big + C::kK;
  const char* v_big = smem + 2 * C::kK + cw * 64 * DV * 4;
  const char* v_small = v_big + C::kV;

  float dk_acc[DQK / 8][4], dv_acc[DV / 8][4];
  uint32_t ka[DQK / 8][4], va[DV / 8][4];  // K's and V's big parts (two warpgroups)
  float s[BN / 8][4], dp[BN / 8][4];  // S^T then P^T; dP^T then dS^T
  uint32_t xb[BN / 8][4], xs[BN / 8][4];  // P^T, then dS^T, split as A fragments
  int it = 0, wi = 0;
  for (int w = blockIdx.x; w < items.n_items; w += gridDim.x)
    for (int half = 0; half < items.halves(w); ++half, ++wi) {
      const Work u = work(w, half);
      const int key0 = u.k0 + 64 * cw + 16 * warp + g;  // this thread's keys: key0, key0 + 8
      zero(dk_acc);
      zero(dv_acc);
      bar_wait(kv_full, wi & 1);
      if constexpr (C::kWG == 2) {
        load_a<DQK>(ka, k_big, warp, lane);
        load_a<DV>(va, v_big, warp, lane);
      }
      if (u.n_turns == 0) bar_arrive(kv_empty);
      for (int i = 0; i < u.n_turns; ++i, ++it) {
        const int st = it % NS, q0 = (u.qt0 + i % u.per_head) * BN;
        const char* sg = stage(st);
        const char* q_rows = sg;
        const char* do_rows = sg + 2 * C::kQ;
        const char* q_tile = sg + 2 * (C::kQ + C::kDO);
        const char* do_tile = q_tile + 2 * C::kQ;
        const float* ls = reinterpret_cast<const float*>(sg + 4 * (C::kQ + C::kDO));
        const float* dl = ls + BN;

        // S^T = K Q^T and dP^T = V dO^T
        bar_wait(full + st, (it / NS) & 1);
        fence_regs(s);
        fence_regs(dp);
        if constexpr (C::kWG == 2) {
          fence_regs(ka);
          fence_regs(va);
          wgmma_fence();
          scores_f32<DQK, BN>(s, ka, k_small, q_rows, q_rows + C::kQ);
          scores_f32<DV, BN>(dp, va, v_small, do_rows, do_rows + C::kDO);
        } else {
          wgmma_fence();
          scores_f32<DQK, BN>(s, k_big, k_small, q_rows, q_rows + C::kQ);
          scores_f32<DV, BN>(dp, v_big, v_small, do_rows, do_rows + C::kDO);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (i + 1 == u.n_turns) bar_arrive(kv_empty);  // K and V are read no more

        // P^T, then dS^T = P^T o (dP^T - Delta), as the bf16 route takes them;
        // element (j, e) is key key0 + 8 (e >> 1) and query q0 + 8 j + 2 t + (e
        // & 1)
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

        // dV += P^T dO, then dK += dS^T Q (scaled at the end)
        split_a<BN / 8>(xb, xs, s);
        grad_f32<DV, BN>(dv_acc, xb, xs, do_tile, do_tile + C::kDO);
        split_a<BN / 8>(xb, xs, dp);
        grad_f32<DQK, BN>(dk_acc, xb, xs, q_tile, q_tile + C::kQ);
        bar_arrive(empty + st);
      }

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = key0 + 8 * i;
        if (key >= Sk) continue;
        float* dkr = dk + u.b * dks.b + key * dks.s + u.hk * dks.h + 2 * t;
        float* dvr = dv + u.b * dvs.b + key * dvs.s + u.hk * dvs.h + 2 * t;
#pragma unroll
        for (int n = 0; n < DQK / 8; ++n)
          store2(dkr + 8 * n, dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
#pragma unroll
        for (int n = 0; n < DV / 8; ++n) store2(dvr + 8 * n, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
      }
    }
}

// The f32 route's dQ (the source note above): BM queries of one (batch, head)
// an item, 64 to a consumer warpgroup; a turn is BN keys.
template <int DQK, int DV>
__global__ void __launch_bounds__(F32Turn<DQK>::kThreads, 1)
flash_bwd_dq_f32_kernel(F32Scratch sc, float* __restrict__ dq, Strides dqs, int B, int H, int Hk,
                        int Sq, int sk_valid, int causal, int pair, float scale_log2,
                        float scale) {
  using C = QF32Cfg<DQK, DV>;
  constexpr int BM = C::BM, BN = C::BN, NS = C::kStages;
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  auto stage = [&](int st) { return smem + 2 * (C::kQ + C::kDO) + (size_t)st * C::kStage; };
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
    bar_init(q_empty, C::kConsumers);
    for (int i = 0; i < NS; ++i) {
      bar_init(full + i, 1);
      bar_init(empty + i, C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {
    if constexpr (C::kWG == 2) regs_down<kProducerRegs>();
    if (tid == 0) {
      int it = 0, wi = 0;
      for (int w = blockIdx.x; w < items.n_items; w += gridDim.x)
        for (int half = 0; half < items.halves(w); ++half, ++wi) {
          const Work u = work(w, half);
          if (wi > 0) bar_wait(q_empty, (wi - 1) & 1);
          bar_expect(q_full, 2 * (C::kQ + C::kDO));
          const long long qw = ((long long)u.b * H + u.h) * sc.sqp + u.q0;
          bulk_copy(smem, sc.qr + qw * DQK, C::kQ, q_full);
          bulk_copy(smem + C::kQ, sc.qr + sc.nq + qw * DQK, C::kQ, q_full);
          bulk_copy(smem + 2 * C::kQ, sc.dor + qw * DV, C::kDO, q_full);
          bulk_copy(smem + 2 * C::kQ + C::kDO, sc.dor + sc.ndo + qw * DV, C::kDO, q_full);
          for (int kt = 0; kt < u.n_kt; ++kt, ++it) {
            const int st = it % NS;
            if (it >= NS) bar_wait(empty + st, (it / NS - 1) & 1);
            bar_expect(full + st, C::kIn);
            const long long kw = ((long long)u.b * Hk + u.kh) * sc.skp + kt * BN;
            char* s = stage(st);
            bulk_copy(s, sc.kr + kw * DQK, C::kK, full + st);
            bulk_copy(s + C::kK, sc.kr + sc.nk + kw * DQK, C::kK, full + st);
            bulk_copy(s + 2 * C::kK, sc.kt + kw * DQK, C::kK, full + st);
            bulk_copy(s + 3 * C::kK, sc.kt + sc.nk + kw * DQK, C::kK, full + st);
            bulk_copy(s + 4 * C::kK, sc.vr + kw * DV, C::kV, full + st);
            bulk_copy(s + 4 * C::kK + C::kV, sc.vr + sc.nv + kw * DV, C::kV, full + st);
          }
        }
    }
    return;
  }

  if constexpr (C::kWG == 2) regs_up<kConsumerRegs>();
  const int ct = tid - 128, cw = ct >> 7, warp = (ct >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // this warpgroup's 64 queries of Q and dO, big and small
  const char* q_big = smem + cw * 64 * DQK * 4;
  const char* q_small = q_big + C::kQ;
  const char* do_big = smem + 2 * C::kQ + cw * 64 * DV * 4;
  const char* do_small = do_big + C::kDO;

  float dq_acc[DQK / 8][4];
  uint32_t qa[DQK / 8][4], da[DV / 8][4];  // Q's and dO's big parts (two warpgroups)
  float s[BN / 8][4], dp[BN / 8][4];  // S; dP then dS
  uint32_t xb[BN / 8][4], xs[BN / 8][4];  // dS split as A fragments
  int it = 0, wi = 0;
  for (int w = blockIdx.x; w < items.n_items; w += gridDim.x)
    for (int half = 0; half < items.halves(w); ++half, ++wi) {
      const Work u = work(w, half);
      const int w0 = u.q0 + 64 * cw + 16 * warp;  // this warp's first query
      const int r0 = w0 + g;  // this thread's rows: r0, r0 + 8
      // lse log2(e) and Delta of the thread's two rows (zeros past Sq)
      float lse2[2], dl[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long at = ((long long)u.b * H + u.h) * sc.sqp + r0 + 8 * i;
        lse2[i] = sc.lse2[at];
        dl[i] = sc.delta[at];
      }
      zero(dq_acc);
      bar_wait(q_full, wi & 1);
      if constexpr (C::kWG == 2) {
        load_a<DQK>(qa, q_big, warp, lane);
        load_a<DV>(da, do_big, warp, lane);
      }
      for (int kt = 0; kt < u.n_kt; ++kt, ++it) {
        const int st = it % NS, k0 = kt * BN;
        const char* sg = stage(st);
        const char* k_rows = sg;
        const char* k_tile = sg + 2 * C::kK;
        const char* v_rows = sg + 4 * C::kK;

        // S = Q K^T and dP = dO V^T
        bar_wait(full + st, (it / NS) & 1);
        fence_regs(s);
        fence_regs(dp);
        if constexpr (C::kWG == 2) {
          fence_regs(qa);
          fence_regs(da);
          wgmma_fence();
          scores_f32<DQK, BN>(s, qa, q_small, k_rows, k_rows + C::kK);
          scores_f32<DV, BN>(dp, da, do_small, v_rows, v_rows + C::kV);
        } else {
          wgmma_fence();
          scores_f32<DQK, BN>(s, q_big, q_small, k_rows, k_rows + C::kK);
          scores_f32<DV, BN>(dp, do_big, do_small, v_rows, v_rows + C::kV);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (kt + 1 == u.n_kt) bar_arrive(q_empty);  // Q and dO are read no more

        // P, then dS = P o (dP - Delta), as the bf16 route takes them; element
        // (j, e) is row r0 + 8 (e >> 1) and key k0 + 8 j + 2 t + (e & 1)
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

        // dQ += dS K (scaled at the end)
        split_a<BN / 8>(xb, xs, dp);
        grad_f32<DQK, BN>(dq_acc, xb, xs, k_tile, k_tile + C::kK);
        bar_arrive(empty + st);
      }
      if (u.n_kt == 0) bar_arrive(q_empty);

#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        if (r >= Sq) continue;
        float* dqr = dq + u.b * dqs.b + r * dqs.s + u.h * dqs.h + 2 * t;
#pragma unroll
        for (int n = 0; n < DQK / 8; ++n)
          store2(dqr + 8 * n, dq_acc[n][2 * i] * scale, dq_acc[n][2 * i + 1] * scale);
      }
    }
}

template <int DQK, int DV>
int launch_f32(const void* q, const void* k, const void* v, const void* o, const float* lse,
               const void* dout, void* dq, void* dk, void* dv, float* scratch,
               const long long* st, int B, int H, int Hk, int Sq, int Sk, int sk_valid,
               int causal, float scale, cudaStream_t stream) {
  using KC = KvF32Cfg<DQK, DV>;
  using QC = QF32Cfg<DQK, DV>;
  auto S = [&](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  const F32Scratch sc = f32_scratch(scratch, B, H, Hk, Sq, Sk, DQK, DV);
  flash_bwd_prep_q_kernel<DQK, DV, KC::BN><<<dim3(sc.sqp / 64, H, B), 256, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, sc, S(0), S(3), S(4), H, Sq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_prep_kv_kernel<DQK, DV, QC::BN><<<dim3(sc.skp / 64, Hk, B), 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v), sc, S(1), S(2), Hk, Sk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int dev, n_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const float scale_log2 = scale * kLog2e;

  auto kv_kernel = flash_bwd_dkdv_f32_kernel<DQK, DV>;
  if ((err = cudaFuncSetAttribute(kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)KC::kSmem)) != cudaSuccess)
    return (int)err;
  const Grid gk = persistent_grid((Sk + KC::BM - 1) / KC::BM, Hk, B, causal, n_sm);
  kv_kernel<<<gk.blocks, KC::kThreads, KC::kSmem, stream>>>(
      sc, static_cast<float*>(dk), static_cast<float*>(dv), S(6), S(7), B, H, Hk, Sq, Sk,
      sk_valid, causal, gk.pair, scale_log2, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  auto q_kernel = flash_bwd_dq_f32_kernel<DQK, DV>;
  if ((err = cudaFuncSetAttribute(q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)QC::kSmem)) != cudaSuccess)
    return (int)err;
  const Grid gq = persistent_grid((Sq + QC::BM - 1) / QC::BM, H, B, causal, n_sm);
  q_kernel<<<gq.blocks, QC::kThreads, QC::kSmem, stream>>>(
      sc, static_cast<float*>(dq), S(5), B, H, Hk, Sq, sk_valid, causal, gq.pair, scale_log2,
      scale);
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
// H, Sq) f32, the forward's log-sum-exp; delta: scratch of
// flash_attention_bwd_scratch_bytes(B, H, Hk, Sq, Sk, D, DV, is_bf16) bytes,
// 16-byte aligned (bf16: Delta, (B, H, Sq) f32; f32: Delta and the prepared
// tiles). (D, DV) is (16, 16), (32, 32), (64, 64), (128, 128) or (192, 128); H
// is a multiple of Hk; 1 <= sk_valid <= Sk. Runs three kernels (bf16) or four
// (f32) on the stream; returns cudaGetLastError() after them, the error of a
// tensor map that could not be made, or cudaErrorInvalidValue for arguments it
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
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv, delta};
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
      return which ? (long long)QF32Cfg<DQK_, DV_>::kSmem : (long long)KvF32Cfg<DQK_, DV_>::kSmem;
  });
}

// The bytes of the launch's scratch (`delta`) at these shapes, or -1 for a
// pair of head dims the kernels lack.
extern "C" long long flash_attention_bwd_scratch_bytes(int B, int H, int Hk, int Sq, int Sk, int D,
                                                       int DV, int is_bf16) {
  return dispatch(D, DV, is_bf16, [&](auto, auto, auto tag) -> long long {
    if constexpr (kIsBf16<decltype(tag)>)
      return 4LL * B * H * Sq;
    else
      return 4 * f32_scratch_words(B, H, Hk, Sq, Sk, D, DV);
  });
}
