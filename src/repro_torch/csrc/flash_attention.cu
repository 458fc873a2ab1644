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
// DQK^-0.5.
//
// Grid: the TPU version walks (B*H, Sq/BQ, Sk/BK) with the KV axis innermost
// and in order, carrying m, l and acc in scratch memory across it. Blocks here
// run in no order, so each block owns one (batch, head, 128-row query tile)
// and walks the KV tiles in order itself. Tiles that the causal mask empties
// are not visited (they would add p = 0); the longest query tiles go first.
// Operands are read through (batch, seq, head) strides, so the model's
// (B, S, H, D) layout needs no transposes, and the ragged tails of Sq and Sk
// are masked here, so nothing is padded.
//
// What bounds it: operations. At the prefill shape (B 4, S 2048, H 32, Hk 4,
// D 64, causal, f32) it does ~6.9e10 operations against ~150 MB of operands.
// On the CUDA cores (67 TFLOP/s of f32) that is 1.03 ms at best. The TF32
// tensor cores are 7x faster but keep 10 mantissa bits, ~1e-3 off in one pass.
// So the f32 products are taken as 3xTF32: each operand x splits once into
// big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and a product is
// big.big + big.small + small.big with f32 sums (small.small, ~2^-22 of it, is
// dropped). That is three TF32 products, 3 x 6.9e10 / 495e12 = 0.42 ms at best,
// and agrees with f32 to ~1e-6. bf16 inputs take one bf16 product with f32 sums.
// MLA's prefill (B 4, S 2048, H 128 over 128, (192, 128), causal, bf16) does
// ~6.9e11 operations against ~1.34 GB: 0.70 ms at the bf16 tensor cores' rate,
// above the 0.40 ms of its bytes. The f32 instance at (192, 128) keeps Q's big
// and small parts in registers (192 a thread beside acc's 64), so it spills; it
// is right, not fast, and serves the card-against-CPU checks.
//
// The instructions. f32: wgmma m64nNk8 tf32, a warpgroup (4 warps, 64 query
// rows) at a time, A (Q, then P) from registers and B (K, then V) from shared
// memory; two warpgroups to a block. A warp's accumulator fragment holds 16
// rows, a row on one quad of lanes, so the online softmax runs on the scores
// in registers (a row max or sum is two shuffles), and the scores are P.V's A
// operand with no data movement: the C fragment holds keys 2t and 2t+1 of an
// 8-key group where the tf32 A fragment wants columns t and t+4, so the
// k-step's keys are taken in the order (0, 2, 4, 6, 1, 3, 5, 7), and V is
// stored in that order. tf32 wgmma reads B K-major only, so V is stored
// transposed. bf16: mma.sync m16n8k16, a warp of 16 rows at a time, A from
// registers, B from shared memory through 32-bit loads (no split, so the
// simpler instruction; the path is not the prefill's).
//
// Copies: a first kernel prepares each KV tile of each (batch, KV head) once,
// into a scratch buffer that the wrapper allocates: f32 K and V split into big
// and small, V transposed, all in wgmma's unswizzled K-major layout of core
// matrices (8 rows by 16 bytes, 128 contiguous bytes); bf16 as K and V^T with
// padded rows. So an element is split once, not once in each of the 16 query
// tiles and 8 query heads that read it. In the attention kernel, one thread
// brings whole tiles into a ring of three shared-memory slots with
// cp.async.bulk (the copy engine, one copy a tile), completing on the slot's
// mbarrier, two tiles ahead of their use; every thread arrives on the slot's
// other mbarrier when it is done with the tile. No block barrier runs per tile.
// The two warpgroups take turns at the tensor cores through two named
// barriers, so that one's softmax runs while the other's products do. Q is
// scaled, split and kept in registers. The softmax's exp is ex2.approx of
// x log2(e) (a few ulp; the 1e-5 tolerance holds with room), and each tile's
// P.V is summed on its own before it is added to the output: the tensor cores'
// f32 sums round less exactly than an add, so their chains stay short.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kBQ = 16 * kWarps;  // query rows per block: 16 a warp
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // the reference's sentinel, not -inf
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x log2(e))

struct Strides {  // in elements; the head dim is contiguous
  long long b, s, h;
};

template <int DQK, int DV, typename T>
struct Cfg {
  static constexpr bool kF32 = sizeof(T) == 4;
  // keys per KV tile; f32 at DQK 192 takes 16, so that three ring slots of
  // split K and V^T (40 KB each) fit the block's shared memory
  static constexpr int BK = DQK <= 64 ? 64 : (kF32 && DQK > 128 ? 16 : 32);
  // bf16 tiles, in elements: rows padded so that fragment loads spread
  static constexpr int LDK = DQK + 8;  // per key row of K
  static constexpr int LDV = BK + 8;   // per d row of V^T
  // one tile as prepared and as the ring holds it; f32: K big, K small, V^T
  // big, V^T small; bf16: K, V^T
  static constexpr size_t kKs = kF32 ? 2 * (size_t)BK * DQK * 4 : (size_t)BK * LDK * 2;
  static constexpr size_t kVs = kF32 ? 2 * (size_t)BK * DV * 4 : (size_t)DV * LDV * 2;
  static constexpr size_t kTile = kKs + kVs;
  static constexpr int kSlots = 3;  // tiles in the ring
  static constexpr size_t kBars = kSlots * kTile;  // then 2 x kSlots mbarriers
  static constexpr size_t kSmem = kBars + 2 * kSlots * 8;
};

// cvt.rna.tf32.f32 on a finite x: to nearest, ties away from zero (a carry
// into the exponent is right), on the bit pattern; two integer instructions
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (to ~2^-22 of x), both tf32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// wgmma's shared-memory operand: unswizzled, K-major; `lbo` bytes between the
// two 16-byte halves of a k-step, `sbo` bytes between 8-row groups
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32;
}

// d (+)= a b: m64nNk8, tf32 in, f32 out; a warpgroup's collective
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[2][4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[4][4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[16][4], const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Named barrier `id` over the block's threads: the two warpgroups take turns
// at the tensor cores, each passing the turn once its products are issued.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}
// keep the compiler from touching the accumulators while a wgmma runs
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x, flushing results below 2^-126 to 0 (the softmax's exp)
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// The ring's hand-offs: mbarriers that every thread of the block arrives on
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar))
               : "memory");
}
// one arrival that also expects `bytes` of bulk copies to complete on it
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(bar)),
               "r"(bytes)
               : "memory");
}
// `bytes` (a multiple of 16) from global to shared by the copy engine,
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"((uint32_t)__cvta_generic_to_shared(dst)),
      "l"(src), "r"(bytes), "r"((uint32_t)__cvta_generic_to_shared(bar))
      : "memory");
}
// until the barrier's phase of this parity has completed; a wait that never
// ends traps instead of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(bar);
  for (int i = 0; i < (1 << 26); ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int DQK, int DV, typename T>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_fwd_kernel(const T* __restrict__ q, const char* __restrict__ tiles,
                           T* __restrict__ o, Strides qs, Strides os, int H, int Hk, int Sq,
                           int n_kv, int sk_valid, int causal, float scale) {
  using C = Cfg<DQK, DV, T>;
  constexpr int BK = C::BK, LDK = C::LDK, LDV = C::LDV;
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
  const T* qb = q + b * qs.b + h * qs.h;
  const char* tb = tiles + ((size_t)b * Hk + kh) * n_kv * C::kTile;  // this KV head's

  const int q_last = min(q0 + kBQ, Sq) - 1;
  int n_kt = (sk_valid + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, q_last / BK + 1);

  // ring slot `s`: K, then V^T (f32: each big, then small). full[s] completes
  // when the slot's tile has landed, empty[s] when every thread is done with it.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBars);
  uint64_t* empty = full + C::kSlots;
  auto ks_buf = [&](int slot) { return reinterpret_cast<T*>(smem + slot * C::kTile); };
  auto vs_buf = [&](int slot) {
    return reinterpret_cast<T*>(smem + slot * C::kTile + C::kKs);
  };
  // tile kt into its slot, by the copy engine in one copy (the producer)
  auto produce = [&](int kt) {
    const int slot = kt % C::kSlots;
    bar_expect(full + slot, (uint32_t)C::kTile);
    bulk_copy(smem + slot * C::kTile, tb + kt * C::kTile, (uint32_t)C::kTile, full + slot);
  };

  // Q fragments, kept in registers, in the A fragment's own order: tf32 (k-step
  // of 8 d's) columns t and t+4; bf16 (k-step of 16) columns 2t, 2t+1 and +8.
  constexpr int KQ = C::kF32 ? DQK / 8 : DQK / 16;
  uint32_t qa[KQ][4], qsm[C::kF32 ? KQ : 1][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    if constexpr (C::kF32) {
      const int d = 8 * kk + t;
      auto scaled = [&](int r, int dd) {
        return r < Sq ? __fmul_rn(qb[r * qs.s + dd], scale) : 0.f;
      };
      split(scaled(r0, d), qa[kk][0], qsm[kk][0]);
      split(scaled(r1, d), qa[kk][1], qsm[kk][1]);
      split(scaled(r0, d + 4), qa[kk][2], qsm[kk][2]);
      split(scaled(r1, d + 4), qa[kk][3], qsm[kk][3]);
    } else {
      const int d = 16 * kk + 2 * t;
      auto word = [&](int r, int dd) {
        return r < Sq ? *reinterpret_cast<const uint32_t*>(qb + r * qs.s + dd) : 0u;
      };
      qa[kk][0] = word(r0, d);
      qa[kk][1] = word(r1, d);
      qa[kk][2] = word(r0, d + 8);
      qa[kk][3] = word(r1, d + 8);
    }
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
  if (C::kF32 && my_turn == 2) turn_pass(1);

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
    // rows past Sq, or all before the tile's first key (causal), add nothing: a
    // bf16 warp skips the tile; a warpgroup takes it to keep its turns (its
    // rows' p are exactly 0 there, their running max being finite)
    const bool skip = !C::kF32 && (w0 >= Sq || (causal && k0 > w0 + 15));
    if (!skip) {
      const T* kd = ks_buf(slot);
      const T* vd = vs_buf(slot);
      float s[BK / 8][4];  // element e of n-tile j: row (e < 2 ? r0 : r1), key 8j + 2t + (e & 1)
      float pv[DV / 8][4];  // the tile's P V

      // S = Q K^T
      if constexpr (C::kF32) {
        const float* kbig = kd;
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
      } else {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            const uint32_t* kw = reinterpret_cast<const uint32_t*>(kd + (8 * j + g) * LDK) +
                                 8 * kk + t;
            mma_bf16(s[j], qa[kk], kw[0], kw[4]);
          }
      }

      // mask, then the online softmax on the fragments
      const bool masked = k0 + BK > sk_valid || (causal && k0 + BK - 1 > w0);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (!C::kF32) s[j][e] *= scale;
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

      // O = O * corr + P V
      if constexpr (C::kF32) {
        // A columns t, t+4 = keys 8j + 2t, 8j + 2t + 1: the C fragment as it is
        uint32_t pb[BK / 8][4], psm[BK / 8][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          split(s[j][0], pb[j][0], psm[j][0]);
          split(s[j][2], pb[j][1], psm[j][1]);
          split(s[j][1], pb[j][2], psm[j][2]);
          split(s[j][3], pb[j][3], psm[j][3]);
        }
        const float* vbig = vd;
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
      } else {
#pragma unroll
        for (int n = 0; n < DV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 16; ++i) {
          const uint32_t pa[4] = {pack_bf16(s[2 * i][0], s[2 * i][1]),
                                  pack_bf16(s[2 * i][2], s[2 * i][3]),
                                  pack_bf16(s[2 * i + 1][0], s[2 * i + 1][1]),
                                  pack_bf16(s[2 * i + 1][2], s[2 * i + 1][3])};
#pragma unroll
          for (int n = 0; n < DV / 8; ++n) {
            const uint32_t* vw = reinterpret_cast<const uint32_t*>(vd + (8 * n + g) * LDV) +
                                 8 * i + t;
            mma_bf16(pv[n], pa, vw[0], vw[4]);
          }
        }
#pragma unroll
        for (int n = 0; n < DV / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n][e] = acc[n][e] * corr[e >> 1] + round_bf16(pv[n][e]);
      }
    }
    bar_arrive(empty + slot);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i ? r1 : r0;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* ob = o + b * os.b + r * os.s + h * os.h + 2 * t;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const float x0 = acc[n][2 * i] / den, x1 = acc[n][2 * i + 1] / den;
      if constexpr (C::kF32) {
        *reinterpret_cast<float2*>(ob + 8 * n) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<uint32_t*>(ob + 8 * n) = pack_bf16(x0, x1);
      }
    }
  }
}

// Each KV tile of each (batch, KV head) once, in the layout the ring takes
// (split, transposed, in core matrices), into `tiles`: the main kernel's
// blocks then copy tiles as they are, and the split of a K or V element, which
// 16 query tiles and 8 query heads share, is taken once instead of in each.
// Keys at or past Sk are zeros. K is read DQK wide, V DV wide.
template <int DQK, int DV, typename T>
__global__ void __launch_bounds__(kThreads)
flash_prepare_kv_kernel(const T* __restrict__ k, const T* __restrict__ v, char* __restrict__ tiles,
                        Strides ks, Strides vs, int Hk, int Sk, int n_kv) {
  using C = Cfg<DQK, DV, T>;
  constexpr int BK = C::BK, LDK = C::LDK, LDV = C::LDV;
  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int k0 = kt * BK;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  char* tile = tiles + (((size_t)b * Hk + kh) * n_kv + kt) * C::kTile;
  if constexpr (C::kF32) {
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
  } else {
    T* kd = reinterpret_cast<T*>(tile);  // (BK, LDK)
    T* vd = reinterpret_cast<T*>(tile + C::kKs);  // (DV, LDV)
    const T zero = __ushort_as_bfloat16(0);
    for (int i = tid; i < BK * DQK; i += kThreads) {
      const int key = i / DQK, d = i % DQK;
      kd[key * LDK + d] = k0 + key < Sk ? kb[(k0 + key) * ks.s + d] : zero;
    }
    for (int i = tid; i < BK * DV; i += kThreads) {
      const int key = i % BK, d = i / BK;
      vd[d * LDV + key] = k0 + key < Sk ? vb[(k0 + key) * vs.s + d] : zero;
    }
  }
}

template <int DQK, int DV, typename T>
size_t scratch_bytes(int B, int Hk, int sk_valid) {
  using C = Cfg<DQK, DV, T>;
  return (size_t)B * Hk * ((sk_valid + C::BK - 1) / C::BK) * C::kTile;
}

template <int DQK, int DV, typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* tiles,
           const long long* st, int B, int H, int Hk, int Sq, int Sk, int sk_valid, int causal,
           float scale, cudaStream_t stream) {
  using C = Cfg<DQK, DV, T>;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]}, vs{st[6], st[7], st[8]},
      os{st[9], st[10], st[11]};
  const int n_kv = (sk_valid + C::BK - 1) / C::BK;
  flash_prepare_kv_kernel<DQK, DV, T><<<dim3(n_kv, Hk, B), kThreads, 0, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<char*>(tiles), ks, vs, Hk,
      Sk, n_kv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kernel = flash_attention_fwd_kernel<DQK, DV, T>;
  if (C::kSmem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::kSmem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(static_cast<const T*>(q),
                                                static_cast<const char*>(tiles),
                                                static_cast<T*>(o), qs, os, H, Hk, Sq, n_kv,
                                                sk_valid, causal, scale);
  return (int)cudaGetLastError();
}

// f(Cfg's DQK, DV and T as template arguments) for a compiled pair of head
// dims and a type, or -1
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

// q: (B, Sq, H, D); k: (B, Sk, Hk, D); v: (B, Sk, Hk, DV); o: (B, Sq, H, DV); all
// f32 (is_bf16 = 0) or all bf16 (is_bf16 = 1), each addressed by its (batch, seq,
// head) strides in elements, strides[3 * operand + axis] for operands q, k, v, o;
// the head dim is contiguous, and every pointer and row (each stride times the
// element size) is 16-byte aligned. (D, DV) is (16, 16), (32, 32), (64, 64),
// (128, 128) or (192, 128); H is a multiple of Hk; 1 <= sk_valid <= Sk. scratch:
// flash_attention_scratch_bytes(B, Hk, sk_valid, D, DV, is_bf16) bytes, 16-byte
// aligned, for the prepared KV tiles. Two kernels run on the stream; returns
// cudaGetLastError() after the launches.
extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          void* scratch, long long scratch_bytes,
                                          const long long* strides, int B, int H, int Hk, int Sq,
                                          int Sk, int D, int DV, int sk_valid, int causal,
                                          int is_bf16, float scale, void* stream);

// The scratch bytes a launch needs, or -1 for a pair of head dims the kernel lacks.
extern "C" long long flash_attention_scratch_bytes(int B, int Hk, int sk_valid, int D, int DV,
                                                   int is_bf16) {
  return dispatch(D, DV, is_bf16, [&](auto d, auto dv, auto tag) -> long long {
    return (long long)scratch_bytes<decltype(d)::value, decltype(dv)::value, decltype(tag)>(
        B, Hk, sk_valid);
  });
}

extern "C" int flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                          void* scratch, long long scratch_bytes,
                                          const long long* strides, int B, int H, int Hk, int Sq,
                                          int Sk, int D, int DV, int sk_valid, int causal,
                                          int is_bf16, float scale, void* stream) {
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
  return (int)dispatch(D, DV, is_bf16, [&](auto d, auto dv, auto tag) -> long long {
    return launch<decltype(d)::value, decltype(dv)::value, decltype(tag)>(
        q, k, v, o, scratch, strides, B, H, Hk, Sq, Sk, sk_valid, causal, scale, s);
  });
}

// The dynamic shared memory, in bytes, that a launch at head dims (D, DV) takes.
extern "C" int flash_attention_smem_bytes(int D, int DV, int is_bf16) {
  return (int)dispatch(D, DV, is_bf16, [](auto d, auto dv, auto tag) -> long long {
    return (long long)Cfg<decltype(d)::value, decltype(dv)::value, decltype(tag)>::kSmem;
  });
}
