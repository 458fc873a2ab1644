// Ordered scatter-add for the SSD simulator's observability sums, CUDA C++
// for sm_90a.
//
// Replaces no Pallas kernel. It computes what the reference's
// `.at[idx].add(src, mode="drop")` computes in src/repro/ssdsim/obs.py
// (`record_reads`: the time series `obs_ts` and the per-(mode, bin)
// component sums `obs_lat_comp`): each lane of src (L, C) float32 is added
// into the running value of the row of dst that idx names, one lane after
// another in lane order, and lanes whose index lies outside [0, N) are
// dropped. Float addition does not commute under rounding, so the order of
// the adds is the function: atomics (PyTorch's `index_add_` and
// `index_put_(accumulate=True)` on CUDA) give another sum on every run, and a
// per-chunk sum added afterwards rounds once more than the reference does.
//
// One launch takes one or two segments, each its own (dst, idx, src, out):
// a chunk's two instruments in one launch. A segment's dst and out are read
// and written through strides, row r at (r / R) * group_stride + (r % R) *
// row_stride and column c at c * col_stride, so that obs_lat_comp's (mode,
// component, bin) layout is taken as it lies, its (mode, bin) pairs as rows.
//
// What bounds it: the chains of adds. A real chunk sends most of its lanes
// to one or a few rows (a closed-loop chunk's reads all take the chunk's one
// clock, so one window of obs_ts gets all 1,024 of them), and an element's
// chain cannot be split: its time is its row's hits x one FADD's latency,
// after the launch. The bytes (tens of KB) take nanoseconds.
//
// Design: a block takes kWarps rows of one segment, a warp a row, and a
// thread the row's columns lane, lane + 32, ... For each tile of lanes, one
// thread has the copy engine bring the lanes' indices and values into shared
// memory (`cp.async.bulk` on two mbarriers, the indices first; plain loads
// where a source is not 16-byte aligned or its size not a multiple of 16).
// Each warp then compacts the lanes that name its row into a list, in lane
// order, by ballot and popc, with no branch and no adds. Then it walks the
// list with the next group of hits' values already in registers: a group's
// loads are issued before the adds of the group before it, and no load
// waits on a predicate, so each add waits only on the add before it. No two
// threads write one address; no atomics.
//
// On an H100 (PERF.md) the staging and the compaction take ~2.5 us over the
// launch floor, and the walk ~6 cycles a hit: beside each FADD the warp
// issues, in order, a shared load and its address. A block-wide stable sort,
// and runs gathered column by column and read 16 bytes at a time (~4 cycles
// a hit), were tried; the sort and the gather cost more than they saved.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block, one a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxColumns = 128;  // four a thread
constexpr int kMaxSegments = 2;
constexpr int kSegmentArgs = 11;  // int64 values a segment takes at the C interface
constexpr int kSmemBudget = 200 * 1024;  // a tile: its indices, values and the warps' lists
constexpr int kMaxTile = 8192;

struct Segment {
  const float* dst;
  float* out;
  const int64_t* idx;
  const float* src;  // (L, C), contiguous
  long long group_stride, row_stride, col_stride;
  int rows_per_group, n, c, l;
  int tile;    // lanes staged at a time, a multiple of 32
  int blocks;  // blocks of this segment: kWarps rows each
};

struct Segments {
  Segment seg[kMaxSegments];
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// shared memory of a segment's block: two mbarriers, then a tile's indices,
// values and each warp's list, each part 16-byte aligned
__host__ __device__ int values_at(int tile) { return 16 + 8 * tile; }
__host__ __device__ int lists_at(int tile, int c) {
  return values_at(tile) + round_up(4 * tile * c, 16);
}
__host__ __device__ int list_len(int tile) { return tile + 32; }  // misses' slots past the hits
__host__ __device__ int smem_bytes(int tile, int c) {
  return lists_at(tile, c) + 4 * kWarps * list_len(tile);
}

__device__ __forceinline__ bool bulk_ok(const void* p, long long bytes) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (bytes & 15) == 0 && bytes > 0;
}

// hits' values per group: a group's loads cover the adds of the group
// before it (U adds of 4 cycles each against two dependent shared loads)
template <int KC>
struct Group {
  static constexpr int U = KC == 1 ? 32 : (KC == 2 ? 16 : 8);
};

// the values of hits [h, h + U) (in the last group, those below `end`) of
// this thread's columns: `list` holds each hit's byte offset into the tile's
// values, `at[k]` points at this thread's column k there (a column past C at
// the first: a load that is never added, so that none waits on a predicate)
template <int KC, bool kPartial>
__device__ __forceinline__ void fetch(float (&v)[Group<KC>::U][KC], const int* list, int h,
                                      int end, const char* const (&at)[KC]) {
  constexpr int U = Group<KC>::U;
#pragma unroll
  for (int u4 = 0; u4 < U; u4 += 4) {
    const int4 o4 = *reinterpret_cast<const int4*>(list + h + u4);
    const int o[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (!kPartial || h + u4 + q < end) {
          v[u4 + q][k] = *reinterpret_cast<const float*>(at[k] + o[q]);
        }
      }
    }
  }
}

template <int KC, bool kPartial>
__device__ __forceinline__ void add(float (&acc)[KC], const float (&v)[Group<KC>::U][KC], int h,
                                    int end) {
#pragma unroll
  for (int u = 0; u < Group<KC>::U; ++u) {
    if (kPartial && h + u >= end) break;
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[k] = __fadd_rn(acc[k], v[u][k]);
  }
}

// acc += the listed hits' values, one after another in list order. Two
// groups of registers in turn: the next group's loads sit in the same block
// as this group's adds, with no branch between them, so that they are issued
// first and the adds wait only on one another.
template <int KC>
__device__ __forceinline__ void walk(float (&acc)[KC], const int* list, int count,
                                     const char* const (&at)[KC]) {
  constexpr int U = Group<KC>::U;
  const int groups = count / U;  // whole groups; the rest after them
  float a[U][KC], b[U][KC];
  if (groups > 0) fetch<KC, false>(a, list, 0, count, at);
  int g = 0;
  for (; g + 2 <= groups; g += 2) {  // a holds group g
    fetch<KC, false>(b, list, (g + 1) * U, count, at);
    add<KC, false>(acc, a, 0, count);
    fetch<KC, false>(a, list, min(g + 2, groups - 1) * U, count, at);  // the last again at the end
    add<KC, false>(acc, b, 0, count);
  }
  if (g < groups) add<KC, false>(acc, a, 0, count);
  const int h = groups * U;
  if (h < count) {
    fetch<KC, true>(a, list, h, count, at);
    add<KC, true>(acc, a, h, count);
  }
}

template <int KC>
__global__ void __launch_bounds__(kThreads)
    ordered_scatter_add_kernel(const __grid_constant__ Segments p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool second = blockIdx.x >= p.seg[0].blocks;
  const Segment s = second ? p.seg[1] : p.seg[0];  // in registers, field by field
  const int block = blockIdx.x - (second ? p.seg[0].blocks : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // [0] indices, [1] values
  int64_t* rows = reinterpret_cast<int64_t*>(smem + 16);
  float* vals = reinterpret_cast<float*>(smem + values_at(s.tile));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* list = reinterpret_cast<int*>(smem + lists_at(s.tile, s.c)) + warp * list_len(s.tile);
  const int row = block * kWarps + warp;
  const bool active = row < s.n;  // the whole warp: all its threads share the row
  if (threadIdx.x == 0) {
    bar_init(&bars[0], 1);
    bar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  long long at_row = 0;
  bool on[KC];
  float acc[KC];
  if (active) {
    at_row = static_cast<long long>(row / s.rows_per_group) * s.group_stride +
             static_cast<long long>(row % s.rows_per_group) * s.row_stride;
  }
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    on[k] = active && lane + 32 * k < s.c;
    acc[k] = on[k] ? s.dst[at_row + (lane + 32 * k) * s.col_stride] : 0.0f;
  }
  const int c4 = 4 * s.c;  // bytes between two lanes' values
  const char* at[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    at[k] = reinterpret_cast<const char*>(vals + (on[k] ? lane + 32 * k : 0));
  }
  const unsigned below = (1u << lane) - 1;
  int phase_idx = 0, phase_val = 0;
  // thread 0 has the copy engine bring the tile at `base`, where its source
  // allows; the block loads the rest itself
  auto stage = [&](int base, bool& idx_bulk, bool& val_bulk) {
    const int n = min(s.tile, s.l - base);
    const int64_t* from_idx = s.idx + base;
    const float* from_val = s.src + static_cast<long long>(base) * s.c;
    idx_bulk = bulk_ok(from_idx, 8LL * n);
    val_bulk = bulk_ok(from_val, 4LL * n * s.c);
    if (threadIdx.x == 0) {
      // the generic proxy's reads of the last tile come before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (idx_bulk) {
        bar_expect(&bars[0], 8u * n);
        bulk_copy(rows, from_idx, 8u * n, &bars[0]);
      }
      if (val_bulk) {
        bar_expect(&bars[1], 4u * n * s.c);
        bulk_copy(vals, from_val, 4u * n * s.c, &bars[1]);
      }
    }
    if (!idx_bulk) {
      for (int i = threadIdx.x; i < n; i += kThreads) rows[i] = from_idx[i];
    }
    if (!val_bulk) {
      for (int i = threadIdx.x; i < n * s.c; i += kThreads) vals[i] = from_val[i];
    }
  };
  bool idx_bulk = false, val_bulk = false;
  if (s.l > 0) stage(0, idx_bulk, val_bulk);  // thread 0 set up the barriers it arms
  __syncthreads();  // the barriers are set up, and any plain loads done
  for (int base = 0; base < s.l; base += s.tile) {
    const int n = min(s.tile, s.l - base);
    if (idx_bulk) {
      bar_wait(&bars[0], phase_idx);
      phase_idx ^= 1;
    }
    // the row's hits in lane order, as byte offsets of their values, and no
    // adds: each lane stores, a hit at its rank among the hits, a miss past
    // them (later hits take those slots), so that no branch holds the next
    // loads back
    int count = 0;
    if (active) {
      for (int j0 = 0; j0 < n; j0 += 128) {
        int64_t r[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) r[q] = rows[min(j0 + 32 * q + lane, n - 1)];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + 32 * q + lane;
          const bool hit = j < n && r[q] == row;
          const unsigned mask = __ballot_sync(0xffffffffu, hit);
          const int rank = __popc(mask & below), hits = __popc(mask);
          list[count + (hit ? rank : hits + lane - rank)] = j * c4;
          count += hits;
        }
      }
      __syncwarp();
    }
    if (val_bulk) {
      bar_wait(&bars[1], phase_val);
      phase_val ^= 1;
    }
    if (active) walk<KC>(acc, list, count, at);
    if (base + s.tile < s.l) {
      __syncthreads();  // the tile has been read
      stage(base + s.tile, idx_bulk, val_bulk);
      if (!idx_bulk || !val_bulk) __syncthreads();
    }
  }
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (on[k]) s.out[at_row + (lane + 32 * k) * s.col_stride] = acc[k];
  }
}

// lanes a tile: as many as the budget holds, a multiple of 32, at most L
// rounded up to 32
int tile_for(int c, int l) {
  const int fit = (kSmemBudget - 16 - 4 * kWarps * 32) / (8 + 4 * c + 4 * kWarps) / 32 * 32;
  return std::min(std::min(fit, kMaxTile), std::max(32, round_up(l, 32)));
}

template <int KC>
int launch(const Segments& p, int blocks, int smem, cudaStream_t stream) {
  // the opt-in above 48 KB of dynamic shared memory, once a device
  constexpr int kDevices = 64;
  static cudaError_t opted[kDevices];
  static bool tried[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!tried[dev]) {
    opted[dev] = cudaFuncSetAttribute(ordered_scatter_add_kernel<KC>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      kSmemBudget + 16);
    tried[dev] = true;
  }
  if (opted[dev] != cudaSuccess) return static_cast<int>(opted[dev]);
  ordered_scatter_add_kernel<KC><<<blocks, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over `count` (1 or 2) segments. `args` holds kSegmentArgs int64
// values a segment: dst, out, idx, src (device pointers), then N, C, L, R
// (rows a group), group stride, row stride, column stride (in elements).
// dst and out: N rows of C float32 (C <= 128) at those strides, N a multiple
// of R; idx: (L,) int64; src: (L, C) float32, contiguous. out may not
// overlap dst, src or another segment's out. Returns cudaGetLastError()
// after the launch.
extern "C" int ordered_scatter_add_launch(int count, const long long* args, void* stream) {
  if (count < 1 || count > kMaxSegments) return static_cast<int>(cudaErrorInvalidValue);
  Segments p{};
  int blocks = 0, smem = 0, kc = 1;
  for (int i = 0; i < count; ++i) {
    const long long* a = args + i * kSegmentArgs;
    Segment& s = p.seg[i];
    s.dst = reinterpret_cast<const float*>(a[0]);
    s.out = reinterpret_cast<float*>(a[1]);
    s.idx = reinterpret_cast<const int64_t*>(a[2]);
    s.src = reinterpret_cast<const float*>(a[3]);
    s.n = static_cast<int>(a[4]);
    s.c = static_cast<int>(a[5]);
    s.l = static_cast<int>(a[6]);
    s.rows_per_group = static_cast<int>(a[7]);
    s.group_stride = a[8];
    s.row_stride = a[9];
    s.col_stride = a[10];
    if (s.n < 1 || s.c < 1 || s.c > kMaxColumns || s.l < 0 || s.rows_per_group < 1 ||
        s.n % s.rows_per_group != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    s.tile = tile_for(s.c, s.l);
    s.blocks = (s.n + kWarps - 1) / kWarps;
    blocks += s.blocks;
    smem = std::max(smem, smem_bytes(s.tile, s.c));
    kc = std::max(kc, (s.c + 31) / 32);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kc) {
    case 1: return launch<1>(p, blocks, smem, st);
    case 2: return launch<2>(p, blocks, smem, st);
    case 3: return launch<3>(p, blocks, smem, st);
    default: return launch<4>(p, blocks, smem, st);
  }
}
