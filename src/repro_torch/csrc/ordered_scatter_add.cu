// Ordered scatter-add for the SSD simulator's observability sums, CUDA C++
// for sm_90a.
//
// Replaces no Pallas kernel. It computes what the reference's
// `.at[idx].add(src, mode="drop")` computes in src/repro/ssdsim/obs.py
// (`record_reads`: the time series `obs_ts` and the per-(mode, bin)
// component sums `obs_lat_comp`): each lane of src (L, C) float32 is added
// into the running value of the row of dst (N, C) that idx names, one lane
// after another in lane order, and lanes whose index lies outside [0, N) are
// dropped. Float addition does not commute under rounding, so the order of
// the adds is the function: atomics (PyTorch's `index_add_` and
// `index_put_(accumulate=True)` on CUDA) give another sum on every run, and a
// per-chunk sum added afterwards rounds once more than the reference does.
//
// Design: one warp per destination row; lane j of the warp holds columns j,
// j + 32, ... (at most kMaxColumns). The block stages a tile of lanes, their
// indices and values, in shared memory, every thread loading its share so
// that all the loads are in flight together; then each warp walks the tile
// 32 lanes at a time: each of its threads reads one lane's index, a ballot
// marks the lanes that name the row, and the warp adds those lanes in lane
// order, each thread into its columns. So every element's chain of adds is
// the reference's, and no two threads write one address. No atomics.
//
// What bounds it: launch latency. At the simulator's shapes (obs_ts 64 x 9,
// obs_lat_comp 3 * 64 x 6, L = 128-1,024 lanes a chunk) a launch reads
// about 40 KB, nanoseconds at the card's memory rate. A thread that reads
// the lanes from device memory one after another waits on a chain of
// dependent loads several times as long as the launch (PERF.md, from
// chip_smoke.py's `times` phase); staging the tile takes that chain out.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxChunks = 4;  // columns a thread holds: kMaxColumns = 128
constexpr int kSmemBytes = 48 * 1024;  // static limit: no opt-in needed

__global__ void __launch_bounds__(kThreads)
    ordered_scatter_add_kernel(const float* __restrict__ dst, const int64_t* __restrict__ idx,
                               const float* __restrict__ src, float* __restrict__ out, int N,
                               int C, int L, int tile) {
  extern __shared__ int smem[];
  int* rows = smem;                                     // tile lanes' rows, -1: dropped
  float* vals = reinterpret_cast<float*>(smem + tile);  // tile x C values
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const bool active = row < N;  // the whole warp: all its threads share the row
  float acc[kMaxChunks];
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int col = lane + 32 * k;
    acc[k] = active && col < C ? dst[static_cast<int64_t>(row) * C + col] : 0.0f;
  }
  for (int base = 0; base < L; base += tile) {
    const int n = min(tile, L - base);
    __syncthreads();  // the previous tile has been read
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int64_t r = idx[base + i];
      rows[i] = (r >= 0 && r < N) ? static_cast<int>(r) : -1;
    }
    const float* from = src + static_cast<int64_t>(base) * C;
    for (int i = threadIdx.x; i < n * C; i += kThreads) vals[i] = from[i];
    __syncthreads();
    if (!active) continue;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const bool hit = j0 + lane < n && rows[j0 + lane] == row;
      for (unsigned mask = __ballot_sync(0xffffffffu, hit); mask; mask &= mask - 1) {
        const float* v = vals + (j0 + __ffs(mask) - 1) * C;  // the hits in lane order
#pragma unroll
        for (int k = 0; k < kMaxChunks; ++k) {
          const int col = lane + 32 * k;
          if (col < C) acc[k] = __fadd_rn(acc[k], v[col]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int col = lane + 32 * k;
    if (col < C) out[static_cast<int64_t>(row) * C + col] = acc[k];
  }
}

}  // namespace

// dst, out: (N, C) float32, contiguous, C <= 128; idx: (L,) int64; src: (L, C)
// float32, contiguous. out may not alias dst or src. Returns
// cudaGetLastError() after the launch.
extern "C" int ordered_scatter_add_launch(const void* dst, const void* idx, const void* src,
                                          void* out, int N, int C, int L, void* stream) {
  if (N < 1 || C < 1 || C > 32 * kMaxChunks || L < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // lanes a tile: as many as the shared memory holds, a multiple of 32, at most L
  const int fit = (kSmemBytes / (4 * (1 + C))) / 32 * 32;
  const int tile = L < fit ? (L > 0 ? L : 1) : fit;
  const int blocks = (N + kWarps - 1) / kWarps;
  ordered_scatter_add_kernel<<<blocks, kThreads, tile * 4 * (1 + C),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dst), static_cast<const int64_t*>(idx),
      static_cast<const float*>(src), static_cast<float*>(out), N, C, L, tile);
  return static_cast<int>(cudaGetLastError());
}
