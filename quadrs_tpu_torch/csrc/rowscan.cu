// Row sums and exclusive prefix sums in a fixed order, for Hopper (sm_90a):
// the trailing stages' reductions (quadrs_tpu_torch/stream.py DcBlock, Agc).
//
// Replaces no TPU kernel.  The JAX package takes DcBlock's and Agc's
// trailing sums from XLA's jnp.cumsum (quadrs_tpu/stream.py:317 and :367);
// the port's DcBlock also centres each block on its mean first.  torch's
// CUDA cumsum and row mean choose their blocking by the tensor's shape, so
// a window's samples moved with the windows batched beside it.  Here the
// order of additions behind every output is fixed by the row length L and
// the constants below alone: not by the number of rows, the launch or the
// timing.  No atomics, no look-back that takes whichever predecessor is
// ready.  The Python wrappers and the plain PyTorch versions are in
// quadrs_tpu_torch/ops/rowscan.py.
//
// A row is L elements of C f32 channels, interleaved: C 1 is f32, C 2 is
// complex64 as (re, im) pairs, each channel summed on its own (a complex
// add is two independent f32 adds).  A tile is kTile = 4096 consecutive
// elements of a row; thread t of a tile's block owns its elements
// [t*kPer, (t+1)*kPer).  The order, per channel:
//  * pass 1 (tile_sums_kernel, a block per tile and row): a thread adds its
//    kPer elements in order from 0; a warp adds its lanes' sums by
//    __shfl_down_sync at 16, 8, 4, 2, 1; thread 0 adds the eight warps' sums
//    in order from 0.  That is the tile's sum.
//  * pass 2 (tile_scan_kernel, a warp per row): the row's tile sums, 32 at a
//    time, through an inclusive Kogge-Stone shuffle scan (offsets 1 to 16);
//    each tile's offset is the carry of the chunks before it plus its
//    exclusive prefix in the chunk, and the carry after the last chunk is
//    the row's sum.
//  * pass 3 (tile_prefix_kernel, a block per tile and row): a thread's
//    running sums of its elements from 0; a Kogge-Stone shuffle scan of the
//    threads' totals in a warp; thread 0 adds the warps' totals in order to
//    the tile's offset; output e + 1 is (the warp's offset + the thread's
//    exclusive prefix) + the thread's running sum at e.  Output 0 is 0.
// The prefix of x - sub[row] (sub optional, one value a channel and row)
// subtracts as it loads, in passes 1 and 3, so DcBlock scans its centred
// block without writing it to memory.
//
// What bounds it on the H100: bytes.  A row sum reads each element once
// (pass 1; 8 bytes a complex64 element) and writes 8 bytes a tile; a
// prefix reads each element twice (passes 1 and 3) and writes it once: 24
// bytes a complex64 element, 12 an f32 one.  Pass 2 touches 8 bytes a tile
// twice.  Each pass stages its tile through shared memory (a padded index,
// i + i/32, keeps a thread's run of kPer elements off a shared bank), so
// loads and stores are coalesced.  Reading the block once in a fused pass
// is a later change's: this form is simple, and its order is the contract.

#include <cuda_runtime.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 16;                 // elements a thread owns in a tile
constexpr int kTile = kThreads * kPer;   // elements a tile: ops/rowscan.TILE
constexpr int kWarps = kThreads / 32;
constexpr int kScanWarps = 4;            // rows a block of pass 2
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxRowsY = 65535;   // gridDim.y; more rows loop

__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Stage the tile at element e0 of row `row` into s as f32 (less sub[row]
// when given), consecutive threads on consecutive floats; elements past
// the row's end are 0.
template <int C>
__device__ __forceinline__ void stage_tile(const float* __restrict__ x, long long len, long long row,
                                           long long e0, const float* __restrict__ sub, float* s) {
  const float* src = x + (row * len + e0) * C;
  const long long left = len - e0;
  const int n = static_cast<int>((left < kTile ? left : kTile) * C);  // floats of the row in this tile
  float sc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) sc[c] = sub != nullptr ? sub[row * C + c] : 0.0f;
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    float v = 0.0f;
    if (i < n) v = sub != nullptr ? src[i] - sc[i % C] : src[i];
    s[pad(i)] = v;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    tile_sums_kernel(const float* __restrict__ x, long long rows, long long len, const float* __restrict__ sub,
                     int n_tiles, float* __restrict__ tile_sums) {
  __shared__ float s[kTile * C + kTile * C / 32];
  __shared__ float warp_sums[kWarps][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long e0 = static_cast<long long>(blockIdx.x) * kTile;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    stage_tile<C>(x, len, row, e0, sub, s);
    __syncthreads();
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    const int base = threadIdx.x * kPer * C;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += s[pad(base + k * C + c)];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc[c] += __shfl_down_sync(kFull, acc[c], off);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) warp_sums[warp][c] = acc[c];
    }
    __syncthreads();
    if (threadIdx.x < C) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += warp_sums[w][threadIdx.x];
      tile_sums[(row * n_tiles + blockIdx.x) * C + threadIdx.x] = t;
    }
    __syncthreads();  // s and warp_sums are the next row's
  }
}

// tile_offsets (rows, n_tiles, C) and row_sums (rows, C) may each be null
template <int C>
__global__ void __launch_bounds__(kScanWarps * 32)
    tile_scan_kernel(long long rows, int n_tiles, const float* __restrict__ tile_sums,
                     float* __restrict__ tile_offsets, float* __restrict__ row_sums) {
  const long long row = static_cast<long long>(blockIdx.x) * kScanWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float carry = 0.0f;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const long long at = (row * n_tiles + t) * C + c;
      float v = t < n_tiles ? tile_sums[at] : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += y;
      }
      float excl = __shfl_up_sync(kFull, v, 1);
      if (lane == 0) excl = 0.0f;
      if (tile_offsets != nullptr && t < n_tiles) tile_offsets[at] = carry + excl;
      carry += __shfl_sync(kFull, v, 31);
    }
    if (row_sums != nullptr && lane == 0) row_sums[row * C + c] = carry;
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    tile_prefix_kernel(const float* __restrict__ x, long long rows, long long len, const float* __restrict__ sub,
                       int n_tiles, const float* __restrict__ tile_offsets, float* __restrict__ out) {
  __shared__ float s[kTile * C + kTile * C / 32];
  __shared__ float warp_tot[kWarps][C];
  __shared__ float warp_off[kWarps][C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long e0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long left = len - e0;
  const int n = static_cast<int>((left < kTile ? left : kTile) * C);
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    stage_tile<C>(x, len, row, e0, sub, s);
    __syncthreads();
    const int base = threadIdx.x * kPer * C;
    float run[kPer][C];
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c] += s[pad(base + k * C + c)];
        run[k][c] = acc[c];
      }
    float excl[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v = acc[c];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, v, off);
        if (lane >= off) v += y;
      }
      excl[c] = __shfl_up_sync(kFull, v, 1);
      if (lane == 0) excl[c] = 0.0f;
      if (lane == 31) warp_tot[warp][c] = v;
    }
    __syncthreads();
    if (threadIdx.x < C) {
      float o = tile_offsets[(row * n_tiles + blockIdx.x) * C + threadIdx.x];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        warp_off[w][threadIdx.x] = o;
        o += warp_tot[w][threadIdx.x];
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float b = warp_off[warp][c] + excl[c];
#pragma unroll
      for (int k = 0; k < kPer; ++k) s[pad(base + k * C + c)] = b + run[k][c];
    }
    __syncthreads();
    float* dst = out + (row * (len + 1) + e0 + 1) * C;
    for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = s[pad(i)];
    if (blockIdx.x == 0 && threadIdx.x < C) out[row * (len + 1) * C + threadIdx.x] = 0.0f;
    __syncthreads();  // s, warp_tot and warp_off are the next row's
  }
}

// The arguments both entry points share, checked; n_tiles on success.
int plan(int channels, long long rows, long long len, int tile, int* n_tiles) {
  if ((channels != 1 && channels != 2) || rows < 1 || len < 1 || tile != kTile) return -1;
  const long long nt = (len + kTile - 1) / kTile;
  if (nt > 0x7fffffffLL) return -1;
  *n_tiles = static_cast<int>(nt);
  return 0;
}

template <int C>
int launch(int device, const float* x, long long rows, long long len, const float* sub, int n_tiles,
           float* tile_sums, float* tile_offsets, float* row_sums, float* out, void* stream) {
  const qt::DeviceScope scope(device);
  cudaError_t err = scope.status();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(rows < kMaxRowsY ? rows : kMaxRowsY));
  tile_sums_kernel<C><<<grid, kThreads, 0, st>>>(x, rows, len, sub, n_tiles, tile_sums);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long scan_blocks = (rows + kScanWarps - 1) / kScanWarps;
  tile_scan_kernel<C><<<static_cast<unsigned>(scan_blocks), kScanWarps * 32, 0, st>>>(rows, n_tiles, tile_sums,
                                                                                      tile_offsets, row_sums);
  err = cudaGetLastError();
  if (err != cudaSuccess || out == nullptr) return static_cast<int>(err);
  tile_prefix_kernel<C><<<grid, kThreads, 0, st>>>(x, rows, len, sub, n_tiles, tile_offsets, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points take: channels (1: f32 rows, 2: complex64 rows as
// (re, im) pairs), the device, the (rows, len, channels) f32 input,
// contiguous, rows >= 1 and len >= 1, and the tile the caller counted its
// scratch in (must be kTile).  tile_sums (and tile_offsets) are (rows,
// ceil(len / tile), channels) f32 scratch.
extern "C" {

// (rows, channels) f32 row sums into sums.
int qt_row_sum(int channels, int device, const float* x, long long rows, long long len, int tile, float* tile_sums,
               float* sums, void* stream) {
  int n_tiles = 0;
  if (plan(channels, rows, len, tile, &n_tiles) != 0) return static_cast<int>(cudaErrorInvalidValue);
  return channels == 1
             ? launch<1>(device, x, rows, len, nullptr, n_tiles, tile_sums, nullptr, sums, nullptr, stream)
             : launch<2>(device, x, rows, len, nullptr, n_tiles, tile_sums, nullptr, sums, nullptr, stream);
}

// (rows, len + 1, channels) f32 exclusive prefix sums of x - sub into out,
// out[:, 0] = 0; sub: (rows, channels) f32, or null for none.
int qt_row_exclusive_prefix(int channels, int device, const float* x, long long rows, long long len,
                            const float* sub, int tile, float* tile_sums, float* tile_offsets, float* out,
                            void* stream) {
  int n_tiles = 0;
  if (plan(channels, rows, len, tile, &n_tiles) != 0) return static_cast<int>(cudaErrorInvalidValue);
  return channels == 1
             ? launch<1>(device, x, rows, len, sub, n_tiles, tile_sums, tile_offsets, nullptr, out, stream)
             : launch<2>(device, x, rows, len, sub, n_tiles, tile_sums, tile_offsets, nullptr, out, stream);
}

}  // extern "C"
