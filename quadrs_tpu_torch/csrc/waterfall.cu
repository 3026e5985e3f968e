// The waterfall bank for Hopper (sm_90a): decode -> optional window -> DFT
// of width N = 128*b (2 <= b <= 64) -> fftshifted magnitudes, over S
// streams of native-dtype planes, with windows at any integer stride >= 1.
// One templated device core, three epilogues:
//
//   qt_waterfall_norms   (S, windows, N) f32 norms.  Replaces
//       quadrs_tpu/ops/waterfall_pallas.py::fused_waterfall (the kernel
//       bodies _kernel, search=False, and _kernel_strided's norms mode).
//   qt_waterfall_search  per window the maximum and the lowest fftshifted
//       bin holding it; a NaN gives bin N-1 and a NaN magnitude.  Replaces
//       fused_waterfall_search (_kernel search=True, _kernel_strided's
//       search mode, and the _fused_waterfall_subaligned route).
//   qt_waterfall_scan    per (stream, bin) the sum, max and count above a
//       runtime threshold over the windows.  Replaces fused_waterfall_scan
//       (_kernel_strided's scan mode and the _scan_subaligned route).
//
// The TPU kernels exist in several layouts because of its 128 lanes and
// VMEM (pre-arranged windows, class rows at 128-multiple strides,
// sub-aligned class interleaves).  Here the window assembly is index
// arithmetic: sample i of window w of stream s is read at
// s*stride_s + w*hop + i, neighbouring threads on neighbouring addresses;
// overlapping windows re-read their samples through L2.  The Python
// wrappers and the plain PyTorch versions are in
// quadrs_tpu_torch/ops/waterfall.py.
//
// The DFT splits n = b*p + q (as the TPU kernels do): b 128-point FFTs over
// p (radix-2, decimation in time, in shared memory), the twiddle
// W_N^{q*r}, then a direct b-point DFT over q per r, which gives bin
// k = r + 128*s.  All tables are planned in f64 on the host and stored as
// f32 (ops/waterfall.plan_twiddles).
//
// What bounds it on the H100, estimated from the code (not profiled).  Per
// N-point window the FFTs issue ~10 shared-memory accesses for each of
// their 448*b butterflies, and the q-DFT 4 for each of its N*b complex
// multiply-adds: at N = 1024 some 75,000 shared-memory words per window,
// against 2 KB of cs8 read and 4 KB of norms written.  The H100's shared
// memory moves ~7e12 words/s over its 132 SMs, its HBM 3.35 TB/s: at
// 64 streams x 2000 windows of 1024 points that is ~1.3 ms of shared-memory
// traffic against ~0.25 ms of HBM traffic.  So the shared-memory
// butterflies bound this version, not HBM, and the search and scan
// epilogues, which write almost nothing, save little time.  The levers for
// later work: radix-8/16 butterflies in registers (fewer shared-memory
// passes), the q-DFT as a complex matrix product on the tensor cores
// (wgmma; b x b against 128 columns per window), and TMA loads of the
// window tiles.  Neither wgmma nor TMA is used here.
//
// Design:
//  * A block owns one stream and a tile of wt windows (wt = 2048/N, at
//    least 1); the scan blocks walk a contiguous run of tiles.  256
//    threads.  Shared memory holds the tile as wt*b rows of 128 complex
//    samples (re and im planes), row pitch 129 so that consecutive rows
//    fall in different banks.  At N = 8192 the tile is 66 KB, and the scan
//    accumulators another 96 KB: dynamic shared memory beyond 48 KB,
//    raised with cudaFuncSetAttribute.
//  * Staging decodes with IEEE division (qt::decode), multiplies by the f32
//    window and stores each sample bit-reversed within its row, so the
//    in-place DIT butterflies leave the FFT output in natural order.
//    Windows past n_windows in the last tile are zeros and never read
//    the planes.
//  * Each thread owns the same bins k = tid + 256*j of every window, so the
//    scan accumulates its per-bin sum, max (NaN-propagating) and count in
//    shared memory that only it touches, in window order: no atomics.  A
//    second kernel sums the blocks' partials in block order.  Both orders
//    are fixed by the shapes, so results repeat run to run.
//  * The search packs (magnitude bits, ~bin) into 64 bits: magnitudes are
//    >= +0, so their bits order as the floats do, and an integer max picks
//    the largest magnitude and, among equals, the lowest bin; any NaN
//    outranks every number and is mapped to bin N-1.  Warp shuffles, then
//    one shared-memory atomicMax per warp and window (integer: the result
//    does not depend on the order).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

using qt::decode;

constexpr int kThreads = 256;
constexpr int kPitch = 129;  // floats per shared row of 128 samples
constexpr int kNorms = 0, kSearch = 1, kScan = 2;

__device__ __forceinline__ int brev7(int p) {
  return static_cast<int>(__brev(static_cast<unsigned>(p)) >> 25);
}

// max that keeps a NaN once one is seen (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

// Shared memory: [search keys (wt u64)] [re rows] [im rows] [W_128 re, im]
// [W_b re, im] [scan accumulators: sum, max, count (3 * width)]
size_t smem_bytes(int mode, int width, int wt) {
  const size_t b = width / 128;
  size_t floats = 2 * wt * b * kPitch + 128 + 2 * b;
  if (mode == kScan) floats += 3 * static_cast<size_t>(width);
  return (mode == kSearch ? 8 * static_cast<size_t>(wt) : 0) + floats * sizeof(float);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) waterfall_kernel(
    const T* __restrict__ planes, long long stride_s, long long stride_c,
    long long n_windows, long long hop, int width, int wt, int tiles_per_block,
    const float* __restrict__ tables, const float* __restrict__ window,
    float threshold, float* __restrict__ out_f, int* __restrict__ out_i) {
  extern __shared__ unsigned long long smem_u64[];
  const int tid = threadIdx.x;
  const int b = width >> 7;
  const int rows = wt * b;
  unsigned long long* keys = smem_u64;
  float* xr = reinterpret_cast<float*>(smem_u64 + (MODE == kSearch ? wt : 0));
  float* xi = xr + rows * kPitch;
  float* w128r = xi + rows * kPitch;
  float* w128i = w128r + 64;
  float* wbr = w128i + 64;
  float* wbi = wbr + b;
  float* acc_sum = wbi + b;
  float* acc_max = acc_sum + width;
  float* acc_cnt = acc_max + width;
  const float* twr = tables + 128 + 2 * b;  // W_N^{q*r} at q*128 + r
  const float* twi = twr + 128 * b;

  for (int j = tid; j < 64; j += kThreads) {
    w128r[j] = tables[j];
    w128i[j] = tables[64 + j];
  }
  for (int j = tid; j < b; j += kThreads) {
    wbr[j] = tables[128 + j];
    wbi[j] = tables[128 + b + j];
  }
  if (MODE == kScan) {
    for (int k = tid; k < width; k += kThreads) {
      acc_sum[k] = 0.0f;
      acc_max[k] = -INFINITY;
      acc_cnt[k] = 0.0f;
    }
  }

  const int s = blockIdx.y;
  const T* re = planes + s * stride_s;
  const T* im = re + stride_c;
  const long long n_tiles = (n_windows + wt - 1) / wt;
  const long long t0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long t1 = t0 + tiles_per_block < n_tiles ? t0 + tiles_per_block : n_tiles;
  const int half = width >> 1;

  for (long long t = t0; t < t1; ++t) {
    const long long w0 = t * wt;
    const int nw = static_cast<int>(n_windows - w0 < wt ? n_windows - w0 : wt);
    __syncthreads();  // the previous tile is no longer read

    // stage: decode, window, bit-reversed store into row (w, q)
    for (int e = tid; e < wt * width; e += kThreads) {
      const int w = e / width;
      const int i = e - w * width;
      float a = 0.0f, c = 0.0f;
      if (w < nw) {
        const long long at = (w0 + w) * hop + i;
        a = decode(re[at]);
        c = decode(im[at]);
        if (window != nullptr) {
          const float g = window[i];
          a = __fmul_rn(a, g);
          c = __fmul_rn(c, g);
        }
      }
      const int p = i / b;
      const int q = i - p * b;
      const int slot = (w * b + q) * kPitch + brev7(p);
      xr[slot] = a;
      xi[slot] = c;
    }
    if (MODE == kSearch && tid < wt) keys[tid] = 0ull;
    __syncthreads();

    // b*wt 128-point FFTs: radix-2 DIT, natural-order output
    for (int h = 1; h < 128; h <<= 1) {
      const int tw_step = 64 / h;
      for (int u = tid; u < rows * 64; u += kThreads) {
        const int row = u >> 6;
        const int t64 = u & 63;
        const int j = t64 & (h - 1);
        const int i0 = ((t64 - j) << 1) + j;
        float* pr = xr + row * kPitch;
        float* pi = xi + row * kPitch;
        const float cr = w128r[j * tw_step];
        const float ci = w128i[j * tw_step];
        const float br = pr[i0 + h], bi = pi[i0 + h];
        const float tr = br * cr - bi * ci;
        const float ti = br * ci + bi * cr;
        const float ar = pr[i0], ai = pi[i0];
        pr[i0] = ar + tr;
        pi[i0] = ai + ti;
        pr[i0 + h] = ar - tr;
        pi[i0 + h] = ai - ti;
      }
      __syncthreads();
    }

    // twiddle: Z_q[r] *= W_N^{q*r}
    for (int e = tid; e < rows * 128; e += kThreads) {
      const int row = e >> 7;
      const int r = e & 127;
      const int q = row % b;
      const float cr = twr[q * 128 + r], ci = twi[q * 128 + r];
      const int slot = row * kPitch + r;
      const float zr = xr[slot], zi = xi[slot];
      xr[slot] = zr * cr - zi * ci;
      xi[slot] = zr * ci + zi * cr;
    }
    __syncthreads();

    // b-point DFT over q for bin k = r + 128*sb, then the epilogue
    for (int w = 0; w < nw; ++w) {
      unsigned long long best = 0ull;
      const float* zr = xr + w * b * kPitch;
      const float* zi = xi + w * b * kPitch;
      for (int k = tid; k < width; k += kThreads) {
        const int r = k & 127;
        const int sb = k >> 7;
        float yr = 0.0f, yi = 0.0f;
        int m = 0;  // (q * sb) mod b
        for (int q = 0; q < b; ++q) {
          const float cr = wbr[m], ci = wbi[m];
          const float vr = zr[q * kPitch + r], vi = zi[q * kPitch + r];
          yr = fmaf(vr, cr, fmaf(-vi, ci, yr));
          yi = fmaf(vr, ci, fmaf(vi, cr, yi));
          m += sb;
          if (m >= b) m -= b;
        }
        const float mag = sqrtf(yr * yr + yi * yi);
        const int col = k < width - half ? k + half : k - (width - half);
        if (MODE == kNorms) {
          out_f[(s * n_windows + w0 + w) * width + col] = mag;
        } else if (MODE == kSearch) {
          const unsigned long long key =
              (static_cast<unsigned long long>(__float_as_uint(mag)) << 32) |
              (0xFFFFFFFFu - static_cast<unsigned>(col));
          best = key > best ? key : best;
        } else {
          acc_sum[col] += mag;
          acc_max[col] = max_nan(acc_max[col], mag);
          acc_cnt[col] += mag > threshold ? 1.0f : 0.0f;
        }
      }
      if (MODE == kSearch) {
        for (int off = 16; off > 0; off >>= 1) {
          const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, off);
          best = o > best ? o : best;
        }
        if ((tid & 31) == 0) atomicMax(&keys[w], best);
      }
    }
    if (MODE == kSearch) {
      __syncthreads();
      if (tid < nw) {
        const unsigned long long key = keys[tid];
        const float val = __uint_as_float(static_cast<unsigned>(key >> 32));
        const int col = static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key & 0xFFFFFFFFull));
        out_f[s * n_windows + w0 + tid] = val;
        out_i[s * n_windows + w0 + tid] = val != val ? width - 1 : col;
      }
    }
  }

  if (MODE == kScan) {
    // partials of this block: (3, S, groups, width), groups = gridDim.x
    const long long plane = static_cast<long long>(gridDim.y) * gridDim.x * width;
    const long long base = (static_cast<long long>(s) * gridDim.x + blockIdx.x) * width;
    for (int k = tid; k < width; k += kThreads) {
      const int col = k < width - half ? k + half : k - (width - half);
      out_f[base + col] = acc_sum[col];
      out_f[plane + base + col] = acc_max[col];
      out_f[2 * plane + base + col] = acc_cnt[col];
    }
  }
}

// Second pass of the scan: out[x][s][col] over the groups' partials, in
// group order (partial[x][s][g][col], x = sum, max, count).
__global__ void __launch_bounds__(kThreads) scan_reduce_kernel(
    const float* __restrict__ partial, int n_streams, int groups, int width,
    float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n = static_cast<long long>(n_streams) * width;
  if (i >= n) return;
  const long long s = i / width;
  const long long col = i - s * width;
  const long long plane = n * groups;
  const float* p = partial + s * groups * width + col;
  float sum = 0.0f, mx = -INFINITY, cnt = 0.0f;
  for (int g = 0; g < groups; ++g) {
    sum += p[static_cast<long long>(g) * width];
    mx = max_nan(mx, p[plane + static_cast<long long>(g) * width]);
    cnt += p[2 * plane + static_cast<long long>(g) * width];
  }
  out[i] = sum;
  out[n + i] = mx;
  out[2 * n + i] = cnt;
}

template <typename T, int MODE>
int launch(int device, const void* planes, long long stride_s,
           long long stride_c, int n_streams, long long n_windows,
           long long hop, int width, int wt, int tiles_per_block, int groups,
           const float* tables, const float* window, float threshold,
           float* out_f, int* out_i, float* scan_out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (width % 128 != 0 || width < 256 || width > 8192 || wt < 1 ||
      wt * (width / 128) > 64 || n_streams < 1 || n_streams > 65535 ||
      n_windows < 1 || hop < 1 || tiles_per_block < 1 || groups < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // every block owns at least one tile, and the blocks cover them all
  const long long n_tiles = (n_windows + wt - 1) / wt;
  if (static_cast<long long>(groups) * tiles_per_block < n_tiles ||
      static_cast<long long>(groups - 1) * tiles_per_block >= n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(MODE, width, wt);
  auto kern = waterfall_kernel<T, MODE>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kern<<<dim3(static_cast<unsigned>(groups), static_cast<unsigned>(n_streams)),
         kThreads, smem, st>>>(static_cast<const T*>(planes), stride_s,
                               stride_c, n_windows, hop, width, wt,
                               tiles_per_block, tables, window, threshold,
                               out_f, out_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || MODE != kScan) return static_cast<int>(err);
  const long long n = static_cast<long long>(n_streams) * width;
  scan_reduce_kernel<<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                       kThreads, 0, st>>>(out_f, n_streams, groups, width,
                                          scan_out);
  return static_cast<int>(cudaGetLastError());
}

// fmt codes: 0 cf32 (float), 1 cs8 (int8), 2 cu8 (uint8), 3 cs16 (int16)
template <int MODE>
int dispatch(int fmt, int device, const void* planes, long long stride_s,
             long long stride_c, int n_streams, long long n_windows,
             long long hop, int width, int wt, int tiles_per_block, int groups,
             const float* tables, const float* window, float threshold,
             float* out_f, int* out_i, float* scan_out, void* stream) {
#define QT_LAUNCH(T)                                                        \
  launch<T, MODE>(device, planes, stride_s, stride_c, n_streams, n_windows, \
                  hop, width, wt, tiles_per_block, groups, tables, window,  \
                  threshold, out_f, out_i, scan_out, stream)
  switch (fmt) {
    case 0: return QT_LAUNCH(float);
    case 1: return QT_LAUNCH(int8_t);
    case 2: return QT_LAUNCH(uint8_t);
    case 3: return QT_LAUNCH(int16_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QT_LAUNCH
}

}  // namespace

// Every entry point takes the same leading arguments: the format code, the
// device, the (S, 2, n) planes (element strides stride_s between streams
// and stride_c between re and im, unit stride along n), n_windows windows
// of width samples at stride hop, wt windows per tile, and the grid: groups
// blocks per stream, each owning tiles_per_block consecutive tiles (the
// last block the rest).  tables: ops/waterfall.plan_twiddles(width);
// window: width f32 weights, or null for rectangular windows.
extern "C" {

// (S, n_windows, width) f32 fftshifted norms into norms.
int qt_waterfall_norms(int fmt, int device, const void* planes,
                       long long stride_s, long long stride_c, int n_streams,
                       long long n_windows, long long hop, int width, int wt,
                       int tiles_per_block, int groups, const float* tables,
                       const float* window, float* norms, void* stream) {
  return dispatch<kNorms>(fmt, device, planes, stride_s, stride_c, n_streams,
                          n_windows, hop, width, wt, tiles_per_block, groups,
                          tables, window, 0.0f, norms, nullptr, nullptr,
                          stream);
}

// (S, n_windows) f32 peak magnitudes into val, int32 fftshifted bins into idx.
int qt_waterfall_search(int fmt, int device, const void* planes,
                        long long stride_s, long long stride_c, int n_streams,
                        long long n_windows, long long hop, int width, int wt,
                        int tiles_per_block, int groups, const float* tables,
                        const float* window, float* val, int* idx,
                        void* stream) {
  return dispatch<kSearch>(fmt, device, planes, stride_s, stride_c, n_streams,
                           n_windows, hop, width, wt, tiles_per_block, groups,
                           tables, window, 0.0f, val, idx, nullptr, stream);
}

// (3, S, width) f32 into out: sum, max and count of norms above threshold
// over the windows; partial is (3, S, groups, width) f32 scratch.
int qt_waterfall_scan(int fmt, int device, const void* planes,
                      long long stride_s, long long stride_c, int n_streams,
                      long long n_windows, long long hop, int width, int wt,
                      int tiles_per_block, int groups, const float* tables,
                      const float* window, float threshold, float* partial,
                      float* out, void* stream) {
  return dispatch<kScan>(fmt, device, planes, stride_s, stride_c, n_streams,
                         n_windows, hop, width, wt, tiles_per_block, groups,
                         tables, window, threshold, partial, nullptr, out,
                         stream);
}

}  // extern "C"
