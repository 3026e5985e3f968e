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
// arithmetic over a span staged in shared memory.  The Python wrappers and
// the plain PyTorch versions are in quadrs_tpu_torch/ops/waterfall.py.
//
// What bounds it on the H100.  At the bank's shape (64 streams x 2000
// windows x 1024 points of cs8) the bytes bound the norms at stride 1024
// (262 MB in, 524 MB out: 0.235 ms at 3.35 TB/s), and the f32 arithmetic
// bounds search and scan at stride 256 (5 N log2 N per window, 6.55 GFLOP:
// 0.098 ms at 67 TFLOP/s).  The first version of this file ran radix-2
// butterflies in shared memory, ten passes per 1024-point window with a
// barrier each, ~75,000 shared-memory words per window, and took
// 2.47-3.06 ms there.  This version takes 0.53-0.62 ms (chip_smoke.py
// phase 5 on an H100 80GB HBM3 at 700 W; PERF.md), 2.5-6.3x its bound,
// and 0.78-0.87x a cuFFT call over the same frames.  No one part holds
// it: builds with one part taken out, timed beside this one on one card,
// put the largest share in the three later passes, then the staging loads
// (most at stride 1024) and the barriers, a few percent in the decode
// table's bank conflicts, none in the norms' stores.  The compiled cs8
// norms body at 1024 points holds 1008 instructions, 311 of them FP
// (chip_smoke.py phase 2); HBM moves 0.1-1.4 TB/s of its 3.35.  16 points
// a thread (two exchanges at 1024) was faster at stride 256 and slower at
// 1024; a second staging buffer filled by cp.async while a tile computes
// gained little; neither was kept.
//
// Design (what it does about the first version's bounds):
//  * The FFT in registers.  A window takes N/8 threads, each holding 8
//    complex points.  The power-of-two part runs as Stockham passes
//    (natural order in and out, no bit reversal) of radix 8 and then the
//    rest (1024 = 8*8*8*2: four passes, three exchanges); each pass is
//    radix-R butterflies in registers with constant twiddles, the pass
//    twiddles W_{ns*R}^{j*r} read from a shared table, and one exchange
//    through shared memory padded one word in 32 (8 in 64 for the pass
//    with ns = 8, whose stores would otherwise meet 4-way bank conflicts).
//    For b = 2^e * m with m odd (384, 640, ...) the power-of-two passes run
//    over N/m points each and a direct m-point DFT is the last pass, its
//    twiddle W_N^{j*r} folded into the store before it.  All tables are
//    planned in f64 on the host and stored as f32
//    (ops/waterfall.plan_twiddles); no fast-math trig.
//  * Shapes at compile time.  The power-of-two widths (256 ... 8192) each
//    have their own instantiation (LN = log2 N), so every shared-memory
//    address is a base register plus a constant and the pass loop unrolls;
//    with the width at run time the addresses' integer work dominated the
//    compiled loop.  The other widths share one instantiation.
//  * Decode by table.  cs8 and cu8 decode through a 256-entry f32 table
//    planned on the host with the reference formula (bit-equal to the
//    IEEE division); cs16 keeps qt::decode's division; cf32 needs none.
//    The optional f32 window is applied as __fmul_rn before the DFT.
//  * Staged spans with wide loads.  A block owns one stream and walks a
//    run of tiles of wt windows (wt*N/8 ~ 256 threads).  It stages the
//    span its tile covers, (nw-1)*hop + N samples per plane when windows
//    overlap (hop < N) and one N-sample segment per window otherwise, with
//    16-byte loads into shared memory at the global address's offset
//    mod 16: any base pointer, stream stride and hop.  A 16-byte load may
//    read up to 15 bytes past either end of a segment, never outside the
//    aligned 16-byte chunks that hold its samples (so never outside the
//    allocation).  The tables load once per block.  The grid has ~64
//    blocks per SM (ops/waterfall.kernel_grid), so the last wave is short.
//  * Epilogues from registers.  The last pass leaves each thread its 8
//    bins, the same ones for every window.  Norms: sqrt.approx of
//    re^2 + im^2 (one MUFU op), stored at the fftshifted column,
//    neighbouring threads on neighbouring columns (full 128-byte lines per
//    warp).  Search: the packed (magnitude bits, ~bin) key reduced in
//    registers, then warp shuffles within the window's threads, then one
//    shared atomicMax per group: magnitudes are >= +0, so their bits order
//    as the floats do, an integer max picks the largest and, among equals,
//    the lowest bin, and any NaN outranks every number and is mapped to bin
//    N-1.  Scan: each thread keeps its bins' sum, max (NaN-propagating) and
//    count in registers over its window slot's windows in order; the block
//    folds its slots in slot order and writes its partial; a second kernel
//    sums the blocks' partials in block order.  No float atomics: the
//    orders are fixed by the shapes, so results repeat run to run.
//  * No tensor cores: TF32 would break the bank's rtol 2e-5.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode.cuh"
#include "device.cuh"
#include "fft.cuh"

namespace {

using qt::cmul;
using qt::dft;

constexpr int kPoints = 8;  // complex points a thread holds (ops/waterfall._POINTS)
constexpr int kLogPoints = 3;
constexpr int kBlockThreads = 256;  // a block's threads to aim for (ops/waterfall._BLOCK_THREADS)
constexpr int kMaxThreads = 8192 / kPoints;
constexpr int kNorms = 0, kSearch = 1, kScan = 2;

// sqrt.approx.f32: one MUFU op, relative error ~2^-23 (the kernel's norms
// are held to rtol 2e-5); 0, +inf and NaN map to themselves
__device__ __forceinline__ float sqrt_approx(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return sqrtf(x);
#endif
}

// max that keeps a NaN once one is seen (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float acc, float v) {
  return (v > acc || v != v) ? v : acc;
}

// Shared word of complex point x of a window: m pad words after every 2^s.
// Every exchange pads one word per 32, but for the store of the radix-8
// pass with ns = 8 (s = 6, m = 8): its lanes write groups of 8 words 64
// apart, which the padding puts in distinct banks.
__host__ __device__ constexpr int pad(int x, int s = 5, int m = 1) { return x + (x >> s) * m; }

__host__ __device__ constexpr int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// windows per block: a window takes width/kPoints threads
__host__ __device__ constexpr int tile_of(int width) {
  return kBlockThreads / (width / kPoints) > 1 ? kBlockThreads / (width / kPoints) : 1;
}

// One Stockham pass of radix R over a window of n points in shared memory
// (xr, xi, padded): the thread's items are j = t + g*u (u < kPoints/R),
// item j's point r at j + r*n/R.  load -> twiddle + butterflies -> store at
// (j / ns)*ns*R + r*ns + j % ns, where ns = 2^lns is the product of the
// earlier radices.  LINEAR (the power-of-two widths): the offsets fold,
// a load at pad(t + c, s, m) with c a multiple of 2^s being
// pad(t, s, m) plus a constant.
template <int R, bool LINEAR>
__device__ __forceinline__ void load_pass(float (&vr)[kPoints], float (&vi)[kPoints], const float* xr,
                                          const float* xi, int t, int g, int n, int s, int m) {
  const int stride = n / R;
#pragma unroll
  for (int u = 0; u < kPoints / R; ++u)
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int c = g * u + r * stride;
      const bool lin = LINEAR && (c & ((1 << s) - 1)) == 0;
      const int a = lin ? pad(t, s, m) + c + (c >> s) * m : pad(t + c, s, m);
      vr[u * R + r] = xr[a];
      vi[u * R + r] = xi[a];
    }
}

template <int R>
__device__ __forceinline__ void butterflies(float (&vr)[kPoints], float (&vi)[kPoints], const float2* tw,
                                            int t, int g, int lns) {
  const int ns = 1 << lns;
#pragma unroll
  for (int u = 0; u < kPoints / R; ++u) {
    if (ns > 1) {
      const int jm = (t + g * u) & (ns - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) cmul(vr[u * R + r], vi[u * R + r], tw[(r - 1) * ns + jm]);
    }
    dft<R>(vr + u * R, vi + u * R);
  }
}

// The store of point r of item j: with hi = (j / ns)*ns*R (a multiple of
// ns*R, a power of two) and jm = j % ns, pad(hi + jm + r*ns, s, m) is a
// base per item plus a constant per point: pad(hi, s, m) + jm + r*ns when
// 2^s = ns*R; with one word per 32, pad(hi) + jm + r*ns + (r*ns >> 5)
// when ns < 32 and pad(hi + jm) + r*ns + (r*ns >> 5) when ns >= 32.  twf (the last power-of-two pass when m > 1): each
// point times twf[its index].
template <int R>
__device__ __forceinline__ void store_pass(const float (&vr)[kPoints], const float (&vi)[kPoints], float* xr,
                                           float* xi, int t, int g, int lns, int s, int m,
                                           const float2* __restrict__ twf) {
  const int ns = 1 << lns;
#pragma unroll
  for (int u = 0; u < kPoints / R; ++u) {
    const int j = t + g * u;
    const int hi = (j >> lns) * ns * R;
    const int jm = j & (ns - 1);
    const bool whole = ns * R == 1 << s;
    const int base = whole ? pad(hi, s, m) + jm : ns < 32 ? pad(hi) + jm : pad(hi + jm);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int a = base + r * ns + (whole ? 0 : (r * ns) >> 5);
      float x = vr[u * R + r], y = vi[u * R + r];
      if (twf != nullptr) cmul(x, y, __ldg(twf + hi + jm + r * ns));
      xr[a] = x;
      xi[a] = y;
    }
  }
}

// the pass plan of width n = 128*b (ops/waterfall.fft_plan): npass radix
// passes over the power-of-two part 2^lp2 (radix kPoints each, the last
// one 2^llr), the odd part m of b, and the float2 pairs of the shared table
struct Plan {
  int npass, m, lp2, llr, shared_pairs;
};

__host__ __device__ constexpr Plan make_plan(int n) {
  Plan p{};
  p.m = n >> 7;
  while ((p.m & 1) == 0) p.m >>= 1;
  p.lp2 = ilog2(n / p.m);
  p.npass = (p.lp2 + kLogPoints - 1) / kLogPoints;
  p.llr = p.lp2 - kLogPoints * (p.npass - 1);
  int pairs = 0;
  for (int q = 1; q < p.npass; ++q)
    pairs += ((1 << (q < p.npass - 1 ? kLogPoints : p.llr)) - 1) << (kLogPoints * q);
  p.shared_pairs = pairs + (p.m > 1 ? p.m : 0);
  return p;
}

// Shared memory: [search keys (wt u64, 16-byte rounded)] [raw re][raw im]
// [decode table (256 f32)] [pass twiddles + W_m (float2)] [X: per window
// re then im, N + N/8 floats each].  raw: per plane one span of
// (wt-1)*hop + N samples when hop < N, else wt segments of N samples, each
// with 16 bytes of slack for its address's offset mod 16.
__host__ __device__ inline long long seg_bytes(int width, long long hop, int wt, int elem) {
  const long long samples = hop < width ? (wt - 1) * hop + width : width;
  return (samples * elem + 15) / 16 * 16 + 16;
}

__host__ __device__ inline long long raw_bytes(int width, long long hop, int wt, int elem) {
  return seg_bytes(width, hop, wt, elem) * (hop < width ? 1 : wt);
}

inline size_t smem_bytes(int width, long long hop, int elem) {
  const Plan p = make_plan(width);
  const size_t wt = tile_of(width);
  return (8 * wt + 15) / 16 * 16 + 2 * static_cast<size_t>(raw_bytes(width, hop, wt, elem)) + 256 * sizeof(float) +
         8 * static_cast<size_t>(p.shared_pairs) + 2 * static_cast<size_t>(width + width / 8) * wt * sizeof(float);
}

template <typename T>
__device__ __forceinline__ float load_sample(const unsigned char* p, const float* dtab) {
  if constexpr (sizeof(T) == 1) {
    return dtab[*p];
  } else {
    return qt::decode(*reinterpret_cast<const T*>(p));
  }
}

// copy the tile's raw segments of one plane into shared memory: 16-byte
// chunks, each landing at the same offset mod 16 as in device memory
template <typename T>
__device__ __forceinline__ void stage_plane(const T* plane, long long w0, long long hop, int nw, int width,
                                            long long seg, unsigned char* dst, int tid, int nthreads) {
  const bool over = hop < width;
  const int nseg = over ? 1 : nw;
  const long long len = (over ? (nw - 1) * hop + width : width) * static_cast<long long>(sizeof(T));
  for (int k = 0; k < nseg; ++k) {
    const uintptr_t g = reinterpret_cast<uintptr_t>(plane + (w0 + k) * hop);
    const uintptr_t a = g & 15;
    const uint4* src = reinterpret_cast<const uint4*>(g - a);
    uint4* to = reinterpret_cast<uint4*>(dst + k * seg);
    const int chunks = static_cast<int>((a + len + 15) >> 4);
    for (int q = tid; q < chunks; q += nthreads) to[q] = __ldg(src + q);
  }
}

// shared byte offset of sample 0 of window slot w of a tile in one plane
template <typename T>
__device__ __forceinline__ int sample0(const T* plane, long long w0, long long hop, int w, int width,
                                       long long seg) {
  if (hop < width) {
    const int a = static_cast<int>(reinterpret_cast<uintptr_t>(plane + w0 * hop) & 15);
    return a + static_cast<int>(w * hop) * static_cast<int>(sizeof(T));
  }
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(plane + (w0 + w) * hop) & 15);
  return static_cast<int>(w * seg) + a;
}

// LN = log2(width) for the power-of-two widths, whose shapes then fold at
// compile time; 0 for the rest (width_arg at run time)
template <typename T, int MODE, int LN>
__global__ void __launch_bounds__(kMaxThreads) waterfall_kernel(
    const T* __restrict__ planes, long long stride_s, long long stride_c, long long n_windows, long long hop,
    int width_arg, int tiles_per_block, const float* __restrict__ tables, const float* __restrict__ dtab_g,
    const float* __restrict__ window, float threshold, float* __restrict__ out_f, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr Plan kPlan = make_plan(LN ? 1 << LN : 256);
  const int width = LN ? 1 << LN : width_arg;
  const Plan plan = LN ? kPlan : make_plan(width);
  const int wt = tile_of(width);
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int g = width / kPoints;  // threads per window
  const int slot = tid / g;
  const int t = tid - slot * g;
  const bool active = slot < wt;
  const int xpitch = width + width / 8;  // room for either padding
  const long long seg = seg_bytes(width, hop, wt, sizeof(T));

  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  unsigned char* raw_re = smem + (8 * wt + 15) / 16 * 16;
  unsigned char* raw_im = raw_re + raw_bytes(width, hop, wt, sizeof(T));
  float* dtab = reinterpret_cast<float*>(raw_im + raw_bytes(width, hop, wt, sizeof(T)));
  float2* tw = reinterpret_cast<float2*>(dtab + 256);
  float* xbase = reinterpret_cast<float*>(tw + plan.shared_pairs);
  float* xr = xbase + 2 * xpitch * (active ? slot : 0);
  float* xi = xr + xpitch;
  const float2* twf = reinterpret_cast<const float2*>(tables) + plan.shared_pairs;  // W_N^{j*r}, m > 1
  const float2* wm = tw + plan.shared_pairs - plan.m;                                 // W_m^k, m > 1

  for (int i = tid; i < 2 * plan.shared_pairs; i += nthreads) reinterpret_cast<float*>(tw)[i] = tables[i];
  if (sizeof(T) == 1)
    for (int i = tid; i < 256; i += nthreads) dtab[i] = dtab_g[i];

  const int s = blockIdx.y;
  const T* re = planes + s * stride_s;
  const T* im = re + stride_c;
  const long long n_tiles = (n_windows + wt - 1) / wt;
  const long long t0 = static_cast<long long>(blockIdx.x) * tiles_per_block;
  const long long t1 = t0 + tiles_per_block < n_tiles ? t0 + tiles_per_block : n_tiles;
  const int half = width >> 1;
  const int pstride = width / kPoints;  // the first pass's point stride

  float acc_sum[kPoints], acc_max[kPoints], acc_cnt[kPoints];
  if (MODE == kScan) {
#pragma unroll
    for (int e = 0; e < kPoints; ++e) {
      acc_sum[e] = 0.0f;
      acc_max[e] = -INFINITY;
      acc_cnt[e] = 0.0f;
    }
  }
  // bin of point e after the last pass: the last radix pass (radix 2^llr,
  // ns = 2^(lp2 - llr)) leaves item j = t + g*u's point r at r*ns + j; the
  // direct m-point pass gives point e bin t + g*e
  const int llr = plan.llr, llns = plan.lp2 - plan.llr;
#define QT_BIN(e) (plan.m > 1 ? t + g * (e) : (((e) & ((1 << llr) - 1)) << llns) + t + g * ((e) >> llr))
  // its fftshifted column: a power-of-two width's bin is t plus a multiple
  // of g >= t that holds the top bit, so the shift flips that bit alone
#define QT_COL(e)                                                                       \
  (LN > 0 ? t + (((((e) & ((1 << llr) - 1)) << llns) + g * ((e) >> llr)) ^ half)        \
          : (QT_BIN(e) + half < width ? QT_BIN(e) + half : QT_BIN(e) + half - width))

  for (long long tile = t0; tile < t1; ++tile) {
    const long long w0 = tile * wt;
    const int nw = static_cast<int>(n_windows - w0 < wt ? n_windows - w0 : wt);
    stage_plane(re, w0, hop, nw, width, seg, raw_re, tid, nthreads);
    stage_plane(im, w0, hop, nw, width, seg, raw_im, tid, nthreads);
    if (MODE == kSearch && tid < wt) keys[tid] = 0ull;
    __syncthreads();

    float vr[kPoints], vi[kPoints];
    // pass 0, radix kPoints, ns 1: decode and window the points t + r*pstride
    if (active && slot < nw) {
      const unsigned char* pr = raw_re + sample0(re, w0, hop, slot, width, seg);
      const unsigned char* pi = raw_im + sample0(im, w0, hop, slot, width, seg);
#pragma unroll
      for (int r = 0; r < kPoints; ++r) {
        const int i = t + r * pstride;
        vr[r] = load_sample<T>(pr + i * static_cast<int>(sizeof(T)), dtab);
        vi[r] = load_sample<T>(pi + i * static_cast<int>(sizeof(T)), dtab);
      }
      if (window != nullptr) {
#pragma unroll
        for (int r = 0; r < kPoints; ++r) {
          const float wv = __ldg(window + t + r * pstride);
          vr[r] = __fmul_rn(vr[r], wv);
          vi[r] = __fmul_rn(vi[r], wv);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kPoints; ++r) vr[r] = vi[r] = 0.0f;
    }
    dft<kPoints>(vr, vi);
    if (active) store_pass<kPoints>(vr, vi, xr, xi, t, g, 0, 5, 1, nullptr);
    __syncthreads();

    const float2* ptw = tw;  // this pass's table
    int ls = 5, lm = 1;      // the padding of the data in X
#pragma unroll
    for (int p = 1; p < plan.npass; ++p) {
      const bool last = p == plan.npass - 1;
      const int lr = last ? plan.llr : kLogPoints, lns = kLogPoints * p;
      const bool store = !last || plan.m > 1;
      const float2* ftw = last ? twf : nullptr;
      // this pass's store padding: ns words after every ns*R when ns < 32
      const int ss = LN > 0 && p == 1 && !last ? lns + lr : 5, sm = ss == 5 ? 1 : 1 << lns;
#define QT_PASS(R)                                                         \
  if (active) load_pass<R, (LN > 0)>(vr, vi, xr, xi, t, g, width, ls, lm); \
  butterflies<R>(vr, vi, ptw, t, g, lns);                                  \
  if (store) {                                                             \
    __syncthreads();                                                       \
    if (active) store_pass<R>(vr, vi, xr, xi, t, g, lns, ss, sm, ftw);     \
    __syncthreads();                                                       \
  }
      switch (lr) {
        case 3: { QT_PASS(8) } break;
        case 2: { QT_PASS(4) } break;
        default: { QT_PASS(2) } break;
      }
#undef QT_PASS
      ptw += ((1 << lr) - 1) << lns;
      ls = ss;
      lm = sm;
    }

    if (LN == 0 && plan.m > 1 && active) {
      // direct m-point DFT over the twiddled power-of-two transforms: point
      // e is bin o = t + g*e, the sum over r of X[o mod 2^lp2 + r*2^lp2]
      // times W_m^{r*(o div 2^lp2)}
      const int p2 = 1 << plan.lp2;
      int mk[kPoints];  // (r * k) mod m of point e
#pragma unroll
      for (int e = 0; e < kPoints; ++e) {
        vr[e] = vi[e] = 0.0f;
        mk[e] = 0;
      }
      for (int r = 0; r < plan.m; ++r) {
#pragma unroll
        for (int e = 0; e < kPoints; ++e) {
          const int o = t + g * e;
          const int a = pad((o & (p2 - 1)) + r * p2);
          const float ar = xr[a], ai = xi[a];
          const float2 w = wm[mk[e]];
          vr[e] = fmaf(ar, w.x, fmaf(-ai, w.y, vr[e]));
          vi[e] = fmaf(ar, w.y, fmaf(ai, w.x, vi[e]));
          mk[e] += o >> plan.lp2;
          if (mk[e] >= plan.m) mk[e] -= plan.m;
        }
      }
    }

    // epilogue: the thread's kPoints bins of its window
    const bool mine = active && slot < nw;
    unsigned long long best = 0ull;
    if (mine) {
      float mag[kPoints];
#pragma unroll
      for (int e = 0; e < kPoints; ++e) mag[e] = sqrt_approx(vr[e] * vr[e] + vi[e] * vi[e]);
      if (MODE == kScan) {
#pragma unroll
        for (int e = 0; e < kPoints; ++e) {
          acc_sum[e] += mag[e];
          acc_max[e] = max_nan(acc_max[e], mag[e]);
          acc_cnt[e] += mag[e] > threshold ? 1.0f : 0.0f;
        }
      } else if (MODE == kNorms) {
        float* row = out_f + (s * n_windows + w0 + slot) * width;
#pragma unroll
        for (int e = 0; e < kPoints; ++e) row[QT_COL(e)] = mag[e];
      } else {
#pragma unroll
        for (int e = 0; e < kPoints; ++e) {
          const unsigned long long key = (static_cast<unsigned long long>(__float_as_uint(mag[e])) << 32) |
                                         (0xFFFFFFFFu - static_cast<unsigned>(QT_COL(e)));
          best = key > best ? key : best;
        }
      }
    }
    if (MODE == kSearch) {
      // shuffle within aligned groups of a window's threads, then one
      // shared atomicMax per group (integer: order-independent)
      const int gs = (g & -g) < 32 ? (g & -g) : 32;
      for (int off = gs >> 1; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, off);
        best = o > best ? o : best;
      }
      if (mine && (t & (gs - 1)) == 0) atomicMax(&keys[slot], best);
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
    // partials of this block: (3, S, groups, width), groups = gridDim.x;
    // the window slots fold in slot order through shared memory (X)
    const long long plane = static_cast<long long>(gridDim.y) * gridDim.x * width;
    const long long base = (static_cast<long long>(s) * gridDim.x + blockIdx.x) * width;
    if (wt == 1) {
      if (active) {
#pragma unroll
        for (int e = 0; e < kPoints; ++e) {
          const int col = QT_COL(e);
          out_f[base + col] = acc_sum[e];
          out_f[plane + base + col] = acc_max[e];
          out_f[2 * plane + base + col] = acc_cnt[e];
        }
      }
    } else {
      float* fs = xbase;  // 3 * width floats <= 2 * wt * xpitch
      __syncthreads();
      for (int sl = 0; sl < wt; ++sl) {
        if (slot == sl) {
#pragma unroll
          for (int e = 0; e < kPoints; ++e) {
            const int k = QT_BIN(e);
            if (sl == 0) {
              fs[k] = acc_sum[e];
              fs[width + k] = acc_max[e];
              fs[2 * width + k] = acc_cnt[e];
            } else {
              fs[k] += acc_sum[e];
              fs[width + k] = max_nan(fs[width + k], acc_max[e]);
              fs[2 * width + k] += acc_cnt[e];
            }
          }
        }
        __syncthreads();
      }
      for (int k = tid; k < width; k += nthreads) {
        const int col = k < width - half ? k + half : k - (width - half);
        out_f[base + col] = fs[k];
        out_f[plane + base + col] = fs[width + k];
        out_f[2 * plane + base + col] = fs[2 * width + k];
      }
    }
  }
}

// Second pass of the scan: out[x][s][col] over the groups' partials, in
// group order (partial[x][s][g][col], x = sum, max, count).
__global__ void __launch_bounds__(256) scan_reduce_kernel(const float* __restrict__ partial, int n_streams,
                                                          int groups, int width, float* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
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


template <typename T, int MODE, int LN>
int launch(int device, const void* planes, long long stride_s, long long stride_c, int n_streams,
           long long n_windows, long long hop, int width, int tiles_per_block, int groups, const float* tables,
           const float* dtab, const float* window, float threshold, float* out_f, int* out_i, float* scan_out,
           void* stream) {
  const qt::DeviceScope scope(device);
  cudaError_t err = scope.status();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wt = tile_of(width);
  const int threads = (wt * (width / kPoints) + 31) / 32 * 32;
  if (width % 128 != 0 || width < 256 || width > 8192 || threads > kMaxThreads || n_streams < 1 ||
      n_streams > 65535 || n_windows < 1 || hop < 1 || tiles_per_block < 1 || groups < 1 ||
      (sizeof(T) == 1 && dtab == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // every block owns at least one tile, and the blocks cover them all
  const long long n_tiles = (n_windows + wt - 1) / wt;
  if (static_cast<long long>(groups) * tiles_per_block < n_tiles ||
      static_cast<long long>(groups - 1) * tiles_per_block >= n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(width, hop, sizeof(T));
  auto kern = waterfall_kernel<T, MODE, LN>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kern<<<dim3(static_cast<unsigned>(groups), static_cast<unsigned>(n_streams)), threads, smem, st>>>(
      static_cast<const T*>(planes), stride_s, stride_c, n_windows, hop, width, tiles_per_block, tables, dtab,
      window, threshold, out_f, out_i);
  err = cudaGetLastError();
  if (err != cudaSuccess || MODE != kScan) return static_cast<int>(err);
  const long long n = static_cast<long long>(n_streams) * width;
  scan_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(out_f, n_streams, groups, width,
                                                                               scan_out);
  return static_cast<int>(cudaGetLastError());
}

// fmt codes: 0 cf32 (float), 1 cs8 (int8), 2 cu8 (uint8), 3 cs16 (int16);
// the power-of-two widths take their own instantiation
template <typename T, int MODE>
int by_width(int device, const void* planes, long long stride_s, long long stride_c, int n_streams,
             long long n_windows, long long hop, int width, int tiles_per_block, int groups, const float* tables,
             const float* dtab, const float* window, float threshold, float* out_f, int* out_i,
             float* scan_out, void* stream) {
#define QT_LAUNCH(LN)                                                                                          \
  launch<T, MODE, LN>(device, planes, stride_s, stride_c, n_streams, n_windows, hop, width, tiles_per_block, \
                      groups, tables, dtab, window, threshold, out_f, out_i, scan_out, stream)
  switch (width) {
    case 256: return QT_LAUNCH(8);
    case 512: return QT_LAUNCH(9);
    case 1024: return QT_LAUNCH(10);
    case 2048: return QT_LAUNCH(11);
    case 4096: return QT_LAUNCH(12);
    case 8192: return QT_LAUNCH(13);
    default: return QT_LAUNCH(0);
  }
#undef QT_LAUNCH
}

template <int MODE>
int dispatch(int fmt, int device, const void* planes, long long stride_s, long long stride_c, int n_streams,
             long long n_windows, long long hop, int width, int tiles_per_block, int groups, const float* tables,
             const float* dtab, const float* window, float threshold, float* out_f, int* out_i,
             float* scan_out, void* stream) {
#define QT_LAUNCH(T)                                                                                       \
  by_width<T, MODE>(device, planes, stride_s, stride_c, n_streams, n_windows, hop, width, tiles_per_block, \
                    groups, tables, dtab, window, threshold, out_f, out_i, scan_out, stream)
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
// and stride_c between re and im, unit stride along n, any alignment),
// n_windows windows of width samples at stride hop, and the grid: groups
// blocks per stream, each owning tiles_per_block consecutive tiles of
// ops/waterfall.window_tile(width) windows (the last block the rest).
// tables: ops/waterfall.plan_twiddles(width); dtab:
// ops/waterfall.decode_table (256 f32, required for cs8 and cu8, else
// ignored); window: width f32 weights, or null for rectangular windows.
extern "C" {

// (S, n_windows, width) f32 fftshifted norms into norms.
int qt_waterfall_norms(int fmt, int device, const void* planes, long long stride_s, long long stride_c,
                       int n_streams, long long n_windows, long long hop, int width, int tiles_per_block,
                       int groups, const float* tables, const float* dtab, const float* window, float* norms,
                       void* stream) {
  return dispatch<kNorms>(fmt, device, planes, stride_s, stride_c, n_streams, n_windows, hop, width,
                          tiles_per_block, groups, tables, dtab, window, 0.0f, norms, nullptr, nullptr, stream);
}

// (S, n_windows) f32 peak magnitudes into val, int32 fftshifted bins into idx.
int qt_waterfall_search(int fmt, int device, const void* planes, long long stride_s, long long stride_c,
                        int n_streams, long long n_windows, long long hop, int width, int tiles_per_block,
                        int groups, const float* tables, const float* dtab, const float* window, float* val,
                        int* idx, void* stream) {
  return dispatch<kSearch>(fmt, device, planes, stride_s, stride_c, n_streams, n_windows, hop, width,
                           tiles_per_block, groups, tables, dtab, window, 0.0f, val, idx, nullptr, stream);
}

// (3, S, width) f32 into out: sum, max and count of norms above threshold
// over the windows; partial is (3, S, groups, width) f32 scratch.
int qt_waterfall_scan(int fmt, int device, const void* planes, long long stride_s, long long stride_c,
                      int n_streams, long long n_windows, long long hop, int width, int tiles_per_block,
                      int groups, const float* tables, const float* dtab, const float* window, float threshold,
                      float* partial, float* out, void* stream) {
  return dispatch<kScan>(fmt, device, planes, stride_s, stride_c, n_streams, n_windows, hop, width,
                         tiles_per_block, groups, tables, dtab, window, threshold, partial, nullptr, out, stream);
}

}  // extern "C"
