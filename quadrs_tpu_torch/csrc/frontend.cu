// Fused receiver frontend for Hopper (sm_90a): decode -> exact NCO mix ->
// polyphase decimating FIR, and optionally the fftshifted W-point STFT
// magnitudes of the decimated stream, in one pass over the raw planes.
//
// Replaces the TPU kernel quadrs_tpu/ops/frontend_pallas.py::_kernel_t, as
// launched by fused_frontend_t without stft_width (frontend_fir below) and
// with it (frontend_fir_stft); and the v1 kernel frontend_pallas.py::_kernel,
// as launched by fused_frontend (frontend_banded).  The Python wrappers, the
// launch plan and the plain PyTorch versions of the same functions are in
// quadrs_tpu_torch/ops/frontend.py.
//
// The v1 function differs from the first two only in its mix and its phase
// tiles: each sample rotates by cosf/sinf(base[t] + delta[q]) of its own
// angle (an f32 sum, accurate trig per element; delta is the host-exact
// in-tile angle table), tiles are 2048 outputs, and any filter length is
// taken as long as the staged span fits in shared memory.  The TPU ran it
// as a banded matmul; here it is the same body with the trig in the
// staging loop.
//
// What bounds it on the H100.  Each decimated output costs 2*taps FMAs (re
// and im) and reads D new input samples: at the stream chain's cs8, D 32,
// 400 taps that is 800 FMAs per 64 input bytes, so the f32 FMA rate (33.5
// TFMA/s), not the 3.35 TB/s of device memory, is the bound: 0.0033 ms for
// a 4M-sample chunk.  This body takes 0.0245 ms there (device time,
// chip_smoke.py phase 5, NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md), 13.6%
// of the bound, where the first version (one output a thread, three
// shared-memory loads per two FMAs) took 0.0731 ms.  Builds with a part cut
// to a quarter, timed beside it on that card, split the time into ~8.5 us
// of FIR, ~7 us of staging and ~9 us that shrinks with neither:
//  * The FIR.  An SM starts four warp-wide FFMA and moves 128 bytes of
//    shared memory a clock, so a loop needs 16 FFMA per 16-byte load to be
//    bound by arithmetic.  A thread owns 8 consecutive outputs of one plane
//    and a chunk of up to 8 subfilters: per phase dd it loads the
//    8 + MC - 1 columns of X[dd] that its outputs share (four 16-byte
//    loads) and the chunk's taps (two, as broadcasts) and runs 8*MC FFMA
//    from registers, 0.09 loads per FFMA.  It reaches about half the FMA
//    peak: 128 registers a thread leave 16 warps on an SM.
//  * The order of the sums is a contract: y[i] = sum_m (sum_dd h[m*D+dd]
//    x[(i+m)*D+dd]), each subfilter a run of D fused multiply-adds from
//    zero, the subfilters added in order, as the plain version's matmul
//    and diagonal sums do (on the card the two are bit-equal).  Past a few
//    thousand taps of cu8 or cs16 the output is a small residual of the
//    decode's DC offset and any other order differs from the plain version
//    by more than its tolerance (tests/test_torch_frontend.py::
//    test_fir_order).  So the 8 x MC partial sums of a chunk stay live in
//    registers (64 of them) and no window slides between phases.
//  * The staging moves 8 MB of cs8 from device memory and 34 MB of
//    cos/sin(delta) tables from L2 (8 table bytes beside 2 input bytes a
//    sample), ~6 TB/s over its 7 us, which is what L2 delivers; per sample
//    it also costs the decode, twelve rounded multiply-adds of the
//    rotation and the mix, and a transposed store.  Deeper load batches
//    did not shorten it.
//  * Residency and lockstep.  The staged span takes 8*D bytes of shared
//    memory per output, so an SM holds two blocks of 256 outputs and a
//    chunk takes two rounds of blocks; the blocks of a round start
//    together, so they all stage and then all sum, and each round pays a
//    block's whole latency chain (tables and bases, three batches of
//    loads, the sums, the stores).  Staging and summing the phases slab by
//    slab, with all blocks resident in one round, was built and was slower
//    (0.045 ms: spills and eight barriers a block); what is left is a
//    persistent block whose staging warps run ahead of its summing warps
//    over a ring of tiles.
//
// What the design does about it.
//  * Each input sample is read from device memory once per block, decoded
//    once, masked once and mixed once, then kept in shared memory as f32
//    re/im in polyphase order, X[dd][c] = x[c*D + dd].  The decimated
//    stream (and, in frontend_fir_stft, the spectrum) never round-trips
//    through device memory.
//  * The threads of a block split the planes, and at two chunks (9 to 16
//    subfilters) also the chunks, between them: the second group's partial
//    sums wait in registers for the first group's y, so the subfilters
//    still add up in order.  The last chunk has its own instantiation per
//    length, so no FMA is spent on padding taps.
//  * Staging by fours (D a multiple of 4): a thread takes four consecutive
//    samples of a column: the raw codes as aligned 32-bit words funnel-
//    shifted to the plane's own alignment (any base pointer; no load
//    outside the aligned words that hold samples below n_ok), the tables as
//    one float4 each, consecutive lanes on consecutive addresses (a warp
//    reads whole 128-byte lines), four groups in flight a thread.  A copy
//    of the raw span in shared memory, as csrc/waterfall.cu stages, would
//    cost a resident block.  cs8 and cu8 decode through the host-planned
//    256-entry table (bit-equal to the IEEE division), cs16 by __fdiv_rn;
//    the mix is written with _rn intrinsics in the reference's operation
//    order, so decode and mix are bit-equal to the plain version.  Other D
//    take one sample at a time, (column, phase) carried without a division.
//  * Rows of X are 16-byte aligned, 4 mod 8 words long, and the 16-byte
//    words of a row are permuted within groups of four by
//    ((w >> 3) ^ (dd >> 3)) & 3: the FIR's vector loads, 32 bytes apart
//    between lanes, and the staging's stores, four rows a thread, then meet
//    no bank conflict at D 32 (without the permutation: 0.0272 ms).
//  * D 32 has its own instantiation (the phase loop and the staging's
//    index arithmetic fold); every other 1 <= D <= 64 shares one.
//  * The STFT epilogue runs W-point FFTs as Stockham passes of radix 8
//    (then 4 or 2) in registers over the block's outputs in shared memory,
//    with the host's f32-from-f64 twiddles and the fftshift folded into
//    the store index (0.0278 ms with W 64).
//  * The launcher sets the dynamic shared-memory limit once per
//    instantiation and size and leaves the current device alone when it is
//    the right one.
// No tensor cores: the path is held to 5e-5 of its scale with cu8's and
// cs16's DC offsets in the stopband.
//
// Layout contract (checked by the wrapper): planes are two rows of a
// native-dtype tensor with unit stride; bases holds one angle per tout
// outputs (the phase-planning tile of the JAX package); the cos/sin tables
// hold (tout + 128) * D entries in in-tile sample order, 16-byte aligned; h
// holds m_sub rows of D taps (the last row zero-padded).  A block owns bout
// outputs (bout divides tout, so a block never straddles two phase tiles).

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"
#include "fft.cuh"

namespace {

constexpr int kR = 8;   // consecutive outputs a thread owns (ops/frontend._R)
constexpr int kMC = 8;  // subfilters a chunk (ops/frontend._CHUNK)
constexpr int kFir = 0, kStft = 1, kBanded = 2;
constexpr int kMaxThreads = 256;
constexpr int kStage = 4;  // groups of four samples a thread stages at once

// Shared memory of a block, in floats (ops/frontend.launch_plan mirrors it):
// [X re: D rows][X im: D rows][taps hs[dd][m_pad]][decode table, byte
// formats][ex: 2 * bout, the chunk hand-over and the STFT's input][STFT
// twiddles: 2 * W].  The STFT's second buffer reuses X.
struct Layout {
  int m_pad, row, hs, dtab, ex, tw, floats;
};

__host__ __device__ inline Layout make_layout(int d, int m_sub, int bout, int elem, bool ex, int width) {
  Layout l{};
  l.m_pad = (m_sub + kMC - 1) / kMC * kMC;
  // the FIR's vector loads reach column bout + m_pad - 1; the permutation
  // stays inside aligned groups of 16 columns; 4 mod 8 words a row
  l.row = (bout + l.m_pad + 15) / 16 * 16 + 4;
  l.hs = 2 * d * l.row;
  l.dtab = l.hs + d * l.m_pad;
  l.ex = l.dtab + (elem == 1 ? 256 : 0);
  l.tw = l.ex + (ex ? 2 * bout : 0);
  l.floats = l.tw + 2 * width;
  return l;
}

// float offset inside a row of X of the 16-byte word w of phase dd
__device__ __forceinline__ int word_at(int w, int dd) { return (w ^ (((w >> 3) ^ (dd >> 3)) & 3)) << 2; }

// Four consecutive samples of a plane as they lie in memory: the aligned
// 32-bit words that hold them, the plane's byte offset in the first word,
// and which of the four lie below n_ok.  fetch4 only starts the loads (so a
// thread can have several groups in flight); decode4 shifts and decodes.
template <typename T>
struct Raw4 {
  uint32_t w[sizeof(T) + 1];
  unsigned shift, valid;
};

// Reads aligned words that hold at least one sample below n_ok, nothing else.
template <typename T>
__device__ __forceinline__ Raw4<T> fetch4(const T* __restrict__ plane, long long p, long long n_ok) {
  constexpr int NW = sizeof(T);  // whole words of four samples
  Raw4<T> raw;
  if (p + 4 <= n_ok) {
    const uintptr_t b = reinterpret_cast<uintptr_t>(plane + p);
    const unsigned a = static_cast<unsigned>(b & 3);
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(b - a);
#pragma unroll
    for (int k = 0; k < NW; ++k) raw.w[k] = __ldg(wp + k);
    raw.w[NW] = a ? __ldg(wp + NW) : 0u;
    raw.shift = 8 * a;
    raw.valid = 15u;
  } else {
    // the group that holds n_ok, and those past it: sample by sample
#pragma unroll
    for (int k = 0; k <= NW; ++k) raw.w[k] = 0u;
    raw.shift = 0;
    raw.valid = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (p + j < n_ok) {
        raw.valid |= 1u << j;
        if constexpr (sizeof(T) == 1) {
          raw.w[0] |= static_cast<uint32_t>(static_cast<uint8_t>(plane[p + j])) << (8 * j);
        } else if constexpr (sizeof(T) == 2) {
          raw.w[j >> 1] |= static_cast<uint32_t>(static_cast<uint16_t>(plane[p + j])) << (16 * (j & 1));
        } else {
          raw.w[j] = __float_as_uint(plane[p + j]);
        }
      }
    }
  }
  return raw;
}

// samples at or past n_ok count as zero (decoded domain)
template <typename T>
__device__ __forceinline__ void decode4(const Raw4<T>& raw, const float* dtab, float (&v)[4]) {
  constexpr int NW = sizeof(T);
  uint32_t u[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) u[k] = __funnelshift_r(raw.w[k], raw.w[k + 1], raw.shift);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float x;
    if constexpr (sizeof(T) == 1) {
      x = dtab[(u[0] >> (8 * j)) & 255u];
    } else if constexpr (sizeof(T) == 2) {
      x = qt::decode(static_cast<T>(static_cast<uint16_t>(u[j >> 1] >> (16 * (j & 1)))));
    } else {
      x = __uint_as_float(u[j]);
    }
    v[j] = (raw.valid >> j) & 1u ? x : 0.0f;
  }
}

// the rotation of one sample: (c, sn) of its NCO angle.  ANGLE: the v1 mix,
// cosf/sinf(base + delta); otherwise the host cos/sin(delta) rotated by the
// tile's base angle.
template <bool ANGLE>
__device__ __forceinline__ void rotation(float tc, float ts, float base, float cb, float sb, float& c, float& sn) {
  if constexpr (ANGLE) {
    const float theta = __fadd_rn(base, tc);
    c = cosf(theta);
    sn = sinf(theta);
  } else {
    c = __fsub_rn(__fmul_rn(tc, cb), __fmul_rn(ts, sb));
    sn = __fadd_rn(__fmul_rn(ts, cb), __fmul_rn(tc, sb));
  }
}

// The partial sums of one chunk: p[m][r] = sum_dd h[(8c + m)*D + dd] *
// X[dd][8t + r + 8c + m], each a run of D fused multiply-adds from zero in
// phase order.  Per phase: the 8 + MC - 1 columns the outputs share as NV
// vector loads, the chunk's taps as one or two, 8 * MC FFMA.
template <int MC, int DC>
__device__ __forceinline__ void chunk_sums(const float* __restrict__ xp, const float* __restrict__ hs, int c,
                                           int t, int d, int row, int m_pad, float (&p)[kMC][kR]) {
  constexpr int NV = (kR + MC + 2) / 4;
#pragma unroll
  for (int m = 0; m < MC; ++m)
#pragma unroll
    for (int r = 0; r < kR; ++r) p[m][r] = 0.0f;
  const int w0 = 2 * t + 2 * c;  // first 16-byte word of the window
  const float* hc = hs + kMC * c;
  for (int dg = 0; dg < d; dg += 8) {
    int off[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) off[v] = word_at(w0 + v, dg);
#pragma unroll 2
    for (int k = 0; k < 8; ++k) {
      if (DC == 0 && dg + k >= d) break;
      const float* xrow = xp + (dg + k) * row;
      float w[4 * NV], hh[kMC];
#pragma unroll
      for (int v = 0; v < NV; ++v)
        *reinterpret_cast<float4*>(w + 4 * v) = *reinterpret_cast<const float4*>(xrow + off[v]);
      *reinterpret_cast<float4*>(hh) = *reinterpret_cast<const float4*>(hc + (dg + k) * m_pad);
      if (MC > 4) *reinterpret_cast<float4*>(hh + 4) = *reinterpret_cast<const float4*>(hc + (dg + k) * m_pad + 4);
#pragma unroll
      for (int m = 0; m < MC; ++m)
#pragma unroll
        for (int r = 0; r < kR; ++r) p[m][r] = fmaf(hh[m], w[r + m], p[m][r]);
    }
  }
}

// y += the chunk's subfilters in order (the first subfilter of all starts y)
template <int MC>
__device__ __forceinline__ void fold(const float (&p)[kMC][kR], float (&y)[kR], bool first) {
#pragma unroll
  for (int r = 0; r < kR; ++r) y[r] = first ? p[0][r] : y[r] + p[0][r];
#pragma unroll
  for (int m = 1; m < MC; ++m)
#pragma unroll
    for (int r = 0; r < kR; ++r) y[r] += p[m][r];
}

#define QT_BY_REM(rem, CALL) \
  switch (rem) {             \
    case 1: CALL(1); break;  \
    case 2: CALL(2); break;  \
    case 3: CALL(3); break;  \
    case 4: CALL(4); break;  \
    case 5: CALL(5); break;  \
    case 6: CALL(6); break;  \
    case 7: CALL(7); break;  \
    default: CALL(8); break; \
  }

// One Stockham pass of radix R over the block's W-point windows: item j of
// a window takes points j + r*W/R, times e^{-2 pi i (j % ns) r / (ns R)}
// (entry (j % ns) * r * W / (ns R) of the W-entry table), an R-point DFT,
// and lands at (j / ns)*ns*R + j % ns + r*ns.  The last pass stores the
// norms at their fftshifted columns instead.
template <int R>
__device__ __forceinline__ void stft_pass(const float* __restrict__ src, float* __restrict__ dst, const float* tw,
                                          int bout, int lw, int lns, bool last, long long i0, long long n_out,
                                          float* __restrict__ norms, int tid, int nt) {
  const int width = 1 << lw;
  const int per = width / R;  // items a window
  const int ns = 1 << lns;
  const int step = width / (ns * R);
  for (int it = tid; it < bout / R; it += nt) {
    const int win = it / per;
    const int j = it - win * per;
    const int base = win * width;
    float vr[R], vi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      vr[r] = src[base + j + r * per];
      vi[r] = src[bout + base + j + r * per];
    }
    const int jm = j & (ns - 1);
    if (ns > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const int e = (jm * r * step) & (width - 1);
        qt::cmul(vr[r], vi[r], make_float2(tw[e], tw[width + e]));
      }
    }
    qt::dft<R>(vr, vi);
    const int o = base + ((j >> lns) << lns) * R + jm;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int at = o + r * ns;
      if (last) {
        const int k = at - base;
        const long long gi = i0 + base + ((k + width / 2) & (width - 1));
        if (gi < n_out) norms[gi] = sqrtf(vr[r] * vr[r] + vi[r] * vi[r]);
      } else {
        dst[at] = vr[r];
        dst[bout + at] = vi[r];
      }
    }
  }
}

// MODE: kFir (planes out), kStft (norms out), kBanded (the v1 mix, planes
// out).  DC: the decimation at compile time (a multiple of 8), or 0 for d
// at run time.  nch: 1, every worker walks all chunks; 2 (exactly two
// chunks), the first half of the workers takes chunk 0, the second chunk 1.
template <typename T, int MODE, int DC>
__global__ void __launch_bounds__(kMaxThreads, 2) frontend_kernel(
    const T* __restrict__ re, const T* __restrict__ im, long long n_ok, const float* __restrict__ bases,
    const float* __restrict__ tab_cos, const float* __restrict__ tab_sin, const float* __restrict__ h,
    const float* __restrict__ dtab_g, int d_arg, int m_sub, int tout, int bout, int nch, long long n_out,
    float* __restrict__ out_re, float* __restrict__ out_im, const float* __restrict__ tw_cos,
    const float* __restrict__ tw_sin, int width, float* __restrict__ norms) {
  static_assert(DC % 8 == 0, "a compile-time decimation is a multiple of 8");
  extern __shared__ __align__(16) float smem[];
  constexpr bool ANGLE = MODE == kBanded;
  const int d = DC ? DC : d_arg;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout lay =
      make_layout(d, m_sub, bout, sizeof(T), MODE == kStft || nch == 2, MODE == kStft ? width : 0);
  const int row = lay.row, m_pad = lay.m_pad;
  float* xr = smem;
  float* xi = smem + d * row;
  float* hs = smem + lay.hs;
  float* dtab = smem + lay.dtab;
  float* ex = smem + lay.ex;
  float* tw = smem + lay.tw;

  const long long i0 = static_cast<long long>(blockIdx.x) * bout;
  const long long t = i0 / tout;
  const long long p0 = i0 * d;               // first sample of the span
  const long long q0 = (i0 - t * tout) * d;  // its offset inside tile t
  const float base = bases[t];
  float cb = 0.0f, sb = 0.0f;
  if (!ANGLE) {
    cb = cosf(base);
    sb = sinf(base);
  }

  // tables: the taps transposed to hs[dd][m_pad], the decode table, twiddles
  for (int k = tid; k < d * m_pad; k += nt) {
    const int dd = k / m_pad, m = k - dd * m_pad;
    hs[k] = m < m_sub ? h[m * d + dd] : 0.0f;
  }
  if (sizeof(T) == 1)
    for (int k = tid; k < 256; k += nt) dtab[k] = dtab_g[k];
  if (MODE == kStft)
    for (int k = tid; k < width; k += nt) {
      tw[k] = tw_cos[k];
      tw[width + k] = tw_sin[k];
    }

  // stage: decode, mask past n_ok in the decoded domain, mix, transpose
  const int cols = bout + m_sub - 1;
  if (d % 4 == 0) {
    // kStage groups of four samples in flight a thread: all their loads
    // are started before the first is decoded.  Every thread makes the same
    // number of rounds, so the barrier that publishes the decode table can
    // sit behind the first round's loads.
    const int qd = d >> 2;
    const int groups = cols * qd;
    for (int r0 = 0; r0 < groups; r0 += kStage * nt) {
      Raw4<T> ra[kStage], rb[kStage];
      float4 tc[kStage], ts[kStage];
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int g = r0 + u * nt + tid;
        if (g < groups) {
          ra[u] = fetch4<T>(re, p0 + 4 * g, n_ok);
          rb[u] = fetch4<T>(im, p0 + 4 * g, n_ok);
          tc[u] = __ldg(reinterpret_cast<const float4*>(tab_cos + q0 + 4 * g));
          ts[u] = ANGLE ? tc[u] : __ldg(reinterpret_cast<const float4*>(tab_sin + q0 + 4 * g));
        }
      }
      if (sizeof(T) == 1 && r0 == 0) __syncthreads();
#pragma unroll
      for (int u = 0; u < kStage; ++u) {
        const int g = r0 + u * nt + tid;
        if (g < groups) {
          const int col = g / qd;
          const int dd0 = (g - col * qd) << 2;
          float a[4], b[4];
          decode4<T>(ra[u], dtab, a);
          decode4<T>(rb[u], dtab, b);
          const float tcs[4] = {tc[u].x, tc[u].y, tc[u].z, tc[u].w};
          const float tss[4] = {ts[u].x, ts[u].y, ts[u].z, ts[u].w};
          const int at = dd0 * row + word_at(col >> 2, dd0) + (col & 3);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float c, sn;
            rotation<ANGLE>(tcs[j], ANGLE ? 0.0f : tss[j], base, cb, sb, c, sn);
            xr[at + j * row] = __fsub_rn(__fmul_rn(a[j], c), __fmul_rn(b[j], sn));
            xi[at + j * row] = __fadd_rn(__fmul_rn(a[j], sn), __fmul_rn(b[j], c));
          }
        }
      }
    }
  } else {
    if (sizeof(T) == 1) __syncthreads();
    int col = tid / d, dd = tid - col * d;
    const int cstep = nt / d, dstep = nt - cstep * d;
    for (int s = tid; s < cols * d; s += nt) {
      const long long q = p0 + s;
      float a = 0.0f, b = 0.0f;
      if (q < n_ok) {
        if constexpr (sizeof(T) == 1) {
          a = dtab[static_cast<uint8_t>(re[q])];
          b = dtab[static_cast<uint8_t>(im[q])];
        } else {
          a = qt::decode(re[q]);
          b = qt::decode(im[q]);
        }
      }
      float c, sn;
      rotation<ANGLE>(tab_cos[q0 + s], ANGLE ? 0.0f : tab_sin[q0 + s], base, cb, sb, c, sn);
      const int at = dd * row + word_at(col >> 2, dd) + (col & 3);
      xr[at] = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, sn));
      xi[at] = __fadd_rn(__fmul_rn(a, sn), __fmul_rn(b, c));
      col += cstep;
      dd += dstep;
      if (dd >= d) {
        dd -= d;
        ++col;
      }
    }
  }
  __syncthreads();

  // polyphase FIR: worker (group, plane, t) owns outputs 8t .. 8t + 7 of
  // its plane
  const int per_plane = bout / kR;
  const bool worker = tid < 2 * per_plane * nch;
  const int grp = tid / (2 * per_plane);
  const int plane = (tid / per_plane) & 1;
  const int tw8 = tid % per_plane;
  const float* xp = plane ? xi : xr;
  const int n_chunks = m_pad / kMC;
  const int rem = m_sub - kMC * (n_chunks - 1);  // subfilters of the last chunk
  float y[kR], p[kMC][kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) y[r] = 0.0f;
#define QT_SUMS(MC) chunk_sums<MC, DC>(xp, hs, c, tw8, d, row, m_pad, p)
#define QT_FOLD(MC) fold<MC>(p, y, c == 0)
  if (nch == 1) {
    if (worker) {
      int c = 0;
      for (; c < n_chunks - 1; ++c) {
        QT_SUMS(kMC);
        QT_FOLD(kMC);
      }
      QT_BY_REM(rem, QT_SUMS)
      QT_BY_REM(rem, QT_FOLD)
    }
  } else {
    // two chunks side by side; the second group's sums wait for the first
    // group's y, so the subfilters still add up in order
    const int c = grp;
    if (worker) {
      if (grp == 0) {
        QT_SUMS(kMC);
        QT_FOLD(kMC);
#pragma unroll
        for (int r = 0; r < kR; ++r) ex[plane * bout + kR * tw8 + r] = y[r];
      } else {
        QT_BY_REM(rem, QT_SUMS)
      }
    }
    __syncthreads();
    if (worker && grp == 1) {
#pragma unroll
      for (int r = 0; r < kR; ++r) y[r] = ex[plane * bout + kR * tw8 + r];
      QT_BY_REM(rem, QT_FOLD)
    }
  }
#undef QT_SUMS
#undef QT_FOLD
  const bool owner = worker && grp == nch - 1;  // holds the finished outputs

  if (MODE != kStft) {
    if (owner) {
      float* out = (plane ? out_im : out_re) + i0 + kR * tw8;
      const long long i = i0 + kR * tw8;
      if (i + kR <= n_out && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        reinterpret_cast<float4*>(out)[0] = make_float4(y[0], y[1], y[2], y[3]);
        reinterpret_cast<float4*>(out)[1] = make_float4(y[4], y[5], y[6], y[7]);
      } else {
#pragma unroll
        for (int r = 0; r < kR; ++r)
          if (i + r < n_out) out[r] = y[r];
      }
    }
    return;
  }

  // STFT epilogue: the block holds bout / width whole windows in ex (re,
  // then im); passes of radix 8, the last of radix 8, 4 or 2, between ex
  // and a second buffer over X
  __syncthreads();  // every read of X and of ex is done
  if (owner) {
#pragma unroll
    for (int r = 0; r < kR; ++r) ex[plane * bout + kR * tw8 + r] = y[r];
  }
  __syncthreads();
  int lw = 0;
  while ((1 << lw) < width) ++lw;
  const int n_pass = (lw + 2) / 3;
  float* src = ex;
  float* dst = smem;
  for (int ps = 0; ps < n_pass; ++ps) {
    const bool last = ps == n_pass - 1;
    const int lr = last ? lw - 3 * (n_pass - 1) : 3;
    const int lns = 3 * ps;
    if (lr == 3) {
      stft_pass<8>(src, dst, tw, bout, lw, lns, last, i0, n_out, norms, tid, nt);
    } else if (lr == 2) {
      stft_pass<4>(src, dst, tw, bout, lw, lns, last, i0, n_out, norms, tid, nt);
    } else {
      stft_pass<2>(src, dst, tw, bout, lw, lns, last, i0, n_out, norms, tid, nt);
    }
    if (!last) __syncthreads();
    float* s = src;
    src = dst;
    dst = s;
  }
}

template <typename T, int MODE, int DC>
int launch(int device, const void* re, const void* im, long long n_ok, const float* bases, const float* tab_cos,
           const float* tab_sin, const float* h, const float* dtab, int d, int m_sub, int tout, int bout, int nch,
           int threads, long long n_out, float* out_re, float* out_im, const float* tw_cos, const float* tw_sin, int width,
           float* norms, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int workers = 2 * (bout / kR) * nch;
  const int m_pad = (m_sub + kMC - 1) / kMC * kMC;
  if (d < 1 || m_sub < 1 || (bout != 32 && bout != 64 && bout != 128 && bout != 256) || tout % bout != 0 ||
      n_out < 1 || (nch != 1 && nch != 2) || (nch == 2 && m_pad != 2 * kMC) || threads % 32 != 0 ||
      threads < workers || threads > kMaxThreads || (sizeof(T) == 1 && dtab == nullptr) ||
      (MODE == kStft && (width < 2 || width > 128 || (width & (width - 1)) != 0 || bout % width != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay =
      make_layout(d, m_sub, bout, sizeof(T), MODE == kStft || nch == 2, MODE == kStft ? width : 0);
  const size_t smem = static_cast<size_t>(lay.floats) * sizeof(float);
  auto kern = frontend_kernel<T, MODE, DC>;
  // the limit of this instantiation on each device, raised when a launch
  // needs more (one attribute call per instantiation and size, not per launch)
  static size_t limit[64] = {};
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > limit[device]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    limit[device] = smem;
  }
  const long long blocks = (n_out + bout - 1) / bout;
  kern<<<static_cast<unsigned>(blocks), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(re), static_cast<const T*>(im), n_ok, bases, tab_cos, tab_sin, h, dtab, d, m_sub, tout,
      bout, nch, n_out, out_re, out_im, tw_cos, tw_sin, width, norms);
  return static_cast<int>(cudaGetLastError());
}

// fmt codes: 0 cf32 (float), 1 cs8 (int8), 2 cu8 (uint8), 3 cs16 (int16);
// D 32 takes its own instantiation
template <int MODE>
int dispatch(int fmt, int device, const void* re, const void* im, long long n_ok, const float* bases,
             const float* tab_cos, const float* tab_sin, const float* h, const float* dtab, int d, int m_sub,
             int tout, int bout, int nch, int threads, long long n_out, float* out_re, float* out_im,
             const float* tw_cos, const float* tw_sin, int width, float* norms, void* stream) {
#define QT_LAUNCH(T, DC)                                                                                        \
  launch<T, MODE, DC>(device, re, im, n_ok, bases, tab_cos, tab_sin, h, dtab, d, m_sub, tout, bout, nch, threads, \
                      n_out, out_re, out_im, tw_cos, tw_sin, width, norms, stream)
#define QT_BY_D(T) return d == 32 ? QT_LAUNCH(T, 32) : QT_LAUNCH(T, 0)
  switch (fmt) {
    case 0: QT_BY_D(float);
    case 1: QT_BY_D(int8_t);
    case 2: QT_BY_D(uint8_t);
    case 3: QT_BY_D(int16_t);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef QT_BY_D
#undef QT_LAUNCH
}

}  // namespace

// Every entry point takes the same leading arguments: the format code, the
// device, the re and im planes, the samples to use (later ones count as
// zero), the per-tile bases, the mix tables, the taps (m_sub rows of D), the
// 256-entry decode table (ops/waterfall.decode_table; required for cs8 and
// cu8, else ignored), D, the subfilters, the outputs per phase tile, and the
// launch plan of ops/frontend.launch_plan: outputs a block, chunk groups
// (1 or 2) and threads.
extern "C" {

// Kernel 1: (2, n_out) f32 decimated planes into out_re / out_im.
int qt_frontend_fir(int fmt, int device, const void* re, const void* im, long long n_ok, const float* bases,
                    const float* tab_cos, const float* tab_sin, const float* h, const float* dtab, int d,
                    int m_sub, int tout, int bout, int nch, int threads, long long n_out, float* out_re, float* out_im,
                    void* stream) {
  return dispatch<kFir>(fmt, device, re, im, n_ok, bases, tab_cos, tab_sin, h, dtab, d, m_sub, tout, bout, nch,
                        threads, n_out, out_re, out_im, nullptr, nullptr, 0, nullptr, stream);
}

// Kernel 2: (n_out / width, width) f32 fftshifted STFT norms into norms;
// tw_cos / tw_sin hold cos and sin of -2 pi j / width, j < width.
int qt_frontend_fir_stft(int fmt, int device, const void* re, const void* im, long long n_ok, const float* bases,
                         const float* tab_cos, const float* tab_sin, const float* h, const float* dtab, int d,
                         int m_sub, int tout, int bout, int nch, int threads, long long n_out,
                         const float* tw_cos, const float* tw_sin, int width, float* norms, void* stream) {
  return dispatch<kStft>(fmt, device, re, im, n_ok, bases, tab_cos, tab_sin, h, dtab, d, m_sub, tout, bout, nch,
                         threads, n_out, nullptr, nullptr, tw_cos, tw_sin, width, norms, stream);
}

// Kernel 3 (v1): (2, n_out) f32 decimated planes into out_re / out_im, the
// mix by cosf/sinf(bases[t] + delta[q]) per element, tout outputs per tile.
int qt_frontend_banded(int fmt, int device, const void* re, const void* im, long long n_ok, const float* bases,
                       const float* delta, const float* h, const float* dtab, int d, int m_sub, int tout,
                       int bout, int nch, int threads, long long n_out, float* out_re, float* out_im, void* stream) {
  return dispatch<kBanded>(fmt, device, re, im, n_ok, bases, delta, nullptr, h, dtab, d, m_sub, tout, bout, nch,
                           threads, n_out, out_re, out_im, nullptr, nullptr, 0, nullptr, stream);
}

const char* qt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
