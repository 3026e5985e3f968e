// Fused receiver frontend for Hopper (sm_90a): decode -> exact NCO mix ->
// polyphase decimating FIR, and optionally the fftshifted W-point STFT
// magnitudes of the decimated stream, in one pass over the raw planes.
//
// Replaces the TPU kernel quadrs_tpu/ops/frontend_pallas.py::_kernel_t, as
// launched by fused_frontend_t without stft_width (frontend_fir below) and
// with it (frontend_fir_stft).  The Python wrapper and the plain PyTorch
// version of the same function are in quadrs_tpu_torch/ops/frontend.py.
//
// What bounds it on the H100.  Each decimated output costs 2*K FMAs
// (re and im, K = ceil(taps/D)*D padded taps) and reads D new input
// samples: at the stream chain's cs8, D 32, 400 taps that is 832 FMAs
// per 64 input bytes (2 B/sample), some 13 FMAs per byte.  The 3.35 TB/s
// of device memory would feed ~44 TFMA/s, above the ~33 TFMA/s of f32
// FMA the SMs have, so the input bytes are not the limit.  Neither, in
// this version, is the arithmetic: with one output per thread, each pair
// of FMAs (re and im) issues about three shared-memory loads (x_re, x_im
// and the tap), so load issue and shared-memory latency bound it; on an
// H100 80GB HBM3 at 700 W it measured ~1.4 TFMA/s at that shape, about 4%
// of the FMA peak.  Register blocking of several outputs per thread, which
// reuses each loaded tap and sample across outputs, is the lever.  The
// STFT epilogue adds 4*W FMAs per output, a fraction of the FIR's.
//
// What the design does about it.
//  * Each input sample is read from device memory once per block, decoded
//    once, masked once and mixed once, then kept in shared memory as f32
//    re/im.  The decimated stream (and, in frontend_fir_stft, the
//    spectrum) never round-trips through device memory.
//  * Shared memory holds the mixed span in polyphase order, X[dd][c] =
//    x[c*D + dd], rows padded to an odd length: thread i's read of
//    X[dd][i + m] and its neighbours' reads are consecutive words (no bank
//    conflicts), and the staging stores of consecutive dd hit distinct
//    banks.  The taps sit in shared memory and are read as broadcasts.
//  * The mix rotates host-planned f32 cos/sin(delta) tables (exact
//    integer phase reduction, f64 trig) by one cosf/sinf of the tile's
//    base angle, as the TPU kernel does; no per-sample trig.
//  * The decode is IEEE division (__fdiv_rn) and the mix is written with
//    _rn intrinsics in the reference's operation order, so both are
//    bit-equal to the plain version; only the FIR and DFT sums (fmaf, in
//    another order than a matmul) differ in the last bits.
// wgmma, TMA and register blocking of several outputs per thread are left
// for later: this is the simple version that is right first.
//
// Layout contract (checked by the wrapper): planes are two rows of a
// native-dtype tensor with unit stride; bases holds one angle per tout
// outputs (the phase-planning tile of the JAX package); the cos/sin tables
// hold (tout + 128) * D entries in in-tile sample order; h holds the
// m_sub * D zero-padded taps.  A block owns bout outputs (bout divides
// tout, so a block never straddles two phase tiles) and one thread
// computes one output.

#include <cuda_runtime.h>
#include <stdint.h>

#include "decode.cuh"

namespace {

using qt::decode;

template <typename T, bool STFT>
__global__ void __launch_bounds__(256) frontend_kernel(
    const T* __restrict__ re, const T* __restrict__ im, long long n_ok,
    const float* __restrict__ bases, const float* __restrict__ tab_cos,
    const float* __restrict__ tab_sin, const float* __restrict__ h, int d,
    int m_sub, int tout, int row, long long n_out, float* __restrict__ out_re,
    float* __restrict__ out_im, const float* __restrict__ tw_cos,
    const float* __restrict__ tw_sin, int width, float* __restrict__ norms) {
  extern __shared__ float smem[];
  const int bout = blockDim.x;
  const int taps = m_sub * d;
  float* xr = smem;                         // [d][row] mixed re
  float* xi = xr + static_cast<size_t>(d) * row;  // [d][row] mixed im
  float* hs = xi + static_cast<size_t>(d) * row;  // [taps]

  const long long i0 = static_cast<long long>(blockIdx.x) * bout;
  const long long t = i0 / tout;
  const long long p0 = i0 * d;               // first sample of the span
  const long long q0 = (i0 - t * tout) * d;  // its offset inside tile t
  const float base = bases[t];
  const float cb = cosf(base);
  const float sb = sinf(base);

  // stage: decode, mask past n_ok in the decoded domain, mix
  const int span = (bout + m_sub - 1) * d;
  for (int s = threadIdx.x; s < span; s += bout) {
    const long long p = p0 + s;
    float a = 0.0f, b = 0.0f;
    if (p < n_ok) {
      a = decode(re[p]);
      b = decode(im[p]);
    }
    const float cd = tab_cos[q0 + s];
    const float sd = tab_sin[q0 + s];
    const float c = __fsub_rn(__fmul_rn(cd, cb), __fmul_rn(sd, sb));
    const float sn = __fadd_rn(__fmul_rn(sd, cb), __fmul_rn(cd, sb));
    const int col = s / d;
    const int dd = s - col * d;
    xr[dd * row + col] = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, sn));
    xi[dd * row + col] = __fadd_rn(__fmul_rn(a, sn), __fmul_rn(b, c));
  }
  for (int k = threadIdx.x; k < taps; k += bout) hs[k] = h[k];
  __syncthreads();

  // polyphase FIR: y[i] = sum_m sum_dd h[m*D + dd] * x[(i + m)*D + dd],
  // summed per subfilter first (as the plain version's matmul does): one
  // running sum over all taps loses accuracy where the output is a small
  // residual of large inputs, e.g. cu8's -127.5 DC in the stopband
  const int il = threadIdx.x;
  float yr = 0.0f, yi = 0.0f;
  for (int m = 0; m < m_sub; ++m) {
    const float* hm = hs + m * d;
    const float* xrm = xr + il + m;
    const float* xim = xi + il + m;
    float pr = 0.0f, pi = 0.0f;
    for (int dd = 0; dd < d; ++dd) {
      const float hv = hm[dd];
      pr = fmaf(hv, xrm[dd * row], pr);
      pi = fmaf(hv, xim[dd * row], pi);
    }
    yr += pr;
    yi += pi;
  }
  const long long i = i0 + il;
  if (!STFT) {
    if (i < n_out) {
      out_re[i] = yr;
      out_im[i] = yi;
    }
    return;
  }

  // STFT epilogue: the block holds bout / width whole windows; column kk
  // of a window is DFT bin (kk + width/2) % width (the fftshift), and
  // e^{-2 pi i n k / W} is the table entry (n*k) % W.
  float* ys_r = hs + taps;
  float* ys_i = ys_r + bout;
  float* twc = ys_i + bout;
  float* tws = twc + width;
  ys_r[il] = yr;
  ys_i[il] = yi;
  for (int k = il; k < width; k += bout) {
    twc[k] = tw_cos[k];
    tws[k] = tw_sin[k];
  }
  __syncthreads();
  const int w0 = il - il % width;
  const int kb = (il - w0 + width / 2) % width;
  float zr = 0.0f, zi = 0.0f;
  for (int n = 0; n < width; ++n) {
    const int j = (n * kb) % width;
    const float c = twc[j];
    const float s = tws[j];
    const float a = ys_r[w0 + n];
    const float b = ys_i[w0 + n];
    zr = fmaf(a, c, fmaf(-b, s, zr));
    zi = fmaf(a, s, fmaf(b, c, zi));
  }
  if (i < n_out) norms[i] = sqrtf(zr * zr + zi * zi);
}

template <typename T, bool STFT>
int launch(int device, const void* re, const void* im, long long n_ok,
           const float* bases, const float* tab_cos, const float* tab_sin,
           const float* h, int d, int m_sub, int tout, int bout,
           long long n_out, float* out_re, float* out_im,
           const float* tw_cos, const float* tw_sin, int width, float* norms,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d < 1 || m_sub < 1 || bout < 32 || bout > 256 || tout % bout != 0 ||
      n_out < 1 || (STFT && (width < 2 || bout % width != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row = (bout + m_sub - 1) | 1;
  const size_t smem =
      (2 * static_cast<size_t>(d) * row + static_cast<size_t>(m_sub) * d +
       (STFT ? 2 * static_cast<size_t>(bout) + 2 * static_cast<size_t>(width)
             : 0)) *
      sizeof(float);
  auto kern = frontend_kernel<T, STFT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_out + bout - 1) / bout;
  kern<<<static_cast<unsigned>(blocks), bout, smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(re), static_cast<const T*>(im), n_ok, bases,
      tab_cos, tab_sin, h, d, m_sub, tout, row, n_out, out_re, out_im, tw_cos,
      tw_sin, width, norms);
  return static_cast<int>(cudaGetLastError());
}

// fmt codes: 0 cf32 (float), 1 cs8 (int8), 2 cu8 (uint8), 3 cs16 (int16)
template <bool STFT>
int dispatch(int fmt, int device, const void* re, const void* im,
             long long n_ok, const float* bases, const float* tab_cos,
             const float* tab_sin, const float* h, int d, int m_sub, int tout,
             int bout, long long n_out, float* out_re, float* out_im,
             const float* tw_cos, const float* tw_sin, int width,
             float* norms, void* stream) {
#define QT_LAUNCH(T)                                                         \
  launch<T, STFT>(device, re, im, n_ok, bases, tab_cos, tab_sin, h, d,       \
                  m_sub, tout, bout, n_out, out_re, out_im, tw_cos, tw_sin, \
                  width, norms, stream)
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

extern "C" {

// Kernel 1: (2, n_out) f32 decimated planes into out_re / out_im.
int qt_frontend_fir(int fmt, int device, const void* re, const void* im,
                    long long n_ok, const float* bases, const float* tab_cos,
                    const float* tab_sin, const float* h, int d, int m_sub,
                    int tout, int bout, long long n_out, float* out_re,
                    float* out_im, void* stream) {
  return dispatch<false>(fmt, device, re, im, n_ok, bases, tab_cos, tab_sin,
                         h, d, m_sub, tout, bout, n_out, out_re, out_im,
                         nullptr, nullptr, 0, nullptr, stream);
}

// Kernel 2: (n_out / width, width) f32 fftshifted STFT norms into norms.
int qt_frontend_fir_stft(int fmt, int device, const void* re, const void* im,
                         long long n_ok, const float* bases,
                         const float* tab_cos, const float* tab_sin,
                         const float* h, int d, int m_sub, int tout, int bout,
                         long long n_out, const float* tw_cos,
                         const float* tw_sin, int width, float* norms,
                         void* stream) {
  return dispatch<true>(fmt, device, re, im, n_ok, bases, tab_cos, tab_sin, h,
                        d, m_sub, tout, bout, n_out, nullptr, nullptr, tw_cos,
                        tw_sin, width, norms, stream);
}

const char* qt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
