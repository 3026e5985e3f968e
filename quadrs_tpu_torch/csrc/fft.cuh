// In-register FFT pieces shared by the port's kernels: the radix-R
// butterflies (R <= 16) that csrc/waterfall.cu's passes and
// csrc/frontend.cu's STFT epilogue run between their exchanges through
// shared memory.  Constants are f64 values rounded to f32; no fast-math trig.
#pragma once

namespace qt {

// W_16^q = cos(2 pi q / 16) - i sin(2 pi q / 16), f64 values rounded to f32
__device__ __forceinline__ float cos16(int q) {
  switch (q) {
    case 1: return 0.92387953251128674f;
    case 2: return 0.70710678118654752f;
    case 3: return 0.38268343236508978f;
    case 5: return -0.38268343236508978f;
    case 6: return -0.70710678118654752f;
    case 7: return -0.92387953251128674f;
    default: return 0.0f;
  }
}
__device__ __forceinline__ float sin16(int q) {
  switch (q) {
    case 1: case 7: return 0.38268343236508978f;
    case 2: case 6: return 0.70710678118654752f;
    case 3: case 5: return 0.92387953251128674f;
    default: return 0.0f;
  }
}

// In-register R-point DFT (R <= 16), natural order in and out: radix-2
// decimation in time, unrolled at compile time.
template <int R>
__device__ __forceinline__ void dft(float* xr, float* xi) {
  if constexpr (R > 1) {
    constexpr int H = R / 2;
    float er[H], ei[H], orr[H], oi[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      er[k] = xr[2 * k];
      ei[k] = xi[2 * k];
      orr[k] = xr[2 * k + 1];
      oi[k] = xi[2 * k + 1];
    }
    dft<H>(er, ei);
    dft<H>(orr, oi);
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const int q = k * (16 / R);  // W_R^k = W_16^q
      float tr, ti;
      if (q == 0) {
        tr = orr[k];
        ti = oi[k];
      } else if (q == 4) {  // times -i
        tr = oi[k];
        ti = -orr[k];
      } else {
        const float c = cos16(q), s = sin16(q);
        tr = orr[k] * c + oi[k] * s;
        ti = oi[k] * c - orr[k] * s;
      }
      xr[k] = er[k] + tr;
      xi[k] = ei[k] + ti;
      xr[k + H] = er[k] - tr;
      xi[k + H] = ei[k] - ti;
    }
  }
}

__device__ __forceinline__ void cmul(float& a, float& b, float2 w) {
  const float r = a * w.x - b * w.y;
  b = a * w.y + b * w.x;
  a = r;
}

}  // namespace qt
