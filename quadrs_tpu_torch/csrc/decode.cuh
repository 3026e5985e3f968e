// The reference's sample decode formulas (src/lib.rs:248-253) in IEEE f32,
// shared by the port's kernels.  The divisions are __fdiv_rn, so the
// decode is bit-equal to the plain PyTorch version on the CPU and the card;
// the library is built without --use_fast_math.
#pragma once

#include <stdint.h>

namespace qt {

__device__ __forceinline__ float decode(float v) { return v; }
__device__ __forceinline__ float decode(int8_t v) {
  return __fdiv_rn(static_cast<float>(v), 127.0f);
}
__device__ __forceinline__ float decode(uint8_t v) {
  return __fsub_rn(__fdiv_rn(static_cast<float>(v), 255.0f), 127.5f);
}
__device__ __forceinline__ float decode(int16_t v) {
  return __fsub_rn(__fdiv_rn(static_cast<float>(v), 65535.0f), 32767.5f);
}

}  // namespace qt
