// Shared helpers of the decode-path kernels (plain C interface, bound with
// ctypes by rtlsdr_ft8d_tpu_torch/ops/build.py).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define FT8_EXPORT extern "C" __attribute__((visibility("default")))

namespace ft8 {

// Waterfall geometry (rtlsdr_ft8d_tpu/protocol/constants.py).
constexpr int kBlocks = 92;        // symbol blocks
constexpr int kNumBin = 256;       // bins per (time_sub, freq_sub) row
constexpr int kPlane = 4 * kNumBin;  // one block: [time_sub][freq_sub][bin]

// Inexact float constants (4.97, 0.999999, 1e-12, 1/174) are written as
// double literals narrowed to float, the way Python and the JAX reference
// turn a float literal into float32.

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

}  // namespace ft8
