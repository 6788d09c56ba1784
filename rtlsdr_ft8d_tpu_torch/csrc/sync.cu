// Costas sync scores: (B, 92, 2, 2, 256) uint8 waterfall -> (B, 2, 2, 36, 249)
// int32, [time_sub][freq_sub][time_offset + 12][freq_offset].
//
// Replaces the Pallas kernel rtlsdr_ft8d_tpu/ops/sync_pallas.py
// (sync_scores_pallas, body _sync_kernel). The score of a cell is
// ft8_lib's neighbour-contrast sum over the 21 Costas symbols at block
// offsets 0/36/72, divided with C's truncating '/' by the data-independent
// term count (the sync_count table). This kernel runs the C loop itself
// (tests/reference_impl.py:sync_score_ref) in integer math, so it is
// bit-exact by construction.
//
// What bounds it: on-chip reads. One block per (b, time_sub, freq_sub)
// plane loads the plane's 92 x 256 bytes (stride 4 x 256 in the
// waterfall layout) into shared memory once (23.5 KB); each of the
// 36 x 249 cells then makes ~84 shared-memory reads and no device-memory
// traffic beyond its 4-byte store. The JAX formulation instead writes
// ~100 MB of int32 difference and fold planes per 64-channel window.
#include "common.cuh"

namespace {

constexpr int kTimeOffsets = 36;
constexpr int kFreqOffsets = 249;
constexpr int kTimeOffsetMin = -12;
constexpr int kThreads = 256;
__constant__ int kCostas[7] = {3, 1, 4, 0, 6, 5, 2};

__global__ void __launch_bounds__(kThreads)
sync_kernel(const uint8_t* __restrict__ wf, const int* __restrict__ count,
            int* __restrict__ scores) {
  __shared__ uint8_t plane[ft8::kBlocks][ft8::kNumBin];
  __shared__ int cnt[kTimeOffsets];

  const int p = blockIdx.x;              // b * 4 + time_sub * 2 + freq_sub
  const uint8_t* src =
      wf + static_cast<size_t>(p >> 2) * ft8::kBlocks * ft8::kPlane
      + (p & 3) * ft8::kNumBin;
  for (int idx = threadIdx.x; idx < ft8::kBlocks * ft8::kNumBin;
       idx += kThreads) {
    const int blk = idx / ft8::kNumBin, bin = idx % ft8::kNumBin;
    plane[blk][bin] = src[blk * ft8::kPlane + bin];
  }
  if (threadIdx.x < kTimeOffsets) cnt[threadIdx.x] = count[threadIdx.x];
  __syncthreads();

  int* out = scores + static_cast<size_t>(p) * kTimeOffsets * kFreqOffsets;
  for (int cell = threadIdx.x; cell < kTimeOffsets * kFreqOffsets;
       cell += kThreads) {
    const int ti = cell / kFreqOffsets, fo = cell % kFreqOffsets;
    const int to = ti + kTimeOffsetMin;
    int score = 0;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        const int blk = to + 36 * m + k;
        if (blk < 0) continue;
        if (blk >= ft8::kBlocks) break;
        const int sm = kCostas[k];
        const int f = fo + sm;
        const int v = plane[blk][f];
        if (sm > 0) score += v - plane[blk][f - 1];
        if (sm < 7) score += v - plane[blk][f + 1];
        if (k > 0 && blk > 0) score += v - plane[blk - 1][f];
        if (k < 6 && blk + 1 < ft8::kBlocks) score += v - plane[blk + 1][f];
      }
    }
    out[cell] = score / cnt[ti];         // C division truncates toward zero
  }
}

}  // namespace

// wf: (planes / 4, 92, 2, 2, 256) u8; count: (36,) i32;
// scores: (planes, 36, 249) i32 with planes = 4 * batch.
FT8_EXPORT int ft8_sync_scores(const uint8_t* wf, const int* count,
                               int* scores, int batch, void* stream) {
  if (batch <= 0) return cudaErrorInvalidValue;
  sync_kernel<<<4 * batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      wf, count, scores);
  return static_cast<int>(cudaGetLastError());
}
