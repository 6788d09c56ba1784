// Tone magnitudes and normalized LLRs of a flat candidate selection.
//
// Replaces the Pallas kernel rtlsdr_ft8d_tpu/ops/llr_pallas.py
// (tone_mags_flat_pallas, body _kernel) and fuses what follows it in
// rtlsdr_ft8d_tpu/ops/llr.py:_llrs_from_mags. For candidate n in channel
// chan with sub-offsets (ts, fs) and offsets (to, fo), data symbol
// k = 0..57 sits in block to + k + 7 + 7 (k / 29); its 8 Gray-mapped tone
// magnitudes are the waterfall bytes
//   wf[(((chan * 92 + block) * 2 + ts) * 2 + fs) * 256 + fo + gray[j]]
// (0 for a block outside [0, 92); to and fo clipped to [-12, 23] and
// [0, 248] as in the Pallas wrapper). It writes s2 (N, 58, 8) and the
// 174 max-log bit LLRs scaled to variance 24 (ft8_lib's normalization).
//
// What bounds it: scattered byte reads, 58 x 8 per candidate from a
// waterfall that stays in L2 (6 MB at B = 64). One warp per candidate:
// lanes own symbols k and k + 32, read their 8 tones directly (the one-hot
// MXU dots and the 104-row zero padding of the Pallas kernel were Mosaic
// workarounds), and the variance sums are warp shuffles. The LLR sums add
// integers below 2^24, so they are exact in any order, and the
// normalization uses round-to-nearest intrinsics to match the plain
// PyTorch version's element-wise arithmetic.
#include "common.cuh"

namespace {

constexpr int kSyms = 58;
constexpr int kBits = 174;
constexpr int kWarpsPerBlock = 8;
__constant__ int kGray[8] = {0, 1, 3, 2, 5, 6, 4, 7};

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
llr_kernel(const uint8_t* __restrict__ wf, const int* __restrict__ chan,
           const int* __restrict__ ts, const int* __restrict__ fs,
           const int* __restrict__ to, const int* __restrict__ fo, int n,
           float* __restrict__ s2, float* __restrict__ llr) {
  const int cand = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (cand >= n) return;                 // the whole warp leaves together

  const int c = chan[cand], t_s = ts[cand], f_s = fs[cand];
  const int t_o = min(max(to[cand], -12), 23);
  const int f_o = min(max(fo[cand], 0), ft8::kNumBin - 8);

  float logl[2][3];
  float sum = 0.f, sumsq = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = lane + 32 * h;
    logl[h][0] = logl[h][1] = logl[h][2] = 0.f;
    if (k >= kSyms) continue;
    const int blk = t_o + k + 7 + 7 * (k / 29);
    const bool valid = blk >= 0 && blk < ft8::kBlocks;
    float v[8];
    if (valid) {
      const uint8_t* row =
          wf + ((static_cast<size_t>(c) * ft8::kBlocks + blk) * 2 + t_s) * 2
                   * ft8::kNumBin + f_s * ft8::kNumBin + f_o;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = static_cast<float>(row[kGray[j]]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    float* s2_row = s2 + (static_cast<size_t>(cand) * kSyms + k) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) s2_row[j] = v[j];
    if (!valid) continue;
#pragma unroll
    for (int b = 0; b < 3; ++b) {         // bit b of the Gray-decoded value
      float max_set = -1e30f, max_clr = -1e30f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if ((j >> (2 - b)) & 1) max_set = fmaxf(max_set, v[j]);
        else max_clr = fmaxf(max_clr, v[j]);
      }
      logl[h][b] = __fsub_rn(max_set, max_clr);
      sum = __fadd_rn(sum, logl[h][b]);
      sumsq = __fadd_rn(sumsq, __fmul_rn(logl[h][b], logl[h][b]));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
    sumsq = __fadd_rn(sumsq, __shfl_xor_sync(0xffffffffu, sumsq, off));
  }
  const float inv_n = static_cast<float>(1.0 / 174.0);
  const float var =
      __fmul_rn(__fsub_rn(sumsq, __fmul_rn(__fmul_rn(sum, sum), inv_n)), inv_n);
  const float norm =
      __fsqrt_rn(__fdiv_rn(24.f, fmaxf(var, static_cast<float>(1e-12))));
  float* out = llr + static_cast<size_t>(cand) * kBits;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k = lane + 32 * h;
    if (k >= kSyms) continue;
#pragma unroll
    for (int b = 0; b < 3; ++b) out[3 * k + b] = __fmul_rn(logl[h][b], norm);
  }
}

}  // namespace

// wf: (B, 92, 2, 2, 256) u8; chan/ts/fs/to/fo: (n,) i32;
// s2: (n, 58, 8) f32; llr: (n, 174) f32.
FT8_EXPORT int ft8_tone_llrs(const uint8_t* wf, const int* chan, const int* ts,
                             const int* fs, const int* to, const int* fo,
                             float* s2, float* llr, int n, void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  llr_kernel<<<blocks, kWarpsPerBlock * 32, 0,
               static_cast<cudaStream_t>(stream)>>>(wf, chan, ts, fs, to, fo,
                                                     n, s2, llr);
  return static_cast<int>(cudaGetLastError());
}
