// Quantized waterfall: (B, >=47872) f32 I/Q -> (B, 92, 2, 2, 256) uint8.
//
// Replaces the Pallas kernel rtlsdr_ft8d_tpu/ops/waterfall_pallas.py
// (waterfall_pallas, body _wf_kernel). Per channel it computes the 184
// overlapped 1024-sample frames' DFT at bins 0..511 against the
// window-folded bases as the 3-multiplication (Karatsuba) complex product
//   P1 = I @ C,  P2 = Q @ S,  P3 = (I + Q) @ (C - S)
//   re = P1 + P2,  im = (P3 - P1) + P2
// then |X|^2 -> 10 log10(1e-12 + |X|^2 * 4/N^2) -> trunc(2 db + 240),
// clipped to [0, 255].
//
// What bounds it: arithmetic. 3 x 184 x 512 x 1024 FMAs per channel,
// 37 GFLOP at B = 64, all in FP32 FMAs (TF32 and bf16 tensor cores are
// ruled out: a 1-pass bf16 product lost 3 of 512 knife-edge decodes on the
// JAX side, rtlsdr_ft8d_tpu/ops/waterfall.py:64-75). The design is a
// shared-memory tiled SGEMM: a block computes a 64-frame x 64-bin tile of
// one channel with 256 threads, each holding 4 x 4 outputs of all three
// products in registers, and walks K = 1024 in steps of 16. Frame t is read
// straight from samples [256 t, 256 t + 1024) (no frame tensor), I + Q is
// formed once per loaded element, and the quantization and the
// [block][time_sub][freq_sub][bin] store are fused into the epilogue, so
// device memory sees the samples and bases in and 94 KB per channel out.
// The epilogue uses round-to-nearest intrinsics so that no FMA contraction
// changes the element-wise arithmetic of the plain PyTorch version.
#include "common.cuh"

namespace {

constexpr int kFrames = 184;
constexpr int kNfft = 1024;
constexpr int kBins = 512;
constexpr int kHop = 256;
constexpr int kUsed = (kFrames + 3) * kHop;   // 47872 samples read
constexpr int BM = 64, BN = 64, BK = 16;      // tile: frames x bins x depth
constexpr int kThreads = 256;                 // 16 x 16, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
waterfall_kernel(const float* __restrict__ xi, const float* __restrict__ xq,
                 const float* __restrict__ cosb,
                 const float* __restrict__ sinb,
                 const float* __restrict__ cmsb, uint8_t* __restrict__ out,
                 int row_stride) {
  __shared__ float s_i[BK][BM + 1];   // A tiles, transposed: [k][frame]
  __shared__ float s_q[BK][BM + 1];
  __shared__ float s_c[BK][BN];       // B tiles: [k][bin]
  __shared__ float s_s[BK][BN];
  __shared__ float s_m[BK][BN];

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* xi_b = xi + static_cast<size_t>(b) * row_stride;
  const float* xq_b = xq + static_cast<size_t>(b) * row_stride;

  float p1[4][4], p2[4][4], p3[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p1[i][j] = p2[i][j] = p3[i][j] = 0.f;

  for (int k0 = 0; k0 < kNfft; k0 += BK) {
#pragma unroll
    for (int e = 0; e < BM * BK / kThreads; ++e) {
      const int idx = tid + kThreads * e;
      const int r = idx / BK, c = idx % BK;
      const int t = t0 + r;
      float vi = 0.f, vq = 0.f;
      if (t < kFrames) {
        const int off = t * kHop + k0 + c;
        vi = xi_b[off];
        vq = xq_b[off];
      }
      s_i[c][r] = vi;
      s_q[c][r] = vq;
    }
#pragma unroll
    for (int e = 0; e < BK * BN / kThreads; ++e) {
      const int idx = tid + kThreads * e;
      const int r = idx / BN, c = idx % BN;
      const size_t off = static_cast<size_t>(k0 + r) * kBins + n0 + c;
      s_c[r][c] = cosb[off];
      s_s[r][c] = sinb[off];
      s_m[r][c] = cmsb[off];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float ai[4], aq[4], as[4], bc[4], bs[4], bm[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ai[i] = s_i[k][ty + 16 * i];
        aq[i] = s_q[k][ty + 16 * i];
        as[i] = __fadd_rn(ai[i], aq[i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bc[j] = s_c[k][tx + 16 * j];
        bs[j] = s_s[k][tx + 16 * j];
        bm[j] = s_m[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p1[i][j] = fmaf(ai[i], bc[j], p1[i][j]);
          p2[i][j] = fmaf(aq[i], bs[j], p2[i][j]);
          p3[i][j] = fmaf(as[i], bm[j], p3[i][j]);
        }
    }
    __syncthreads();
  }

  const float pow_scale = static_cast<float>(4.0 / (1024.0 * 1024.0));
  const float eps = static_cast<float>(1e-12);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= kFrames) continue;
    const int blk = t >> 1, ts = t & 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kb = n0 + tx + 16 * j;
      const float re = __fadd_rn(p1[i][j], p2[i][j]);
      const float im = __fadd_rn(__fsub_rn(p3[i][j], p1[i][j]), p2[i][j]);
      const float mag2 = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
      const float db =
          __fmul_rn(10.f, log10f(__fadd_rn(eps, __fmul_rn(mag2, pow_scale))));
      const float q =
          ft8::clampf(truncf(__fadd_rn(__fmul_rn(2.f, db), 240.f)), 0.f, 255.f);
      const int fs = kb & 1, pos = kb >> 1;
      const size_t row = ((static_cast<size_t>(b) * ft8::kBlocks + blk) * 2
                          + ts) * 2 + fs;
      out[row * ft8::kNumBin + pos] = static_cast<uint8_t>(q);
    }
  }
}

}  // namespace

// i, q: (batch, row_stride) f32 with row_stride >= 47872; bases (1024, 512)
// f32; out (batch, 92, 2, 2, 256) u8.
FT8_EXPORT int ft8_waterfall(const float* i, const float* q, const float* cosb,
                             const float* sinb, const float* cmsb, uint8_t* out,
                             int batch, int row_stride, void* stream) {
  if (batch <= 0 || batch > 65535 || row_stride < kUsed)
    return cudaErrorInvalidValue;
  dim3 grid((kFrames + BM - 1) / BM, kBins / BN, batch);
  waterfall_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      i, q, cosb, sinb, cmsb, out, row_stride);
  return static_cast<int>(cudaGetLastError());
}
