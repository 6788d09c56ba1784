// Costas sync scores of a (B, 92, 2, 2, 256) uint8 waterfall, and the first
// stage of find_sync's two-stage top-K fused onto them.
//
// Replaces the Pallas kernel rtlsdr_ft8d_tpu/ops/sync_pallas.py
// (sync_scores_pallas, body _sync_kernel) and the chunk stage of
// rtlsdr_ft8d_tpu/ops/sync.py:find_sync (lines 163-176). The score of a
// cell is ft8_lib's neighbour-contrast sum over the 21 Costas symbols at
// block offsets 0/36/72, divided with C's truncating '/' by the
// data-independent term count (the sync_count table). This kernel runs the
// C loop itself (tests/reference_impl.py:sync_score_ref) in integer math,
// so it is bit-exact by construction.
//
// Outputs, each written only when its pointer is not null:
//   scores (B, 2, 2, 36, 249) i32   [time_sub][freq_sub][to + 12][fo]
//   v1, gidx (B, 9216) i32          each (ts, fs, to) row padded to 256
//       cells with kPadScore, cut into 16 chunks of 16; per chunk its top
//       4 in jax.lax.top_k's order (descending, lower index first among
//       equal scores): v1 the score, gidx the index in the padded
//       (2, 2, 36, 256) grid; chunk-major, rank within the chunk.
//
// What bounds it: its bytes bound is ~3 us at B = 64, but it runs at the
// rate it issues instructions, ~5 shared-memory byte loads and 8 integer
// adds per Costas symbol and cell. One block owns kRows time offsets of one
// (b, time_sub, freq_sub) plane and stages only the waterfall rows they
// touch, to-1 .. to+kRows+6 in each of the three Costas groups (9 KB),
// with 16-byte loads; the grid is B x 4 x 9 blocks. A thread owns one
// padded frequency cell of a row, so a chunk is a half-warp: each lane
// forms the unique key score * 16 + (15 - position) (|score| <= 255 * 84,
// so it cannot overflow) and ranks itself by 15 shuffles against the other
// lanes of its chunk; ranks 0-3 write their slot. The keys are unique, so
// the rank is the top-K position with top_k's tie rule, in one pass with
// no sort. Device memory sees the waterfall once and the survivors
// (4.7 MB at B = 64) instead of 9.2 MB of scores that a sort reads back.
#include "common.cuh"

namespace {

constexpr int kTimeOffsets = 36;
constexpr int kFreqOffsets = 249;
constexpr int kTimeOffsetMin = -12;
constexpr int kThreads = 256;          // one thread per padded cell
constexpr int kRows = 4;               // time offsets per block
constexpr int kRowBlocks = kTimeOffsets / kRows;
constexpr int kSpan = kRows + 8;       // staged rows per Costas group
constexpr int kChunk = 16;
constexpr int kChunkK = 4;
constexpr int kPadScore = -(1 << 20);  // ops/sync.py _PAD_SCORE
constexpr int kSurvivorsPerRow = ft8::kNumBin / kChunk * kChunkK;  // 64
__constant__ int kCostas[7] = {3, 1, 4, 0, 6, 5, 2};

static_assert(kTimeOffsets % kRows == 0, "blocks split the time offsets");

__global__ void __launch_bounds__(kThreads)
sync_kernel(const uint8_t* __restrict__ wf, const int* __restrict__ count,
            int* __restrict__ scores, int* __restrict__ v1,
            int* __restrict__ gidx) {
  __shared__ __align__(16) uint8_t rows[3 * kSpan][ft8::kNumBin];

  const int p = blockIdx.x / kRowBlocks;  // b * 4 + time_sub * 2 + freq_sub
  const int ti0 = (blockIdx.x % kRowBlocks) * kRows;
  const int to0 = ti0 + kTimeOffsetMin;
  const uint8_t* src =
      wf + static_cast<size_t>(p >> 2) * ft8::kBlocks * ft8::kPlane
      + (p & 3) * ft8::kNumBin;
  // staged row m * kSpan + i holds waterfall block to0 + 36 m - 1 + i;
  // rows outside the window stay unwritten and are never read
  constexpr int kVecs = ft8::kNumBin / 16;
  for (int idx = threadIdx.x; idx < 3 * kSpan * kVecs; idx += kThreads) {
    const int r = idx / kVecs, q = idx % kVecs;
    const int blk = to0 + 36 * (r / kSpan) - 1 + r % kSpan;
    if (blk >= 0 && blk < ft8::kBlocks)
      reinterpret_cast<uint4*>(rows[r])[q] =
          reinterpret_cast<const uint4*>(src + blk * ft8::kPlane)[q];
  }
  __syncthreads();

  const int fo = threadIdx.x;
  for (int r = 0; r < kRows; ++r) {
    const int ti = ti0 + r;
    const int to = ti + kTimeOffsetMin;
    int score = kPadScore;
    if (fo < kFreqOffsets) {
      score = 0;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          const int blk = to + 36 * m + k;
          if (blk < 0) continue;
          if (blk >= ft8::kBlocks) break;
          const uint8_t* row = rows[m * kSpan + r + k + 1];
          const int sm = kCostas[k];
          const int f = fo + sm;
          const int v = row[f];
          if (sm > 0) score += v - row[f - 1];
          if (sm < 7) score += v - row[f + 1];
          if (k > 0 && blk > 0) score += v - row[f - ft8::kNumBin];
          if (k < 6 && blk + 1 < ft8::kBlocks)
            score += v - row[f + ft8::kNumBin];
        }
      }
      score /= __ldg(count + ti);       // C division truncates toward zero
      if (scores != nullptr)
        scores[(static_cast<size_t>(p) * kTimeOffsets + ti) * kFreqOffsets
               + fo] = score;
    }
    if (v1 != nullptr) {
      const int pos = fo % kChunk;
      const int key = score * kChunk + (kChunk - 1 - pos);
      int rank = 0;
#pragma unroll
      for (int j = 1; j < kChunk; ++j)
        rank += __shfl_xor_sync(0xffffffffu, key, j) > key;
      if (rank < kChunkK) {
        const size_t row_id = static_cast<size_t>(p) * kTimeOffsets + ti;
        const size_t o = row_id * kSurvivorsPerRow + fo / kChunk * kChunkK
                         + rank;
        v1[o] = score;
        gidx[o] = ((p & 3) * kTimeOffsets + ti) * ft8::kNumBin + fo;
      }
    }
  }
}

}  // namespace

// wf: (batch, 92, 2, 2, 256) u8, 16-byte aligned; count: (36,) i32;
// scores: (batch, 2, 2, 36, 249) i32 or null; v1, gidx: (batch, 9216) i32,
// both or neither. At least one output.
FT8_EXPORT int ft8_sync(const uint8_t* wf, const int* count, int* scores,
                        int* v1, int* gidx, int batch, void* stream) {
  if (batch <= 0 || (v1 == nullptr) != (gidx == nullptr)
      || (scores == nullptr && v1 == nullptr)
      || reinterpret_cast<uintptr_t>(wf) % 16 != 0)
    return cudaErrorInvalidValue;
  sync_kernel<<<4 * kRowBlocks * batch, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(wf, count, scores, v1,
                                                      gidx);
  return static_cast<int>(cudaGetLastError());
}
