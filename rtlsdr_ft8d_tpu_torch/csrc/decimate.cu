// int8 ingest decimator: (rows, 5250 + 750 M) int8 I and Q at 2.4 Msps ->
// (rows, M) float32 I and Q at 3,200 sps, scaled by 1/128.
//
// Replaces the Pallas kernel rtlsdr_ft8d_tpu/ops/decimate_pallas.py
// (decimate_int8, body _make_kernel). Output m is the 6000-tap polyphase
// filter over frames m .. m+7 of 750 samples:
//
//   y[f, r] = sum_p x[f * 750 + p] * bank[p, r]      (8 phase dot products)
//   out[m]  = (sum_r y[m + r, r]) * (1/128)
//
// What bounds it: per band-window (M = 48,000, n = 36,005,250 per
// component) the function reads 72 MB of int8: 21.6 us at 3.35 TB/s. The
// previous version (one block per 128 outputs) took ~0.1 ms on an H100:
// byte loads from HBM (32 bytes per warp load), an I2F conversion per
// sample (16 per clock per SM), 8 FP32 FMAs per sample, the 24 KB bank
// reloaded by each of 750 blocks and 7 frames of halo per block. This
// design takes each of those off the path:
//
// - Persistent blocks, a carried halo. The grid is what fits on the card
//   at once (2 blocks per SM). A block owns a contiguous range of outputs
//   of one (row, component), starting at a multiple of 8 outputs, and
//   walks it in tiles of 64 frames (48,000 bytes). y of the frames it has
//   computed stays in a 128-frame ring in shared memory, so a tile's
//   outputs take the previous tile's last 7 frames from there: the halo
//   is read once per block, not once per tile.
// - TMA staging. One thread copies each tile's span into a 2-stage ring
//   in shared memory with one 1-D bulk copy (cp.async.bulk, completing on
//   an mbarrier), a tile ahead of the one in use. Frame starts are only
//   2-byte aligned, but tile starts are multiples of 8 frames (6,000 =
//   375 x 16 bytes), so a row at a 16-byte-aligned stride gives aligned
//   copies; the wrapper (ops/decimate.py) keeps rows so, readable to the
//   next multiple of 16 past their end, and copies any other input into
//   that layout first.
// - Exact conversion without I2F. Two int8 samples become a float16 pair
//   by one byte permute: 0x64XX is the float16 1024 + XX, and with
//   XX = b ^ 0x80 = b + 128 one HSUB2 of 1152 leaves b exactly.
// - The product on the tensor cores: mma.sync m16n8k16, float16 in,
//   float32 accumulate. A is 16 frames x 16 samples straight from the
//   stage (int8 is exact in float16), n = 8 is the 8 phases, and K = 750
//   is padded to 752 with two zero bank rows (the two samples past a frame
//   are the next frame's, times 0). B is the bank split in two float16
//   parts, hi + lo = 2^s bank to ~22 bits (tables.polyphase_bank_split):
//   two MMAs per A fragment, products exact in float32, 2^-s back in the
//   epilogue. The 8 warps split K (6 steps of 16 each), so each warp holds
//   its B fragments in 24 registers for the whole kernel; their 64 x 8
//   partial sums meet in warp order in the stage just consumed. wgmma
//   would buy nothing: its tiles are 64 rows by n >= 8 from a shared
//   layout that 750-byte frames cannot give, and the tensor-core work is
//   ~2.3 GFLOP per band-window, a few microseconds at mma.sync's rate.
// - The epilogue sums each output's diagonal of 8 ring entries, scales by
//   2^-(s+7) (exact) and stores coalesced.
//
// Known cost: an A fragment load reads 2 bytes at a frame stride of 750
// bytes (110 mod 128), so fragment rows 0 and 7 meet in one bank: a 2-way
// conflict on every A load. The streaming history (the last 5,250
// samples of [history, chunk]) is kept by the caller, before any padding.
#include <cuda_fp16.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kR = 750;                          // decimation factor, frame
constexpr int kPhases = 8;
constexpr int kHistory = (kPhases - 1) * kR;     // 5250
constexpr int kTile = 64;                        // frames per tile
constexpr int kTileBytes = kTile * kR;           // 48,000
constexpr int kStageBytes = kTileBytes + 128;    // + the padded K's overread
constexpr int kStages = 2;
constexpr int kKSteps = 47;                      // K = 752 = 47 x 16
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStepsPerWarp = (kKSteps + kWarps - 1) / kWarps;   // 6
constexpr int kGroups = kTile / 16;              // MMA row groups of a tile
constexpr int kAcc = kGroups * 4;                // accumulators per lane
constexpr int kRing = 128;                       // frames of y kept
constexpr int kYStride = kPhases + 1;            // diagonal reads, no conflicts
constexpr int kAlign = 8;                        // range starts, in outputs
constexpr int kMinChunk = kTile - kPhases;       // 56: one tile's outputs
static_assert(kTileBytes % 16 == 0 && kAlign * kR % 16 == 0,
              "bulk copies move multiples of 16 bytes from 16-byte starts");
static_assert(kWarps * kAcc * 32 * 4 <= kTileBytes,
              "the warps' partial sums fit in a stage");
static_assert(kRing >= 2 * kTile && (kRing & (kRing - 1)) == 0,
              "a tile's writes never meet the previous tile's reads");

struct Smem {
  unsigned char stage[kStages][kStageBytes];     // 16-byte aligned copies
  float y[kRing * kYStride];                     // y[frame % kRing][phase]
  unsigned long long full[kStages];              // mbarriers
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two int8 samples (the low 16 bits of v, lower address in the low byte)
// -> a float16 pair, exactly.
__device__ __forceinline__ uint32_t i8x2_to_f16x2(uint32_t v) {
  uint32_t biased = __byte_perm(v ^ 0x8080u, 0x64646464u, 0x4140);
  __half2 h = *reinterpret_cast<__half2*>(&biased);
  h = __hsub2(h, __half2half2(__ushort_as_half(0x6480)));    // 1152
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld_u16(const unsigned char* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// c += a (16 x 16, row) * b (16 x 8, col), float16 in, float32 accumulate.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// bank: (47, 32) uint4, the B fragments of K step ks for lane l at
// [ks * 32 + l]: hi's two registers, then lo's.
__global__ void __launch_bounds__(kThreads, 2)
decimate_kernel(const int8_t* __restrict__ i8, const int8_t* __restrict__ q8,
                long long stride, const uint4* __restrict__ bank,
                float* __restrict__ out_i, float* __restrict__ out_q, int m,
                int chunk, int chunks, float scale) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int unit = blockIdx.x / chunks;          // row * 2 + component
  const int m0 = (blockIdx.x % chunks) * chunk;  // this block's outputs
  const int m1 = min(m, m0 + chunk);
  const int row = unit >> 1;
  const int8_t* x = ((unit & 1) ? q8 : i8) + row * stride;
  float* out = ((unit & 1) ? out_q : out_i) + static_cast<size_t>(row) * m;
  const long long n = kHistory + static_cast<long long>(kR) * m;
  const int tiles = (m1 - m0 + kPhases - 1 + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // tile t's frames into stage t % kStages; the last tile's copy stops at
  // the row's end rounded up to 16 bytes, which the wrapper keeps readable
  auto stage_tile = [&](int t) {
    const long long start = static_cast<long long>(m0 + t * kTile) * kR;
    const long long rest = (n - start + 15) & ~15LL;
    const int s = t % kStages;
    bulk_load(smem_addr(sm.stage[s]), x + start,
              static_cast<uint32_t>(rest < kTileBytes ? rest : kTileBytes),
              smem_addr(&sm.full[s]));
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&sm.full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < kStages && t < tiles; ++t) stage_tile(t);
  }
  // this warp's K steps warp * 6 .. warp * 6 + 5 (warp 7 has 5)
  uint4 b[kStepsPerWarp];
#pragma unroll
  for (int j = 0; j < kStepsPerWarp; ++j) {
    const int ks = warp * kStepsPerWarp + j;
    b[j] = ks < kKSteps ? bank[ks * 32 + lane] : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  const int g = lane / 4, t4 = lane % 4;
  for (int t = 0; t < tiles; ++t) {
    const int s = t % kStages;
    const int f0 = m0 + t * kTile;               // the tile's first frame
    wait_parity(smem_addr(&sm.full[s]), (t / kStages) & 1);

    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kStepsPerWarp; ++j) {
      const int ks = warp * kStepsPerWarp + j;
      if (ks < kKSteps) {
        // A rows g and g + 8 of each group, samples 2t, 2t+1 and +8, +9
        const unsigned char* col = sm.stage[s] + g * kR + ks * 16 + 2 * t4;
#pragma unroll
        for (int q = 0; q < kGroups; ++q) {
          const unsigned char* r0 = col + q * 16 * kR;
          const unsigned char* r8 = r0 + 8 * kR;
          const uint32_t a[4] = {
              i8x2_to_f16x2(ld_u16(r0)), i8x2_to_f16x2(ld_u16(r8)),
              i8x2_to_f16x2(ld_u16(r0 + 8)), i8x2_to_f16x2(ld_u16(r8 + 8))};
          mma16816(acc + 4 * q, a, b[j].x, b[j].y);    // hi
          mma16816(acc + 4 * q, a, b[j].z, b[j].w);    // lo
        }
      }
    }
    __syncthreads();                 // every warp is done reading stage s
    float* red = reinterpret_cast<float*>(sm.stage[s]);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) red[(warp * kAcc + i) * 32 + lane] = acc[i];
    __syncthreads();
    // accumulator i of lane l is y[frame 16 (i / 4) + l / 4 + 8 (i / 2 % 2),
    // phase 2 (l % 4) + i % 2]: the warps' partials summed in warp order
    for (int e = tid; e < kAcc * 32; e += kThreads) {
      const int i = e / 32, l = e % 32;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += red[(w * kAcc + i) * 32 + l];
      const int f = f0 + (i / 4) * 16 + l / 4 + ((i & 2) ? 8 : 0);
      sm.y[(f % kRing) * kYStride + 2 * (l % 4) + (i & 1)] = v;
    }
    __syncthreads();
    if (tid == 0 && t + kStages < tiles) {
      // the stage's last generic accesses before the async proxy's write
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage_tile(t + kStages);
    }
    // the outputs whose last frame is in this tile: f0 - 7 .. f0 + 56
    if (tid < kTile) {
      const int mo = f0 - (kPhases - 1) + tid;
      if (mo >= m0 && mo < m1) {
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < kPhases; ++r)
          v += sm.y[((mo + r) % kRing) * kYStride + r];
        out[mo] = v * scale;
      }
    }
  }
}

// Resident blocks on the current device (SMs x blocks per SM), once per
// device; sets the kernel's dynamic shared memory size on the way.
int grid_slots(int* slots) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && cached[dev] > 0) {
    *slots = cached[dev];
    return 0;
  }
  const int smem = static_cast<int>(sizeof(Smem));
  err = cudaFuncSetAttribute(decimate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  int sms = 0, per_sm = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, decimate_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  if (dev < 64) cached[dev] = *slots;
  return 0;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// i8, q8: rows of n = 5250 + 750 M int8 samples (M >= 1) at `stride`
// bytes, a multiple of 16 >= n, 16-byte aligned, each row readable to its
// end rounded up to 16 bytes; bank: (47, 32, 4) int32 B fragments of the
// split bank (ops/decimate.bank_fragments), 16-byte aligned; shift: its s;
// out_i, out_q: (rows, M) f32.
FT8_EXPORT int ft8_decimate_int8(const int8_t* i8, const int8_t* q8,
                                 const void* bank, float* out_i,
                                 float* out_q, int rows, int n, int stride,
                                 int shift, void* stream) {
  if (rows <= 0 || n < kHistory + kR || (n - kHistory) % kR != 0
      || stride < n || stride % 16 != 0)
    return cudaErrorInvalidValue;
  if (!aligned16(i8) || !aligned16(q8) || !aligned16(bank))
    return cudaErrorMisalignedAddress;
  int slots = 0;
  const int err = grid_slots(&slots);
  if (err != 0) return err;
  const int m = (n - kHistory) / kR;
  // split each (row, component) so that the grid about fills the card
  const long long units = 2LL * rows;
  const long long per = (units * m + slots - 1) / slots;
  long long chunk = (per + kAlign - 1) / kAlign * kAlign;
  if (chunk < kMinChunk) chunk = kMinChunk;
  const long long chunks = (m + chunk - 1) / chunk;
  if (units * chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  decimate_kernel<<<static_cast<unsigned>(units * chunks), kThreads,
                    sizeof(Smem), static_cast<cudaStream_t>(stream)>>>(
      i8, q8, stride, static_cast<const uint4*>(bank), out_i, out_q, m,
      static_cast<int>(chunk), static_cast<int>(chunks),
      std::ldexp(1.0f, -(shift + 7)));
  return static_cast<int>(cudaGetLastError());
}

// info[0..4]: registers per thread, static and dynamic shared bytes per
// block, resident blocks per SM, local (spill) bytes per thread.
FT8_EXPORT int ft8_decimate_info(int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, decimate_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int slots = 0, sms = 0, dev = 0;
  int rc = grid_slots(&slots);
  if (rc != 0) return rc;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes);
  info[2] = static_cast<int>(sizeof(Smem));
  info[3] = slots / sms;
  info[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
