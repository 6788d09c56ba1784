// Signal subtraction between decode passes: the refinement of every decoded
// (channel, message) pair, then the residual, in two launches.
//
// Replaces no Pallas kernel: the JAX package's subtract_signals
// (rtlsdr_ft8d_tpu/ops/subtract.py) is plain jnp, and the port ran it as
// plain PyTorch over padded (B, 16, 79, 512) tensors, about 31 gathers and
// reductions of 41 M elements a call. This computes ops/subtract.py's
// refine_pairs and reconstruct (whose docstrings give the algorithm) on the
// flat list of P pairs, in (channel, message) order with the channels
// ascending.
//
// Launch 1 (refine), one block a pair, nothing but the results leaving the
// block: the start variants -1, 0, +1 (the most energy wins), the coherence
// search over the shifts -128..128 step 16, then -8..8 step 2 around the
// winner, the frequency error from the phase slope of consecutive
// per-symbol gains, the gains at f + f_err and one global complex gain. It
// writes the chosen start and shift, f_err, the gain and the 79 per-symbol
// start phases at f + f_err.
// Launch 2 (residual), one thread a (channel, sample): x minus the sum of
// the reconstructions of that channel's pairs, in pair order, written once
// into a new pair of arrays. No atomics, no scratch; deterministic.
//
// What bounds it: operations. A pair evaluates 31 variants (3 + 17 + 9 and
// the two gain passes) x 79 symbols x 512 samples, each 8 FP32 operations
// (two complex products summed): ~10 MFLOP a pair, ~3 GFLOP at the ~300
// pairs of a deep window, ~50 us at 67 TFLOP/s; the bytes, the (B, 48000)
// windows read once and the residual written once (2 x 24.6 MB at B = 64),
// take ~15 us at 3.35 TB/s. The design follows:
// - The angles depend only on the frequency, not on the start or the shift,
//   so each stage computes a sample's cos/sin once and applies it to every
//   variant of the stage, in registers. The gains at the aligned windows at
//   f are the fine search's winner's, read back from shared memory: 4
//   rounds of sincos a pair in launch 1, 1 in launch 2, not 31.
// - A warp owns a symbol at a time, a lane 16 of its samples; a lane keeps
//   one complex sum per variant, the warp reduces them with shuffles and
//   lane 0 stores the (variant, symbol) gain in shared memory (at most
//   17 x 79 complex). The windows are read through the read-only cache:
//   64 channels are 24.6 MB, in L2.
// - The selections (energies, coherences, argmax keeping the first
//   maximum, atan2, the global gain) are short sequential sums over the 79
//   symbols, one thread a variant.
//
// Arithmetic is the plain version's as PyTorch runs it on the card, in
// float32 and without fast math: angles are phase0 + ((2 pi / fs) f) n with
// phase0 the exclusive sum of the per-symbol increments, summed in the order
// of torch.cumsum's CUDA scan over rows of 79 (a Sklansky scan in chunks of
// 32, the carry added to a chunk's first element: the configuration
// PyTorch picks for more than 64 rows, which the padded (B, 16, 79) layout
// of the JAX package's function has from 5 channels on); the frequency
// error is atan2 times the reciprocal of 2 pi T_sym, as PyTorch divides a
// CUDA tensor by a scalar; __fmul_rn / __fadd_rn keep nvcc from contracting
// the angle, the gain terms and the reconstruction into FMAs; sincosf is
// the accurate one (arguments past ~1e5 rad take its slow path). The
// phases matter most: a float32 phase near 1e5 rad is off by up to ~0.01
// rad in any order, and the residual of a strong signal moves by that much
// of its amplitude. The sums over samples and symbols run in another order
// than PyTorch's, so near-ties of two variants may resolve the other way.
// Out-of-window samples add nothing, as the plain version's clamped index
// with weight 0; a symbol with no sample in the window drops out of the
// coherence sums and the gain mean.
#include "common.cuh"

namespace {

constexpr int kNN = 79;                 // symbols
constexpr int kBlock = 512;             // samples a symbol
constexpr int kHalf = kBlock / 2;       // a half symbol
constexpr int kWindow = 48000;          // samples a window
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerLane = kBlock / 32;
constexpr int kCoarse = 17;             // shifts -128..128 step 16
constexpr int kFine = 9;                // shifts -8..8 step 2
constexpr int kResidualThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

constexpr double kPi = 3.141592653589793;
// Python's double constants, narrowed to float as PyTorch narrows a scalar
constexpr float kStep = static_cast<float>(2.0 * kPi / 3200.0);
constexpr float kSymbolStep = static_cast<float>(2.0 * kPi * 512 / 3200.0);
constexpr float kInvTwoPiSymbolS =
    1.0f / static_cast<float>(2.0 * kPi * (512.0 / 3200.0));
constexpr int kScanChunk = 32;          // torch.cumsum's chunk on the card

struct Shared {
  float g[kCoarse][kNN][2];     // per-(variant, symbol) complex gains
  float slope[kNN];             // (2 pi / fs) f, a symbol's phase a sample
  float phase0[kNN];            // the symbols' start phases
  float f[kNN];                 // the symbols' frequencies, Hz
  float score[kCoarse];
  float scan[kScanChunk];
  int pick;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ bool symbol_in_window(int first) {
  return first < kWindow && first + kBlock > 0;
}

// The per-symbol phase steps and start phases at sh.f (all threads enter;
// thread 0 runs the scan). The inclusive sums are torch.cumsum's on the
// card: chunks of 32 symbols, the sum so far added to a chunk's first
// increment, then the 5 levels of the Sklansky tree of 16 threads (at
// level m thread x adds element a - 1 into element a + x mod 2^m, a =
// (x / 2^m) 2^(m+1) + 2^m); each level's targets are disjoint from its
// sources, so one thread running them in turn gives the same sums.
__device__ void set_phases(Shared& sh) {
  for (int k = threadIdx.x; k < kNN; k += kThreads)
    sh.slope[k] = __fmul_rn(kStep, sh.f[k]);
  if (threadIdx.x == 0) {
    float carry = 0.f;
    for (int c0 = 0; c0 < kNN; c0 += kScanChunk) {
      for (int i = 0; i < kScanChunk; ++i)
        sh.scan[i] = c0 + i < kNN ? __fmul_rn(kSymbolStep, sh.f[c0 + i]) : 0.f;
      sh.scan[0] = __fadd_rn(sh.scan[0], carry);
      for (int m = 0; (1 << m) < kScanChunk; ++m) {
        for (int x = 0; x < kScanChunk / 2; ++x) {
          const int a = ((x >> m) << (m + 1)) | (1 << m);
          const int ti = a + (x & ((1 << m) - 1));
          sh.scan[ti] = __fadd_rn(sh.scan[ti], sh.scan[a - 1]);
        }
      }
      for (int i = 0; i < kScanChunk && c0 + i < kNN; ++i)
        sh.phase0[c0 + i] = __fsub_rn(
            sh.scan[i], __fmul_rn(kSymbolStep, sh.f[c0 + i]));
      carry = sh.scan[kScanChunk - 1];
    }
  }
  __syncthreads();
}

// sh.g[v][k] for the V windows starting at first + step * v (symbol 0's
// first sample), at the phases in sh.
template <int V>
__device__ void gains(const float* __restrict__ xi,
                      const float* __restrict__ xq, int first, int step,
                      Shared& sh) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int k = warp; k < kNN; k += kWarps) {
    float ar[V], ai[V];
#pragma unroll
    for (int v = 0; v < V; ++v) ar[v] = ai[v] = 0.f;
    const float p0 = sh.phase0[k], sl = sh.slope[k];
    const int base = first + k * kBlock + lane;
    for (int j = 0; j < kPerLane; ++j) {
      const int n = lane + 32 * j;
      float s, c;
      sincosf(__fadd_rn(p0, __fmul_rn(sl, static_cast<float>(n))), &s, &c);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int idx = base + step * v + 32 * j;
        if (static_cast<unsigned>(idx) < static_cast<unsigned>(kWindow)) {
          const float a = __ldg(xi + idx), b = __ldg(xq + idx);
          ar[v] = __fadd_rn(ar[v], __fadd_rn(__fmul_rn(a, c), __fmul_rn(b, s)));
          ai[v] = __fadd_rn(ai[v], __fsub_rn(__fmul_rn(b, c), __fmul_rn(a, s)));
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float r = warp_sum(ar[v]), i = warp_sum(ai[v]);
      if (lane == 0) {
        sh.g[v][k][0] = r / kBlock;
        sh.g[v][k][1] = i / kBlock;
      }
    }
  }
  __syncthreads();
}

// Index of the first maximum of sh.score[0..V) into sh.pick.
__device__ void pick_first_max(Shared& sh, int V) {
  if (threadIdx.x == 0) {
    int best = 0;
    for (int v = 1; v < V; ++v)
      if (sh.score[v] > sh.score[best]) best = v;
    sh.pick = best;
  }
  __syncthreads();
}

// The consecutive-symbol coherence |sum g_n conj(g_{n-1})|^2 of each of the
// V windows first + step * v, over the symbols in the window; then the
// first maximum.
__device__ void coherence(Shared& sh, int V, int first, int step) {
  const int v = threadIdx.x;
  if (v < V) {
    const int w = first + step * v;
    float cr = 0.f, ci = 0.f;
    bool prev = symbol_in_window(w);
    for (int k = 1; k < kNN; ++k) {
      const bool cur = symbol_in_window(w + k * kBlock);
      const float r1 = sh.g[v][k][0], i1 = sh.g[v][k][1];
      const float r0 = sh.g[v][k - 1][0], i0 = sh.g[v][k - 1][1];
      const float svv = (cur && prev) ? 1.f : 0.f;
      const float pr = __fadd_rn(__fmul_rn(r1, r0), __fmul_rn(i1, i0));
      const float pi = __fsub_rn(__fmul_rn(i1, r0), __fmul_rn(r1, i0));
      cr = __fadd_rn(cr, __fmul_rn(pr, svv));
      ci = __fadd_rn(ci, __fmul_rn(pi, svv));
      prev = cur;
    }
    sh.score[v] = __fadd_rn(__fmul_rn(cr, cr), __fmul_rn(ci, ci));
  }
  __syncthreads();
  pick_first_max(sh, V);
}

__global__ void __launch_bounds__(kThreads)
refine_kernel(const float* __restrict__ x_i, const float* __restrict__ x_q,
              const int* __restrict__ chan, const int* __restrict__ tones,
              const int* __restrict__ fb2, const int* __restrict__ start2,
              int n_rows, int* __restrict__ choice, float* __restrict__ fit,
              float* __restrict__ phase0) {
  __shared__ Shared sh;
  const int p = blockIdx.x;
  const int row = chan[p];
  if (row < 0 || row >= n_rows) {           // not a channel of the batch
    if (threadIdx.x == 0) {
      choice[2 * p] = choice[2 * p + 1] = 0;
      fit[3 * p] = fit[3 * p + 1] = fit[3 * p + 2] = __int_as_float(0x7fc00000);
    }
    for (int k = threadIdx.x; k < kNN; k += kThreads)
      phase0[p * kNN + k] = __int_as_float(0x7fc00000);
    return;
  }
  const float* xi = x_i + static_cast<size_t>(row) * kWindow;
  const float* xq = x_q + static_cast<size_t>(row) * kWindow;
  const float base_hz = __fmul_rn(static_cast<float>(fb2[p]), 0.5f);
  for (int k = threadIdx.x; k < kNN; k += kThreads)
    sh.f[k] = __fmul_rn(__fadd_rn(base_hz, static_cast<float>(
                                      tones[p * kNN + k])), 6.25f);
  __syncthreads();
  set_phases(sh);

  // 1. timing: the start variant -1, 0, +1 with the most energy
  const int s0 = start2[p];
  gains<3>(xi, xq, (s0 - 1) * kHalf, kHalf, sh);
  if (threadIdx.x < 3) {
    float e = 0.f;
    for (int k = 0; k < kNN; ++k) {
      const float r = sh.g[threadIdx.x][k][0], i = sh.g[threadIdx.x][k][1];
      e = __fadd_rn(e, __fadd_rn(__fmul_rn(r, r), __fmul_rn(i, i)));
    }
    sh.score[threadIdx.x] = e;
  }
  __syncthreads();
  pick_first_max(sh, 3);
  const int start = s0 + sh.pick - 1;
  const int origin = start * kHalf;

  // 2. fractional delay: the coarse then the fine coherence search
  gains<kCoarse>(xi, xq, origin - 128, 16, sh);
  coherence(sh, kCoarse, origin - 128, 16);
  int shift = -128 + 16 * sh.pick;
  __syncthreads();
  gains<kFine>(xi, xq, origin + shift - 8, 2, sh);
  coherence(sh, kFine, origin + shift - 8, 2);
  const int won = sh.pick;
  shift += -8 + 2 * won;
  const int first = origin + shift;

  // 3. frequency from the phase slope of the winner's gains (those of the
  // aligned windows at f)
  if (threadIdx.x == 0) {
    float dr = 0.f, di = 0.f;
    for (int k = 1; k < kNN; ++k) {
      const float r1 = sh.g[won][k][0], i1 = sh.g[won][k][1];
      const float r0 = sh.g[won][k - 1][0], i0 = sh.g[won][k - 1][1];
      dr = __fadd_rn(dr, __fadd_rn(__fmul_rn(r1, r0), __fmul_rn(i1, i0)));
      di = __fadd_rn(di, __fsub_rn(__fmul_rn(i1, r0), __fmul_rn(r1, i0)));
    }
    sh.score[0] = __fmul_rn(atan2f(di, dr), kInvTwoPiSymbolS);
  }
  __syncthreads();
  const float f_err = sh.score[0];
  __syncthreads();
  for (int k = threadIdx.x; k < kNN; k += kThreads)
    sh.f[k] = __fadd_rn(sh.f[k], f_err);
  __syncthreads();
  set_phases(sh);
  gains<1>(xi, xq, first, 0, sh);

  // 4. one global complex gain over the symbols in the window
  if (threadIdx.x == 0) {
    float gr = 0.f, gi = 0.f, n = 0.f;
    for (int k = 0; k < kNN; ++k) {
      if (symbol_in_window(first + k * kBlock)) {
        gr = __fadd_rn(gr, sh.g[0][k][0]);
        gi = __fadd_rn(gi, sh.g[0][k][1]);
        n = __fadd_rn(n, 1.f);
      }
    }
    n = fmaxf(n, 1.f);
    choice[2 * p] = start;
    choice[2 * p + 1] = shift;
    fit[3 * p] = f_err;
    fit[3 * p + 1] = gr / n;
    fit[3 * p + 2] = gi / n;
  }
  for (int k = threadIdx.x; k < kNN; k += kThreads)
    phase0[p * kNN + k] = sh.phase0[k];
}

// The first index of the ascending chan[0..n) whose value is >= v.
__device__ __forceinline__ int lower_bound(const int* __restrict__ chan,
                                           int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (chan[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kResidualThreads)
residual_kernel(const float* __restrict__ x_i, const float* __restrict__ x_q,
                const int* __restrict__ chan, const int* __restrict__ tones,
                const int* __restrict__ fb2, const int* __restrict__ choice,
                const float* __restrict__ fit,
                const float* __restrict__ phase0, int n_pairs,
                float* __restrict__ out_i, float* __restrict__ out_q) {
  const int row = blockIdx.y;
  const int t = blockIdx.x * kResidualThreads + threadIdx.x;
  if (t >= kWindow) return;
  const int lo = lower_bound(chan, n_pairs, row);
  const int hi = lower_bound(chan, n_pairs, row + 1);
  float acc_i = 0.f, acc_q = 0.f;
  for (int p = lo; p < hi; ++p) {
    const int d = t - (choice[2 * p] * kHalf + choice[2 * p + 1]);
    if (d < 0 || d >= kNN * kBlock) continue;
    const int k = d / kBlock, n = d % kBlock;
    const float f = __fadd_rn(
        __fmul_rn(__fadd_rn(__fmul_rn(static_cast<float>(fb2[p]), 0.5f),
                            static_cast<float>(tones[p * kNN + k])), 6.25f),
        fit[3 * p]);
    const float ang = __fadd_rn(phase0[p * kNN + k],
                                __fmul_rn(__fmul_rn(kStep, f),
                                          static_cast<float>(n)));
    float s, c;
    sincosf(ang, &s, &c);
    const float gr = fit[3 * p + 1], gi = fit[3 * p + 2];
    acc_i = __fadd_rn(acc_i, __fsub_rn(__fmul_rn(gr, c), __fmul_rn(gi, s)));
    acc_q = __fadd_rn(acc_q, __fadd_rn(__fmul_rn(gr, s), __fmul_rn(gi, c)));
  }
  const size_t at = static_cast<size_t>(row) * kWindow + t;
  out_i[at] = __fsub_rn(x_i[at], acc_i);
  out_q[at] = __fsub_rn(x_q[at], acc_q);
}

}  // namespace

// stage 0: refine (x, chan, tones, fb2, start2 -> choice, fit, phase0);
// stage 1: residual (x, chan, tones, fb2, choice, fit, phase0 -> out).
// Arrays not read or written by the stage may be null.
FT8_EXPORT int ft8_subtract(int stage, const float* x_i, const float* x_q,
                            const int* chan, const int* tones, const int* fb2,
                            const int* start2, int* choice, float* fit,
                            float* phase0, float* out_i, float* out_q,
                            int n_pairs, int n_rows, void* stream) {
  if (n_pairs <= 0 || n_rows <= 0 || n_rows > 65535)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (stage == 0) {
    refine_kernel<<<n_pairs, kThreads, 0, s>>>(
        x_i, x_q, chan, tones, fb2, start2, n_rows, choice, fit, phase0);
  } else if (stage == 1) {
    dim3 grid((kWindow + kResidualThreads - 1) / kResidualThreads, n_rows);
    residual_kernel<<<grid, kResidualThreads, 0, s>>>(
        x_i, x_q, chan, tones, fb2, choice, fit, phase0, n_pairs, out_i,
        out_q);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
