// LDPC(174, 91) sum-product belief propagation, at most `iters` iterations.
//
// Replaces the Pallas kernel rtlsdr_ft8d_tpu/ops/ldpc_pallas.py
// (bp_decode_pallas, body _bp_kernel). Same message schedule as the XLA
// formulation (rtlsdr_ft8d_tpu/ops/ldpc.py:226-264), per iteration:
//   post[n] = llr[n] + (tov[n,0] + tov[n,1]) + tov[n,2];  hard = post > 0
//   errors  = number of odd-parity checks (83 if hard is all zero); keep
//             the first iteration with the fewest errors (best-so-far)
//   toc[m,j] = fast_tanh(-0.5 (post[n] - tov[n,pos])) on the edge (m, j)
//             of variable n = NM[m,j]; 1 on padded slots
//   tov'[n,pos] = -2 fast_atanh(clip(prod_{j' != j} toc[m,j'], +-0.999999))
// with the exclusive products as prefix x suffix products, which stay
// right when a message is zero. The parity is evaluated at tov_0..tov_19;
// the optional posterior comes from the final tov.
//
// What bounds it: instruction throughput and the latency of a dependent
// chain (20 iterations of gather, rational tanh/atanh with IEEE divisions
// and row products) on a small state. One block of 96 threads decodes one
// codeword, one check per thread: thread m holds its check's 7 variable
// and message-slot indices and its 7 outgoing messages in registers,
// loaded once; shared memory holds only what crosses checks, the 522
// messages for the posterior sums and the 174 posteriors (2.8 KB). Each
// thread also owns 2 of the 174 variables and keeps their best-so-far hard
// bits in registers. The two barriers of an iteration carry its two
// reductions: __syncthreads_or gives "any hard bit set" and
// __syncthreads_count the parity count.
//
// Exactness: every operation is a round-to-nearest intrinsic in the plain
// PyTorch version's order (ops/ldpc.py:bp_decode_plain), so the two agree
// bit for bit. best_err only drops on a strict '<', so once it is 0 the
// hard bits and the error count are final: without a posterior output a
// codeword stops there (uniform across the block, as the count is). A zero
// numerator, which out-of-window symbols (LLR exactly 0) make common, takes
// the IEEE division's slow path; div_rn returns the numerator itself for
// it, the same signed zero the division gives, since every denominator
// here is positive.
#include "common.cuh"

namespace {

constexpr int kN = 174;            // variables
constexpr int kM = 83;             // checks
constexpr int kDeg = 7;            // padded check degree
constexpr int kSlots = kN * 3;     // check-to-variable messages
constexpr int kThreads = 96;       // one check per thread, 3 warps
static_assert(kThreads >= kM && 2 * kThreads >= kN, "thread ownership");

// num / den rounded to nearest, for den > 0
__device__ __forceinline__ float div_rn(float num, float den) {
  const bool zero = num == 0.f;
  const float q = __fdiv_rn(zero ? 1.f : num, den);
  return zero ? num : q;
}

__device__ __forceinline__ float fast_tanh(float x) {
  const float lim = static_cast<float>(4.97);
  x = ft8::clampf(x, -lim, lim);
  const float x2 = __fmul_rn(x, x);
  const float num =
      __fmul_rn(x, __fadd_rn(945.f, __fmul_rn(x2, __fadd_rn(105.f, x2))));
  const float den =
      __fadd_rn(945.f, __fmul_rn(x2, __fadd_rn(420.f, __fmul_rn(15.f, x2))));
  return div_rn(num, den);           // den >= 945
}

__device__ __forceinline__ float fast_atanh(float x) {
  const float x2 = __fmul_rn(x, x);
  const float num = __fmul_rn(
      x,
      __fadd_rn(945.f, __fmul_rn(x2, __fadd_rn(-735.f, __fmul_rn(x2, 64.f)))));
  const float den =
      __fadd_rn(945.f, __fmul_rn(x2, __fadd_rn(-1050.f, __fmul_rn(x2, 225.f))));
  return div_rn(num, den);           // den >= 120 for |x| <= 1
}

// llr + (tov[n,0] + tov[n,1]) + tov[n,2], the XLA formulation's order
__device__ __forceinline__ float posterior(float l, const float* tov, int v) {
  return __fadd_rn(
      l, __fadd_rn(__fadd_rn(tov[3 * v], tov[3 * v + 1]), tov[3 * v + 2]));
}

__global__ void __launch_bounds__(kThreads)
bp_kernel(const float* __restrict__ llr, const int* __restrict__ edge_var,
          const int* __restrict__ edge_slot, int iters,
          int8_t* __restrict__ hard_out, int* __restrict__ err_out,
          float* __restrict__ post_out) {
  __shared__ float s_tov[kSlots];
  __shared__ float s_post[kN];

  const int t = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * kN;
  const int v1 = t + kThreads;           // this thread's variables: t, v1
  const bool has_v1 = v1 < kN;
  const float l0 = llr[row + t];
  const float l1 = has_v1 ? llr[row + v1] : 0.f;

  const bool has_check = t < kM;         // this thread's check: t
  int var[kDeg], slot[kDeg];
  float msg[kDeg];
#pragma unroll
  for (int j = 0; j < kDeg; ++j) {
    var[j] = has_check ? __ldg(edge_var + t * kDeg + j) : -1;
    slot[j] = has_check ? __ldg(edge_slot + t * kDeg + j) : -1;
    msg[j] = 0.f;
  }
  for (int s = t; s < kSlots; s += kThreads) s_tov[s] = 0.f;
  const float clip = static_cast<float>(0.999999);
  bool best0 = false, best1 = false;
  int best_err = kM;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    const float p0 = posterior(l0, s_tov, t);
    const float p1 = has_v1 ? posterior(l1, s_tov, v1) : 0.f;
    s_post[t] = p0;
    if (has_v1) s_post[v1] = p1;
    const bool h0 = p0 > 0.f, h1 = p1 > 0.f;
    // every read of s_tov above precedes every write below
    const bool any_hard = __syncthreads_or(h0 || h1);

    int parity = 0;
    if (has_check) {
      float toc[kDeg];
#pragma unroll
      for (int j = 0; j < kDeg; ++j) {
        toc[j] = 1.f;
        if (var[j] >= 0) {
          const float p = s_post[var[j]];
          parity ^= p > 0.f;
          toc[j] = fast_tanh(__fmul_rn(-0.5f, __fsub_rn(p, msg[j])));
        }
      }
      float fwd[kDeg], bwd[kDeg];
      fwd[0] = bwd[0] = 1.f;
#pragma unroll
      for (int j = 0; j < kDeg - 1; ++j) {
        fwd[j + 1] = __fmul_rn(fwd[j], toc[j]);
        bwd[j + 1] = __fmul_rn(bwd[j], toc[kDeg - 1 - j]);
      }
#pragma unroll
      for (int j = 0; j < kDeg; ++j) {
        if (var[j] < 0) continue;
        const float x =
            ft8::clampf(__fmul_rn(fwd[j], bwd[kDeg - 1 - j]), -clip, clip);
        msg[j] = __fmul_rn(-2.f, fast_atanh(x));
        s_tov[slot[j]] = msg[j];
      }
    }
    // the messages are visible and every read of s_post is done
    int err = __syncthreads_count(parity);
    if (!any_hard) err = kM;
    if (err < best_err) {                  // block-uniform
      best_err = err;
      best0 = h0;
      best1 = h1;
    }
    if (best_err == 0 && post_out == nullptr) break;
  }

  hard_out[row + t] = static_cast<int8_t>(best0);
  if (has_v1) hard_out[row + v1] = static_cast<int8_t>(best1);
  if (post_out != nullptr) {
    post_out[row + t] = posterior(l0, s_tov, t);
    if (has_v1) post_out[row + v1] = posterior(l1, s_tov, v1);
  }
  if (t == 0) err_out[blockIdx.x] = best_err;
}

}  // namespace

// llr: (n, 174) f32; edge_var / edge_slot: (581,) i32 (-1 on padded slots);
// hard: (n, 174) i8; errors: (n,) i32; post: (n, 174) f32 or null.
FT8_EXPORT int ft8_bp_decode(const float* llr, const int* edge_var,
                             const int* edge_slot, int8_t* hard, int* errors,
                             float* post, int n, int iters, void* stream) {
  if (n <= 0 || iters < 0) return cudaErrorInvalidValue;
  bp_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      llr, edge_var, edge_slot, iters, hard, errors, post);
  return static_cast<int>(cudaGetLastError());
}
