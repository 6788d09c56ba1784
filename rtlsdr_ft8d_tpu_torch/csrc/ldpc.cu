// LDPC(174, 91) sum-product belief propagation, fixed iteration count.
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
// What bounds it: latency of a long dependent chain (20 iterations of
// gather, rational tanh/atanh with IEEE divisions, and row products) on a
// small state. One warp decodes one codeword with its whole state on chip:
// the 522 check-to-variable messages, the posterior and the hard and best
// bits in shared memory (3.1 KB per warp), its 6 LLRs per lane in
// registers. Lanes own variables for the posterior and checks for the
// parity and message update; a check reads and writes only its own
// message slots, so the update is in place. The Tanner graph is indexed
// directly from the edge tables (no selection GEMMs), staged once per
// block in shared memory. Device memory sees the LLRs in and the
// decisions out. All arithmetic uses round-to-nearest intrinsics in the
// plain PyTorch version's order, so the two agree bit for bit.
#include "common.cuh"

namespace {

constexpr int kN = 174;            // variables
constexpr int kM = 83;             // checks
constexpr int kEdges = kM * 7;     // padded (check, slot) edges
constexpr int kSlots = kN * 3;     // check-to-variable messages
constexpr int kWarps = 4;          // codewords per block

__device__ __forceinline__ float fast_tanh(float x) {
  const float lim = static_cast<float>(4.97);
  x = ft8::clampf(x, -lim, lim);
  const float x2 = __fmul_rn(x, x);
  const float num =
      __fmul_rn(x, __fadd_rn(945.f, __fmul_rn(x2, __fadd_rn(105.f, x2))));
  const float den =
      __fadd_rn(945.f, __fmul_rn(x2, __fadd_rn(420.f, __fmul_rn(15.f, x2))));
  return __fdiv_rn(num, den);
}

__device__ __forceinline__ float fast_atanh(float x) {
  const float x2 = __fmul_rn(x, x);
  const float num = __fmul_rn(
      x,
      __fadd_rn(945.f, __fmul_rn(x2, __fadd_rn(-735.f, __fmul_rn(x2, 64.f)))));
  const float den =
      __fadd_rn(945.f, __fmul_rn(x2, __fadd_rn(-1050.f, __fmul_rn(x2, 225.f))));
  return __fdiv_rn(num, den);
}

// llr + (tov[n,0] + tov[n,1]) + tov[n,2], the XLA formulation's order
__device__ __forceinline__ float posterior(float l, const float* tov, int v) {
  return __fadd_rn(
      l, __fadd_rn(__fadd_rn(tov[3 * v], tov[3 * v + 1]), tov[3 * v + 2]));
}

__global__ void __launch_bounds__(kWarps * 32)
bp_kernel(const float* __restrict__ llr, const int* __restrict__ edge_var,
          const int* __restrict__ edge_slot, int n, int iters,
          int8_t* __restrict__ hard_out, int* __restrict__ err_out,
          float* __restrict__ post_out) {
  __shared__ short s_var[kEdges], s_slot[kEdges];
  __shared__ float s_tov[kWarps][kSlots];
  __shared__ float s_post[kWarps][kN];
  __shared__ uint8_t s_hard[kWarps][kN], s_best[kWarps][kN];

  for (int e = threadIdx.x; e < kEdges; e += kWarps * 32) {
    s_var[e] = static_cast<short>(edge_var[e]);
    s_slot[e] = static_cast<short>(edge_slot[e]);
  }
  __syncthreads();

  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cw = blockIdx.x * kWarps + w;
  if (cw >= n) return;                   // no block-wide barrier follows
  float* tov = s_tov[w];
  float* post = s_post[w];
  uint8_t* hard = s_hard[w];
  uint8_t* best = s_best[w];
  const float clip = static_cast<float>(0.999999);

  float l[6];                            // variables lane + 32 i
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int v = lane + 32 * i;
    l[i] = v < kN ? llr[static_cast<size_t>(cw) * kN + v] : 0.f;
    if (v < kN) best[v] = 0;
  }
  for (int s = lane; s < kSlots; s += 32) tov[s] = 0.f;
  int best_err = kM;
  __syncwarp();

  for (int it = 0; it < iters; ++it) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const int v = lane + 32 * i;
      if (v < kN) {
        const float p = posterior(l[i], tov, v);
        post[v] = p;
        hard[v] = p > 0.f;
        any |= p > 0.f;
      }
    }
    __syncwarp();
    const bool any_hard = __any_sync(0xffffffffu, any);

    int err = 0;
    for (int m = lane; m < kM; m += 32) {
      float toc[7];
      int parity = 0;
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const int v = s_var[m * 7 + j];
        if (v >= 0) {
          parity ^= hard[v];
          const float d = __fsub_rn(post[v], tov[s_slot[m * 7 + j]]);
          toc[j] = fast_tanh(__fmul_rn(-0.5f, d));
        } else {
          toc[j] = 1.f;
        }
      }
      err += parity;
      float fwd[7], bwd[7];
      fwd[0] = bwd[0] = 1.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        fwd[j + 1] = __fmul_rn(fwd[j], toc[j]);
        bwd[j + 1] = __fmul_rn(bwd[j], toc[6 - j]);
      }
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        const int v = s_var[m * 7 + j];
        if (v < 0) continue;
        const float x = ft8::clampf(__fmul_rn(fwd[j], bwd[6 - j]), -clip, clip);
        tov[s_slot[m * 7 + j]] = __fmul_rn(-2.f, fast_atanh(x));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      err += __shfl_xor_sync(0xffffffffu, err, off);
    if (!any_hard) err = kM;
    if (err < best_err) {                // warp-uniform
      best_err = err;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const int v = lane + 32 * i;
        if (v < kN) best[v] = hard[v];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const int v = lane + 32 * i;
    if (v >= kN) continue;
    const size_t o = static_cast<size_t>(cw) * kN + v;
    hard_out[o] = static_cast<int8_t>(best[v]);
    if (post_out != nullptr)
      post_out[o] = posterior(l[i], tov, v);
  }
  if (lane == 0) err_out[cw] = best_err;
}

}  // namespace

// llr: (n, 174) f32; edge_var / edge_slot: (581,) i32 (-1 on padded slots);
// hard: (n, 174) i8; errors: (n,) i32; post: (n, 174) f32 or null.
FT8_EXPORT int ft8_bp_decode(const float* llr, const int* edge_var,
                             const int* edge_slot, int8_t* hard, int* errors,
                             float* post, int n, int iters, void* stream) {
  if (n <= 0 || iters < 0) return cudaErrorInvalidValue;
  const int blocks = (n + kWarps - 1) / kWarps;
  bp_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      llr, edge_var, edge_slot, n, iters, hard, errors, post);
  return static_cast<int>(cudaGetLastError());
}
