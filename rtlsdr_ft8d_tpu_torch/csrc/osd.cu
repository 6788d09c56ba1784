// Ordered-statistics decoding (OSD) of the deep decode's BP failures, both
// posterior flavors in one launch.
//
// Replaces no Pallas kernel: the JAX package runs this stage on the host
// (rtlsdr_ft8d_tpu/ops/osd.py, whose native path is native/osd.cc's
// ft8_osd_batch), and so did the port until this kernel. It computes
// exactly native/osd.cc:osd_one, whose algorithm ops/osd.py documents: the
// most reliable basis (MRB) of E = [I; G] in reliability order, the hard
// MRB solve, order-1 flips of the `depth` weakest basis slots and pairs
// among the `pair_depth` weakest, the `crc_top` lowest soft discrepancies
// and the first CRC-valid one with a non-zero payload, accepted when its
// discrepancy over the summed reliabilities is at most `max_norm`. A row
// runs flavor A first and flavor B only where A does not accept, the order
// of pipeline._merge_osd_decodes; accept is 0 (none), 1 (A) or 2 (B), and
// a row's 91 message bits are written where it accepts, zeros elsewhere.
//
// What bounds it: neither bytes (1.4 KB in and 92 B out a row) nor
// operations, but the latency of each row's sequential chain: up to 174
// elimination steps, each depending on the one before. So one warp owns one
// row and keeps its state on chip. Shared memory holds the E table and the
// CRC-14 columns once a block, and per warp the reliabilities (as float:
// fabs of a float widened to double is the same double as fabs of the
// widened float), the orders and the flip columns' codewords. The reduced
// rows and their basis combinations live in registers, pivot column c in
// lane c % 32, slot c / 32.
//
// Where the native loop is sequential, the warp computes the same thing:
// - Stable orders without a sort: a position's rank is the count of
//   positions with greater reliability plus the equal ones at lower index,
//   std::stable_sort's order (ascending for the basis slots).
// - One MRB step: the stored rows are in reduced row echelon form (each is
//   zero in every other pivot column), so the rows the native loop XORs
//   into a new row are those whose pivot bit the new row has on entry, in
//   any order. Each lane XORs in its own, a butterfly of shuffles combines
//   the lanes, then the lanes back-eliminate their rows in parallel and the
//   pivot's owner stores the new row.
// - Solve, encodes and flip columns: a bit per lane, gathered by ballots.
// - Shortlist: every pattern's discrepancy is summed by one lane in double,
//   over the differing bits in ascending index as osd.cc's score, so the
//   sums are bit-equal. The native Shortlist keeps the crc_top smallest by
//   (discrepancy, pattern index) and takes the first CRC-valid entry; that
//   entry is the valid pattern of smallest key, if fewer than crc_top
//   patterns have a smaller key, else none is taken. The summed
//   reliabilities are one lane's sequential double sum, as in osd.cc.
#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kN = 174;            // codeword bits
constexpr int kK = 91;             // message bits
constexpr int kP = 77;             // payload bits
constexpr int kMaxDepth = 32;      // osd.cc's colcw[32]
constexpr int kMaxShort = 16;      // osd.cc's Shortlist capacity
constexpr int kMaxPatterns = 1 + kMaxDepth + kMaxDepth * (kMaxDepth - 1) / 2;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct WarpState {
  u64 colcw[kMaxDepth][3];         // codeword toggles of the weakest slots
  double disc[kMaxPatterns];       // each pattern's discrepancy
  float rel[kN];                   // |llr|
  uint8_t perm[kN];                // positions, most reliable first
  uint8_t basis[kK];               // the MRB's positions, by slot
  uint8_t order[kMaxDepth];        // the weakest basis slots, ascending
};

struct Tables {
  u64 e[kN][2];                    // rows of E over the 91 message columns
  uint16_t crc[kP];                // CRC-14 of each unit payload, bit b = cw bit 77+b
};

__device__ __forceinline__ int parity2(const u64 a[2], const u64 b[2]) {
  return (__popcll(a[0] & b[0]) ^ __popcll(a[1] & b[1])) & 1;
}

// The 91-bit vector whose bit lane + 32k is p[k].
__device__ __forceinline__ void gather91(const bool p[3], u64 out[2]) {
  const unsigned b0 = __ballot_sync(kFull, p[0]);
  const unsigned b1 = __ballot_sync(kFull, p[1]);
  const unsigned b2 = __ballot_sync(kFull, p[2]);
  out[0] = b0 | (static_cast<u64>(b1) << 32);
  out[1] = b2;
}

// Bit b of a 91-bit vector (2 words) or of a codeword (3 words), by
// selects: a register array indexed by a run-time value would go to local
// memory.
__device__ __forceinline__ int bit2(const u64 w[2], int b) {
  return static_cast<int>(((b < 64 ? w[0] : w[1]) >> (b & 63)) & 1);
}

__device__ __forceinline__ int bit3(const u64 w[3], int b) {
  return static_cast<int>(
      ((b < 64 ? w[0] : b < 128 ? w[1] : w[2]) >> (b & 63)) & 1);
}

// cw = E @ m: the 91 systematic bits, then parity bit 91 + lane + 32k from
// lane's dot product with row 91 + lane + 32k of E; warp-uniform.
__device__ __forceinline__ void encode(const Tables& t, const u64 m[2],
                                       u64 cw[3]) {
  const int lane = threadIdx.x & 31;
  cw[0] = m[0];
  cw[1] = m[1] & ((1ull << (kK - 64)) - 1);
  cw[2] = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int i = kK + lane + 32 * k;
    const u64 b = __ballot_sync(kFull, i < kN && parity2(t.e[i], m));
    const int start = kK + 32 * k, w = start >> 6, sh = start & 63;
    cw[w] |= b << sh;
    if (sh > 32) cw[w + 1] |= b >> (64 - sh);
  }
}

// Pattern p's codeword: none, then the singles, then the pairs (a < b) in
// osd.cc's order.
__device__ __forceinline__ void pattern_cw(const WarpState& s, const u64 cw0[3],
                                           int p, int nd, int npw, u64 c[3]) {
  c[0] = cw0[0];
  c[1] = cw0[1];
  c[2] = cw0[2];
  if (p == 0) return;
  int a = p - 1, b = -1;
  if (a >= nd) {
    int q = a - nd;
    a = 0;
    while (q >= npw - 1 - a) {
      q -= npw - 1 - a;
      ++a;
    }
    b = a + 1 + q;
  }
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    c[w] ^= s.colcw[a][w];
    if (b >= 0) c[w] ^= s.colcw[b][w];
  }
}

// osd.cc's score: sum of rel over the differing bits, ascending index.
__device__ __forceinline__ double score(const WarpState& s, const u64 c[3],
                                        const u64 hard[3]) {
  double d = 0.0;
#pragma unroll
  for (int w = 0; w < 3; ++w) {
    u64 diff = c[w] ^ hard[w];
    while (diff) {
      d += static_cast<double>(s.rel[w * 64 + __ffsll(diff) - 1]);
      diff &= diff - 1;
    }
  }
  return d;
}

// A non-zero payload whose CRC-14 matches bits 77..90.
__device__ __forceinline__ bool crc_valid(const Tables& t, const u64 c[3]) {
  const u64 lo = c[0], hi = c[1] & ((1ull << (kP - 64)) - 1);
  if (!(lo | hi)) return false;
  unsigned crc = 0;
  for (u64 x = lo; x; x &= x - 1) crc ^= t.crc[__ffsll(x) - 1];
  for (u64 x = hi; x; x &= x - 1) crc ^= t.crc[64 + __ffsll(x) - 1];
  return crc == ((c[1] >> (kP - 64)) & 0x3fff);
}

// One row of one flavor; warp-uniform. Returns true and the accepted
// codeword in cw_out where osd_one returns 1.
__device__ bool osd_row(const float* __restrict__ llr, const Tables& t,
                        WarpState& s, int depth, int pair_depth, int crc_top,
                        double max_norm, u64 cw_out[3]) {
  const int lane = threadIdx.x & 31;
  __syncwarp();                    // the warp's last row has read its state

  // reliabilities and hard decisions: position lane + 32k
  u64 hard[3] = {0, 0, 0};
  float x[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int i = lane + 32 * k;
    const float l = i < kN ? llr[i] : 0.f;
    x[k] = fabsf(l);
    if (i < kN) s.rel[i] = x[k];
    const u64 b = __ballot_sync(kFull, i < kN && l > 0.f);
    hard[k >> 1] |= b << (32 * (k & 1));
  }
  __syncwarp();

  // most reliable first, stable: rank = #greater + #equal at lower index
  {
    int rank[6] = {0, 0, 0, 0, 0, 0};
    for (int t2 = 0; t2 < kN; ++t2) {
      const float y = s.rel[t2];
#pragma unroll
      for (int k = 0; k < 6; ++k)
        rank[k] += (y > x[k]) | ((y == x[k]) & (t2 < lane + 32 * k));
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int i = lane + 32 * k;
      if (i < kN && rank[k] < kN) s.perm[rank[k]] = static_cast<uint8_t>(i);
    }
  }
  __syncwarp();

  // the greedy MRB, RREF kept: pivot column lane + 32k in rows[k], augs[k]
  u64 rows[3][2] = {}, augs[3][2] = {};
  u64 pivots[2] = {0, 0};
  int nbasis = 0;
  for (int j = 0; j < kN && nbasis < kK; ++j) {
    const int pos = min(static_cast<int>(s.perm[j]), kN - 1);
    u64 r[2] = {t.e[pos][0], t.e[pos][1]};
    const u64 sel[2] = {r[0] & pivots[0], r[1] & pivots[1]};
    u64 xr0 = 0, xr1 = 0, xa0 = 0, xa1 = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (bit2(sel, lane + 32 * k)) {
        xr0 ^= rows[k][0];
        xr1 ^= rows[k][1];
        xa0 ^= augs[k][0];
        xa1 ^= augs[k][1];
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      xr0 ^= __shfl_xor_sync(kFull, xr0, o);
      xr1 ^= __shfl_xor_sync(kFull, xr1, o);
      xa0 ^= __shfl_xor_sync(kFull, xa0, o);
      xa1 ^= __shfl_xor_sync(kFull, xa1, o);
    }
    r[0] ^= xr0;
    r[1] ^= xr1;
    if (!(r[0] | r[1])) continue;                  // dependent row
    u64 a[2] = {xa0, xa1};
    if (nbasis < 64)                               // + e_slot
      a[0] ^= 1ull << nbasis;
    else
      a[1] ^= 1ull << (nbasis - 64);
    const int piv = r[0] ? __ffsll(r[0]) - 1 : 63 + __ffsll(r[1]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {                  // back-eliminate
      const int c = lane + 32 * k;
      if (bit2(pivots, c) && bit2(rows[k], piv)) {
        rows[k][0] ^= r[0];
        rows[k][1] ^= r[1];
        augs[k][0] ^= a[0];
        augs[k][1] ^= a[1];
      }
      if (c == piv) {
        rows[k][0] = r[0];
        rows[k][1] = r[1];
        augs[k][0] = a[0];
        augs[k][1] = a[1];
      }
    }
    if (piv < 64)
      pivots[0] |= 1ull << piv;
    else
      pivots[1] |= 1ull << (piv - 64);
    if (lane == 0) s.basis[nbasis] = static_cast<uint8_t>(pos);
    ++nbasis;
  }
  if (nbasis < kK) return false;
  __syncwarp();

  // m0 = inv @ y0, y0 the hard bits of the basis positions by slot
  bool p[3];
  u64 y0[2], m0[2], cw0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int sl = lane + 32 * k;
    p[k] = sl < kK && bit3(hard, s.basis[sl]);
  }
  gather91(p, y0);
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = parity2(augs[k], y0);
  gather91(p, m0);
  encode(t, m0, cw0);

  // the weakest basis slots, stable ascending: rank = #less + #equal lower
  const int nd = depth;
  {
    float xb[3];
    int rank[3] = {0, 0, 0};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int sl = lane + 32 * k;
      xb[k] = sl < kK ? s.rel[s.basis[sl]] : 0.f;
    }
    for (int t2 = 0; t2 < kK; ++t2) {
      const float y = s.rel[s.basis[t2]];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        rank[k] += (y < xb[k]) | ((y == xb[k]) & (t2 < lane + 32 * k));
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (lane + 32 * k < kK && rank[k] < nd)
        s.order[rank[k]] = static_cast<uint8_t>(lane + 32 * k);
  }
  __syncwarp();

  // flipping slot sl toggles m by inverse column sl: its codeword
  for (int w = 0; w < nd; ++w) {
    const int sl = s.order[w];
    u64 icol[2], c[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) p[k] = bit2(augs[k], sl);
    gather91(p, icol);
    encode(t, icol, c);
    if (lane == w) {
      s.colcw[w][0] = c[0];
      s.colcw[w][1] = c[1];
      s.colcw[w][2] = c[2];
    }
  }
  __syncwarp();

  // every pattern's discrepancy; the valid pattern of smallest key
  const int npw = pair_depth;
  const int n_pat = 1 + nd + npw * (npw - 1) / 2;
  double best_d = 0.0;
  int best_p = -1;
  for (int q = lane; q < n_pat; q += 32) {
    u64 c[3];
    pattern_cw(s, cw0, q, nd, npw, c);
    const double d = score(s, c, hard);
    s.disc[q] = d;
    if (best_p < 0 || d < best_d) {                // q rises: ties keep the first
      if (crc_valid(t, c)) {
        best_d = d;
        best_p = q;
      }
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const double od = __shfl_xor_sync(kFull, best_d, o);
    const int op = __shfl_xor_sync(kFull, best_p, o);
    if (op >= 0 && (best_p < 0 || od < best_d || (od == best_d && op < best_p))) {
      best_d = od;
      best_p = op;
    }
  }
  if (best_p < 0) return false;
  // its place among all patterns by (discrepancy, index): in the shortlist?
  unsigned ahead = 0;
  for (int q = lane; q < n_pat; q += 32) {
    const double d = s.disc[q];
    ahead += (d < best_d) | ((d == best_d) & (q < best_p));
  }
  ahead = __reduce_add_sync(kFull, ahead);
  if (static_cast<int>(ahead) >= min(crc_top, kMaxShort)) return false;

  double relsum = 0.0;
  if (lane == 0)
    for (int i = 0; i < kN; ++i) relsum += static_cast<double>(s.rel[i]);
  relsum = __shfl_sync(kFull, relsum, 0);
  const double scale = relsum < 1e-9 ? 1e-9 : relsum;
  if (best_d / scale > max_norm) return false;
  pattern_cw(s, cw0, best_p, nd, npw, cw_out);
  return true;
}

__global__ void __launch_bounds__(kThreads)
osd_kernel(const float* __restrict__ post_a, const float* __restrict__ post_b,
           const u64* __restrict__ e_tab, const uint16_t* __restrict__ crc_tab,
           int n, int depth, int pair_depth, int crc_top, double max_norm,
           uint8_t* __restrict__ msgs, uint8_t* __restrict__ accept) {
  __shared__ Tables t;
  __shared__ WarpState ws[kWarps];
  for (int i = threadIdx.x; i < 2 * kN; i += kThreads)
    (&t.e[0][0])[i] = e_tab[i];
  for (int i = threadIdx.x; i < kP; i += kThreads) t.crc[i] = crc_tab[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n) return;
  const size_t off = static_cast<size_t>(row) * kN;
  u64 cw[3];
  int acc = osd_row(post_a + off, t, ws[warp], depth, pair_depth, crc_top,
                    max_norm, cw) ? 1 : 0;
  if (!acc && post_b != nullptr)
    acc = osd_row(post_b + off, t, ws[warp], depth, pair_depth, crc_top,
                  max_norm, cw) ? 2 : 0;
  uint8_t* m = msgs + static_cast<size_t>(row) * kK;
  for (int i = lane; i < kK; i += 32)
    m[i] = acc ? static_cast<uint8_t>(bit3(cw, i)) : 0;
  if (lane == 0) accept[row] = static_cast<uint8_t>(acc);
}

}  // namespace

// post_a, post_b: (n, 174) f32 posteriors (post_b may be null: flavor A
// alone); e_tab: (174, 2) u64 rows of E = [I; G] over the 91 message
// columns, column c in word c / 64, bit c % 64; crc_tab: (77,) u16, bit b
// the CRC-14 bit checked against codeword bit 77 + b for a unit payload;
// msgs: (n, 91) u8; accept: (n,) u8. 0 <= pair_depth <= depth <= 32 and
// 0 <= crc_top <= 16, as native/osd.cc takes them.
FT8_EXPORT int ft8_osd_rows(const float* post_a, const float* post_b,
                            const void* e_tab, const void* crc_tab,
                            uint8_t* msgs, uint8_t* accept, int n, int depth,
                            int pair_depth, int crc_top, double max_norm,
                            void* stream) {
  if (n <= 0 || pair_depth < 0 || pair_depth > depth || depth > kMaxDepth ||
      crc_top < 0 || crc_top > kMaxShort)
    return cudaErrorInvalidValue;
  osd_kernel<<<(n + kWarps - 1) / kWarps, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      post_a, post_b, static_cast<const u64*>(e_tab),
      static_cast<const uint16_t*>(crc_tab), n, depth, pair_depth, crc_top,
      max_norm, msgs, accept);
  return static_cast<int>(cudaGetLastError());
}
