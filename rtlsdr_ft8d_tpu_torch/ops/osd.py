# Copied from rtlsdr_ft8d_tpu/ops/osd.py:1-366; the CRC-14 matrix comes from
# the port's ops/tables.py (the original takes it from ops/ldpc.py, which
# imports jax) and the native library from the port's bindings. From
# osd_rows_plain on, the module is the port's own: the two flavors of the
# deep decode in one call, and the kernel csrc/osd.cu.
"""Ordered-statistics decoding (OSD) of LDPC(174,91) BP failures.

WSJT-X reaches ~-21 dB partly via OSD on candidates belief propagation
cannot converge (neither the reference daemon nor ft8_lib has this; it is
a beyond-reference sensitivity feature, ROADMAP r1 #3 / VERDICT r1 #7).

Method (OSD with order-1 + partial order-2 reprocessing):
  1. Sort the 174 bit positions by reliability |LLR|.
  2. Greedily pick the 91 most-reliable positions whose encoding-matrix
     rows are linearly independent (the "most reliable basis", MRB).
  3. Hard-decide the MRB bits; solve for the message; re-encode.
  4. Reprocess: flip each of the `depth` least-reliable MRB bits
     (order 1), and pairs within the least-reliable `pair_depth`
     (partial order 2); keep the codeword minimizing the soft
     discrepancy sum(|llr| over positions where cw != hard decision).
  5. Accept only if the CRC-14 passes AND the normalized discrepancy is
     below a threshold (false-decode control; CRC alone is 14 bits).

It only ever runs on the <=N best FAILED candidates per window (the
device graph already decoded everything BP can), and one solve is a 91x91
GF(2) elimination. `osd_rows` reprocesses both posterior flavors of the
deep decode: posteriors on a card go to the kernel csrc/osd.cu, every
other input to `osd_batch` on the host (native, else numpy).
"""

import ctypes
import functools

import numpy as np
import torch

from ..protocol.constants import FT8_LDPC_K, FT8_LDPC_N
from . import build
from .tables import crc_matrix

KERNEL = build.Kernel(
    "osd", "ft8_osd_rows", [build.P] * 6 + [build.I] * 4 + [ctypes.c_double],
    source="rtlsdr_ft8d_tpu_torch/csrc/osd.cu",
    replaces="no Pallas kernel: the host ft8_osd_batch of "
             "rtlsdr_ft8d_tpu/ops/osd.py:osd_batch")

_E = None           # (174, 91) systematic encoding matrix over GF(2)
_POPCNT = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def encode_matrix() -> np.ndarray:
    global _E
    if _E is None:
        from ..protocol.generator import generator_matrix
        G = generator_matrix().astype(np.uint8)          # (83, 91)
        _E = np.concatenate([np.eye(FT8_LDPC_K, dtype=np.uint8), G])
    return _E


@functools.cache
def _crc_mat() -> np.ndarray:
    """(77, 14) float32 CRC-14 matrix (ops/tables.crc_matrix)."""
    return crc_matrix().astype(np.float32)


def pair_indices(pair_depth: int):
    """(a, b) slot-index pairs for the order-2 flip patterns, in the
    exact order osd_decode enumerates them — shared by the numpy and
    native (native/ft8codec.cc) paths so the stable discrepancy sort
    tie-breaks identically everywhere."""
    pa = np.array([a for a in range(pair_depth)
                   for _ in range(a + 1, pair_depth)], np.intp)
    pb = np.array([b for a in range(pair_depth)
                   for b in range(a + 1, pair_depth)], np.intp)
    return pa, pb


def _mrb_and_inverse(perm):
    """Greedy most-reliable basis: first 91 positions (in reliability
    order `perm`) with independent rows of E, plus the inverse of that
    91x91 submatrix. Returns (basis_positions, inv)."""
    E = encode_matrix()
    k = FT8_LDPC_K
    rows = np.zeros((k, k), np.uint8)      # reduced rows (kept in RREF)
    pivot_of = np.full(k, -1, np.int32)    # pivot col -> row slot
    basis = []
    orig = np.zeros((k, k), np.uint8)      # original rows of chosen basis
    for pos in perm:
        r = E[pos].copy()
        # stored rows are RREF (each has zeros in every other pivot
        # column), so one ordered pass fully reduces r
        for c in range(k):
            if r[c] and pivot_of[c] >= 0:
                r ^= rows[pivot_of[c]]
        nz = np.nonzero(r)[0]
        if nz.size == 0:
            continue
        piv = nz[0]
        slot = len(basis)
        # back-eliminate the new pivot from stored rows to keep RREF
        hit = rows[:slot, piv].astype(bool)
        rows[:slot][hit] ^= r
        pivot_of[piv] = slot
        rows[slot] = r
        orig[slot] = E[pos]
        basis.append(pos)
        if len(basis) == k:
            break
    if len(basis) < k:
        return None, None
    # invert orig (k x k) over GF(2)
    a = np.concatenate([orig, np.eye(k, dtype=np.uint8)], axis=1)
    for col in range(k):
        piv = None
        for r in range(col, k):
            if a[r, col]:
                piv = r
                break
        if piv is None:
            return None, None
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
        mask = a[:, col].copy()
        mask[col] = 0
        a[mask.astype(bool)] ^= a[col]
    return np.asarray(basis), a[:, k:]


def _crc_ok(msg91: np.ndarray) -> bool:
    from ..protocol.crc import payload_crc
    crc = 0
    for b in msg91[77:91]:
        crc = (crc << 1) | int(b)
    return payload_crc(msg91[:77]) == crc and bool(msg91[:77].any())


def osd_decode(llr: np.ndarray, depth: int = 24, pair_depth: int = 10,
               crc_top: int = 8):
    """OSD one candidate. llr: (174,) float, positive = bit 1.

    CRC-checks the `crc_top` lowest-discrepancy reprocessed codewords and
    returns the best CRC-VALID one — the true codeword is occasionally
    outranked on soft discrepancy by a wrong near-codeword, and the
    14-bit CRC arbitrates. `crc_top` stays small to bound the
    false-accept probability (crc_top/2^14 per candidate).

    Returns (codeword174 uint8, normalized_discrepancy float) or
    (None, inf)."""
    llr = np.asarray(llr, np.float64)
    rel = np.abs(llr)
    hard = (llr > 0).astype(np.uint8)
    perm = np.argsort(-rel, kind="stable")
    basis, inv = _mrb_and_inverse(perm)
    if basis is None:
        return None, np.inf
    E = encode_matrix()
    y0 = hard[basis]                       # (91,)

    # flip patterns over the LEAST reliable basis members
    k = FT8_LDPC_K
    order = np.argsort(rel[basis], kind="stable")   # ascending reliability
    weak = order[:depth]
    pats = [np.zeros(k, np.uint8)]
    for i in weak:
        p = np.zeros(k, np.uint8)
        p[i] = 1
        pats.append(p)
    pw = order[:pair_depth]
    for a_i in range(len(pw)):
        for b_i in range(a_i + 1, len(pw)):
            p = np.zeros(k, np.uint8)
            p[pw[a_i]] = 1
            p[pw[b_i]] = 1
            pats.append(p)
    Y = (np.stack(pats) ^ y0[None, :])            # (P, 91)
    msgs = (Y @ inv.T) % 2                         # solve E[basis] m = y
    cws = (msgs @ E.T) % 2                         # (P, 174)
    diff = (cws != hard[None, :]).astype(np.float64)
    disc = diff @ rel                              # (P,)
    # normalize by the mean reliability so the threshold is SNR-invariant
    scale = max(np.mean(rel) * FT8_LDPC_N, 1e-9)
    for j in np.argsort(disc, kind="stable")[:crc_top]:
        msg = cws[j][:FT8_LDPC_K].astype(np.uint8)
        if _crc_ok(msg):
            return cws[j].astype(np.uint8), float(disc[j] / scale)
    return None, np.inf


def osd_batch_scalar(llrs: np.ndarray, max_norm: float = 0.12,
                     depth: int = 24, pair_depth: int = 10):
    """Per-candidate loop over osd_decode — the parity oracle for the
    vectorized path below (tests/test_osd.py checks they agree)."""
    n = llrs.shape[0]
    msgs = np.zeros((n, FT8_LDPC_K), np.uint8)
    accept = np.zeros(n, bool)
    for i in range(n):
        cw, norm = osd_decode(llrs[i], depth, pair_depth)
        if cw is None or norm > max_norm:
            continue
        msgs[i] = cw[:FT8_LDPC_K]
        accept[i] = True
    return msgs, accept


def _mrb_batch(perm: np.ndarray):
    """Batched greedy most-reliable basis over GF(2).

    For each candidate n, processes rows of E in reliability order
    perm[n] and keeps the first 91 linearly independent ones — the exact
    algorithm of _mrb_and_inverse, run in lockstep across the batch.

    State per candidate, all updated with vectorized numpy ops:
      rowsP  (N, 91, 91): RREF-reduced kept rows, indexed by PIVOT column
        (a stored row has 1 at its pivot and 0 at every other pivot, so
        reducing a new row is ONE GF(2) matvec — no inner elimination).
      augP   (N, 91, 91): the same rows expressed over the chosen basis
        rows (in selection order); when all 91 pivots are found the RREF
        is the identity, so augP IS the basis inverse.

    Rows live BIT-PACKED as 12-byte uint8 vectors (91 bits + 5 pad) so
    every GF(2) row op is an in-place uint8 XOR over 12 bytes — ~7x less
    memory traffic than unpacked bytes and no float mod-2 round trips.
    This is what makes the batch ~two orders of magnitude faster than
    the per-candidate Python loop.

    Returns (pos (N, 91) basis positions in selection order,
             aug (N, 91, 12) bit-packed basis inverses (row d = row d of
             the inverse, packed over the 91 slot columns),
             ok (N,) — False where no full-rank basis exists)."""
    N = perm.shape[0]
    k = FT8_LDPC_K
    E = encode_matrix()
    Eb = np.packbits(E, axis=1)                     # (174, 12)
    M = E[perm]                                     # (N, 174, 91) uint8
    Mb = Eb[perm]                                   # (N, 174, 12) packed
    # rows and their basis-combination (augmented) halves share one
    # array so each elimination step is ONE multiply + ONE xor-reduce +
    # ONE in-place update: [:, :, :12] = RREF rows indexed by pivot
    # column, [:, :, 12:] = the same rows over the chosen basis
    ra = np.zeros((N, k, 24), np.uint8)
    has_piv = np.zeros((N, k), np.uint8)
    nbasis = np.zeros(N, np.intp)
    basis_step = np.zeros((N, k), np.intp)          # perm step of slot s
    arangeN = np.arange(N)
    bitmask = np.array([128 >> b for b in range(8)], np.uint8)
    for j in range(perm.shape[1]):
        live = nbasis < k
        if not live.any():
            break
        coeff = (M[:, j] & has_piv)[:, :, None]     # stored rows to XOR in
        new = np.bitwise_xor.reduce(ra * coeff, axis=1)     # (N, 24)
        np.bitwise_xor(new[:, :12], Mb[:, j], out=new[:, :12])
        slot = nbasis.clip(max=k - 1)
        new[arangeN, 12 + (slot >> 3)] ^= bitmask[slot & 7]  # aug + e_slot
        r2u = np.unpackbits(new[:, :12], axis=1)    # (N, 96)
        piv = np.argmax(r2u, axis=1)                # first set bit
        take = live & (r2u.max(axis=1) > 0)
        # back-eliminate the new pivot from already-stored rows: rows
        # with bit piv set get the new row (both halves) XORed in
        pbyte = np.take_along_axis(
            ra, (piv >> 3)[:, None, None], axis=2)[:, :, 0]
        hit = (((pbyte & bitmask[piv & 7][:, None]) != 0)
               & (has_piv != 0) & take[:, None])    # (N, 91)
        np.bitwise_xor(ra, hit[:, :, None] * new[:, None, :], out=ra)
        # store the new row where taken
        tk = np.nonzero(take)[0]
        ra[tk, piv[tk]] = new[tk]
        has_piv[tk, piv[tk]] = 1
        basis_step[tk, nbasis[tk]] = j
        nbasis[tk] += 1
    ok = nbasis >= k
    pos = np.take_along_axis(perm, basis_step, axis=1)      # (N, 91)
    return pos, np.ascontiguousarray(ra[:, :, 12:]), ok


def osd_batch(llrs: np.ndarray, max_norm: float = 0.12,
              depth: int = 24, pair_depth: int = 10, crc_top: int = 8):
    """OSD a batch (N, 174) of failed candidates' LLRs.

    Dispatches to the native C++ implementation (native/osd.cc, bit-sliced
    GF(2) rows, ~200x the scalar Python loop) when libft8tpu.so is built,
    else the vectorized numpy path. All three paths produce identical
    accept decisions and messages (tests/test_osd.py fuzzes the parity).

    Returns (messages (N, 91) uint8, accept (N,) bool): accept requires
    a CRC-valid reprocessed codeword with normalized soft discrepancy
    below max_norm (false-decode control; tests/test_osd.py verifies
    pure noise stays clean)."""
    llrs = np.ascontiguousarray(llrs, np.float32)
    n = llrs.shape[0]
    if n and pair_depth <= depth and depth <= 32 and crc_top <= 16:
        from ..native import load
        lib = load()
        if lib is not None:
            import ctypes
            msgs = np.zeros((n, FT8_LDPC_K), np.uint8)
            accept = np.zeros(n, np.uint8)
            lib.ft8_osd_batch(
                llrs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n, depth, pair_depth, crc_top, float(max_norm),
                msgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                accept.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
            return msgs, accept.astype(bool)
    return osd_batch_numpy(llrs, max_norm, depth, pair_depth, crc_top)


def osd_batch_numpy(llrs: np.ndarray, max_norm: float = 0.12,
                    depth: int = 24, pair_depth: int = 10,
                    crc_top: int = 8):
    """Vectorized numpy OSD batch (fallback when the native lib is
    absent): batched MRB elimination (_mrb_batch) + rank-<=2 codeword
    updates + GF(2)-matrix CRC over the per-candidate shortlist. Same
    algorithm and acceptance rule as osd_decode/osd_batch_scalar —
    identical decode lists (tested)."""
    llrs = np.asarray(llrs, np.float64)
    N = llrs.shape[0]
    k = FT8_LDPC_K
    msgs_out = np.zeros((N, k), np.uint8)
    accept = np.zeros(N, bool)
    if N == 0:
        return msgs_out, accept
    rel = np.abs(llrs)                              # (N, 174)
    hard = (llrs > 0).astype(np.uint8)
    perm = np.argsort(-rel, axis=1, kind="stable")
    pos, augp, ok_basis = _mrb_batch(perm)
    y0 = np.take_along_axis(hard, pos, axis=1)      # (N, 91) slot order

    # base solve m0 = inv @ y0 over GF(2) on the PACKED inverse rows:
    # bit d = parity(popcount(aug_row_d AND y0))
    y0p = np.packbits(y0, axis=1)                   # (N, 12)
    m0 = (_POPCNT[augp & y0p[:, None, :]].sum(axis=2, dtype=np.uint8)
          & 1)                                      # (N, 91)
    Ef = encode_matrix().astype(np.float32)
    cw0 = ((m0.astype(np.float32) @ Ef.T) % 2.0).astype(np.uint8)

    # flip patterns over the least-reliable basis SLOTS — the pattern
    # list (none, singles, pairs) is ordered exactly as osd_decode's so
    # the stable discrepancy sort breaks ties identically. Flipping slot
    # s toggles the solution by inverse COLUMN s and the codeword by
    # E @ inv[:, s], so every pattern codeword is cw0 XOR one or two
    # precomputed per-slot columns — no GEMM over the pattern set.
    rel_b = np.take_along_axis(rel, pos, axis=1)
    order = np.argsort(rel_b, axis=1, kind="stable")
    # column set over the weakest max(depth, pair_depth) slots: singles
    # flip the first `depth`, pairs combine within the first `pair_depth`
    # (independent depths, exactly like osd_decode — pair_depth > depth
    # used to IndexError here while the scalar oracle handled it)
    nw = max(depth, pair_depth)
    weak = order[:, :nw]                            # (N, nw)
    bitmask = np.array([128 >> b for b in range(8)], np.uint8)
    wbytes = np.take_along_axis(
        augp, np.broadcast_to((weak >> 3)[:, None, :], (N, k, nw)),
        axis=2)
    icols = ((wbytes & bitmask[weak & 7][:, None, :]) != 0)  # (N,91,nw)
    colcw = ((icols.transpose(0, 2, 1).reshape(N * nw, k)
              .astype(np.float32) @ Ef.T) % 2.0) \
        .astype(np.uint8).reshape(N, nw, FT8_LDPC_N)

    P = 1 + depth + pair_depth * (pair_depth - 1) // 2
    cws = np.empty((N, P, FT8_LDPC_N), np.uint8)
    cws[:, 0] = cw0
    cws[:, 1:1 + depth] = cw0[:, None, :] ^ colcw[:, :depth]
    pa, pb = pair_indices(pair_depth)
    cws[:, 1 + depth:] = cw0[:, None, :] ^ colcw[:, pa] ^ colcw[:, pb]
    diff = cws != hard[:, None, :]
    disc = np.einsum('npj,nj->np', diff, rel)       # (N, P) float64
    scale = np.maximum(rel.mean(axis=1) * FT8_LDPC_N, 1e-9)

    # CRC-check the crc_top lowest-discrepancy codewords per candidate
    sel = np.argsort(disc, axis=1, kind="stable")[:, :crc_top]
    cand_cw = np.take_along_axis(cws, sel[:, :, None], axis=1)  # (N,T,174)
    payload = cand_cw[:, :, :77]
    expect = payload.astype(np.float32) @ _crc_mat()
    crc_ok = np.all(expect % 2.0 == cand_cw[:, :, 77:91], axis=2) \
        & payload.any(axis=2)
    # osd_decode returns the FIRST CRC-valid of the shortlist and the
    # caller then applies the norm gate to that one — keep that order so
    # decode lists are identical
    good = crc_ok & ok_basis[:, None]
    has = good.any(axis=1)
    first = np.argmax(good, axis=1)                 # lowest-disc valid
    sel_disc = np.take_along_axis(disc, sel, axis=1)
    first_norm = np.take_along_axis(
        sel_disc, first[:, None], axis=1)[:, 0] / scale
    best = np.take_along_axis(
        cand_cw, first[:, None, None], axis=1)[:, 0]
    acc = has & (first_norm <= max_norm)
    accept[acc] = True
    msgs_out[acc] = best[acc, :k]
    return msgs_out, accept


def osd_rows_plain(post_a, post_b=None, *, max_norm=0.12, depth=24,
                   pair_depth=10, crc_top=8):
    """Both flavors on the host, as pipeline._merge_osd_decodes ran them:
    osd_batch on flavor A's (n, 174) posteriors, then on flavor B's rows
    that A did not accept. Takes numpy arrays or CPU tensors. Returns CPU
    tensors (messages (n, 91) uint8, zeros where no flavor accepts;
    accept (n,) uint8: 0 none, 1 flavor A, 2 flavor B)."""
    kw = dict(max_norm=max_norm, depth=depth, pair_depth=pair_depth,
              crc_top=crc_top)
    msgs, acc = osd_batch(np.asarray(post_a, np.float32), **kw)
    accept = acc.astype(np.uint8)
    rej = np.nonzero(~acc)[0]
    if post_b is not None and rej.size:
        msgs_b, acc_b = osd_batch(np.asarray(post_b, np.float32)[rej], **kw)
        msgs[rej[acc_b]] = msgs_b[acc_b]
        accept[rej[acc_b]] = 2
    return torch.from_numpy(msgs), torch.from_numpy(accept)


@functools.cache
def kernel_tables() -> tuple[np.ndarray, np.ndarray]:
    """The kernel's constant operands: the rows of E packed over the 91
    message columns, (174, 2) int64 (column c in word c // 64, bit
    c % 64), and the CRC-14 of each unit payload, (77,) int16 (bit b is
    checked against codeword bit 77 + b)."""
    E = encode_matrix().astype(np.uint64)
    words = np.zeros((FT8_LDPC_N, 2), np.uint64)
    for c in range(FT8_LDPC_K):
        words[:, c >> 6] |= E[:, c] << np.uint64(c & 63)
    crc = (crc_matrix().astype(np.int64) << np.arange(14)).sum(axis=1)
    return words.view(np.int64), crc.astype(np.int16)


@functools.cache
def _tables_on(device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in kernel_tables())


def osd_rows_cuda(post_a, post_b=None, *, max_norm=0.12, depth=24,
                  pair_depth=10, crc_top=8):
    """The kernel: one warp a row, flavor B only where flavor A does not
    accept, both in one launch; the same outputs as osd_rows_plain, as
    tensors on the posteriors' card. Takes the parameters native/osd.cc
    takes: 0 <= pair_depth <= depth <= 32, 0 <= crc_top <= 16."""
    if not (0 <= pair_depth <= depth <= 32 and 0 <= crc_top <= 16):
        raise ValueError(f"the OSD kernel takes 0 <= pair_depth <= depth "
                         f"<= 32 and 0 <= crc_top <= 16, got depth {depth}, "
                         f"pair_depth {pair_depth}, crc_top {crc_top}")
    dev = post_a.device
    a = post_a.to(torch.float32).contiguous()
    n = a.shape[0]
    b = None if post_b is None else post_b.to(torch.float32).contiguous()
    msgs = torch.empty((n, FT8_LDPC_K), dtype=torch.uint8, device=dev)
    accept = torch.empty((n,), dtype=torch.uint8, device=dev)
    if n:
        e_tab, crc_tab = _tables_on(dev)
        KERNEL(dev, build.check(a, torch.float32, (n, FT8_LDPC_N), dev),
               None if b is None else
               build.check(b, torch.float32, (n, FT8_LDPC_N), dev),
               build.check(e_tab, torch.int64), build.check(crc_tab,
                                                            torch.int16),
               build.check(msgs, torch.uint8), build.check(accept, torch.uint8),
               n, depth, pair_depth, crc_top, float(max_norm))
    return msgs, accept


def runs_on_card(post) -> bool:
    """Whether osd_rows reprocesses posteriors `post` on a card (the
    kernel) rather than on the host."""
    return isinstance(post, torch.Tensor) and build.on_cuda(post)


def osd_rows(post_a, post_b=None, *, max_norm=0.12, depth=24,
             pair_depth=10, crc_top=8):
    """OSD of the deep decode's BP failures, both flavors: (n, 174)
    posteriors of flavor A and, optionally, of flavor B for the same rows
    -> (messages (n, 91) uint8, accept (n,) uint8: 0 none, 1 flavor A, 2
    flavor B, tried only where A does not accept). Posteriors on a card
    launch the kernel (tensors on that card) or raise; numpy arrays and
    CPU tensors take osd_rows_plain (CPU tensors). Both give exactly
    ft8_osd_batch's messages and accepts."""
    fn = osd_rows_cuda if runs_on_card(post_a) else osd_rows_plain
    return fn(post_a, post_b, max_norm=max_norm, depth=depth,
              pair_depth=pair_depth, crc_top=crc_top)
