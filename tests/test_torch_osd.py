"""The port's ordered-statistics decoding (rtlsdr_ft8d_tpu_torch/ops/osd.py).

Against the JAX package's (rtlsdr_ft8d_tpu/ops/osd.py): on seeded
posteriors (codewords under three noise levels, and pure noise) the
copy's osd_batch through the native library, its osd_batch_numpy and its
per-candidate osd_decode must give exactly the originals' messages and
accepts.

The kernel csrc/osd.cu: osd_rows on CPU tensors against the two calls of
osd_batch that pipeline._merge_osd_decodes made before it; numpy models
of the kernel's three warp-level reformulations of native/osd.cc (the
rank-based stable order, the order-free XOR reduction of a basis step,
the (discrepancy, index) shortlist), each against the native or numpy
path, and a model of a whole row built from them and from the kernel's
packed tables, against native ft8_osd_batch. The `cuda` tests hold the
kernel on the card bit-equal to native ft8_osd_batch on every row; this
file imports JAX only inside the tests that compare with it, so on the
GPU machine, which has no JAX, run

    python -m pytest --noconftest -m cuda tests/test_torch_osd.py -q
"""

import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu_torch import native
from rtlsdr_ft8d_tpu_torch.ops import osd
from rtlsdr_ft8d_tpu_torch.protocol.crc import add_crc
from rtlsdr_ft8d_tpu_torch.protocol.encode import ldpc_encode

from .torch_cpu import few_torch_threads  # noqa: F401

SEEDS = [0, 1, 2]
N, K = 174, 91


def _posteriors(seed, n=48):
    """Soft codewords near the OSD threshold: a third at each noise
    sigma, every fourth row pure noise."""
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(n):
        if t % 4 == 3:
            rows.append(rng.normal(0, 2.0, 174))
            continue
        cw = ldpc_encode(add_crc(rng.integers(0, 2, 77).astype(np.uint8)))
        rows.append((2.0 * cw - 1.0) * 2.0
                    + rng.normal(0, [1.6, 2.0, 2.4][t % 3], 174))
    return np.stack(rows).astype(np.float32)


def _codeword(rng):
    return ldpc_encode(add_crc(rng.integers(0, 2, 77).astype(np.uint8)))


def _flavor_rows(seed, n):
    """(flavor A, flavor B) posteriors of n rows in five kinds, cycled:
    codewords with LLRs quantized to steps of 0.5 (ties in |llr| and
    exact zeros common), pure noise (no accept), noisy codewords at noise
    levels either side of the max_norm gate, rows whose flavor A is noise
    and whose flavor B carries the codeword (A rejects, B accepts), and
    two noisy views of one codeword."""
    rng = np.random.default_rng(seed)
    a = np.empty((n, N), np.float32)
    b = np.empty((n, N), np.float32)
    for t in range(n):
        kind = t % 5
        s = 2.0 * _codeword(rng) - 1.0
        if kind == 0:
            x = np.round((2.0 * s + rng.normal(0, 2.2, N)) * 2.0) / 2.0
            a[t], b[t] = x, np.round(x + rng.normal(0, 1.0, N))
        elif kind == 1:
            a[t], b[t] = rng.normal(0, 2.0, N), rng.normal(0, 2.0, N)
        elif kind == 2:
            sigma = rng.uniform(1.9, 2.7)
            a[t] = 2.0 * s + rng.normal(0, sigma, N)
            b[t] = 2.0 * s + rng.normal(0, sigma, N)
        elif kind == 3:
            a[t], b[t] = rng.normal(0, 2.0, N), 2.0 * s + rng.normal(0, 1.5, N)
        else:
            a[t] = 2.0 * s + rng.normal(0, 1.8, N)
            b[t] = 2.0 * s + rng.normal(0, 2.0, N)
    return a, b


def _two_calls(a, b=None):
    """What pipeline._merge_osd_decodes did before osd_rows: osd_batch on
    flavor A, then on flavor B's rows that A rejected."""
    msgs, acc = osd.osd_batch(a)
    accept = acc.astype(np.uint8)
    if b is not None:
        rej = np.nonzero(~acc)[0]
        if rej.size:
            m2, a2 = osd.osd_batch(b[rej])
            hit = np.nonzero(a2)[0]
            msgs[rej[hit]] = m2[hit]
            accept[rej[hit]] = 2
    return msgs, accept


@pytest.fixture
def native_lib():
    if native.load() is None:
        pytest.skip("the port's native library could not be built")


@pytest.mark.parametrize("seed", SEEDS)
def test_osd_batch_native_equals_jax(seed, monkeypatch, native_lib):
    """The copy through the port's native library against the original
    through the numpy path (tests/test_osd.py holds that path equal to
    the original's native and scalar paths)."""
    from rtlsdr_ft8d_tpu.ops import osd as josd

    calls = []
    real = native.load

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(native, "load", spy)
    post = _posteriors(seed)
    msgs, acc = osd.osd_batch(post)
    assert calls                                  # the native path ran
    j_msgs, j_acc = josd.osd_batch_numpy(post)
    assert np.array_equal(acc, j_acc) and np.array_equal(msgs, j_msgs)
    assert 0 < int(acc.sum()) < post.shape[0]


@pytest.mark.parametrize("seed", SEEDS)
def test_osd_batch_numpy_equals_jax(seed):
    from rtlsdr_ft8d_tpu.ops import osd as josd

    post = _posteriors(seed)
    msgs, acc = osd.osd_batch_numpy(post)
    j_msgs, j_acc = josd.osd_batch_numpy(post)
    assert np.array_equal(acc, j_acc) and np.array_equal(msgs, j_msgs)


@pytest.mark.parametrize("seed", SEEDS)
def test_osd_decode_equals_jax(seed):
    from rtlsdr_ft8d_tpu.ops import osd as josd

    post = _posteriors(seed, n=8)
    for row in post:
        cw, norm = osd.osd_decode(row)
        j_cw, j_norm = josd.osd_decode(row)
        assert (cw is None) == (j_cw is None)
        if j_cw is not None:
            assert np.array_equal(cw, j_cw) and norm == j_norm


# -- osd_rows on the host ----------------------------------------------------

@pytest.mark.parametrize("flavors", ["a", "a+b"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_osd_rows_plain_equals_two_calls(flavors, as_tensor):
    """osd_rows on numpy arrays and CPU tensors is the two-call merge
    logic: flavor B tried only where A rejects, accept 1 or 2 by flavor,
    zero messages where neither accepts; CPU tensors out, no launch."""
    a, b = _flavor_rows(3, 40)
    b = b if flavors == "a+b" else None
    want_m, want_a = _two_calls(a, b)
    before = osd.KERNEL.launches
    args = [a, b]
    if as_tensor:
        args = [None if x is None else torch.from_numpy(x) for x in args]
    msgs, accept = osd.osd_rows(*args)
    assert osd.KERNEL.launches == before
    assert msgs.device.type == accept.device.type == "cpu"
    assert msgs.dtype == accept.dtype == torch.uint8
    assert np.array_equal(msgs.numpy(), want_m)
    assert np.array_equal(accept.numpy(), want_a)
    counts = np.bincount(want_a, minlength=3)
    assert counts[0] > 0 and counts[1] > 0
    assert (counts[2] > 0) == (b is not None)
    assert not msgs.numpy()[want_a == 0].any()


def test_osd_rows_cuda_takes_native_parameters_only():
    x = torch.zeros((1, N))
    for kw in (dict(depth=33), dict(pair_depth=25), dict(crc_top=17),
               dict(depth=-1), dict(crc_top=-1)):
        with pytest.raises(ValueError):
            osd.osd_rows_cuda(x, **kw)


def test_kernel_tables_are_e_and_the_crc_matrix():
    """The packed operands of csrc/osd.cu unpack to ops/osd's E and to
    ops/tables' CRC-14 matrix."""
    from rtlsdr_ft8d_tpu_torch.ops.tables import crc_matrix

    e, crc = osd.kernel_tables()
    w = e.view(np.uint64)
    bits = np.array([[(int(w[i, c >> 6]) >> (c & 63)) & 1 for c in range(K)]
                     for i in range(N)], np.uint8)
    assert np.array_equal(bits, osd.encode_matrix())
    assert not (w[:, 1] >> np.uint64(K - 64)).any()
    back = (crc.astype(np.int64)[:, None] >> np.arange(14)) & 1
    assert np.array_equal(back, crc_matrix())


# -- numpy models of the kernel's warp-level reformulations ------------------

def rank_order(keys, descending):
    """The kernel's stable order without a sort: position i's rank is the
    number of keys that come before it (greater when descending, smaller
    when ascending) plus the equal keys at a lower index; order[rank] = i."""
    k = np.asarray(keys)
    idx = np.arange(k.size)
    before = k[None, :] > k[:, None] if descending else k[None, :] < k[:, None]
    ties = (k[None, :] == k[:, None]) & (idx[None, :] < idx[:, None])
    rank = np.count_nonzero(before | ties, axis=1)
    order = np.full(k.size, -1)
    order[rank] = idx
    return order


def mrb_xor_model(perm):
    """The kernel's basis steps: the stored rows XORed into a new row are
    those whose pivot the new row has set on entry, combined as 32 lane
    partials (lane c % 32) in a shuffled order; then the back-elimination
    and the owner's store. Returns (the basis positions by slot, the
    augmented rows by pivot column), or (None, None) short of rank."""
    E = osd.encode_matrix()
    rows = np.zeros((K, K), np.uint8)
    augs = np.zeros((K, K), np.uint8)
    has = np.zeros(K, bool)
    basis = []
    lanes = np.random.default_rng(len(perm)).permutation(32)
    for pos in perm:
        if len(basis) == K:
            break
        r = E[pos].copy()
        sel = has & (r == 1)                       # fixed on entry
        xr = np.zeros(K, np.uint8)
        xa = np.zeros(K, np.uint8)
        for lane in lanes:
            mine = sel & (np.arange(K) % 32 == lane)
            xr ^= np.bitwise_xor.reduce(rows[mine], axis=0) if mine.any() \
                else 0
            xa ^= np.bitwise_xor.reduce(augs[mine], axis=0) if mine.any() \
                else 0
        r ^= xr
        if not r.any():
            continue
        a = xa.copy()
        a[len(basis)] ^= 1
        piv = int(np.argmax(r))
        hit = has & (rows[:, piv] == 1)
        rows[hit] ^= r
        augs[hit] ^= a
        rows[piv], augs[piv], has[piv] = r, a, True
        basis.append(int(pos))
    if len(basis) < K:
        return None, None
    return np.array(basis), augs


def shortlist_model(disc, valid, cap):
    """The kernel's pick: the valid pattern of least (discrepancy, index)
    if fewer than `cap` patterns have a smaller key, else -1."""
    disc = np.asarray(disc)
    idx = np.arange(disc.size)
    v = np.nonzero(valid)[0]
    if v.size == 0:
        return -1
    best = int(v[np.lexsort((v, disc[v]))[0]])
    ahead = np.count_nonzero((disc < disc[best])
                             | ((disc == disc[best]) & (idx < best)))
    return best if ahead < cap else -1


def shortlist_insertion(disc, valid, cap):
    """native/osd.cc's Shortlist, line for line: insert after the entries
    whose discrepancy is <= d, drop what falls past `cap`; then the first
    valid entry."""
    top = []
    for p, d in enumerate(disc):
        i = len(top)
        while i > 0 and top[i - 1][0] > d:
            i -= 1
        if i >= cap:
            continue
        top.insert(i, (d, p))
        del top[cap:]
    return next((p for _, p in top if valid[p]), -1)


def _reliabilities(seed):
    """|llr| rows rich in ties and zeros, as float32 widened to double."""
    a, _ = _flavor_rows(seed, 10)
    return [np.abs(r).astype(np.float64) for r in a]


@pytest.mark.parametrize("seed", SEEDS)
def test_rank_order_is_the_stable_sort(seed):
    """Descending over positions and ascending over basis slots, ties in
    index order: numpy's stable argsort, the numpy path's and
    std::stable_sort's order."""
    rels = _reliabilities(seed)
    assert any(np.unique(r).size < N // 4 and (r == 0).any() for r in rels)
    for rel in rels:
        assert np.array_equal(rank_order(rel, True),
                              np.argsort(-rel, kind="stable"))
        sub = rel[:K]
        assert np.array_equal(rank_order(sub, False),
                              np.argsort(sub, kind="stable"))


@pytest.mark.parametrize("seed", SEEDS)
def test_mrb_xor_reduction_equals_the_numpy_basis(seed):
    """The order-free step gives _mrb_batch's basis positions and its
    basis inverse (the augmented rows), row for row."""
    rels = _reliabilities(seed)
    perms = np.stack([np.argsort(-r, kind="stable") for r in rels])
    pos, aug_p, ok = osd._mrb_batch(perms)
    aug = np.unpackbits(aug_p, axis=2)[:, :, :K]
    for t, perm in enumerate(perms):
        basis, augs = mrb_xor_model(perm)
        assert ok[t] and basis is not None
        assert np.array_equal(basis, pos[t])
        assert np.array_equal(augs, aug[t])


@pytest.mark.parametrize("seed", SEEDS)
def test_shortlist_pick_equals_insertion(seed):
    """On discrepancies with many ties, at capacities 1, 8 and 16 and
    fewer patterns than the capacity: the kernel's pick is the Shortlist's
    first valid entry and the numpy path's (stable argsort, first
    valid)."""
    rng = np.random.default_rng(seed)
    for trial in range(300):
        n_pat = int(rng.choice([5, 70, 70, 529]))
        disc = rng.integers(0, 12, n_pat).astype(np.float64) * 0.25
        valid = rng.random(n_pat) < rng.choice([0.02, 0.1, 0.5])
        for cap in (1, 8, 16):
            want = shortlist_insertion(disc, valid, cap)
            first = [int(j) for j in np.argsort(disc, kind="stable")[:cap]
                     if valid[j]]
            assert want == (first[0] if first else -1)
            assert shortlist_model(disc, valid, cap) == want


def _kernel_row_model(llr, depth=24, pair_depth=10, crc_top=8,
                      max_norm=0.12):
    """One row as csrc/osd.cu computes it, on the kernel's packed tables
    and the three models above, in Python integers and doubles. Returns
    the 91 message bits or None."""
    e, crc = osd.kernel_tables()
    e_rows = [int(w0) | int(w1) << 64 for w0, w1 in e.view(np.uint64)]
    crc_tab = [int(c) for c in crc]
    llr = np.asarray(llr, np.float32)
    rel = np.abs(llr).astype(np.float64)
    hard = sum(1 << i for i in range(N) if llr[i] > 0)
    basis, augs = mrb_xor_model(rank_order(rel, True))
    if basis is None:
        return None
    aug_int = [sum(int(b) << s for s, b in enumerate(row)) for row in augs]

    def encode(m):
        # the kernel's words: parity bits K + 32k + lane as ballots
        cw = [m & (2 ** 64 - 1), (m >> 64) & (2 ** (K - 64) - 1), 0]
        for k in range(3):
            ballot = sum((bin(e_rows[i] & m).count("1") & 1) << (i - K - 32 * k)
                         for i in range(K + 32 * k, min(K + 32 * k + 32, N)))
            w, sh = (K + 32 * k) >> 6, (K + 32 * k) & 63
            cw[w] |= (ballot << sh) & (2 ** 64 - 1)
            if sh > 32:
                cw[w + 1] |= ballot >> (64 - sh)
        return cw[0] | cw[1] << 64 | cw[2] << 128

    def pair(q):
        # the kernel's pattern_cw: pattern 1 + depth + q is the pair (a, b)
        a = 0
        while q >= pair_depth - 1 - a:
            q -= pair_depth - 1 - a
            a += 1
        return a, a + 1 + q

    y0 = sum(((hard >> int(p)) & 1) << s for s, p in enumerate(basis))
    cw0 = encode(sum((bin(aug_int[c] & y0).count("1") & 1) << c
                     for c in range(K)))
    order = rank_order(rel[basis], False)[:depth]
    colcw = [encode(sum(((aug_int[c] >> int(s)) & 1) << c for c in range(K)))
             for s in order]
    pats = [cw0] + [cw0 ^ c for c in colcw[:depth]]
    pats += [cw0 ^ colcw[a] ^ colcw[b] for a, b in
             map(pair, range(pair_depth * (pair_depth - 1) // 2))]
    disc, valid = [], []
    for c in pats:
        d = 0.0
        for i in range(N):
            if ((c ^ hard) >> i) & 1:
                d += float(rel[i])
        disc.append(d)
        payload = c & ((1 << 77) - 1)
        crc_c = 0
        for i in range(77):
            if (payload >> i) & 1:
                crc_c ^= crc_tab[i]
        valid.append(payload != 0 and crc_c == (c >> 77) & 0x3FFF)
    pick = shortlist_model(np.array(disc), np.array(valid), min(crc_top, 16))
    if pick < 0:
        return None
    relsum = 0.0
    for r in rel:
        relsum += float(r)
    if disc[pick] / max(relsum, 1e-9) > max_norm:
        return None
    return np.array([(pats[pick] >> i) & 1 for i in range(K)], np.uint8)


@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_row_model_equals_native(seed, native_lib):
    """The whole row as the kernel computes it gives native
    ft8_osd_batch's accept and message on rows of every kind."""
    a, b = _flavor_rows(seed + 10, 10)
    a = np.concatenate([a, b, _posteriors(seed + 10, 8)])
    msgs, acc = osd.osd_batch(a)
    assert 0 < int(acc.sum()) < a.shape[0]
    for t, row in enumerate(a):
        got = _kernel_row_model(row)
        assert (got is not None) == bool(acc[t])
        if acc[t]:
            assert np.array_equal(got, msgs[t])


# -- the kernel on the card --------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from rtlsdr_ft8d_tpu_torch.ops import build

    build.load()
    if native.load() is None:
        pytest.fail("the native library did not build")
    return torch.device("cuda", torch.cuda.current_device())


def _check_on_card(a, b, dev):
    want_m, want_a = _two_calls(a, b)
    before = osd.KERNEL.launches
    msgs, accept = osd.osd_rows(torch.from_numpy(a).to(dev),
                                None if b is None else
                                torch.from_numpy(b).to(dev))
    torch.cuda.synchronize()
    assert msgs.device == accept.device == dev
    assert osd.KERNEL.launches == before + (a.shape[0] > 0)
    assert np.array_equal(accept.cpu().numpy(), want_a)
    assert np.array_equal(msgs.cpu().numpy(), want_m)
    return want_a


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 33, 2400])
def test_kernel_equals_native_on_every_row(card, n):
    a, b = _flavor_rows(100 + n, n)
    acc = _check_on_card(a, b, card)
    if n >= 33:
        assert set(np.unique(acc)) == {0, 1, 2}
    _check_on_card(a, None, card)


@pytest.mark.cuda
def test_kernel_equals_native_on_quantized_rows(card):
    """Every row quantized: |llr| ties everywhere, a tenth exact zeros."""
    rng = np.random.default_rng(7)
    n = 512
    s = np.stack([2.0 * _codeword(rng) - 1.0 for _ in range(n)])
    sigma = rng.uniform(1.2, 2.2, (n, 1))
    a = np.round(2.0 * s + rng.normal(0, 1.0, (n, N)) * sigma)
    a[rng.random((n, N)) < 0.1] = 0.0
    b = np.round(a + rng.normal(0, 0.5, (n, N)))
    acc = _check_on_card(a.astype(np.float32), b.astype(np.float32), card)
    assert set(np.unique(acc)) == {0, 1, 2}


@pytest.mark.cuda
def test_kernel_equals_native_on_a_deep_forward(card):
    """The real osd_post and osd_post_coh of a deep forward on the card
    (golden_busy, osd_cands=8 with the CQ clamp row), every row."""
    import os

    from rtlsdr_ft8d_tpu_torch.host.io import read_iq
    from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder, ap_tensors

    fix = os.path.join(os.path.dirname(__file__), "fixtures")
    i, q = read_iq(os.path.join(fix, "golden_busy.iq"))
    dec = WindowDecoder().to(card)
    i_t, q_t = (torch.from_numpy(np.stack([x, np.roll(x, 4000)])
                                 .astype(np.float32)).to(card)
                for x in (i, q))
    clamp, _ = ap_tensors(True, None, None, card)
    with torch.no_grad():
        out = dec(i_t, q_t, osd_cands=64,
                  ap_clamp_signs=clamp)
    a = out["osd_post"].cpu().numpy()
    b = out["osd_post_coh"].cpu().numpy()
    assert a.shape[0] == 128
    _check_on_card(a, b, card)
