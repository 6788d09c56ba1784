"""The plain reference decoder: one FT8 window of many channels, in plain
PyTorch on whatever device its inputs sit on, and its host unpack in
Python.

Frozen copies of the port's plain versions, which its CPU tests hold to
the JAX package: rtlsdr_ft8d_tpu_torch/pipeline.py:99-137 (normalize_peak,
compact_survivors), 172-262 (forward, decode_from_waterfall, main_pass
without the AP rows), 377-433 (unpack_survivors, with the Python
unpack_spot in place of the native batch); ops/waterfall.py:35-61
(waterfall_plain); ops/sync.py:28-66, 112-127, 146-164 (top_k,
sync_scores_plain, chunk_survivors, find_sync); ops/llr.py:44-94, 147-167
(tone_llrs_plain, estimate_snr_flat); ops/ldpc.py:23-96, 126-135
(bp_decode_plain, crc_check). The BP copy also counts, per row, the
iterations a decoder that stops at its first error-free iteration runs.

Float32 matmuls run at the precision `precision()` sets: "f32" (TF32
off, as the port's configuration states) or "tf32", the control.
"""

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from . import tables
from .protocol.constants import (COSTAS_PATTERN, FREQ_OSR, FT8_LDPC_K,
                                 FT8_LDPC_M, FT8_LDPC_N, FT8_ND, GRAY_MAP,
                                 K_LDPC_ITERS, K_MAX_CANDIDATES,
                                 K_MAX_MESSAGES, K_MIN_SCORE, NFFT, NUM_BIN,
                                 NUM_BLOCKS, SUB_BLOCK_SIZE, TIME_OSR,
                                 TONE_SPACING_HZ)
from .protocol.text import CallsignHashTable
from .protocol.unpack import UnpackError, unpack_spot

NUM_FRAMES = NUM_BLOCKS * TIME_OSR                  # 184
NUM_SEGMENTS = NFFT // SUB_BLOCK_SIZE               # 4
NUM_BLOCKS_RAW = NUM_FRAMES + NUM_SEGMENTS - 1      # 187
USED_SAMPLES = NUM_BLOCKS_RAW * SUB_BLOCK_SIZE      # 47872
NUM_FREQ_OFFSETS = NUM_BIN - 7                      # 249
CHUNK = 16
CHUNK_K = 4
PAD_SCORE = -(1 << 20)
PAD_WIDTH = NUM_FREQ_OFFSETS + (-NUM_FREQ_OFFSETS) % CHUNK    # 256
DATA_SYM = np.array([k + (7 if k < 29 else 14) for k in range(FT8_ND)],
                    dtype=np.int64)
BIT_SET = np.array([[(j >> (2 - b)) & 1 for j in range(8)]
                    for b in range(3)], dtype=bool)
CAND_KEYS = ("time_sub", "freq_sub", "time_offset", "freq_offset")


@dataclass(frozen=True)
class Decode:
    """One decoded message as the harness compares it."""
    text: str
    freq_hz: float
    time_sec: float
    score: int
    snr_db: float


@contextlib.contextmanager
def precision(mode: str):
    """Float32 matmuls in full float32 ("f32") or in TF32 ("tf32") inside
    the block; the previous settings are restored after it."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"precision must be f32 or tf32, got {mode!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


@functools.cache
def _host_tables():
    cos, sin, cms = tables.dft_bases()
    var, slot, slot_edge = tables.edge_maps()
    return {"cos": cos, "sin": sin, "cms": cms,
            "sync_count": tables.sync_count(),
            "edge_var": var, "edge_slot": slot, "slot_edge": slot_edge,
            "crc_mat": tables.crc_matrix(),
            "data_sym": DATA_SYM, "gray": GRAY_MAP.astype(np.int64),
            "bit_set": BIT_SET,
            "bit_weights": (1 << np.arange(7, -1, -1)).astype(np.int32)}


@functools.cache
def device_tables(device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device)
            for k, v in _host_tables().items()}


def normalize_peak(i_samples, q_samples):
    peak = torch.maximum(i_samples.abs().amax(-1, keepdim=True),
                         q_samples.abs().amax(-1, keepdim=True))
    scale = torch.full_like(peak, 0.5) / torch.clamp(peak, min=1e-12)
    return i_samples * scale, q_samples * scale


def _frames(x):
    bl = x[..., :USED_SAMPLES].reshape(
        x.shape[:-1] + (NUM_BLOCKS_RAW, SUB_BLOCK_SIZE))
    return torch.cat([bl[..., j:j + NUM_FRAMES, :]
                      for j in range(NUM_SEGMENTS)], dim=-1)


def waterfall(i_samples, q_samples, t):
    """(B, 48000) float32 -> (B, 92, 2, 2, 256) uint8 by three matmuls."""
    i_f = _frames(i_samples)
    q_f = _frames(q_samples)
    p1 = torch.matmul(i_f, t["cos"])
    p2 = torch.matmul(q_f, t["sin"])
    p3 = torch.matmul(i_f + q_f, t["cms"])
    re = p1 + p2
    im = p3 - p1 + p2
    mag2 = re * re + im * im
    db = 10.0 * torch.log10(1e-12 + mag2 * (4.0 / (NFFT * NFFT)))
    scaled = torch.trunc(2.0 * db + 240.0)
    q = torch.clamp(scaled, 0.0, 255.0).to(torch.uint8)
    q = q.reshape(q.shape[:-2] + (NUM_BLOCKS, TIME_OSR, NUM_BIN, FREQ_OSR))
    return q.transpose(-1, -2).contiguous()


def top_k(x, k):
    """jax.lax.top_k's order: descending, lower index first among ties."""
    n = x.shape[-1]
    rev = torch.arange(n - 1, -1, -1, device=x.device, dtype=torch.int64)
    key = x.to(torch.int64) * n + rev
    idx = torch.topk(key, k, dim=-1, sorted=True).indices
    return x.gather(-1, idx), idx


def sync_scores(wf, count):
    """(..., 92, 2, 2, 256) uint8 -> (..., 2, 2, 36, 249) int32."""
    w = wf.to(torch.int32).movedim(-4, -2)
    dl = F.pad(w[..., :, 1:] - w[..., :, :-1], (1, 0))
    dh = F.pad(w[..., :, :-1] - w[..., :, 1:], (0, 1))
    dp = F.pad(w[..., 1:, :] - w[..., :-1, :], (0, 0, 1, 0))
    dn = F.pad(w[..., :-1, :] - w[..., 1:, :], (0, 0, 0, 1))
    s4 = dl + dh + dp + dn
    variants = {"all": s4, "no_dp": s4 - dp, "no_dl": s4 - dl,
                "no_dn": s4 - dn}

    def fold(e):
        ep = F.pad(e, (0, 0, 12, 10))
        return ep[..., 0:42, :] + ep[..., 36:78, :] + ep[..., 72:114, :]

    folded = {v: fold(e) for v, e in variants.items()}
    score = None
    for k in range(7):
        sm = int(COSTAS_PATTERN[k])
        v = {0: "no_dp", 3: "no_dl", 6: "no_dn"}.get(k, "all")
        term = folded[v][..., k:k + tables.NUM_TIME_OFFSETS,
                         sm:sm + NUM_FREQ_OFFSETS]
        score = term if score is None else score + term
    cnt = count.to(torch.int32)[:, None]
    return torch.sign(score) * torch.div(score.abs(), cnt,
                                         rounding_mode="floor")


def find_sync(wf, count, num_candidates=K_MAX_CANDIDATES):
    """Top-K candidates by sync score in two stages (the top 4 of each
    16-cell chunk, then the global top-K over those)."""
    scores = sync_scores(wf, count)
    batch_shape = scores.shape[:-4]
    sp = F.pad(scores, (0, PAD_WIDTH - NUM_FREQ_OFFSETS), value=PAD_SCORE)
    chunks = sp.reshape(batch_shape + (-1, CHUNK))
    v1, i1 = top_k(chunks, CHUNK_K)
    base = (torch.arange(chunks.shape[-2], device=wf.device) * CHUNK)[:, None]
    v1 = v1.reshape(batch_shape + (-1,))
    gidx = (i1 + base).reshape(batch_shape + (-1,))
    top, sel = top_k(v1, num_candidates)
    idx = gidx.gather(-1, sel).to(torch.int64)
    fo = idx % PAD_WIDTH
    rest = idx // PAD_WIDTH
    to = rest % tables.NUM_TIME_OFFSETS + tables.TIME_OFFSET_MIN
    rest = rest // tables.NUM_TIME_OFFSETS
    return {"score": top.to(torch.int64), "time_sub": rest // 2,
            "freq_sub": rest % 2, "time_offset": to, "freq_offset": fo}


def _llrs_from_mags(s2, valid, t):
    s2e = s2[..., None, :]
    neg = torch.tensor(-1e30, dtype=s2.dtype, device=s2.device)
    max_set = torch.where(t["bit_set"], s2e, neg).amax(-1)
    max_clr = torch.where(t["bit_set"], neg, s2e).amax(-1)
    logl = torch.where(valid[..., None], max_set - max_clr, 0.0)
    log174 = logl.reshape(s2.shape[:-2] + (FT8_LDPC_N,))
    s = log174.sum(-1, keepdim=True)
    s2sum = (log174 * log174).sum(-1, keepdim=True)
    inv_n = 1.0 / FT8_LDPC_N
    var = (s2sum - s * s * inv_n) * inv_n
    norm = torch.sqrt(torch.full_like(var, 24.0) / torch.clamp(var, 1e-12))
    return log174 * norm


def tone_llrs(wf, cand_flat, chan, t):
    """(s2 (N, 58, 8), valid (N, 58), llr (N, 174)) of flat candidates."""
    ts, fs, to, fo = (cand_flat[k].to(torch.int64) for k in CAND_KEYS)
    chan = chan.to(torch.int64)
    to = torch.clamp(to, -12, 23)
    fo = torch.clamp(fo, 0, NUM_BIN - 8)
    blocks = to[:, None] + t["data_sym"]
    valid = (blocks >= 0) & (blocks < NUM_BLOCKS)
    base = ((((chan[:, None] * NUM_BLOCKS + blocks.clamp(0, NUM_BLOCKS - 1))
              * 2 + ts[:, None]) * 2 + fs[:, None]) * NUM_BIN
            + fo[:, None])
    s2 = wf.reshape(-1)[base[..., None] + t["gray"]].to(torch.float32)
    s2 = torch.where(valid[..., None], s2, 0.0)
    return s2, valid, _llrs_from_mags(s2, valid, t)


def estimate_snr_flat(wf, cand_flat, chan, t):
    s2, valid, _ = tone_llrs(wf, cand_flat, chan, t)
    peak = s2.amax(-1)
    nvalid = torch.clamp(valid.sum(-1), min=1)
    sig_half_db = torch.where(valid, peak, 0.0).sum(-1) / nvalid
    wf_f = wf.reshape(wf.shape[0], -1).to(torch.float32)
    m1 = wf_f.mean(-1, keepdim=True)
    below = (wf_f <= m1).to(torch.float32)
    noise_half_db = ((wf_f * below).sum(-1)
                     / torch.clamp(below.sum(-1), min=1.0) + 9.9)
    return 0.5 * (sig_half_db - noise_half_db[chan]) - 26.0


def _fast_tanh(x):
    x = torch.clamp(x, -4.97, 4.97)
    x2 = x * x
    return x * (945.0 + x2 * (105.0 + x2)) \
        / (945.0 + x2 * (420.0 + 15.0 * x2))


def _fast_atanh(x):
    x2 = x * x
    return x * (945.0 + x2 * (-735.0 + x2 * 64.0)) \
        / (945.0 + x2 * (-1050.0 + x2 * 225.0))


def bp_decode(llr, t, max_iters=K_LDPC_ITERS):
    """(N, 174) LLRs (positive = bit 1) -> (hard (N, 174) int8, errors
    (N,) int32, iterations (N,) int64). `iterations` is what a decoder
    that stops a row at its first error-free iteration runs on it: that
    iteration's number (1-based), max_iters if none, 0 for an all-zero
    row, whose outputs are fixed."""
    l = llr.reshape(-1, FT8_LDPC_N).to(torch.float32)
    N = l.shape[0]
    var = t["edge_var"]
    valid = var >= 0
    var = var.clamp(min=0)
    slot = t["edge_slot"].clamp(min=0)
    slot_edge = t["slot_edge"]
    tov = torch.zeros((N, FT8_LDPC_N * 3), dtype=torch.float32,
                      device=l.device)
    best_err = torch.full((N,), FT8_LDPC_M, dtype=torch.int32,
                          device=l.device)
    best_hard = torch.zeros((N, FT8_LDPC_N), dtype=torch.int8,
                            device=l.device)
    iters = torch.full((N,), max_iters, dtype=torch.int64, device=l.device)

    for it in range(max_iters):
        t3 = tov.view(N, FT8_LDPC_N, 3)
        post = l + ((t3[..., 0] + t3[..., 1]) + t3[..., 2])
        hard = post > 0
        ones = (hard[:, var] & valid).view(N, FT8_LDPC_M, 7).sum(-1)
        errors = (ones % 2).sum(-1).to(torch.int32)
        errors = torch.where(hard.any(-1), errors, FT8_LDPC_M)
        iters = torch.where((errors == 0) & (iters == max_iters),
                            min(it + 1, max_iters), iters)
        better = errors < best_err
        best_err = torch.where(better, errors, best_err)
        best_hard = torch.where(better[:, None], hard.to(torch.int8),
                                best_hard)
        diff = post[:, var] - tov[:, slot]
        toc = torch.where(valid, _fast_tanh(-0.5 * diff), 1.0)
        toc7 = toc.view(N, FT8_LDPC_M, 7)
        fwd = [torch.ones_like(toc7[..., 0])]
        bwd = [torch.ones_like(toc7[..., 0])]
        for j in range(6):
            fwd.append(fwd[-1] * toc7[..., j])
            bwd.append(bwd[-1] * toc7[..., 6 - j])
        excl = torch.stack([fwd[j] * bwd[6 - j] for j in range(7)],
                           dim=-1).view(N, tables.NUM_EDGES)
        val = torch.clamp(excl[:, slot_edge], -0.999999, 0.999999)
        tov = -2.0 * _fast_atanh(val)
    iters = torch.where((l != 0).any(-1), iters, 0)
    return best_hard, best_err, iters


def crc_check(hard, crc_mat):
    payload = hard[..., :77].to(torch.float32)
    expect = torch.remainder(torch.matmul(payload, crc_mat.to(torch.float32)),
                             2.0)
    got = hard[..., 77:FT8_LDPC_K].to(torch.float32)
    return (expect == got).all(-1)


def forward(i_samples, q_samples, budget=None,
            num_candidates=K_MAX_CANDIDATES, ldpc_iters=K_LDPC_ITERS):
    """(B, 48000) float32 I/Q -> the compacted survivor dict of one pass,
    plus "bp_iterations": the row-iterations the BP rows need, and
    "bp_rows": the number of BP rows."""
    t = device_tables(i_samples.device)
    i_n, q_n = normalize_peak(i_samples, q_samples)
    wf = waterfall(i_n, q_n, t)
    cand = find_sync(wf, t["sync_count"], num_candidates)
    B, K = cand["score"].shape
    if budget and budget < B * K:
        _, sel = top_k(cand["score"].reshape(-1), budget)
        cand_flat = {k: cand[k].reshape(-1)[sel] for k in CAND_KEYS}
        chan = sel // K
        scores = cand["score"].reshape(-1)[sel]
    else:
        sel = None
        cand_flat = {k: cand[k].reshape(-1) for k in CAND_KEYS}
        chan = torch.arange(B, device=wf.device).repeat_interleave(K)
        scores = cand["score"].reshape(-1)
    llrs = tone_llrs(wf, cand_flat, chan, t)[2]
    hard, errors, iters = bp_decode(llrs, t, ldpc_iters)
    ok = (errors == 0) & crc_check(hard, t["crc_mat"]) & (scores >= K_MIN_SCORE)
    if sel is not None:
        hard_f = hard.new_zeros((B * K, FT8_LDPC_N))
        hard_f[sel] = hard
        errors_f = errors.new_full((B * K,), FT8_LDPC_M)
        errors_f[sel] = errors
        ok_f = ok.new_zeros((B * K,))
        ok_f[sel] = ok
        hard, errors, ok = hard_f, errors_f, ok_f
    hard = hard.view(B, K, FT8_LDPC_N)
    errors = errors.view(B, K)
    ok = ok.view(B, K)

    key = torch.where(ok, -cand["score"], 1 << 20)
    order = torch.sort(key, dim=-1, stable=True).indices[..., :K_MAX_MESSAGES]
    take = lambda x: x.gather(-1, order)                      # noqa: E731
    hard_k = hard[..., :FT8_LDPC_K].gather(
        -2, order[..., None].expand(order.shape + (FT8_LDPC_K,)))
    bits96 = F.pad(hard_k.to(torch.int32), (0, 96 - FT8_LDPC_K))
    packed = (bits96.reshape(bits96.shape[:-1] + (12, 8)) * t["bit_weights"]) \
        .sum(-1).to(torch.uint8)
    cand50 = {k: take(cand[k]) for k in CAND_KEYS}
    kk = cand50["time_sub"].shape[-1]
    chan50 = torch.arange(B, device=wf.device).repeat_interleave(kk)
    snr50 = estimate_snr_flat(
        wf, {k: v.reshape(-1) for k, v in cand50.items()}, chan50, t)
    snr50 = torch.round(snr50.reshape(B, kk) * 2.0).to(torch.int32) / 2.0
    out = {"packed": packed, "ok": take(ok),
           "score": take(cand["score"]).to(torch.int32), "snr_db": snr50,
           "time_sub": cand50["time_sub"].to(torch.uint8),
           "freq_sub": cand50["freq_sub"].to(torch.uint8),
           "time_offset": cand50["time_offset"].to(torch.int8),
           "freq_offset": cand50["freq_offset"].to(torch.int32)}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["bp_iterations"] = int(iters.sum().item())
    out["bp_rows"] = int(llrs.shape[0])
    return out


def unpack_survivors(out, n_channels, hashes):
    """Per-channel Decode lists of a survivor dict: unpack in rank order,
    first occurrence of each text kept; `hashes` one table per channel."""
    results = [[] for _ in range(n_channels)]
    b_idx, k_idx = np.nonzero(out["ok"])
    seen = [set() for _ in range(n_channels)]
    for b, k in zip(b_idx.tolist(), k_idx.tolist()):
        bits = np.unpackbits(out["packed"][b, k])
        try:
            text = unpack_spot(bits[:77], hashes[b])[0]
        except UnpackError:
            continue
        if text in seen[b]:
            continue
        seen[b].add(text)
        freq_hz = (out["freq_offset"][b, k] + out["freq_sub"][b, k] / 2.0) \
            * TONE_SPACING_HZ
        time_sec = (out["time_offset"][b, k] + out["time_sub"][b, k] / 2.0) \
            * 0.16
        results[b].append(Decode(text, float(freq_hz), float(time_sec),
                                 int(out["score"][b, k]),
                                 float(out["snr_db"][b, k])))
    return results


def decode_window(i_samples, q_samples, budget=None, hashes=None,
                  mode="f32"):
    """(B, 48000) float32 I/Q tensors -> (per-channel Decode lists,
    {"bp_iterations", "bp_rows"}), the matmuls at `mode`'s precision."""
    B = i_samples.shape[0]
    hashes = hashes or [CallsignHashTable() for _ in range(B)]
    with torch.no_grad(), precision(mode):
        out = forward(i_samples.float(), q_samples.float(), budget)
    return (unpack_survivors(out, B, hashes),
            {"bp_iterations": out["bp_iterations"],
             "bp_rows": out["bp_rows"]})
