"""Single-window FT8 decode: the device graph as an nn.Module plus the
host unpack.

Port of rtlsdr_ft8d_tpu/pipeline.py for one pass without AP or deep
decode (osd_cands=0): -3 dB peak normalization -> waterfall -> Costas
sync top-K -> (optional global candidate budget) -> LLRs -> BP -> CRC ->
survivor compaction on the device; unpack and dedup on the host.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rtlsdr_ft8d_tpu.protocol.constants import (FT8_LDPC_K, FT8_LDPC_M,
                                                FT8_LDPC_N, K_LDPC_ITERS,
                                                K_MAX_CANDIDATES,
                                                K_MAX_MESSAGES, K_MIN_SCORE,
                                                TONE_SPACING_HZ)
from rtlsdr_ft8d_tpu.protocol.text import CallsignHashTable
from rtlsdr_ft8d_tpu.protocol.unpack import unpack_spots_batch

from .ops import tables
from .ops.ldpc import bp_decode, crc_check
from .ops.llr import (CAND_KEYS, estimate_snr, extract_llrs,
                      extract_llrs_flat)
from .ops.sync import find_sync, top_k
from .ops.waterfall import waterfall

_NOT_PORTED = ("is not ported to the PyTorch package yet; it is queued in "
               "ROADMAP.md (Queue 1)")


# Copied from rtlsdr_ft8d_tpu/pipeline.py:43-89 (that module imports jax).
@dataclass
class Decode:
    """One decoded message (reference `decoder_results` + full text).

    call/loc/is_cq come from the 77-bit payload FIELDS when the decode was
    produced by the pipeline (protocol/unpack.py:unpack_spot); the text
    heuristics below are only the fallback for hand-constructed instances
    (the reference strtok-parses text, c:1509-1521, which misparses
    'CQ RAEM KO85')."""
    text: str
    freq_hz: float
    time_sec: float
    score: int
    snr_db: float = 0.0
    call_field: str | None = None
    loc_field: str | None = None
    cq_field: bool | None = None

    @property
    def is_cq(self) -> bool:
        if self.cq_field is not None:
            return self.cq_field
        return self.text.startswith("CQ")

    @property
    def call(self) -> str:
        if self.call_field is not None:
            return self.call_field
        parts = self.text.split()
        if self.is_cq:
            # 'CQ CALL GRID' or directed 'CQ DX|nnn|AAAA CALL GRID'
            idx = 1
            if len(parts) > 3 and (parts[1] == "DX" or parts[1].isdigit()
                                   or (parts[1].isalpha()
                                       and len(parts[1]) <= 4)):
                idx = 2
            return parts[idx] if len(parts) > idx else ""
        return parts[0] if parts else ""

    @property
    def loc(self) -> str:
        if self.loc_field is not None:
            return self.loc_field
        if not self.is_cq:
            return ""
        parts = self.text.split()
        return parts[-1] if len(parts) >= 3 and len(parts[-1]) == 4 else ""


def normalize_peak(i_samples, q_samples):
    """Scale each channel to a -3 dB peak (reference C9 normalizer,
    rtlsdr_ft8d_tpu/pipeline.py:192-197); the scale is a true division,
    as in the JAX graph (`0.5 / tensor` would be reciprocal() * 0.5)."""
    peak = torch.maximum(i_samples.abs().amax(-1, keepdim=True),
                         q_samples.abs().amax(-1, keepdim=True))
    scale = torch.full_like(peak, 0.5) / torch.clamp(peak, min=1e-12)
    return i_samples * scale, q_samples * scale


def compact_survivors(wf, cand, hard, errors, ok):
    """Keep at most K_MAX_MESSAGES CRC-clean candidates per channel, best
    score first (stable among equals), with their 91 message bits packed
    into 12 bytes (rtlsdr_ft8d_tpu/pipeline.py:360-397)."""
    key = torch.where(ok, -cand["score"], 1 << 20)
    order = torch.sort(key, dim=-1, stable=True).indices[..., :K_MAX_MESSAGES]
    take = lambda x: x.gather(-1, order)                      # noqa: E731
    hard_k = hard[..., :FT8_LDPC_K].gather(
        -2, order[..., None].expand(order.shape + (FT8_LDPC_K,)))
    bits96 = F.pad(hard_k.to(torch.int32), (0, 96 - FT8_LDPC_K))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=hard.device)
    packed = (bits96.reshape(bits96.shape[:-1] + (12, 8)) * weights) \
        .sum(-1).to(torch.uint8)
    cand50 = {k: take(cand[k]) for k in CAND_KEYS}
    snr50 = torch.round(estimate_snr(wf, cand50) * 2.0).to(torch.int32) / 2.0
    count = lambda m: m.to(torch.int32).sum(-1)               # noqa: E731
    return {
        "packed": packed,                                   # (B, 50, 12)
        "n_ok": count(ok),
        "n_above_min": count(cand["score"] >= K_MIN_SCORE),
        "n_ldpc_ok": count(errors == 0),
        "ok": take(ok),
        "score": take(cand["score"]).to(torch.int32),
        "snr_db": snr50,
        "time_sub": cand50["time_sub"].to(torch.uint8),
        "freq_sub": cand50["freq_sub"].to(torch.uint8),
        "time_offset": cand50["time_offset"].to(torch.int8),
        "freq_offset": cand50["freq_offset"].to(torch.int32),
    }


class WindowDecoder(nn.Module):
    """The device side of one decode pass, holding the static tables
    (ops/tables.py) as buffers; `forward` is decode_window_device
    (rtlsdr_ft8d_tpu/pipeline.py:170-357) with osd_cands=0 and no AP."""

    def __init__(self, buffers: dict[str, torch.Tensor] | None = None):
        super().__init__()
        if buffers is None:
            buffers = tables.from_reference(tables.reference_arrays())
        for name, t in buffers.items():
            self.register_buffer(name, t, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.wf_cos.device

    def bp(self, llr, max_iters=K_LDPC_ITERS, return_posterior=False):
        return bp_decode(llr, self.ldpc_edge_var, self.ldpc_edge_slot,
                         self.ldpc_slot_edge, max_iters, return_posterior)

    def forward(self, i_samples: torch.Tensor, q_samples: torch.Tensor,
                budget: int | None = None,
                num_candidates: int = K_MAX_CANDIDATES,
                ldpc_iters: int = K_LDPC_ITERS, sync_exact: bool = False):
        """(B, 48000) float32 I/Q -> the compacted survivor dict."""
        i_samples, q_samples = normalize_peak(i_samples, q_samples)
        wf = waterfall(i_samples, q_samples, self.wf_cos, self.wf_sin,
                       self.wf_cos_minus_sin)
        cand = find_sync(wf, self.sync_count, num_candidates,
                         exact=sync_exact)
        B, K = cand["score"].shape

        # budget in (None, 0) means unbudgeted
        if budget and budget < B * K:
            # global budget: LLRs and BP only for the `budget` best-scoring
            # candidates across channels, scattered back afterwards
            _, sel = top_k(cand["score"].reshape(-1), budget)
            chan_idx = sel // K
            cand_flat = {k: cand[k].reshape(-1)[sel] for k in CAND_KEYS}
            llrs = extract_llrs_flat(wf, cand_flat, chan_idx)
            hard_sel, errors_sel = self.bp(llrs, ldpc_iters)
            hard = hard_sel.new_zeros((B * K, FT8_LDPC_N))
            hard[sel] = hard_sel
            errors = errors_sel.new_full((B * K,), FT8_LDPC_M)
            errors[sel] = errors_sel
            hard = hard.view(B, K, FT8_LDPC_N)
            errors = errors.view(B, K)
        else:
            hard, errors = self.bp(extract_llrs(wf, cand), ldpc_iters)

        ok = ((errors == 0) & crc_check(hard, self.crc_mat)
              & (cand["score"] >= K_MIN_SCORE))
        return compact_survivors(wf, cand, hard, errors, ok)


# Copied from rtlsdr_ft8d_tpu/pipeline.py:487-544 (that module imports jax).
def unpack_survivors(out, n_channels, hashes=None):
    """Host side of a decode pass: batched unpack + dedup of the
    device-compacted survivors. ONE native call covers every survivor of
    every channel (hash-table side effects stay sequential in (channel,
    rank) order, identical to a per-message loop)."""
    per_row_hashes = isinstance(hashes, (list, tuple))
    results = [[] for _ in range(n_channels)]
    sub_params = [[] for _ in range(n_channels)]
    ok_mask = np.asarray(out["ok"])
    b_idx, k_idx = np.nonzero(ok_mask)
    if b_idx.size == 0:
        return results, sub_params
    packed = np.asarray(out["packed"])[b_idx, k_idx]       # (N, 12)
    if per_row_hashes:
        # group by channel so each band's adds/lookups hit its own table
        spots = []
        start = 0
        while start < b_idx.size:
            end = start
            while end < b_idx.size and b_idx[end] == b_idx[start]:
                end += 1
            spots.extend(unpack_spots_batch(packed[start:end],
                                            hashes[b_idx[start]]))
            start = end
    else:
        spots = unpack_spots_batch(packed, hashes)
    bits_all = np.unpackbits(packed, axis=1)               # (N, 96)
    freq_off = np.asarray(out["freq_offset"])[b_idx, k_idx]
    freq_sub = np.asarray(out["freq_sub"])[b_idx, k_idx]
    time_off = np.asarray(out["time_offset"])[b_idx, k_idx]
    time_sub = np.asarray(out["time_sub"])[b_idx, k_idx]
    score = np.asarray(out["score"])[b_idx, k_idx]
    snr = np.asarray(out["snr_db"])[b_idx, k_idx]
    seen = [None] * n_channels
    for n in range(b_idx.size):
        spot = spots[n]
        if spot is None:
            continue
        b = int(b_idx[n])
        text, call, loc, is_cq = spot
        if seen[b] is None:
            seen[b] = set()
        if text in seen[b]:
            continue
        seen[b].add(text)
        freq_hz = (freq_off[n] + freq_sub[n] / 2.0) * TONE_SPACING_HZ
        time_sec = (time_off[n] + time_sub[n] / 2.0) * 0.16
        results[b].append(Decode(text=text, freq_hz=float(freq_hz),
                                 time_sec=float(time_sec),
                                 score=int(score[n]),
                                 snr_db=float(snr[n]),
                                 call_field=call, loc_field=loc,
                                 cq_field=is_cq))
        sub_params[b].append((bits_all[n, :91],
                              int(freq_off[n]) * 2 + int(freq_sub[n]),
                              int(time_off[n]) * 2 + int(time_sub[n])))
    return results, sub_params


def decode_window(iq, hashes: CallsignHashTable | None = None,
                  budget: int | None = None,
                  num_candidates: int = K_MAX_CANDIDATES,
                  ldpc_iters: int = K_LDPC_ITERS,
                  sync_exact: bool = False,
                  passes: int = 1, osd_cands: int = 0, ap_cq: bool = False,
                  ap_call: str | None = None, ap_texts=None,
                  device: str | torch.device = "cuda",
                  decoder: WindowDecoder | None = None):
    """Decode a batch of channels; returns (per channel) Decode lists.

    `iq` may be (48000,) or (B, 48000), complex or an (i, q) tuple of
    float32, as for rtlsdr_ft8d_tpu.pipeline.decode_window. `decoder`
    reuses a WindowDecoder (and its device); otherwise one is built on
    `device`. Multipass, OSD and AP are not ported yet and raise.
    """
    for name, unsupported in (("passes > 1", passes > 1),
                              ("osd_cands > 0", osd_cands > 0),
                              ("ap_cq", ap_cq), ("ap_call", bool(ap_call)),
                              ("ap_texts", ap_texts is not None)):
        if unsupported:
            raise NotImplementedError(f"{name} {_NOT_PORTED}")
    if isinstance(iq, tuple):
        i_s = np.asarray(iq[0], np.float32)
        q_s = np.asarray(iq[1], np.float32)
    else:
        iq = np.asarray(iq)
        i_s = np.real(iq).astype(np.float32)
        q_s = np.imag(iq).astype(np.float32)
    squeeze = i_s.ndim == 1
    if squeeze:
        i_s, q_s = i_s[None], q_s[None]

    if decoder is None:
        decoder = WindowDecoder().to(device)
    dev = decoder.device
    with torch.no_grad():
        out = decoder(torch.from_numpy(np.ascontiguousarray(i_s)).to(dev),
                      torch.from_numpy(np.ascontiguousarray(q_s)).to(dev),
                      budget=budget, num_candidates=num_candidates,
                      ldpc_iters=ldpc_iters, sync_exact=sync_exact)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    results, _ = unpack_survivors(out, i_s.shape[0], hashes)
    return results[0] if squeeze else results
