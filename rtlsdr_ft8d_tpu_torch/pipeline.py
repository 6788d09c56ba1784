"""Single-window FT8 decode: the device graph as an nn.Module plus the
host unpack.

Port of rtlsdr_ft8d_tpu/pipeline.py: -3 dB peak normalization ->
waterfall -> Costas sync top-K -> (optional global candidate budget) ->
LLRs -> BP -> CRC, then the a-priori clamp rows (ops/ap.py, their BP in
the same launch as the main pass) and the codeword bank, then with
osd_cands > 0 the deep decode of the best BP failures (ops/refine.py
matched filters, one BP launch over every rung, the bank again) ->
survivor compaction on the device; unpack and dedup on the host; the
ordered-statistics reprocessing of the deep decode's posteriors
(ops/osd.py) where they lie, on the card or on the host; with passes >
1, subtraction of the decoded signals (ops/subtract.py) and a decode of
the residual.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .host.log import NO_TIMER, WindowStats
from .ops import build, subtract, tables
from .ops.ap import (apply_clamp, bank_correlate, clamp_row_cq,
                     clamp_row_to_call, codeword_signs)
from .ops.ldpc import bp_decode, crc_check
from .ops.llr import (CAND_KEYS, estimate_snr, estimate_snr_flat,
                      extract_llrs, extract_llrs_flat)
from .ops.osd import osd_rows, runs_on_card
from .ops.refine import refine_llrs_flat
from .ops.sync import find_sync, top_k
from .ops.waterfall import waterfall
from .protocol.constants import (FT8_LDPC_K, FT8_LDPC_M, FT8_LDPC_N,
                                 K_LDPC_ITERS, K_MAX_CANDIDATES,
                                 K_MAX_MESSAGES, K_MIN_SCORE, TONE_SPACING_HZ)
from .protocol.text import CallsignHashTable
from .protocol.unpack import UnpackError, unpack_spot, unpack_spot_columns

MAX_OSD = 1024          # global cap on the deep decode's selection
# the deep decode's fields that _decode_pass leaves on the decoder's device
OSD_POSTERIORS = ("osd_post", "osd_post_coh")


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


# Copied from rtlsdr_ft8d_tpu/pipeline.py:92-97 (that module imports jax).
def ap_prefix_for_call(call: str) -> np.ndarray | None:
    """(77,) ±1/0 clamp row hypothesizing a message addressed TO `call`
    (the operator's own callsign in the daemon); None if the call has no
    fixed c28 bits. Thin wrapper over ops/ap.py (the AP module)."""
    return clamp_row_to_call(call)


def normalize_peak(i_samples, q_samples):
    """Scale each channel to a -3 dB peak (reference C9 normalizer,
    rtlsdr_ft8d_tpu/pipeline.py:192-197); the scale is a true division,
    as in the JAX graph (`0.5 / tensor` would be reciprocal() * 0.5)."""
    peak = torch.maximum(i_samples.abs().amax(-1, keepdim=True),
                         q_samples.abs().amax(-1, keepdim=True))
    scale = torch.full_like(peak, 0.5) / torch.clamp(peak, min=1e-12)
    return i_samples * scale, q_samples * scale


def compact_survivors(wf, cand, hard, errors, ok, bit_weights):
    """Keep at most K_MAX_MESSAGES CRC-clean candidates per channel, best
    score first (stable among equals), with their 91 message bits packed
    into 12 bytes (rtlsdr_ft8d_tpu/pipeline.py:360-397); `bit_weights` is
    the decoder's (8,) int32 buffer 128, 64, ..., 1."""
    key = torch.where(ok, -cand["score"], 1 << 20)
    order = torch.sort(key, dim=-1, stable=True).indices[..., :K_MAX_MESSAGES]
    take = lambda x: x.gather(-1, order)                      # noqa: E731
    hard_k = hard[..., :FT8_LDPC_K].gather(
        -2, order[..., None].expand(order.shape + (FT8_LDPC_K,)))
    bits96 = F.pad(hard_k.to(torch.int32), (0, 96 - FT8_LDPC_K))
    packed = (bits96.reshape(bits96.shape[:-1] + (12, 8)) * bit_weights) \
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
    (rtlsdr_ft8d_tpu/pipeline.py:170-357): `waterfall`, then
    `decode_from_waterfall`."""

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

    def _waterfall(self, i_n: torch.Tensor, q_n: torch.Tensor):
        return waterfall(i_n, q_n, self.wf_cos, self.wf_sin,
                         self.wf_cos_minus_sin, self.wf_twiddle,
                         self.wf_window)

    def waterfall(self, i_samples: torch.Tensor, q_samples: torch.Tensor):
        """(B, 48000) float32 I/Q -> peak-normalized (B, 92, 2, 2, 256)
        uint8 waterfall: the kernel on a CUDA decoder, the plain version
        on a CPU one."""
        return self._waterfall(*normalize_peak(i_samples, q_samples))

    def forward(self, i_samples: torch.Tensor, q_samples: torch.Tensor, *,
                budget: int | None = None, osd_cands: int = 0,
                ap_clamp_signs: torch.Tensor | None = None,
                ap_cw_signs: torch.Tensor | None = None, timer=NO_TIMER):
        """The forward contract every decoder of decode_window honours
        (parallel/elastic.ElasticDecoder too): (B, 48000) float32 I/Q on
        `self.device` -> the compacted survivor dict as tensors on that
        device (with the osd_* fields when osd_cands > 0). The deep
        decode refines from the peak-normalized samples; `timer` records
        its span."""
        i_n, q_n = normalize_peak(i_samples, q_samples)
        return self.decode_from_waterfall(
            self._waterfall(i_n, q_n), budget=budget, osd_cands=osd_cands,
            ap_clamp_signs=ap_clamp_signs, ap_cw_signs=ap_cw_signs,
            samples=(i_n, q_n), timer=timer)

    def decode_from_waterfall(self, wf: torch.Tensor, *,
                              budget: int | None = None,
                              osd_cands: int = 0,
                              ap_clamp_signs: torch.Tensor | None = None,
                              ap_cw_signs: torch.Tensor | None = None,
                              samples: tuple | None = None,
                              timer=NO_TIMER):
        """(B, 92, 2, 2, 256) uint8 waterfall -> the compacted survivor
        dict: sync, the optional global budget, LLRs, BP and CRC; the
        clamp rows `ap_clamp_signs` (H, 77) and the codeword bank
        `ap_cw_signs` (H, 174), if given; with osd_cands > 0 the deep
        decode, which needs the peak-normalized (i, q) `samples`, in the
        span "deep" of `timer`."""
        if osd_cands > 0 and samples is None:
            raise ValueError("osd_cands > 0 needs the normalized samples")
        cand = self.candidates(wf)
        B, K = cand["score"].shape
        ap_rows = [] if ap_clamp_signs is None else list(ap_clamp_signs)

        # budget in (None, 0) means unbudgeted
        sel = None
        if budget and budget < B * K:
            _, sel = top_k(cand["score"].reshape(-1), budget)
        hard, errors, ok = self.main_pass(wf, cand, sel, ap_rows,
                                          ap_cw_signs)
        if osd_cands <= 0:
            return compact_survivors(wf, cand, hard, errors, ok,
                                     self.bit_weights)

        # deep decode (rtlsdr_ft8d_tpu/pipeline.py:306-356) of the best BP
        # failures across the batch
        flat_rank, failed = self.osd_rank(cand, errors,
                                          cand["score"] >= K_MIN_SCORE)
        _, sel_f = top_k(flat_rank, min(B * osd_cands, MAX_OSD, B * K))
        hard, errors, ok, osd = self.deep_pass(
            samples, wf, cand, hard, errors, ok, failed, sel_f, ap_rows,
            ap_cw_signs, timer)
        out = compact_survivors(wf, cand, hard, errors, ok, self.bit_weights)
        out.update(osd)
        return out

    # The stages of decode_from_waterfall, which the sharded and dense
    # decodes (parallel/) also run on each shard.

    def candidates(self, wf: torch.Tensor) -> dict:
        """find_sync's (B, K_MAX_CANDIDATES) candidate grid of a
        waterfall."""
        return find_sync(wf, self.sync_count)

    def main_pass(self, wf, cand, sel, ap_rows, ap_cw_signs):
        """LLRs, BP and CRC, the clamp rows and the bank on every
        candidate of the (B, K) grid (`sel` None) or on the flat indices
        `sel` into it (the global budget), scattered back: hard 0, errors
        83 and ok False elsewhere. Returns (hard (B, K, 174), errors
        (B, K), ok (B, K))."""
        if sel is None:
            return self._main_and_ap(extract_llrs(wf, cand), cand["score"],
                                     ap_rows, ap_cw_signs)
        B, K = cand["score"].shape
        cand_flat = {k: cand[k].reshape(-1)[sel] for k in CAND_KEYS}
        llrs = extract_llrs_flat(wf, cand_flat, sel // K)
        hard, errors, ok = self._main_and_ap(
            llrs, cand["score"].reshape(-1)[sel], ap_rows, ap_cw_signs)
        hard_f = hard.new_zeros((B * K, FT8_LDPC_N))
        hard_f[sel] = hard
        errors_f = errors.new_full((B * K,), FT8_LDPC_M)
        errors_f[sel] = errors
        ok_f = ok.new_zeros((B * K,))
        ok_f[sel] = ok
        return (hard_f.view(B, K, FT8_LDPC_N), errors_f.view(B, K),
                ok_f.view(B, K))

    @staticmethod
    def osd_rank(cand, errors, eligible):
        """The deep decode's ranking: (the flat (B*K,) scores of the BP
        failures among the `eligible` candidates, -1 elsewhere; the
        (B, K) failed mask). Its top_k is the selection."""
        failed = (errors > 0) & eligible
        return torch.where(failed, cand["score"], -1).reshape(-1), failed

    def deep_pass(self, samples, wf, cand, hard, errors, ok, failed, sel_f,
                  ap_rows, ap_cw_signs, timer=NO_TIMER):
        """Refine the selected BP failures (flat indices `sel_f` into the
        (B, K) grid) from the (i, q) `samples`, BP on every rung, merge
        the successes into (hard, errors, ok); the posteriors of the rest
        go to the OSD (ops/osd.osd_rows). Returns the merged (hard, errors, ok) and
        the osd_* fields, in the order of `sel_f`. A detailed `timer`
        records the span "deep", also on the device, and counts the
        selection's rows as deep_rows."""
        timer.count("deep_rows", sel_f.numel())
        with timer.stage("deep", device=self.device):
            B, K = cand["score"].shape
            chan_f = sel_f // K
            cand_sel = {k: cand[k].reshape(-1)[sel_f] for k in CAND_KEYS}
            llr_ref, _, llr_pair, llr_coh = refine_llrs_flat(
                *samples, cand_sel, chan_f, self.refine_cos, self.refine_sin)
            was_failed = failed.reshape(-1)[sel_f]
            score_sel = cand["score"].reshape(-1)[sel_f]
            hard_r, ok_r, post_r, post_c = self.deep_rungs(
                llr_ref, llr_pair, llr_coh, was_failed, score_sel, ap_rows,
                ap_cw_signs)
            # sel_f holds each index once, so the writes do not collide
            hard = hard.reshape(B * K, FT8_LDPC_N)
            hard[sel_f] = torch.where(ok_r[:, None], hard_r, hard[sel_f])
            errors = errors.reshape(-1)
            errors[sel_f] = torch.where(ok_r, 0, errors[sel_f])
            ok = ok.reshape(-1)
            ok[sel_f] = ok[sel_f] | ok_r
            return (hard.view(B, K, FT8_LDPC_N), errors.view(B, K),
                    ok.view(B, K), {
                        "osd_post": post_r,                  # (n_osd, 174)
                        "osd_post_coh": post_c,              # (n_osd, 174)
                        "osd_valid": was_failed & ~ok_r,     # (n_osd,)
                        "osd_chan": chan_f.to(torch.int32),
                        "osd_score": score_sel.to(torch.int32),
                        "osd_snr_db": estimate_snr_flat(wf, cand_sel,
                                                        chan_f),
                        "osd_time_sub": cand_sel["time_sub"].to(torch.uint8),
                        "osd_freq_sub": cand_sel["freq_sub"].to(torch.uint8),
                        "osd_time_offset": cand_sel["time_offset"].to(
                            torch.int8),
                        "osd_freq_offset": cand_sel["freq_offset"].to(
                            torch.int32)})

    def _main_and_ap(self, llrs, scores, ap_rows, ap_cw_signs,
                     eligible=None):
        """BP of the main pass and, in the same launch, of one clamped
        copy per AP row (rtlsdr_ft8d_tpu/pipeline.py:244-304); a row's
        accepts count only where the main pass and the rows before it
        failed. Then the codeword bank. Only `eligible` candidates are
        accepted (default: scores >= K_MIN_SCORE; the dense decode passes
        its global selection). Returns (hard, errors, ok) in the shape of
        `scores`."""
        if ap_rows:
            hard_all, err_all = self.bp(torch.stack(
                [llrs] + [apply_clamp(llrs, s) for s in ap_rows]))
        else:
            hard, errors = self.bp(llrs)
            hard_all, err_all = hard[None], errors[None]
        if eligible is None:
            eligible = scores >= K_MIN_SCORE
        ok_all = (err_all == 0) & crc_check(hard_all, self.crc_mat) & eligible
        hard, errors, ok = hard_all[0], err_all[0], ok_all[0]
        for r in range(1, len(ap_rows) + 1):
            ok_ap = ok_all[r] & ~ok
            hard = torch.where(ok_ap[..., None], hard_all[r], hard)
            errors = torch.where(ok_ap, 0, errors)
            ok = ok | ok_ap
        if ap_cw_signs is not None:
            hit, bits = bank_correlate(llrs, ap_cw_signs, scores)
            acc = hit & eligible & ~ok
            hard = torch.where(acc[..., None], bits.to(hard.dtype), hard)
            errors = torch.where(acc, 0, errors)
            ok = ok | acc
        return hard, errors, ok

    def deep_rungs(self, llr_ref, llr_pair, llr_coh, was_failed, score_sel,
                   ap_rows, ap_cw_signs):
        """The deep-decode rung ladder on a flat refined selection
        (rtlsdr_ft8d_tpu/pipeline.py:100-164): BP with the posterior on
        the noncoherent, pair/triple-coherent and block-coherent LLRs and
        on one clamped copy of the pair, block and noncoherent flavors per
        AP row, all rungs in ONE launch; acceptance cascades in that
        order, CRC-gated and only where the main pass failed; then the
        bank on the noncoherent and pair flavors. Returns (hard, ok, the
        pair flavor's posterior, the block-coherent one's)."""
        rungs = [llr_ref, llr_pair, llr_coh]
        for signs in ap_rows:
            rungs += [apply_clamp(base, signs)
                      for base in (llr_pair, llr_coh, llr_ref)]
        hard_all, err_all, post_all = self.bp(torch.stack(rungs),
                                              return_posterior=True)
        ok_all = ((err_all == 0) & crc_check(hard_all, self.crc_mat)
                  & was_failed[None, :])
        hard_r, ok_r = hard_all[0], ok_all[0]
        for m in range(1, len(rungs)):
            ok_m = ok_all[m] & ~ok_r
            hard_r = torch.where(ok_m[:, None], hard_all[m], hard_r)
            ok_r = ok_r | ok_m
        if ap_cw_signs is not None:
            for llr_b in (llr_ref, llr_pair):
                hit_r, bits_r = bank_correlate(llr_b, ap_cw_signs, score_sel)
                ok_cw = hit_r & was_failed & ~ok_r
                hard_r = torch.where(ok_cw[:, None],
                                     bits_r.to(hard_r.dtype), hard_r)
                ok_r = ok_r | ok_cw
        return hard_r, ok_r, post_all[1], post_all[2]


# Port of rtlsdr_ft8d_tpu/pipeline.py:487-544 (that module imports jax).
def unpack_survivors(out, n_channels, hashes=None, *, timer=NO_TIMER):
    """Host side of a decode pass: batched unpack + dedup of the
    device-compacted survivors -> (per-channel Decode lists, per-channel
    subtraction params (bits[:91], freq2, time2)).

    ONE native call covers every survivor of every channel; the hash-
    table side effects stay sequential in (channel, rank) order, each
    channel's on its own table where `hashes` is a per-channel list,
    identical to a per-message loop (protocol/unpack.py:
    unpack_spot_columns). The survivors' fields are computed in bulk;
    Python builds one Decode per text unique in its channel. A detailed
    `timer` counts unpack_fallbacks, the survivors unpacked one at a time
    in Python (a hashed call looked up, or every survivor without the
    native library)."""
    results = [[] for _ in range(n_channels)]
    sub_params = [[] for _ in range(n_channels)]
    b_idx, k_idx = np.nonzero(np.asarray(out["ok"]))
    if b_idx.size == 0:
        timer.count("unpack_fallbacks", 0)
        return results, sub_params
    packed = np.asarray(out["packed"])[b_idx, k_idx]       # (N, 12)
    text, call, loc, is_cq, n_python = unpack_spot_columns(packed, hashes,
                                                          b_idx)
    timer.count("unpack_fallbacks", n_python)
    # the first survivor of each text in its channel, in (channel, rank)
    # order: channel by channel, a dict from the texts in reverse
    b_list = b_idx.tolist()
    cuts = [0] + (np.flatnonzero(np.diff(b_idx)) + 1).tolist() + [len(text)]
    keep = []
    for s, e in zip(cuts[:-1], cuts[1:]):
        keep += sorted(dict(zip(reversed(text[s:e]),
                                range(e - 1, s - 1, -1))).values())
    keep = [n for n in keep if text[n] is not None]
    at = b_idx[keep], k_idx[keep]
    col = lambda k: np.asarray(out[k])[at].astype(np.int64)  # noqa: E731
    freq2 = col("freq_offset") * 2 + col("freq_sub")    # half-bin steps
    time2 = col("time_offset") * 2 + col("time_sub")
    bits91 = np.unpackbits(packed[keep], axis=1)[:, :91]
    for n, f_hz, t_s, f2, t2, score, snr, bits in zip(
            keep, (freq2 / 2.0 * TONE_SPACING_HZ).tolist(),
            (time2 / 2.0 * 0.16).tolist(), freq2.tolist(), time2.tolist(),
            col("score").tolist(),
            np.asarray(out["snr_db"])[at].astype(np.float64).tolist(),
            bits91):
        b = b_list[n]
        results[b].append(Decode(text=text[n], freq_hz=f_hz, time_sec=t_s,
                                 score=score, snr_db=snr,
                                 call_field=call[n], loc_field=loc[n],
                                 cq_field=is_cq[n]))
        sub_params[b].append((bits, f2, t2))
    return results, sub_params


def _decode_pass(decoder, i_t, q_t, hashes, timer, bank_rows=0, **kw):
    """One device pass + host unpack (rtlsdr_ft8d_tpu/pipeline.py:400-418):
    (B, 48000) float32 I/Q on the decoder's device and the forward's
    options -> (per-channel Decode lists, per-channel subtraction params,
    the survivor dict as numpy but the OSD_POSTERIORS, which stay on the
    decoder's device, with n_osd_recovered when the deep decode ran).
    `timer` records the spans forward (forward.deep inside it with the
    deep decode), download, unpack and osd (also on the device) and their
    counters, and counts the pass, its clamp rows (ap_rows), the bank's
    `bank_rows` non-zero rows and each kernel's launches in the pass."""
    if timer.detail:
        clamp = kw.get("ap_clamp_signs")
        timer.count("passes")
        timer.count("ap_rows", 0 if clamp is None else clamp.shape[0])
        timer.count("bank_rows", bank_rows)
        before = {n: k.launches for n, k in build.KERNELS.items()}
    with timer.stage("forward", device=decoder.device):
        with torch.no_grad():
            out = decoder(i_t, q_t, timer=timer, **kw)
    with timer.stage("download"):
        # the OSD's posteriors stay on the decoder's device, where
        # _merge_osd_decodes reprocesses them
        out = {k: v if k in OSD_POSTERIORS else v.cpu().numpy()
               for k, v in out.items()}
        if timer.detail:
            timer.count("download_bytes", sum(
                v.nbytes for k, v in out.items() if k not in OSD_POSTERIORS))
    with timer.stage("unpack"):
        # the timer goes only to a detailed timer, the one that counts, so
        # a wrapper of unpack_survivors(out, n_channels, hashes) still fits
        results, sub_params = unpack_survivors(
            out, i_t.shape[0], hashes,
            **({"timer": timer} if timer.detail else {}))
        if timer.detail:
            timer.count("survivors", np.count_nonzero(out["ok"]))
    if kw.get("osd_cands", 0) > 0:
        with timer.stage("osd", device=decoder.device):
            out["n_osd_recovered"] = _merge_osd_decodes(
                out, results, sub_params, hashes, timer=timer)
    if timer.detail:
        for n, k in build.KERNELS.items():
            timer.count("launches." + n, k.launches - before.get(n, 0))
    return results, sub_params, out


# Copied from rtlsdr_ft8d_tpu/pipeline.py:421-484 (that module imports jax);
# the counters of a detailed `timer` are the port's own.
def _merge_osd_decodes(out, results, sub_params, hashes, *, timer=NO_TIMER):
    """OSD reprocessing (ops/osd.osd_rows) of the BP-failed candidates the
    device shipped (posterior LLRs, on the card or on the host), merging
    CRC-clean recoveries into the per-channel decode lists. A detailed
    `timer` counts the rows reprocessed, both flavors (osd_candidates),
    those of them reprocessed on a card (osd_device_rows) and the
    recoveries (osd_recovered)."""
    valid = np.asarray(out["osd_valid"])            # (n_osd,)
    n_idx = np.nonzero(valid)[0]
    timer.count("osd_candidates", n_idx.size)
    if n_idx.size == 0:
        timer.count("osd_device_rows", 0)
        timer.count("osd_recovered", 0)
        return 0
    chan = np.asarray(out["osd_chan"])
    # flavor B, the block-coherent posteriors, is tried on the rows that
    # flavor A rejects (+1..2/48 recoveries at -21..-22 dB,
    # scripts/osd_coh_ab.py)
    post, post_c = out["osd_post"], out.get("osd_post_coh")
    rows = (torch.from_numpy(n_idx).to(post.device)
            if isinstance(post, torch.Tensor) else n_idx)
    msgs, accept = (t.cpu().numpy() for t in osd_rows(
        post[rows], None if post_c is None else post_c[rows]))
    n_rows = n_idx.size
    if post_c is not None:
        n_rows += int(np.count_nonzero(accept != 1))
        timer.count("osd_candidates", n_rows - n_idx.size)
    timer.count("osd_device_rows", n_rows if runs_on_card(post) else 0)
    per_row = isinstance(hashes, (list, tuple))
    n_recovered = 0
    for j, n in enumerate(n_idx):
        if not accept[j]:
            continue
        b = int(chan[n])
        # false-decode gates beyond the CRC: OSD reprocessing only trusts
        # candidates with real sync evidence (score >= 13; pure-noise
        # candidates cluster at 10-12), and never surfaces raw-typed
        # payloads (a genuine type-5..7 signal surviving only via OSD is
        # vastly less likely than a 14-bit CRC collision)
        if out["osd_score"][n] < 13:
            continue
        row_hashes = hashes[b] if per_row else hashes
        try:
            text, call, loc, is_cq = unpack_spot(msgs[j][:77], row_hashes)
        except UnpackError:
            continue
        if text.startswith("<type"):
            continue
        if any(d.text == text for d in results[b]):
            continue
        freq_hz = (out["osd_freq_offset"][n]
                   + out["osd_freq_sub"][n] / 2.0) * TONE_SPACING_HZ
        time_sec = (out["osd_time_offset"][n]
                    + out["osd_time_sub"][n] / 2.0) * 0.16
        results[b].append(Decode(
            text=text, freq_hz=float(freq_hz), time_sec=float(time_sec),
            score=int(out["osd_score"][n]),
            snr_db=float(np.round(out["osd_snr_db"][n] * 2.0) / 2.0),
            call_field=call, loc_field=loc, cq_field=is_cq))
        sub_params[b].append((msgs[j],
                              int(out["osd_freq_offset"][n]) * 2
                              + int(out["osd_freq_sub"][n]),
                              int(out["osd_time_offset"][n]) * 2
                              + int(out["osd_time_sub"][n])))
        n_recovered += 1
    timer.count("osd_recovered", n_recovered)
    return n_recovered


def ap_tensors(ap_cq: bool, ap_call: str | None, ap_texts, device):
    """The forward's AP operands from decode_window's options
    (rtlsdr_ft8d_tpu/pipeline.py:257-263, 586-608): the (H, 77) clamp rows
    (CQ first, then the call's row) or None, and the (H, 174) codeword
    bank or None. A text bank is padded with all-zero rows to a power of
    two >= 64, as in the JAX package; an array is taken as it is."""
    rows = [clamp_row_cq()] if ap_cq else []
    if ap_call:
        row = ap_prefix_for_call(ap_call)
        if row is not None:
            rows.append(row)
    bank = None
    if isinstance(ap_texts, np.ndarray):
        bank = np.asarray(ap_texts, np.float32)
    elif ap_texts is not None:
        bank = codeword_signs(ap_texts)
        if bank is not None:
            h = 64
            while h < bank.shape[0]:
                h *= 2
            if h > bank.shape[0]:       # pad with inert all-zero rows
                bank = np.concatenate([bank, np.zeros(
                    (h - bank.shape[0], bank.shape[1]), np.float32)])
    to_dev = lambda a: torch.from_numpy(                # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(device)
    return (to_dev(np.stack(rows)) if rows else None,
            None if bank is None else to_dev(bank))


MAX_SUBTRACT = 16       # signals subtracted per channel and pass (MAXM)


def subtraction_pairs(sub_params):
    """Up to MAX_SUBTRACT decoded signals per channel (per-channel lists
    of (bits91, freq2, time2)) as the flat list of P pairs in (channel,
    message) order: int32 arrays chan (P,), tones (P, 79), fbin2 (P,)
    and start2 (P,)."""
    from .protocol.encode import codeword_to_tones, ldpc_encode

    pairs = [(b, p) for b, params in enumerate(sub_params)
             for p in params[:MAX_SUBTRACT]]
    P = len(pairs)
    chan = np.zeros(P, np.int32)
    tones = np.zeros((P, 79), np.int32)
    fbin2 = np.zeros(P, np.int32)
    start2 = np.zeros(P, np.int32)
    for j, (b, (bits91, fb2, st2)) in enumerate(pairs):
        chan[j], fbin2[j], start2[j] = b, fb2, st2
        tones[j] = codeword_to_tones(ldpc_encode(bits91))
    return chan, tones, fbin2, start2


def _subtract_decoded(i_t, q_t, sub_params, timer=NO_TIMER):
    """Rebuild and subtract up to MAX_SUBTRACT decoded signals per channel
    (rtlsdr_ft8d_tpu/pipeline.py:621-641) as subtraction_pairs' pairs,
    uploaded in one copy. A detailed `timer` counts the pairs
    (subtract_pairs) and the kernel's launches (launches.subtract: 2 on
    a card, 0 on the CPU)."""
    chan, tones, fbin2, start2 = subtraction_pairs(sub_params)
    P = chan.shape[0]
    before = subtract.KERNEL.launches
    with torch.no_grad():
        ops = torch.from_numpy(np.concatenate(
            [chan, fbin2, start2, tones.ravel()])).to(i_t.device)
        i_t, q_t = subtract.subtract_pairs(
            i_t, q_t, ops[:P], ops[3 * P:].view(P, 79), ops[P:2 * P],
            ops[2 * P:3 * P])
    if timer.detail:
        timer.count("subtract_pairs", P)
        timer.count("launches.subtract", subtract.KERNEL.launches - before)
    return i_t, q_t


def decode_window(iq, hashes: CallsignHashTable | None = None,
                  budget: int | None = None, passes: int = 1,
                  osd_cands: int = 0, ap_cq: bool = False,
                  ap_call: str | None = None, ap_texts=None,
                  device: str | torch.device = "cuda", decoder=None,
                  return_stats: bool = False, timer=None):
    """Decode a batch of channels; returns (per channel) Decode lists.

    `iq` may be (48000,) or (B, 48000), complex or an (i, q) tuple of
    float32, as for rtlsdr_ft8d_tpu.pipeline.decode_window; the tuple may
    hold float32 tensors, which are used in place when they sit on the
    decoder's device (the wideband daemon's channel bank), so nothing
    goes through the host. `hashes`: one
    CallsignHashTable or a per-channel list (multiband). `passes`:
    multipass subtraction decoding. `decoder`: any decoder of
    WindowDecoder.forward's contract, used on its device (a WindowDecoder
    or parallel/elastic.ElasticDecoder); a long-running caller passes
    one, since building a WindowDecoder makes the DFT tables anew;
    otherwise one is built on `device`.
    `ap_cq` / `ap_call`: a-priori clamp hypotheses (universal CQ and/or
    the operator's own callsign, ops/ap.py). `ap_texts`: complete message
    texts (QSO continuations) scored as a codeword bank, or a prebuilt
    (H, 174) +-1/0 sign array (QsoTracker.bank()). `osd_cands`: the
    per-channel quota of the deep decode (refinement + BP + OSD, at
    most MAX_OSD candidates per batch). `return_stats` also returns a
    WindowStats with the counters summed over passes (and the OSD
    recoveries in `extra` when osd_cands > 0).

    `timer` (host/log.StageTimer; None records nothing) times the spans
    upload (the float32 conversion, the copy to the decoder's device and
    the AP operands), forward (also on the device; with osd_cands > 0
    forward.deep, the deep decode, also on the device), download, unpack,
    osd and subtract (both also on the device) and stats inside the
    caller's open stage, and, on a detailed timer, counts upload_bytes
    (none for tensors already on the device), download_bytes (all but the
    OSD_POSTERIORS, which stay on the device), survivors (the `ok`
    rows unpacked), unpack_fallbacks (those unpacked one at a time in
    Python), each kernel's launches in the pass (launches.<kernel>),
    passes (the passes run), ap_rows (the clamp rows), bank_rows (the
    bank's non-zero rows) and, with osd_cands > 0, deep_rows (the deep
    decode's selection), osd_candidates (the rows handed to the OSD,
    both flavors), osd_device_rows (those of them reprocessed on a card)
    and osd_recovered, and with passes > 1 subtract_pairs (the decoded
    pairs subtracted) and launches.subtract; the spans and counters of
    every pass add under the same names.
    """
    if timer is None:
        timer = NO_TIMER
    if decoder is None:
        decoder = WindowDecoder().to(device)
    dev = decoder.device
    with timer.stage("upload"):
        if isinstance(iq, tuple):
            i_t, q_t = (x.to(dev, torch.float32) if torch.is_tensor(x) else
                        torch.from_numpy(np.ascontiguousarray(x, np.float32))
                        .to(dev) for x in iq)
            copied = [not (torch.is_tensor(x) and x.device == dev)
                      for x in iq]
        else:
            iq = np.asarray(iq)
            i_t = torch.from_numpy(np.real(iq).astype(np.float32)).to(dev)
            q_t = torch.from_numpy(np.imag(iq).astype(np.float32)).to(dev)
            copied = [True, True]
        squeeze = i_t.ndim == 1
        if squeeze:
            i_t, q_t = i_t[None], q_t[None]
        clamp_signs, cw_signs = ap_tensors(ap_cq, ap_call, ap_texts, dev)
        bank_rows = 0
        if timer.detail:
            moved = [t for t, c in zip((i_t, q_t), copied) if c]
            moved += [t for t in (clamp_signs, cw_signs) if t is not None]
            timer.count("upload_bytes", sum(t.nbytes for t in moved))
            if cw_signs is not None:
                bank_rows = int((cw_signs != 0).any(-1).sum())

    kw = dict(budget=budget, osd_cands=osd_cands, ap_clamp_signs=clamp_signs,
              ap_cw_signs=cw_signs)
    results, sub_params, out = _decode_pass(decoder, i_t, q_t, hashes,
                                            timer, bank_rows, **kw)
    outs = [out]

    # Multipass (rtlsdr_ft8d_tpu/pipeline.py:614-654): subtract the
    # signals decoded so far and decode the residual; only the NEW
    # signals are subtracted on the next pass.
    for _ in range(passes - 1):
        if not any(sub_params):
            break
        with timer.stage("subtract", device=dev):
            i_t, q_t = _subtract_decoded(i_t, q_t, sub_params, timer)
        res2, sub_params, out2 = _decode_pass(decoder, i_t, q_t, hashes,
                                              timer, bank_rows, **kw)
        outs.append(out2)
        for b in range(len(results)):
            known = {d.text for d in results[b]}
            results[b].extend(d for d in res2[b] if d.text not in known)
            sub_params[b] = [p for p, d in zip(sub_params[b], res2[b])
                             if d.text not in known]
    results = results[0] if squeeze else results
    if not return_stats:
        return results

    # counters summed over all passes (pipeline.py:655-671)
    B = i_t.shape[0]
    with timer.stage("stats"):
        stats = WindowStats(
            channels=B,
            candidates_scored=len(outs) * B * K_MAX_CANDIDATES,
            candidates_above_min=sum(int(np.sum(o["n_above_min"]))
                                     for o in outs),
            ldpc_converged=sum(int(np.sum(o["n_ldpc_ok"])) for o in outs),
            crc_passed=sum(int(np.sum(o["n_ok"])) for o in outs),
            messages_unique=sum(len(r) for r in
                                ([results] if squeeze else results)),
            extra=({"osd_recovered": sum(int(o["n_osd_recovered"])
                                         for o in outs)}
                   if osd_cands > 0 else {}))
    return results, stats
