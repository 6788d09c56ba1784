"""The numbers that decide `correct`, from the program's decode lists and
the plain reference's.

A decode is compared whole: (text, frequency, time, sync score, SNR).

- decode_diff_pct: decodes that differ (a text on one side only, or on
  both with other fields or another number of copies), over all windows
  compared, as a share of the reference's decodes. Rounding flips a knife-edge
  decode now and then; a lower precision, a lost channel or a wrong field
  moves many.
- false_decodes: texts the program reports in a channel that were
  neither sent there nor decoded there by the reference. Every decode
  reported has to be a message on the air or one the reference decoder
  also finds: the limit is 0.
- bank_rel_err (wideband): the relative Frobenius distance of the channel
  bank the channelizer handed to the decode from the reference's.
"""

import collections
import math

import torch


def as_tuple(d) -> tuple:
    return (d.text, float(d.freq_hz), float(d.time_sec), int(d.score),
            float(d.snr_db))


def freeze(lists) -> tuple:
    """Per-channel decode lists as tuples of as_tuple(d): what a run keeps
    until its window closes, in objects the garbage collector stops
    scanning."""
    return tuple(tuple(as_tuple(d) for d in ds) for ds in lists)


def _by_text(ds) -> dict:
    """text -> the sorted tuples of its copies in one channel's list."""
    out = collections.defaultdict(list)
    for d in ds:
        t = d if isinstance(d, tuple) else as_tuple(d)
        out[t[0]].append(t)
    return {k: sorted(v) for k, v in out.items()}


def decode_numbers(windows) -> dict:
    """windows: iterable of (program lists, reference lists, sent texts),
    one list or set per channel each; a decode is a Decode or its
    as_tuple. A text decoded on one side only, or on both with another
    frequency, time, score, SNR or number of copies, is one decode that
    differs. Returns {"decode_diff_pct", "false_decodes",
    "reference_decodes", "windows"}."""
    diff = ref_total = false = n = 0
    for prog, ref, sent in windows:
        n += 1
        for p_ch, r_ch, s_ch in zip(prog, ref, sent):
            p, r = _by_text(p_ch), _by_text(r_ch)
            diff += sum(p.get(t) != r.get(t) for t in p.keys() | r.keys())
            ref_total += len(r)
            false += sum(t not in r and t not in s_ch for t in p)
    return {"decode_diff_pct": 100.0 * diff / max(ref_total, 1),
            "false_decodes": false, "reference_decodes": ref_total,
            "windows": n}


def bank_rel_err(prog_i, prog_q, ref_i, ref_q) -> float:
    """sqrt(sum |program - reference|^2 / sum |reference|^2), float64."""
    num = den = 0.0
    for p, r in ((prog_i, ref_i), (prog_q, ref_q)):
        d = p.to(torch.float64) - r.to(torch.float64)
        num += float((d * d).sum())
        den += float((r.to(torch.float64) ** 2).sum())
    return math.sqrt(num / den) if den > 0 else math.inf
