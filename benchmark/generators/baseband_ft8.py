"""Baseband FT8 windows: C channels of 3,200 sps I/Q, each holding several
bursts over white Gaussian noise, for the multiband decode.

Every seed gets the same work in another order: in each window the
channels' burst counts are the same evenly spread set over
`signals_per_channel` and the bursts' SNRs the same evenly spread set
over `snr_db`, both permuted by the seed; frequencies (distinct slots),
start times and texts are drawn from the seed. The windows are made on
`device` and handed over as host numpy float32 (i, q) pairs.
"""

import numpy as np
import torch

from generators import ft8synth, messages


def spread(lo, hi, n, integer=False):
    """n values evenly spread over [lo, hi] (integers: each of lo..hi
    equally often, as far as n allows)."""
    if integer:
        return lo + (np.arange(n) * (hi - lo + 1)) // n
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def plan(p: dict, seed: int, channels: int) -> list[list[dict]]:
    """Per window, the bursts: dicts with chan, text, f0_hz, start,
    snr_db. Host only, deterministic in the seed."""
    rng = np.random.default_rng(seed)
    slots = int((p["f0_hz"][1] - p["f0_hz"][0]) // p["slot_hz"])
    out = []
    for _ in range(p["windows"]):
        counts = rng.permutation(spread(*p["signals_per_channel"], channels,
                                        integer=True))
        n = int(counts.sum())
        snrs = rng.permutation(spread(*p["snr_db"], n))
        bursts = []
        for c, k in enumerate(counts):
            for s in rng.choice(slots, size=int(k), replace=False):
                f0 = (p["f0_hz"][0] + p["slot_hz"] * int(s)
                      + rng.uniform(0.0, p["f0_jitter_hz"]))
                start = int(round(rng.uniform(*p["start_s"])
                                  * ft8synth.SAMPLE_RATE))
                bursts.append({"chan": c, "f0_hz": f0, "start": start,
                               "text": messages.canonical(
                                   messages.message(rng, p["messages"])),
                               "snr_db": float(snrs[len(bursts)])})
        out.append(bursts)
    return out


def generate(p: dict, seed: int, device, channels: int) -> dict:
    """{"windows": [(i, q) host float32 (C, 48000)], "truth": [per window
    a list per channel of the texts sent], "plan": plan(...)}."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sigma = float(p["noise_sigma"])
    windows, truth = [], []
    bursts_all = plan(p, seed, channels)
    tone_cache = {}
    for bursts in bursts_all:
        shape = (channels, ft8synth.WINDOW)
        w_i = sigma * torch.randn(shape, generator=gen, device=dev)
        w_q = sigma * torch.randn(shape, generator=gen, device=dev)
        for b in bursts:
            if b["text"] not in tone_cache:
                tone_cache[b["text"]] = ft8synth.tones_of(b["text"])
        as_t = lambda a, dt: torch.as_tensor(                 # noqa: E731
            np.asarray(a), dtype=dt).to(dev)
        ft8synth.render_baseband(
            w_i, w_q, as_t([b["chan"] for b in bursts], torch.int64),
            as_t(np.stack([tone_cache[b["text"]] for b in bursts]),
                 torch.int64),
            as_t([b["f0_hz"] for b in bursts], torch.float64),
            as_t([b["start"] for b in bursts], torch.int64),
            as_t(ft8synth.amplitude_for_snr(
                [b["snr_db"] for b in bursts], sigma,
                ft8synth.SAMPLE_RATE), torch.float64))
        windows.append((w_i.cpu().numpy(), w_q.cpu().numpy()))
        sent = [[] for _ in range(channels)]
        for b in bursts:
            sent[b["chan"]].append(b["text"])
        truth.append(sent)
    return {"windows": windows, "truth": truth, "plan": bursts_all}
