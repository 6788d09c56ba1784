"""Full-band captures as an RTL-SDR delivers them: 15 s of 2.4 Msps
interleaved unsigned 8-bit I/Q, the band centre offset by +fs/4 (the
reference's tuning recipe, which the native ring's mixer undoes), white
Gaussian noise everywhere and FT8 bursts in one 3-kHz sub-band.

Every seed gets the same work in another order: the windows' burst
counts are evenly spread over `signals_per_window`, ends included, and the bursts' SNRs
evenly spread over `snr_db`, both permuted by the seed; slots, start
times and texts are drawn from the seed. Each capture is made on
`device` and kept on the host; a capture that would clip at 8 bits is
refused.
"""

import numpy as np
import torch

from generators import ft8synth, messages
from generators.baseband_ft8 import spread

FS4_OFFSET = ft8synth.CAPTURE_RATE // 4          # 600 kHz
WINDOW_SAMPLES = 15 * ft8synth.CAPTURE_RATE      # 36,000,000


def plan(p: dict, seed: int) -> list[list[dict]]:
    """Per window, the bursts: dicts with abs_hz (relative to the band
    centre after the fs/4 mix), start (samples), text, snr_db."""
    rng = np.random.default_rng(seed)
    counts = rng.permutation(np.rint(np.linspace(
        *p["signals_per_window"], p["windows"])).astype(int))
    lo = p["subband_channel"] * p["channel_step_hz"] + p["subband_offset_hz"]
    slots = int(p["subband_hz"] // p["slot_hz"])
    out = []
    for k in counts:
        snrs = rng.permutation(spread(*p["snr_db"], int(k)))
        bursts = []
        for j, s in enumerate(rng.choice(slots, size=int(k), replace=False)):
            bursts.append({
                "abs_hz": lo + p["slot_hz"] * int(s)
                + rng.uniform(0.0, p["f0_jitter_hz"]),
                "start": int(round(rng.uniform(*p["start_s"])
                                   * ft8synth.CAPTURE_RATE)),
                "text": messages.canonical(messages.message(
                    rng, p["messages"])),
                "snr_db": float(snrs[j])})
        out.append(bursts)
    return out


def generate(p: dict, seed: int, device) -> dict:
    """{"captures": [(72,000,000,) host uint8], "truth": [per window the
    set of texts sent], "plan": plan(...), "peak_counts": the largest
    |sample - 128| of any capture}."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sigma = float(p["noise_sigma"])
    captures, truth, peak = [], [], 0.0
    bursts_all = plan(p, seed)
    for bursts in bursts_all:
        x_i = sigma * torch.randn((WINDOW_SAMPLES,), generator=gen,
                                  device=dev)
        x_q = sigma * torch.randn((WINDOW_SAMPLES,), generator=gen,
                                  device=dev)
        amps = ft8synth.amplitude_for_snr([b["snr_db"] for b in bursts],
                                          sigma, ft8synth.CAPTURE_RATE)
        for b, a in zip(bursts, amps):
            ft8synth.render_fullrate(x_i, x_q, ft8synth.tones_of(b["text"]),
                                     FS4_OFFSET + b["abs_hz"], b["start"],
                                     float(a))
        scale = float(p["u8_scale"])
        top = float(torch.maximum(x_i.abs().max(), x_q.abs().max())) * scale
        if top >= 127.0:
            raise ValueError(f"capture clips at 8 bits: peak {top:.1f} "
                             "counts; lower noise_sigma")
        peak = max(peak, top)
        captures.append(ft8synth.to_u8(x_i, x_q, scale,
                                       float(p["u8_offset"])).cpu().numpy())
        del x_i, x_q
        truth.append({b["text"] for b in bursts})
    return {"captures": captures, "truth": truth, "plan": bursts_all,
            "peak_counts": peak}
