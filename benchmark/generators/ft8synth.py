"""FT8 synthesis for the benchmark's traffic.

`synthesize_tones` is a frozen copy of rtlsdr_ft8d_tpu_torch/host/synth.py:
17-41 (phase-continuous complex 8-FSK, 512 samples a symbol at 3,200 sps,
tone frequency f0 + (tone - 3.5) * 6.25 Hz); it is the oracle the tests
hold `render_baseband` to. `render_baseband` and `render_fullrate` are the
same waveform rendered in bulk with torch on any device, in float64
phases: at 3,200 sps (many signals at once), and at 2.4 Msps (one signal
at a time; the full-rate form of rtlsdr_ft8d_tpu_torch/host/sources.py:
152-166 and chip_smoke.py:1881-1902, 384,000 samples a symbol).
`to_u8` is SyntheticSource's quantization (host/sources.py:169-172):
interleaved unsigned 8-bit I/Q, x * 127 + 128 truncated.
"""

import numpy as np
import torch

from reference.protocol.encode import encode
from reference.protocol.pack import pack77

SAMPLE_RATE = 3200
CAPTURE_RATE = 2_400_000
BLOCK_SIZE = 512                  # samples a symbol at 3,200 sps
TONE_SPACING_HZ = 6.25
NUM_SYMBOLS = 79
WINDOW = 48000


def tones_of(text: str) -> np.ndarray:
    """The 79 channel symbols of a message text."""
    return encode(pack77(text))


def synthesize_tones(tones, f0_hz=50.0, start_sample=0, amplitude=0.5,
                     noise_sigma=0.0, rng=None, num_samples=WINDOW):
    """Render a 79-tone FT8 burst into a complex64 window."""
    rng = rng or np.random.default_rng(0)
    out = np.zeros(num_samples, dtype=np.complex128)
    dt = 1.0 / SAMPLE_RATE
    phi = 0.0
    idx = start_sample
    for tone in tones:
        f = f0_hz + (float(tone) - 3.5) * TONE_SPACING_HZ
        dphi = 2.0 * np.pi * dt * f
        n = np.arange(BLOCK_SIZE)
        seg = amplitude * np.exp(1j * (phi + dphi * n))
        end = min(idx + BLOCK_SIZE, num_samples)
        s0 = max(idx, 0)
        if s0 < end:
            out[s0:end] += seg[s0 - idx:end - idx]
        phi += dphi * BLOCK_SIZE
        idx += BLOCK_SIZE
    if noise_sigma > 0:
        out += noise_sigma * (rng.standard_normal(num_samples)
                              + 1j * rng.standard_normal(num_samples))
    return out.astype(np.complex64)


def _phases(tones: torch.Tensor, f0_hz: torch.Tensor, rate: float,
            sps: int):
    """(S, 79) tones, (S,) f0 -> (phase at each symbol's start (S, 79),
    phase step per sample (S, 79)), float64."""
    f = f0_hz[:, None] + (tones.to(torch.float64) - 3.5) * TONE_SPACING_HZ
    dphi = 2.0 * np.pi * f / rate
    step = dphi * sps
    phi0 = torch.cumsum(step, dim=1) - step
    return phi0, dphi


def render_baseband(out_i: torch.Tensor, out_q: torch.Tensor, chan, tones,
                    f0_hz, start, amplitude, chunk: int = 128):
    """Add S bursts into (C, 48000) float32 `out_i`, `out_q` in place:
    burst s in channel chan[s] from sample start[s] (may be negative),
    at f0_hz[s] and amplitude[s]. Arguments are tensors on out_i's
    device; bursts are rendered `chunk` at a time."""
    dev = out_i.device
    C, n_win = out_i.shape
    flat_i, flat_q = out_i.view(-1), out_q.view(-1)
    n = torch.arange(BLOCK_SIZE, device=dev, dtype=torch.float64)
    span = torch.arange(NUM_SYMBOLS * BLOCK_SIZE, device=dev)
    for s0 in range(0, tones.shape[0], chunk):
        sl = slice(s0, s0 + chunk)
        phi0, dphi = _phases(tones[sl], f0_hz[sl].to(torch.float64),
                             SAMPLE_RATE, BLOCK_SIZE)
        ph = (phi0[..., None] + dphi[..., None] * n).reshape(phi0.shape[0], -1)
        amp = amplitude[sl].to(torch.float64)[:, None]
        pos = start[sl][:, None] + span
        keep = (pos >= 0) & (pos < n_win)
        idx = (chan[sl][:, None] * n_win + pos)[keep]
        flat_i.index_add_(0, idx, (amp * torch.cos(ph))[keep].float())
        flat_q.index_add_(0, idx, (amp * torch.sin(ph))[keep].float())


def render_fullrate(out_i: torch.Tensor, out_q: torch.Tensor, tones,
                    abs_freq_hz: float, start: int, amplitude: float,
                    block: int = 8):
    """Add one burst at abs_freq_hz of a 2.4 Msps capture into (n,)
    float32 `out_i`, `out_q` in place, from sample `start` on, `block`
    symbols at a time."""
    dev = out_i.device
    sps = BLOCK_SIZE * (CAPTURE_RATE // SAMPLE_RATE)        # 384,000
    t = torch.as_tensor(np.asarray(tones)[None], device=dev)
    phi0, dphi = _phases(t, torch.tensor([float(abs_freq_hz)], device=dev,
                                         dtype=torch.float64),
                         CAPTURE_RATE, sps)
    phi0 = torch.remainder(phi0[0], 2.0 * np.pi)
    dphi = dphi[0]
    n = torch.arange(sps, device=dev, dtype=torch.float64)
    total = out_i.shape[0]
    for j0 in range(0, NUM_SYMBOLS, block):
        j1 = min(j0 + block, NUM_SYMBOLS)
        ph = (phi0[j0:j1, None] + dphi[j0:j1, None] * n).reshape(-1)
        a = start + j0 * sps
        b = min(a + ph.shape[0], total)
        if b <= max(a, 0):
            continue
        lo = max(-a, 0)
        ph = ph[lo:b - a]
        out_i[a + lo:b] += (amplitude * torch.cos(ph)).float()
        out_q[a + lo:b] += (amplitude * torch.sin(ph)).float()


def to_u8(x_i: torch.Tensor, x_q: torch.Tensor, scale: float = 127.0,
          offset: float = 128.0) -> torch.Tensor:
    """(n,) float I/Q -> (2n,) interleaved uint8: trunc(x * scale +
    offset), clipped to 0..255."""
    u = torch.empty((2 * x_i.shape[0],), dtype=torch.uint8, device=x_i.device)
    u[0::2] = torch.clamp(x_i * scale + offset, 0, 255).to(torch.uint8)
    u[1::2] = torch.clamp(x_q * scale + offset, 0, 255).to(torch.uint8)
    return u


def amplitude_for_snr(snr_db, noise_sigma: float, rate: float):
    """Amplitude of a burst at snr_db in 2500 Hz over complex white noise
    of `noise_sigma` per component at `rate` samples a second (the
    convention of bench.py's sigma_for_snr)."""
    snr = 10.0 ** (np.asarray(snr_db, np.float64) / 10.0)
    return noise_sigma * np.sqrt(2.0 * snr * 2500.0 / rate)
