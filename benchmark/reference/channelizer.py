"""The plain reference for the wideband ingest: the RTL-SDR's unsigned
8-bit capture to the 1500-channel bank, written from the definitions and
not from the port's code.

Ingest (the native ring's contract, native/ingest.cc:54-99): each byte
minus 128 as int8, then the fs/4 down-shift x[n] * (-j)^n with int8
negation saturating (-(-128) = 127).

Channelizer: channel k (centre k * 1600 Hz, k >= 750 negative) of frame m
(global index, 750 samples apart) is

    y_k[m] = sum_{i < 48000} w[i] x[m*750 + i] e^{-j 2 pi k (m*750 + i) / 1500}

with x the int8 I/Q over 128 and w the time-reversed 48,000-tap Kaiser
prototype (cutoff 1600 Hz, beta 7). Since e^{-j 2 pi k m 750 / 1500} =
(-1)^{mk}, and i = 1500 s + t folds the 48,000 taps onto 1500 phases,
y_k[m] = (-1)^{mk} DFT_1500(u_m)[k] with u_m[t] = sum_s w[1500 s + t]
x[m*750 + 1500 s + t]. The sums and the DFT (as matmuls against cos and
sin) run in float64 ("f64") or, as the control, in float32 with TF32
matmuls ("tf32").
"""

import functools

import numpy as np
import torch

from .decoder import precision
from .tables import design_lowpass

CAPTURE_RATE = 2_400_000
CHANNEL_STEP_HZ = 1600
NUM_CHANNELS = CAPTURE_RATE // CHANNEL_STEP_HZ    # 1500
HOP = 750
TAPS = 48000
HISTORY = TAPS - HOP                              # 47250


def ingest_u8(u8: torch.Tensor, phase: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved u8 I/Q (2n,) -> mixed int8 (i, q), each (n,), the
    first sample at mixer phase `phase`."""
    x = (u8.to(torch.int16) - 128)
    i, q = x[0::2], x[1::2]

    def neg(v):
        return torch.where(v == -128, 127, -v)

    ph = (torch.arange(i.shape[0], device=u8.device) + phase) % 4
    oi = torch.where(ph == 0, i, torch.where(ph == 1, q, torch.where(
        ph == 2, neg(i), neg(q))))
    oq = torch.where(ph == 0, q, torch.where(ph == 1, neg(i), torch.where(
        ph == 2, neg(q), i)))
    return oi.to(torch.int8), oq.to(torch.int8)


@functools.cache
def _weights() -> np.ndarray:
    """w[i], float64: the prototype time-reversed."""
    return design_lowpass(TAPS, 1600.0, beta=7.0)[::-1].astype(np.float64)


@functools.cache
def _bases(device, dtype, channels):
    t = np.arange(NUM_CHANNELS, dtype=np.float64)[:, None]
    k = np.asarray(channels, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * ((t * k) % NUM_CHANNELS) / NUM_CHANNELS
    return (torch.from_numpy(np.cos(ang)).to(device, dtype),
            torch.from_numpy(np.sin(ang)).to(device, dtype))


def channelize(i8: torch.Tensor, q8: torch.Tensor, frame_offset: int = 0,
               channels=None, mode: str = "f64", block: int = 4000):
    """int8 I/Q of length HISTORY + 750 M (history first) -> (i, q), each
    (len(channels), M) float32: the bank of `channels` (default all 1500)
    over frames frame_offset .. frame_offset + M - 1, computed in blocks
    of `block` frames."""
    if mode not in ("f64", "tf32"):
        raise ValueError(f"mode must be f64 or tf32, got {mode!r}")
    n = i8.shape[-1]
    m_total = (n - HISTORY) // HOP
    if m_total < 1 or n != HISTORY + m_total * HOP:
        raise ValueError(f"length must be {HISTORY} + 750*M, got {n}")
    channels = tuple(range(NUM_CHANNELS)) if channels is None \
        else tuple(channels)
    dev = i8.device
    dtype = torch.float64 if mode == "f64" else torch.float32
    w = torch.from_numpy(_weights()).to(dev, dtype).view(TAPS // HOP, HOP)
    cos, sin = _bases(dev, dtype, channels)
    odd = torch.as_tensor([k % 2 for k in channels], device=dev,
                          dtype=torch.bool)
    xi = (i8.to(dtype) / 128.0).view(-1, HOP)       # (M + 63, 750)
    xq = (q8.to(dtype) / 128.0).view(-1, HOP)
    out_i = torch.empty((len(channels), m_total), dtype=torch.float32,
                        device=dev)
    out_q = torch.empty_like(out_i)
    with torch.no_grad(), precision("tf32" if mode == "tf32" else "f32"):
        for m0 in range(0, m_total, block):
            m1 = min(m0 + block, m_total)
            ui = torch.zeros((m1 - m0, 2, HOP), dtype=dtype, device=dev)
            uq = torch.zeros_like(ui)
            for r in range(TAPS // HOP):          # tap block r: 2 s + a
                a = r % 2
                ui[:, a].addcmul_(xi[m0 + r:m1 + r], w[r])
                uq[:, a].addcmul_(xq[m0 + r:m1 + r], w[r])
            ui = ui.view(m1 - m0, NUM_CHANNELS)
            uq = uq.view(m1 - m0, NUM_CHANNELS)
            re = ui @ cos + uq @ sin                # (frames, channels)
            im = uq @ cos - ui @ sin
            m = torch.arange(m0, m1, device=dev) + frame_offset
            flip = ((m % 2 == 1)[:, None] & odd[None, :])
            sign = 1.0 - 2.0 * flip.to(dtype)
            out_i[:, m0:m1] = (re * sign).T.to(torch.float32)
            out_q[:, m0:m1] = (im * sign).T.to(torch.float32)
    return out_i, out_q


def channel_center_hz(k: int) -> float:
    f = k * float(CHANNEL_STEP_HZ)
    if f >= CAPTURE_RATE / 2:
        f -= CAPTURE_RATE
    return f


def dedup_wideband(decodes_per_channel):
    """Same text in one window -> the highest score, the first among
    equals; a flat list sorted by frequency. Frozen copy of
    rtlsdr_ft8d_tpu_torch/ops/channelize.py:223-235."""
    best = {}
    for _k, decodes in decodes_per_channel:
        for d in decodes:
            cur = best.get(d.text)
            if cur is None or d.score > cur.score:
                best[d.text] = d
    return sorted(best.values(), key=lambda d: d.freq_hz)
