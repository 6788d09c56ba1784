"""Static tables of the decode path: built with numpy, and their buffers.

The JAX package computes these as module constants of modules that
import jax; the functions here recompute them with numpy alone, from the
same protocol definitions and in the same operation order, so the
results are bit-identical (tests/test_torch_tables.py holds them to the
JAX modules' own arrays):

  wf_cos, wf_sin, wf_cos_minus_sin  window-folded DFT bases (1024, 512)
                                    of the plain waterfall
                                    (rtlsdr_ft8d_tpu/ops/waterfall.py:55-61)
  wf_window                         the sine window (1024,)
                                    (rtlsdr_ft8d_tpu/ops/waterfall.py:37)
  wf_twiddle                        FFT twiddles exp(-2 pi i k / 1024) as
                                    (1024, 2) [re, im], computed in float64
                                    (the waterfall kernel's FFT)
  sync_count                        Costas score divisor per time offset
                                    (rtlsdr_ft8d_tpu/ops/sync.py:34-56)
  ldpc_nm, ldpc_mn, ldpc_nm_pos     Tanner graph index tables
                                    (rtlsdr_ft8d_tpu/ops/ldpc.py:23-34)
  crc_mat                           CRC-14 as a GF(2) matrix (77, 14)
                                    (rtlsdr_ft8d_tpu/ops/ldpc.py:277-289)

`from_reference` turns a dict of such arrays, built here or taken from
the JAX modules, into the tensors the port holds as module buffers.
The JAX package has no FFT, so wf_twiddle has no JAX counterpart; the
tests hold it to numpy's exp in float64 cast to float32.

The ingest decimator's filter (rtlsdr_ft8d_tpu/ops/decimate.py:36-68) is
built here too, by `polyphase_bank`, with `polyphase_bank_split`, its
two-part float16 form for the int8 kernel's tensor-core product; it is
not a decode-graph buffer, so the decimators (ops/decimate.py) take it
as an argument instead.
"""

import functools

import numpy as np
import torch

from ..protocol.constants import (CAPTURE_RATE, COSTAS_OFFSETS,
                                  COSTAS_PATTERN, DOWNSAMPLING, FREQ_OSR,
                                  FT8_LDPC_M, FT8_LDPC_N, NFFT, NUM_BIN,
                                  NUM_BLOCKS)
from ..protocol.parity_tables import LDPC_MN, LDPC_NM

NUM_FFT_BINS = NUM_BIN * FREQ_OSR          # 512
TIME_OFFSET_MIN = -12
TIME_OFFSET_MAX = 24                       # exclusive
NUM_TIME_OFFSETS = TIME_OFFSET_MAX - TIME_OFFSET_MIN   # 36
NUM_EDGES = FT8_LDPC_M * 7                 # 581 padded (check, slot) edges

# key -> (shape, dtype) of every array from_reference accepts
SPEC = {
    "wf_cos": ((NFFT, NUM_FFT_BINS), np.float32),
    "wf_sin": ((NFFT, NUM_FFT_BINS), np.float32),
    "wf_cos_minus_sin": ((NFFT, NUM_FFT_BINS), np.float32),
    "wf_window": ((NFFT,), np.float32),
    "wf_twiddle": ((NFFT, 2), np.float32),
    "sync_count": ((NUM_TIME_OFFSETS,), np.int32),
    "ldpc_nm": ((FT8_LDPC_M, 7), np.int32),
    "ldpc_mn": ((FT8_LDPC_N, 3), np.int32),
    "ldpc_nm_pos": ((FT8_LDPC_M, 7), np.int32),
    "crc_mat": ((77, 14), np.int32),
}


def sine_window():
    """(1024,) float32 sin(pi n / 1024), the expression of
    rtlsdr_ft8d_tpu/ops/waterfall.py:37."""
    return np.sin(np.pi * np.arange(NFFT) / NFFT).astype(np.float32)


def fft_twiddles():
    """(1024, 2) float32 [re, im] of exp(-2 pi i k / 1024), computed in
    float64 and rounded once."""
    w = np.exp(-2j * np.pi * np.arange(NFFT) / NFFT)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


def dft_bases():
    """(cos, sin, cos - sin), each (1024, 512) float32, sine window folded
    in — the same expressions as rtlsdr_ft8d_tpu/ops/waterfall.py:37,57-61."""
    window = sine_window()
    n, k = np.meshgrid(np.arange(NFFT), np.arange(NUM_FFT_BINS),
                       indexing="ij")
    ang = 2.0 * np.pi * n * k / NFFT
    cos = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin = (np.sin(ang) * window[:, None]).astype(np.float32)
    return cos, sin, cos - sin


def sync_count():
    """Accumulated-term count of the C scoring loop per time offset; it
    depends on (time_offset, m, k) only (ops/sync.py:34-53)."""
    cnt = np.zeros(NUM_TIME_OFFSETS, np.int32)
    for ti, to in enumerate(range(TIME_OFFSET_MIN, TIME_OFFSET_MAX)):
        for m in COSTAS_OFFSETS:
            for k in range(7):
                b = to + m + k
                if not 0 <= b < NUM_BLOCKS:
                    continue
                sm = int(COSTAS_PATTERN[k])
                cnt[ti] += (sm > 0) + (sm < 7)
                cnt[ti] += (k > 0) and (b > 0)
                cnt[ti] += (k < 6) and (b + 1 < NUM_BLOCKS)
    return np.maximum(cnt, 1)


def ldpc_nm_pos():
    """Position of check m within LDPC_MN[n] for each edge (m, j) with
    n = LDPC_NM[m, j]; 0 on padded slots (ops/ldpc.py:28-34)."""
    pos = np.zeros_like(LDPC_NM)
    for m in range(FT8_LDPC_M):
        for j in range(7):
            n = LDPC_NM[m, j]
            if n >= 0:
                pos[m, j] = int(np.where(LDPC_MN[n] == m)[0][0])
    return pos


def crc_matrix():
    """CRC-14 of a unit payload vector per bit: crc = payload @ mat mod 2
    (ops/ldpc.py:277-289)."""
    from ..protocol.crc import payload_crc

    mat = np.zeros((77, 14), dtype=np.int32)
    base = np.zeros(77, dtype=np.uint8)
    if payload_crc(base) != 0:
        raise ValueError("CRC-14 of the zero payload must be 0")
    for i in range(77):
        v = base.copy()
        v[i] = 1
        c = payload_crc(v)
        mat[i] = [(c >> (13 - b)) & 1 for b in range(14)]
    return mat


# Copied from rtlsdr_ft8d_tpu/ops/decimate.py:36-68 (that module imports
# jax), in the same operation order, so the bank is bit-identical.
DECIMATE_PHASES = 8                         # filter length = 8 * 750


@functools.cache
def design_lowpass(taps: int, cutoff_hz: float, beta: float = 7.0
                   ) -> np.ndarray:
    """Kaiser-windowed sinc lowpass prototype (unity DC gain)."""
    n = np.arange(taps) - (taps - 1) / 2.0
    c = cutoff_hz / CAPTURE_RATE
    h = np.sinc(2 * c * n) * 2 * c
    h *= np.kaiser(taps, beta)
    h /= h.sum()
    return h.astype(np.float32)


@functools.cache
def filter_taps() -> np.ndarray:
    """The decimator's 6000-tap prototype, cutoff 2400 Hz."""
    return design_lowpass(DECIMATE_PHASES * DOWNSAMPLING, 2400.0)


def polyphase_bank() -> np.ndarray:
    """(750, 8) float32 bank: bank[p, r] = h[r*750 + p] time-reversed."""
    h = filter_taps()[::-1].copy()
    return np.ascontiguousarray(
        h.reshape(DECIMATE_PHASES, DOWNSAMPLING).T).astype(np.float32)


DECIMATE_K = 752            # the bank's rows padded to 47 steps of 16


def polyphase_bank_split(bank=None):
    """The int8 kernel's bank (csrc/decimate.cu): float16 (hi, lo), each
    (752, 8) with two zero rows after the 750 taps, and the shift s with
    hi + lo = 2^s * bank to about 22 bits. s puts the largest tap in
    [2^13, 2^14): hi keeps it far inside float16's range, and lo, at most
    half a unit of hi's last place, keeps 11 more bits."""
    bank = polyphase_bank() if bank is None else np.asarray(bank, np.float32)
    _, e = np.frexp(np.abs(bank).max())       # max |tap| < 2^e
    shift = 14 - int(e)
    scaled = np.zeros((DECIMATE_K, DECIMATE_PHASES), np.float64)
    scaled[:bank.shape[0]] = np.ldexp(bank.astype(np.float64), shift)
    hi = scaled.astype(np.float16)
    lo = (scaled - hi.astype(np.float64)).astype(np.float16)
    return hi, lo, shift


def reference_arrays() -> dict[str, np.ndarray]:
    """Every table of SPEC, built with numpy."""
    cos, sin, cms = dft_bases()
    return {"wf_cos": cos, "wf_sin": sin, "wf_cos_minus_sin": cms,
            "wf_window": sine_window(), "wf_twiddle": fft_twiddles(),
            "sync_count": sync_count(),
            "ldpc_nm": LDPC_NM.astype(np.int32),
            "ldpc_mn": LDPC_MN.astype(np.int32),
            "ldpc_nm_pos": ldpc_nm_pos().astype(np.int32),
            "crc_mat": crc_matrix()}


def from_reference(arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """SPEC arrays -> CPU tensors, plus the edge maps derived from the
    Tanner graph and the survivor packer's bit weights:

      ldpc_edge_var  (581,) variable n of edge (m, j) = m*7 + j, -1 padded
      ldpc_edge_slot (581,) its message slot n*3 + pos, -1 padded
      ldpc_slot_edge (522,) the edge of each message slot (inverse map)
      bit_weights    (8,) 128, 64, ..., 1: MSB-first bits -> byte
    """
    if set(arrays) != set(SPEC):
        raise ValueError(f"expected tables {sorted(SPEC)}, "
                         f"got {sorted(arrays)}")
    out = {}
    for key, (shape, dtype) in SPEC.items():
        a = np.asarray(arrays[key])
        if a.shape != shape:
            raise ValueError(f"{key}: shape {a.shape}, expected {shape}")
        if a.dtype.kind != np.dtype(dtype).kind:
            raise TypeError(f"{key}: dtype {a.dtype}, expected {dtype}")
        out[key] = torch.from_numpy(np.ascontiguousarray(a, dtype).copy())
    nm = arrays["ldpc_nm"].astype(np.int64).reshape(-1)
    pos = arrays["ldpc_nm_pos"].astype(np.int64).reshape(-1)
    slot = np.where(nm >= 0, nm * 3 + pos, -1)
    slot_edge = np.full(FT8_LDPC_N * 3, -1, np.int64)
    slot_edge[slot[slot >= 0]] = np.nonzero(slot >= 0)[0]
    if (slot_edge < 0).any():
        raise ValueError("Tanner graph: a message slot has no edge")
    out["ldpc_edge_var"] = torch.from_numpy(nm.astype(np.int32))
    out["ldpc_edge_slot"] = torch.from_numpy(slot.astype(np.int32))
    out["ldpc_slot_edge"] = torch.from_numpy(slot_edge)
    out["bit_weights"] = torch.from_numpy(1 << np.arange(7, -1, -1,
                                                         dtype=np.int32))
    return out
