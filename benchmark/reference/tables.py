"""The decode path's static tables, built with numpy.

Frozen copy of rtlsdr_ft8d_tpu_torch/ops/tables.py:57-131 (sine_window,
dft_bases, sync_count, ldpc_nm_pos, crc_matrix), 177-188 (design_lowpass)
and 230-259 (the edge maps of from_reference), against this folder's own
copy of the protocol tables.
"""

import functools

import numpy as np

from .protocol.constants import (CAPTURE_RATE, COSTAS_OFFSETS, COSTAS_PATTERN,
                                 FREQ_OSR, FT8_LDPC_M, FT8_LDPC_N, NFFT,
                                 NUM_BIN, NUM_BLOCKS)
from .protocol.crc import payload_crc
from .protocol.parity_tables import LDPC_MN, LDPC_NM

NUM_FFT_BINS = NUM_BIN * FREQ_OSR          # 512
TIME_OFFSET_MIN = -12
TIME_OFFSET_MAX = 24                       # exclusive
NUM_TIME_OFFSETS = TIME_OFFSET_MAX - TIME_OFFSET_MIN   # 36
NUM_EDGES = FT8_LDPC_M * 7                 # 581 padded (check, slot) edges


def sine_window():
    return np.sin(np.pi * np.arange(NFFT) / NFFT).astype(np.float32)


def dft_bases():
    """(cos, sin, cos - sin), each (1024, 512) float32, window folded in."""
    window = sine_window()
    n, k = np.meshgrid(np.arange(NFFT), np.arange(NUM_FFT_BINS),
                       indexing="ij")
    ang = 2.0 * np.pi * n * k / NFFT
    cos = (np.cos(ang) * window[:, None]).astype(np.float32)
    sin = (np.sin(ang) * window[:, None]).astype(np.float32)
    return cos, sin, cos - sin


def sync_count():
    """Accumulated-term count of the C scoring loop per time offset."""
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
    pos = np.zeros_like(LDPC_NM)
    for m in range(FT8_LDPC_M):
        for j in range(7):
            n = LDPC_NM[m, j]
            if n >= 0:
                pos[m, j] = int(np.where(LDPC_MN[n] == m)[0][0])
    return pos


def crc_matrix():
    """CRC-14 of a unit payload vector per bit: crc = payload @ mat mod 2."""
    mat = np.zeros((77, 14), dtype=np.int32)
    base = np.zeros(77, dtype=np.uint8)
    for i in range(77):
        v = base.copy()
        v[i] = 1
        c = payload_crc(v)
        mat[i] = [(c >> (13 - b)) & 1 for b in range(14)]
    return mat


def edge_maps():
    """(edge_var (581,), edge_slot (581,), slot_edge (522,)) int64: the
    variable and message slot of each padded (check, slot) edge, -1 on
    padding, and the edge of each message slot."""
    nm = LDPC_NM.astype(np.int64).reshape(-1)
    pos = ldpc_nm_pos().astype(np.int64).reshape(-1)
    slot = np.where(nm >= 0, nm * 3 + pos, -1)
    slot_edge = np.full(FT8_LDPC_N * 3, -1, np.int64)
    slot_edge[slot[slot >= 0]] = np.nonzero(slot >= 0)[0]
    return nm, slot, slot_edge


@functools.cache
def design_lowpass(taps: int, cutoff_hz: float, beta: float = 7.0
                   ) -> np.ndarray:
    """Kaiser-windowed sinc lowpass prototype (unity DC gain), float32."""
    n = np.arange(taps) - (taps - 1) / 2.0
    c = cutoff_hz / CAPTURE_RATE
    h = np.sinc(2 * c * n) * 2 * c
    h *= np.kaiser(taps, beta)
    h /= h.sum()
    return h.astype(np.float32)
