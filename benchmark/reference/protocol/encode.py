# Frozen copy of rtlsdr_ft8d_tpu_torch/protocol/encode.py:1-71 without
# bytes_to_bits, bits_to_bytes and tones_to_codeword, which nothing here
# calls; the benchmark keeps the rest unchanged so that a change to the
# program cannot move the yardstick.
# Copied from rtlsdr_ft8d_tpu/protocol/encode.py:1-70.
"""FT8 encoder: 77-bit payload -> 79 channel symbols.

Pipeline: payload -> +CRC-14 -> LDPC(174,91) systematic encode -> 3-bit
groups -> Gray map -> insert Costas sync at symbols 0/36/72.
Parity target: reference golden vector at rtlsdr_ft8d.c:919-923.
"""

import numpy as np

from .constants import (COSTAS_OFFSETS, COSTAS_PATTERN, DATA_SYMBOL_IDX,
                        FT8_LDPC_K, FT8_LDPC_N, FT8_NN, GRAY_MAP)
from .crc import add_crc
from .generator import generator_matrix

_G = None


def _gen():
    global _G
    if _G is None:
        _G = generator_matrix()
    return _G


def ldpc_encode(message_bits: np.ndarray) -> np.ndarray:
    """91 message bits -> 174-bit systematic codeword [message | parity]."""
    assert len(message_bits) == FT8_LDPC_K
    m = np.asarray(message_bits, dtype=np.uint8)
    parity = (_gen() @ m) & 1
    cw = np.concatenate([m, parity.astype(np.uint8)])
    assert cw.shape[0] == FT8_LDPC_N
    return cw


def codeword_to_tones(codeword: np.ndarray) -> np.ndarray:
    """174-bit codeword -> 79 tones (Costas at 0/36/72, Gray-mapped data)."""
    groups = codeword.reshape(58, 3)
    vals = groups[:, 0] * 4 + groups[:, 1] * 2 + groups[:, 2]
    tones = np.zeros(FT8_NN, dtype=np.int32)
    for off in COSTAS_OFFSETS:
        tones[off:off + 7] = COSTAS_PATTERN
    tones[DATA_SYMBOL_IDX] = GRAY_MAP[vals]
    return tones


def encode(payload_bits: np.ndarray) -> np.ndarray:
    """77 payload bits -> 79 channel tones."""
    return codeword_to_tones(ldpc_encode(add_crc(payload_bits)))
