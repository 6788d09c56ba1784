# Frozen copy of rtlsdr_ft8d_tpu_torch/protocol/crc.py:1-53 without
# check_crc, which nothing here calls; the benchmark keeps the rest
# unchanged so that a change to the program cannot move the yardstick.
# Copied from rtlsdr_ft8d_tpu/protocol/crc.py:1-52.
"""CRC-14 for FT8 (host reference implementation).

The 14-bit CRC (polynomial 0x2757, MSB-first, init 0) is computed over the 77
payload bits zero-padded to 82 bits, and stored in codeword bits 77..90.
Behavioural contract observed from the reference decode path
(rtlsdr_ft8d.c:1476-1482 consumes crc_calculated/crc_extracted).
"""

import numpy as np

from .constants import CRC_POLYNOMIAL, CRC_WIDTH, FT8_PAYLOAD_BITS


def crc14(bits) -> int:
    """CRC-14 over a sequence of bits (MSB-first shift register)."""
    reg = 0
    top = 1 << (CRC_WIDTH - 1)
    mask = (1 << CRC_WIDTH) - 1
    for b in bits:
        reg ^= (int(b) & 1) << (CRC_WIDTH - 1)
        if reg & top:
            reg = ((reg << 1) ^ CRC_POLYNOMIAL) & mask
        else:
            reg = (reg << 1) & mask
    return reg


def payload_crc(payload_bits: np.ndarray) -> int:
    """CRC-14 of a 77-bit payload (padded to 82 bits with zeros)."""
    assert len(payload_bits) == FT8_PAYLOAD_BITS
    padded = list(payload_bits) + [0] * 5
    return crc14(padded)


def add_crc(payload_bits: np.ndarray) -> np.ndarray:
    """77 payload bits -> 91 message bits (payload + CRC-14)."""
    c = payload_crc(payload_bits)
    crc_bits = [(c >> (CRC_WIDTH - 1 - i)) & 1 for i in range(CRC_WIDTH)]
    return np.concatenate([
        np.asarray(payload_bits, dtype=np.uint8),
        np.asarray(crc_bits, dtype=np.uint8),
    ])
