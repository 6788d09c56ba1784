# Frozen copy of rtlsdr_ft8d_tpu_torch/protocol/constants.py:1-75; the benchmark keeps
# it unchanged so that a change to the program cannot move the yardstick.
# Copied from rtlsdr_ft8d_tpu/protocol/constants.py:1-74.
"""FT8 protocol constants.

Protocol facts mirror the FT8 spec ("The FT4 and FT8 Communication Protocols",
Franke/Somerville/Taylor, QEX 2020) as consumed by the reference daemon
(rtlsdr_ft8d.c:38-44 includes ft8_lib headers; sampling
constants at rtlsdr_ft8d.h:33-56).
"""

import numpy as np

# ---- Code dimensions -------------------------------------------------------
FT8_PAYLOAD_BITS = 77      # i3/n3-typed payload
FT8_CRC_BITS = 14          # CRC-14 appended to payload
FT8_LDPC_K = 91            # message bits = payload + CRC
FT8_LDPC_M = 83            # parity checks / parity bits
FT8_LDPC_N = 174           # codeword bits
FT8_ND = 58                # data symbols (3 bits each -> 174)
FT8_NN = 79                # total channel symbols (58 data + 3x7 Costas)

# CRC-14: polynomial 0x2757 (x^14+x^13+x^10+x^9+x^8+x^6+x^4+x^2+x+1),
# computed over the 77 payload bits zero-padded to 82 bits, MSB-first,
# no reflection, init 0.
CRC_POLYNOMIAL = 0x2757
CRC_WIDTH = 14

# 7x7 Costas array transmitted at symbol offsets 0, 36 and 72.
COSTAS_PATTERN = np.array([3, 1, 4, 0, 6, 5, 2], dtype=np.int32)
COSTAS_OFFSETS = (0, 36, 72)

# Gray map: 3-bit group value -> transmitted tone.
GRAY_MAP = np.array([0, 1, 3, 2, 5, 6, 4, 7], dtype=np.int32)
# Inverse: tone -> 3-bit group value.
GRAY_INV = np.zeros(8, dtype=np.int32)
GRAY_INV[GRAY_MAP] = np.arange(8)

# Indices (0..78) of the 58 data symbols (those not in a Costas block).
DATA_SYMBOL_IDX = np.array(
    [i for i in range(FT8_NN)
     if not any(off <= i < off + 7 for off in COSTAS_OFFSETS)],
    dtype=np.int32,
)
assert DATA_SYMBOL_IDX.shape[0] == FT8_ND

# ---- Sampling / waterfall geometry (reference rtlsdr_ft8d.h:33-56) ---------
SIGNAL_LENGTH_S = 15
SIGNAL_SAMPLE_RATE = 3200
CAPTURE_RATE = 2_400_000
DOWNSAMPLING = 750
TONE_SPACING_HZ = 6.25
SYMBOL_PERIOD_S = 0.16

NUM_BIN = 256          # frequency bins kept per FFT (SIGNAL_SAMPLE_RATE / (2*6.25))
BLOCK_SIZE = 512       # samples per symbol at 3200 sps
TIME_OSR = 2           # time oversampling (half-symbol hops)
FREQ_OSR = 2           # frequency oversampling (zero-pad factor)
SUB_BLOCK_SIZE = BLOCK_SIZE // TIME_OSR   # 256
NFFT = BLOCK_SIZE * FREQ_OSR              # 1024
NUM_BLOCKS = ((SIGNAL_LENGTH_S * SIGNAL_SAMPLE_RATE) - NFFT + SUB_BLOCK_SIZE) // BLOCK_SIZE  # 92
MAG_ARRAY = NUM_BLOCKS * FREQ_OSR * TIME_OSR * NUM_BIN  # 94208

# Decoder defaults (reference rtlsdr_ft8d.h:43-47)
K_MIN_SCORE = 10
K_MAX_CANDIDATES = 120
K_LDPC_ITERS = 20
K_MAX_MESSAGES = 50

# ---- Golden end-to-end vector (reference rtlsdr_ft8d.c:919-923) ------------
# pack77("CQ K1JT FN20QI") -> these 10 bytes -> ft8_encode -> these 79 tones.
GOLDEN_MESSAGE = "CQ K1JT FN20QI"
GOLDEN_PACKED = bytes.fromhex("000000204dfcdc8a1408")
GOLDEN_TONES = np.array([int(c) for c in
    "31406520000000010054775471060350363731406525474413421160564600651744271431"
    "40652"], dtype=np.int32)
assert GOLDEN_TONES.shape[0] == FT8_NN
