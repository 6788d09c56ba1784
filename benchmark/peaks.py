"""The H100's published peaks and the work of each decode kernel, counted
from the shapes and the inputs, whatever implements it.

Frozen copy of chip_smoke.py:178-186 (HBM_BYTES_PER_S, F32_OPS_PER_S,
KERNEL_SYMBOLS), 214-250 (bound, waterfall_bound, llr_bound, bp_bound)
and 525-528 (the sync bound), written over shapes instead of tensors.
Each `*_work` returns (bytes moved, FP32-class operations) for one
launch: each input read once, each output written once.
"""

# H100 SXM published peaks at a 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# each kernel's function in the profiler's kernel names
KERNEL_SYMBOLS = {"waterfall": "waterfall_kernel", "sync": "sync_kernel",
                  "llr": "llr_kernel", "bp": "bp_kernel"}

NUM_BLOCKS, NUM_BIN = 92, 256
USED_SAMPLES = 47872               # 187 blocks of 256 samples
NUM_FRAMES = 184
WF_BYTES = NUM_BLOCKS * 2 * 2 * NUM_BIN      # one channel's waterfall
SCORE_CELLS = 2 * 2 * 36 * 249               # one channel's sync grid
NUM_SURVIVORS = 4 * 36 * 16 * 4              # first-stage survivors
FT8_ND, FT8_LDPC_N = 58, 174
BP_EDGES = 522


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for `nbytes` moved and `ops` FP32-class operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def waterfall_work(channels: int) -> tuple[int, int]:
    """Both components' used float32 samples in, the uint8 waterfall out;
    a 1024-point FFT (5 N log2 N) per frame."""
    return (2 * channels * USED_SAMPLES * 4 + channels * WF_BYTES,
            5 * 1024 * 10 * NUM_FRAMES * channels)


def sync_work(channels: int) -> tuple[int, int]:
    """The waterfall in, the first stage's int32 scores and indices out;
    3 Costas blocks x 7 tones x 4 neighbour differences per score cell."""
    return (channels * WF_BYTES + channels * NUM_SURVIVORS * 2 * 4,
            channels * SCORE_CELLS * 84)


def llr_work(rows: int, field_bytes: int = 40) -> tuple[int, int]:
    """The LLR launch as the forward needs it: the tone cells read, the
    candidate fields (`field_bytes` a row: five int64, the program's
    width), the LLRs written; per symbol 3 x 8 tone magnitudes and
    3 x 3 max-log terms, 2 per LLR. The s2 and valid it also writes are
    not asked for there and not counted."""
    n = rows
    return (n * FT8_ND * 8 + n * field_bytes + n * FT8_LDPC_N * 4,
            n * FT8_ND * (3 * 8 + 3 * 3) + n * FT8_LDPC_N * 2)


def snr_work(rows: int, field_bytes: int = 40) -> tuple[int, int]:
    """The survivors' SNR launch (tone_mags_flat): the tone cells read,
    the candidate fields, s2 and valid written; one conversion per tone
    cell. The LLRs the kernel also writes are not asked for there and
    not counted."""
    n = rows
    return (n * FT8_ND * 8 + n * field_bytes + n * FT8_ND * 8 * 4
            + n * FT8_ND, n * FT8_ND * 8)


def bp_work(rows: int, row_iterations: int) -> tuple[int, int]:
    """The LLRs in, int8 hard bits and int32 error counts out; 32 FP32
    operations per edge and iteration over the row-iterations the rows'
    outputs need."""
    return (rows * FT8_LDPC_N * 4 + rows * FT8_LDPC_N + rows * 4,
            32 * BP_EDGES * row_iterations)


def roofline_pct(trace: dict, kernel: str):
    """A kernel's share of its roofline over the profiled windows, in %:
    the sum of its launches' bounds over its device time by name; None
    where the profile holds no launch of it."""
    prof = trace.get("profile")
    if not prof:
        return None
    sym = KERNEL_SYMBOLS[kernel]
    dev_ms = sum(e - s for name, s, e in prof["device"] if sym in name) / 1e3
    if dev_ms <= 0:
        return None
    bound = sum(bound_ms(b, o)[0] for work in trace["work"]
                for b, o in work[kernel])
    return 100.0 * bound / dev_ms
