"""Polyphase decimating front end: 2.4 Msps I/Q -> 3,200 sps baseband.

Port of rtlsdr_ft8d_tpu/ops/decimate.py (polyphase_decimate and the
streaming wrappers; the plain versions here) and ops/decimate_pallas.py
(decimate_int8, the kernel, csrc/decimate.cu). The 6000-tap Kaiser
lowpass is applied as a polyphase product: the input is cut into
750-sample frames, each frame is dotted with the 8 phases of the
(750, 8) bank (ops/tables.polyphase_bank), and output m sums the 8
shifted diagonals y[m + r, r]. A chunk of 750 M samples needs the
HISTORY = 5,250 samples before it; the streaming decimators carry them.

The kernel takes the bank as two float16 parts in its tensor-core
fragment order (`DecimatorBank`), and its rows at a 16-byte-aligned
stride (`ALIGN`), which its bulk copies need; `decimate_int8_cuda`
copies any other input into that layout.
"""

import numpy as np
import torch

from ..protocol.constants import DOWNSAMPLING
from . import build
from .tables import (DECIMATE_K, DECIMATE_PHASES, polyphase_bank,
                     polyphase_bank_split)

R = DOWNSAMPLING                # 750
PHASES = DECIMATE_PHASES        # 8: filter length = PHASES * R
TAPS = PHASES * R               # 6000
HISTORY = TAPS - R              # 5250 samples of carried state
K_STEPS = DECIMATE_K // 16      # 47 tensor-core steps of 16 samples
ALIGN = 16                      # the kernel's row alignment, bytes

KERNEL = build.Kernel(
    "decimate", "ft8_decimate_int8", [build.P] * 5 + [build.I] * 4,
    source="rtlsdr_ft8d_tpu_torch/csrc/decimate.cu",
    replaces="rtlsdr_ft8d_tpu/ops/decimate_pallas.py:114")


def _outputs(n: int) -> int:
    m = (n - HISTORY) // R
    if m < 1 or n != HISTORY + m * R:
        raise ValueError(f"length must be {HISTORY} + 750*M with M >= 1, "
                         f"got {n}")
    return m


def _padded(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _device(device) -> torch.device:
    """The decimators' device; "cuda" without a card raises: they never
    fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"decimator on {dev}, but "
                           "torch.cuda.is_available() is False")
    return dev


def bank_fragments(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(K_STEPS, 32, 4) int32: the split bank (tables.polyphase_bank_split)
    as the B operands of mma.m16n8k16. For K step ks and lane (g, t) =
    (lane // 4, lane % 4), the float16 pairs of column g at rows
    16 ks + 2t, +1 and 16 ks + 2t + 8, +9 (lower row in the low half), of
    hi, then of lo."""
    lane = np.arange(32)
    g, k = lane // 4, 2 * (lane % 4)

    def regs(part):
        u = part.view(np.uint16).astype(np.uint32).reshape(K_STEPS, 16,
                                                            PHASES)
        return [u[:, k + d, g] | (u[:, k + d + 1, g] << 16) for d in (0, 8)]

    return np.ascontiguousarray(
        np.stack(regs(hi) + regs(lo), axis=-1)).view(np.int32)


class DecimatorBank:
    """The decimator's filter on one device: `f32`, the (750, 8) float32
    bank of the plain version, and for the kernel `fragments` with
    `shift`, the bank split in two float16 parts of 2^shift * bank."""

    def __init__(self, bank=None, device="cuda"):
        bank = polyphase_bank() if bank is None else np.asarray(bank,
                                                                np.float32)
        hi, lo, self.shift = polyphase_bank_split(bank)
        dev = _device(device)
        self.f32 = torch.from_numpy(np.ascontiguousarray(bank)).to(dev)
        self.fragments = torch.from_numpy(bank_fragments(hi, lo)).to(dev)


def polyphase_decimate_plain(x: torch.Tensor, bank: torch.Tensor):
    """(..., HISTORY + 750 M) float32 -> (..., M) float32: frames @ bank,
    then the 8 shifted diagonal sums, in the order of
    rtlsdr_ft8d_tpu/ops/decimate.py:109-121."""
    if x.is_cuda:
        build.require_full_f32_matmul()
    m = _outputs(x.shape[-1])
    fr = x.reshape(x.shape[:-1] + (m + PHASES - 1, R))
    y = torch.matmul(fr, bank)                        # (..., nf, 8)
    out = torch.zeros(x.shape[:-1] + (m,), dtype=torch.float32,
                      device=x.device)
    for r in range(PHASES):
        out = out + y[..., r:r + m, r]
    return out


def decimate_int8_plain(i8: torch.Tensor, q8: torch.Tensor,
                        bank: torch.Tensor):
    """Plain version of the kernel: the float decimator on int8 values,
    scaled by 1/128 (exact: a power of two); `bank` the (750, 8) float32
    bank."""
    return (polyphase_decimate_plain(i8.to(torch.float32), bank) / 128.0,
            polyphase_decimate_plain(q8.to(torch.float32), bank) / 128.0)


def _rows(x: torch.Tensor, n: int):
    """x as (rows, n), and the byte stride between its rows if the kernel
    may read it in place (16-byte-aligned rows, each readable to its end
    rounded up to 16 bytes), else None."""
    x2 = x.reshape(-1, n)
    rows = x2.shape[0]
    stride = x2.stride(0) if rows > 1 else _padded(n)
    end = x2.storage_offset() + (rows - 1) * stride + _padded(n)
    if (x2.stride(1) == 1 and x2.data_ptr() % ALIGN == 0
            and stride % ALIGN == 0 and stride >= n
            and end <= x2.untyped_storage().nbytes()):
        return x2, stride
    return x2, None


def _decimate_cuda(i8, q8, bank: DecimatorBank):
    """One launch for I and Q of every row: (..., n) int8 each ->
    (2, rows, M) float32, I then Q."""
    dev = i8.device
    if q8.shape != i8.shape:
        raise ValueError(f"I and Q shapes differ: {tuple(i8.shape)} vs "
                         f"{tuple(q8.shape)}")
    for x in (i8, q8):
        if x.dtype != torch.int8:
            raise TypeError(f"expected torch.int8, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"I on {dev}, Q on {x.device}")
    n = i8.shape[-1]
    m = _outputs(n)
    (i2, si), (q2, sq) = _rows(i8, n), _rows(q8, n)
    rows = i2.shape[0]
    if si is None or sq is None or (rows > 1 and si != sq):
        staged = torch.empty((2, rows, _padded(n)), dtype=torch.int8,
                             device=dev)
        staged[0, :, :n] = i2
        staged[1, :, :n] = q2
        i2, q2, si = staged[0], staged[1], _padded(n)
    out = torch.empty((2, rows, m), dtype=torch.float32, device=dev)
    if rows:
        KERNEL(dev, i2.data_ptr(), q2.data_ptr(),
               build.check(bank.fragments, torch.int32, (K_STEPS, 32, 4),
                           dev),
               build.check(out[0], torch.float32),
               build.check(out[1], torch.float32), rows, n, si, bank.shift)
    return out


def decimate_int8_cuda(i8: torch.Tensor, q8: torch.Tensor,
                       bank: DecimatorBank):
    """The kernel: (..., HISTORY + 750 M) int8 I/Q on one CUDA device,
    any leading shape, one launch for both components."""
    out = _decimate_cuda(i8, q8, bank)
    shape = i8.shape[:-1] + (out.shape[-1],)
    return out[0].reshape(shape), out[1].reshape(shape)


def decimate_int8(i8: torch.Tensor, q8: torch.Tensor, bank: DecimatorBank):
    """(..., HISTORY + 750 M) int8 I/Q -> (..., M) float32 I/Q at 3,200
    sps, scaled by 1/128: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if build.on_cuda(i8):
        return decimate_int8_cuda(i8, q8, bank)
    return decimate_int8_plain(i8, q8, bank.f32)


def kernel_info() -> dict:
    """The kernel's registers per thread, static and dynamic shared bytes
    per block, resident blocks per SM and spill bytes per thread, as the
    CUDA runtime reports them for the current device."""
    lib = build.load()
    info = (build.I * 5)()
    fn = lib.ft8_decimate_info
    fn.argtypes = [build.P]
    fn.restype = build.I
    err = fn(info)
    if err != 0:
        raise RuntimeError(f"ft8_decimate_info failed: "
                           f"{lib.ft8_cuda_error_string(err).decode()}")
    return dict(zip(("registers", "static_shared_bytes",
                     "dynamic_shared_bytes", "blocks_per_sm",
                     "spill_bytes"), info))


def _chunk(x, dtype):
    x = np.ascontiguousarray(x, dtype)
    if x.ndim != 1 or x.shape[0] % R:
        raise ValueError(f"a chunk must be 1-D with a multiple of {R} "
                         f"samples, got shape {x.shape}")
    return torch.from_numpy(x)


class StreamingDecimator:
    """Overlap-save float decimator (rtlsdr_ft8d_tpu/ops/decimate.py:
    126-148): feed 1-D float32 chunks of any multiple of 750 samples,
    receive the 3,200 sps output as numpy, with the HISTORY-sample tail
    carried on `device`. On "cpu" it is the host decimator (`--ingest
    host`): same bank, same state, no upload."""

    def __init__(self, bank, device="cuda"):
        self.device = _device(device)
        self.bank = torch.as_tensor(bank, dtype=torch.float32).to(
            self.device)
        self._hist = torch.zeros((2, HISTORY), dtype=torch.float32,
                                 device=self.device)

    def process(self, i_chunk, q_chunk):
        chunk = torch.stack([_chunk(i_chunk, np.float32),
                             _chunk(q_chunk, np.float32)]).to(self.device)
        full = torch.cat([self._hist, chunk], dim=-1)
        self._hist = full[:, -HISTORY:].clone()
        out = polyphase_decimate_plain(full, self.bank).cpu().numpy()
        return out[0], out[1]


class StreamingDecimatorInt8:
    """int8 overlap-save decimator (rtlsdr_ft8d_tpu/ops/decimate.py:
    197-229): uploads only the new int8 chunk (4x fewer bytes than float
    I/Q), keeps the int8 history on `device`, and runs decimate_int8.
    Output scale matches StreamingDecimator fed with int8 / 128.

    On a CUDA device one buffer holds [history | chunk] as two rows, I and
    Q, at a 16-byte-aligned stride, so the kernel reads it in place. A
    chunk goes in from a reused pinned host buffer (`staging`; a caller
    that writes the chunk there saves the one host copy) by one
    asynchronous copy, the history moves within the device buffer, and
    both outputs come back in one copy. The buffers are reallocated only
    when the chunk length changes. On "cpu" it is the plain version."""

    def __init__(self, bank, device="cuda"):
        self.device = _device(device)
        self.bank = DecimatorBank(bank, self.device)
        self._hist = torch.zeros((2, HISTORY), dtype=torch.int8)  # on "cpu"
        self._len = 0
        self._buf = self._host = None

    def _resize(self, length):
        on_card = self.device.type == "cuda"
        if on_card:
            buf = torch.zeros((2, _padded(HISTORY + length)),
                              dtype=torch.int8, device=self.device)
            if self._buf is not None:
                buf[:, :HISTORY] = self._buf[:, :HISTORY]
            self._buf = buf
        self._host = torch.empty((2, length), dtype=torch.int8,
                                 pin_memory=on_card)
        self._len = length

    def staging(self, length):
        """(i, q): numpy views of the host buffer that a `process` call on
        chunks of `length` samples uploads from (pinned on a CUDA
        device)."""
        if length != self._len:
            self._resize(length)
        host = self._host.numpy()
        return host[0], host[1]

    def process(self, i8_chunk, q8_chunk):
        i8, q8 = _chunk(i8_chunk, np.int8), _chunk(q8_chunk, np.int8)
        if self.device.type != "cuda":
            chunk = torch.stack([i8, q8]).to(self.device)
            # the history is the tail of [history, chunk], never of padding
            full = torch.cat([self._hist, chunk], dim=-1)
            self._hist = full[:, -HISTORY:].clone()
            out_i, out_q = decimate_int8(full[0], full[1], self.bank)
            return out_i.cpu().numpy(), out_q.cpu().numpy()
        length = i8.shape[0]
        if q8.shape[0] != length:
            raise ValueError(f"I and Q chunks differ: {length} vs "
                             f"{q8.shape[0]}")
        if length != self._len:
            self._resize(length)
        for row, x in enumerate((i8, q8)):
            if x.data_ptr() != self._host[row].data_ptr():
                self._host[row].copy_(x)
        n = HISTORY + length
        buf = self._buf
        buf[:, HISTORY:n].copy_(self._host, non_blocking=True)
        out = _decimate_cuda(buf[0, :n], buf[1, :n], self.bank)
        # the history is the tail of [history, chunk], never of padding;
        # a chunk shorter than it overlaps it, so goes through a copy
        tail = buf[:, length:n]
        buf[:, :HISTORY].copy_(tail.clone() if length < HISTORY else tail)
        # a copy to pageable memory waits for the stream: the next call's
        # writes to the pinned buffer come after the upload above read it
        out = out.cpu().numpy()
        return out[0, 0], out[1, 0]
