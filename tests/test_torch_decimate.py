"""The port's ingest decimator against the JAX package.

The bank and taps must equal the JAX module's bit for bit. The float
polyphase product is held to rtlsdr_ft8d_tpu.ops.decimate.polyphase_decimate
at rtol 1e-5, atol 1e-6 (float32 matmuls of 750-term dot products in
another summation order). The int8 path is held to the Pallas kernel
(interpret mode, as tests/test_decimate_pallas.py runs it) and to the
float streaming decimator on int8 / 128 with that file's hold: rtol 1e-4,
atol 1e-5. numpy models of csrc/decimate.cu (its byte-permute conversion
and its tensor-core arithmetic) are held to the same references, since
the kernel itself runs only on a card.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu.ops import decimate as jdec
from rtlsdr_ft8d_tpu.ops.decimate_pallas import decimate_int8 as pallas_int8
from rtlsdr_ft8d_tpu_torch.ops import decimate, tables

from .torch_cpu import few_torch_threads  # noqa: F401

HISTORY, R = decimate.HISTORY, decimate.R


def _int8(rng, *shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


def test_bank_and_taps_equal_jax_bitwise():
    assert (decimate.HISTORY, decimate.TAPS, decimate.PHASES) == \
        (jdec.HISTORY, jdec.TAPS, jdec.PHASES)
    np.testing.assert_array_equal(tables.filter_taps(), jdec.filter_taps())
    bank = tables.polyphase_bank()
    assert bank.dtype == np.float32 and bank.shape == (750, 8)
    np.testing.assert_array_equal(bank, jdec._polyphase_bank())


def test_polyphase_plain_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, HISTORY + 64 * R)).astype(np.float32)
    ref, _ = jdec.polyphase_decimate(jnp.asarray(x), jnp.zeros_like(x))
    got = decimate.polyphase_decimate_plain(
        torch.from_numpy(x), torch.from_numpy(jdec._polyphase_bank()))
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_int8_plain_matches_pallas_interpret():
    rng = np.random.default_rng(1)
    n = HISTORY + 48 * R
    i8, q8 = _int8(rng, n), _int8(rng, n)
    ri, rq = pallas_int8(jnp.asarray(i8), jnp.asarray(q8), interpret=True,
                         tile_out=16)
    bank = decimate.DecimatorBank(device="cpu")
    before = decimate.KERNEL.launches
    oi, oq = decimate.decimate_int8(torch.from_numpy(i8),
                                    torch.from_numpy(q8), bank)
    assert decimate.KERNEL.launches == before      # CPU: the plain version
    np.testing.assert_allclose(oi.numpy(), np.asarray(ri), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(oq.numpy(), np.asarray(rq), rtol=1e-4,
                               atol=1e-5)


def test_streaming_three_chunks_match_jax_and_one_shot():
    rng = np.random.default_rng(2)
    sizes = (8 * R, 3 * R, 21 * R)
    i_all = rng.standard_normal(sum(sizes)).astype(np.float32)
    q_all = rng.standard_normal(sum(sizes)).astype(np.float32)
    ref = jdec.StreamingDecimator()
    mine = decimate.StreamingDecimator(tables.polyphase_bank(), "cpu")
    got_i, got_q, ref_i, ref_q = [], [], [], []
    start = 0
    for size in sizes:
        sl = slice(start, start + size)
        a, b = mine.process(i_all[sl], q_all[sl])
        c, d = ref.process(i_all[sl], q_all[sl])
        got_i.append(a), got_q.append(b), ref_i.append(c), ref_q.append(d)
        start += size
    got_i, got_q = np.concatenate(got_i), np.concatenate(got_q)
    np.testing.assert_allclose(got_i, np.concatenate(ref_i), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_q, np.concatenate(ref_q), rtol=1e-5,
                               atol=1e-6)
    one_i, one_q = decimate.StreamingDecimator(
        tables.polyphase_bank(), "cpu").process(i_all, q_all)
    np.testing.assert_allclose(got_i, one_i, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_q, one_q, rtol=1e-5, atol=1e-6)


def test_streaming_int8_matches_jax_float():
    """StreamingDecimatorInt8 against the JAX float StreamingDecimator on
    int8 / 128, over two chunks so the int8 history is carried."""
    rng = np.random.default_rng(3)
    ref = jdec.StreamingDecimator()
    mine = decimate.StreamingDecimatorInt8(tables.polyphase_bank(), "cpu")
    for m in (32, 5):
        i8, q8 = _int8(rng, m * R), _int8(rng, m * R)
        ri, rq = ref.process(i8.astype(np.float32) / 128.0,
                             q8.astype(np.float32) / 128.0)
        oi, oq = mine.process(i8, q8)
        assert oi.shape == ri.shape == (m,)
        np.testing.assert_allclose(oi, ri, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(oq, rq, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cls,dtype", [
    (decimate.StreamingDecimator, np.float32),
    (decimate.StreamingDecimatorInt8, np.int8)])
def test_chunk_not_multiple_of_750_raises(cls, dtype):
    dec = cls(tables.polyphase_bank(), "cpu")
    x = np.zeros(R + 1, dtype)
    with pytest.raises(ValueError, match="multiple of 750"):
        dec.process(x, x)


def test_length_and_device_checks():
    bank = decimate.DecimatorBank(device="cpu")
    with pytest.raises(ValueError, match="5250"):
        decimate.polyphase_decimate_plain(torch.zeros(HISTORY + R - 2),
                                          bank.f32)
    with pytest.raises(ValueError, match="5250"):
        decimate.decimate_int8(torch.zeros(HISTORY, dtype=torch.int8),
                               torch.zeros(HISTORY, dtype=torch.int8), bank)
    meta = torch.zeros(HISTORY + R, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        decimate.decimate_int8(meta, meta, bank)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8 bytes (y:x), x the low four."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


@pytest.mark.parametrize("width", ["f16", "f32"])
def test_byte_permute_conversion_is_exact(width):
    """The kernel's int8 -> float conversion without I2F, for all 256
    values: 0x64XX is the float16 1024 + XX (0x4B0000XX the float32
    2^23 + XX), and XX = b ^ 0x80 = b + 128, so subtracting 1152
    (2^23 + 128) leaves b exactly."""
    b = np.arange(256, dtype=np.uint64)
    want = b.astype(np.uint8).view(np.int8)
    if width == "f16":
        # two samples per word, every value in both halves
        v = b | ((255 - b) << 8)
        word = _byte_perm(v ^ 0x8080, np.uint64(0x64646464), 0x4140)
        pair = word.astype(np.uint32).view(np.float16).reshape(256, 2)
        got = pair - np.float16(1152)
        assert got.dtype == np.float16
        np.testing.assert_array_equal(got[:, 0], want.astype(np.float16))
        np.testing.assert_array_equal(got[:, 1],
                                      want[::-1].astype(np.float16))
    else:
        word = _byte_perm(b ^ 0x80, np.uint64(0x4B000000), 0x7650)
        got = word.astype(np.uint32).view(np.float32) - np.float32(8388736)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want.astype(np.float32))


def _kernel_model(x8, fragments, shift):
    """csrc/decimate.cu's arithmetic on one row of int8 samples, in numpy:
    B read back from the fragment layout as each lane holds it; A as
    16-frame tiles with K padded to 752 (the two samples past a frame are
    the next frame's, 0 past the row); per warp (K steps 6w .. 6w+5) one
    float32 rounding per MMA (products exact), hi then lo; the warps'
    partials summed in warp order; the diagonal epilogue; 2^-(s+7)."""
    n = x8.shape[0]
    m = (n - HISTORY) // R
    nf = m + decimate.PHASES - 1
    steps = decimate.K_STEPS
    lane = np.arange(32)
    regs = fragments.view(np.uint32)                 # (47, 32, 4)
    b = np.zeros((2, steps, 16, 8))                  # hi, lo
    for reg in range(4):
        part, k = reg // 2, 2 * (lane % 4) + 8 * (reg % 2)
        for half in (0, 1):
            bits = (regs[:, :, reg] >> (16 * half)) & 0xFFFF
            b[part][:, k + half, lane // 4] = \
                bits.astype(np.uint16).view(np.float16)
    tiles = -(-nf // 16)
    xp = np.zeros(tiles * 16 * R + 16 * steps)
    xp[:n] = x8
    a = np.stack([xp[f * R:f * R + 16 * steps] for f in range(tiles * 16)])
    a = a.reshape(tiles, 16, steps, 16)
    y = np.zeros((tiles, 16, 8), np.float32)
    for w in range(8):
        acc = np.zeros((tiles, 16, 8), np.float32)
        for ks in range(6 * w, min(6 * w + 6, steps)):
            for part in (0, 1):
                acc = (acc + a[:, :, ks] @ b[part, ks]).astype(np.float32)
        y = (y + acc).astype(np.float32)
    y = y.reshape(-1, 8)[:nf]
    out = np.zeros(m, np.float32)
    for r in range(decimate.PHASES):
        out = (out + y[r:r + m, r]).astype(np.float32)
    return out * np.float32(2.0 ** -(shift + 7))


@pytest.mark.parametrize("m", [1, 7, 300])
def test_kernel_arithmetic_model_matches_jax(m):
    rng = np.random.default_rng(m)
    x8 = rng.integers(-128, 128, HISTORY + m * R).astype(np.int8)
    x = x8.astype(np.float32) / 128.0
    ref, _ = jdec.polyphase_decimate(jnp.asarray(x), jnp.zeros_like(x))
    hi, lo, shift = tables.polyphase_bank_split()
    got = _kernel_model(x8, decimate.bank_fragments(hi, lo), shift)
    assert got.shape == (m,)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_streaming_int8_staging_matches_jax_across_chunks():
    """StreamingDecimatorInt8 on "cpu" against the JAX float
    StreamingDecimator on int8 / 128 over chunks of 64, 1 and 300 frames,
    the chunks written into the decimator's staging buffer as the daemon's
    ring pop does."""
    rng = np.random.default_rng(4)
    ref = jdec.StreamingDecimator()
    mine = decimate.StreamingDecimatorInt8(tables.polyphase_bank(), "cpu")
    for m in (64, 1, 300):
        i_st, q_st = mine.staging(m * R)
        i_st[:], q_st[:] = _int8(rng, m * R), _int8(rng, m * R)
        ri, rq = ref.process(i_st.astype(np.float32) / 128.0,
                             q_st.astype(np.float32) / 128.0)
        oi, oq = mine.process(i_st, q_st)
        assert oi.shape == ri.shape == (m,)
        np.testing.assert_allclose(oi, ri, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(oq, rq, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cls", [decimate.StreamingDecimator,
                                 decimate.StreamingDecimatorInt8,
                                 decimate.DecimatorBank])
def test_decimators_default_to_the_card(cls, monkeypatch):
    """The port's rule: the card unless the caller asks for the CPU, and
    no fallback when there is no card."""
    assert inspect.signature(cls).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cls(tables.polyphase_bank())
