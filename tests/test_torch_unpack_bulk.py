"""The port's bulk host unpack: pipeline.unpack_survivors (one native
call over every survivor of a window, the fields in bulk) against the JAX
package's unpack_survivors (one call per channel, a Python loop over the
survivors) on the same survivors, with the same per-channel or shared
tables; the vectorized 22-bit callsign hash and
CallsignHashTable.add_hashed against the JAX package's hash_callsign and
repeated CallsignHashTable.add; the record layout of the native batch
unpack; and the unpack_fallbacks counter of a detailed timer.
"""

import ctypes
import dataclasses
import os

import numpy as np
import pytest

from benchmark.generators import messages
from rtlsdr_ft8d_tpu.pipeline import unpack_survivors as jax_unpack
from rtlsdr_ft8d_tpu.protocol.text import CallsignHashTable as JaxTable
from rtlsdr_ft8d_tpu.protocol.text import hash_callsign as jax_hash
from rtlsdr_ft8d_tpu.protocol.unpack import UnpackError as JaxUnpackError
from rtlsdr_ft8d_tpu.protocol.unpack import unpack_spot as jax_unpack_spot
from rtlsdr_ft8d_tpu_torch import native
from rtlsdr_ft8d_tpu_torch.host.io import read_iq
from rtlsdr_ft8d_tpu_torch.host.log import NO_TIMER, StageTimer
from rtlsdr_ft8d_tpu_torch.host.synth import synthesize_message
from rtlsdr_ft8d_tpu_torch.pipeline import (WindowDecoder, decode_window,
                                            unpack_survivors)
from rtlsdr_ft8d_tpu_torch.protocol.constants import K_MAX_MESSAGES
from rtlsdr_ft8d_tpu_torch.protocol.crc import add_crc
from rtlsdr_ft8d_tpu_torch.protocol.pack import pack77
from rtlsdr_ft8d_tpu_torch.protocol.text import CallsignHashTable
from rtlsdr_ft8d_tpu_torch.protocol.unpack import (hash_calls_22,
                                                   unpack_spots_batch)

from .torch_cpu import few_torch_threads  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
SHARES = dict.fromkeys(messages.KINDS, 1.0)
# learned, looked up and re-learned across channels: i3=4 adds the full
# call, i3=1 with a hashed c28 looks it up at 22 bits, i3=4 with h12 and
# the DXpedition's h10 at 12 and 10 bits
HASHED = ["PJ4/K1ABC W9XYZ -10", "CQ PJ4/K1ABC", "PJ4/K1ABC W9XYZ -10",
          "W9XYZ PJ4/K1ABC RR73", "K1ABC RR73; W9XYZ <PJ4/K1ABC> -12",
          "CQ 3DA0/ZS6ABC", "3DA0/ZS6ABC K1ABC R-07", "K1ABC 3DA0/ZS6ABC 73"]


def _payload(text):
    bits = np.zeros(96, np.uint8)
    bits[:91] = add_crc(pack77(text))
    return np.packbits(bits)


def _reserved_token():
    """i3=1 with c28a a reserved token: both unpackers refuse it."""
    bits = np.zeros(96, np.uint8)
    n28 = 600_000
    bits[:28] = [(n28 >> (27 - i)) & 1 for i in range(28)]
    bits[74:77] = [0, 0, 1]
    bits[:91] = add_crc(bits[:77])
    return np.packbits(bits)


def _bad_field_day():
    """i3=0 n3=3 with class 7 (> F): both unpackers refuse it."""
    row = _payload("K1ABC W9XYZ 6A WI")
    bits = np.unpackbits(row)
    bits[61:64] = 1
    bits[:91] = add_crc(bits[:77])
    return np.packbits(bits)


def _out(rows, n_channels, rng):
    """A survivor dict as the decoder downloads it, with `rows[b]` the
    payloads of channel b's survivors in rank order and holes between."""
    shape = (n_channels, K_MAX_MESSAGES)
    out = {"ok": np.zeros(shape, bool),
           "packed": rng.integers(0, 256, shape + (12,)).astype(np.uint8),
           "freq_offset": rng.integers(0, 470, shape).astype(np.int32),
           "freq_sub": rng.integers(0, 2, shape).astype(np.uint8),
           "time_offset": rng.integers(-10, 60, shape).astype(np.int8),
           "time_sub": rng.integers(0, 2, shape).astype(np.uint8),
           "score": rng.integers(10, 200, shape).astype(np.int32),
           "snr_db": (rng.integers(-48, 20, shape) / 2).astype(np.float32)}
    for b, payloads in rows.items():
        ks = np.sort(rng.choice(K_MAX_MESSAGES, len(payloads), replace=False))
        out["ok"][b, ks] = True
        out["packed"][b, ks] = payloads
    return out


def _scene(name, rng, Table):
    """(out, n_channels, hashes) of one case, the tables of class Table."""
    if name == "busy64":
        rows = {}
        for b in range(64):
            pool = [_payload(messages.message(rng, SHARES))
                    for _ in range(int(rng.integers(8, 16)))]
            pool += [_payload(t) for t in HASHED[:2]] if b % 16 == 0 else []
            rows[b] = [pool[int(i)] for i in
                       rng.integers(0, len(pool), int(rng.integers(30, 40)))]
        return _out(rows, 64, rng), 64, [Table() for _ in range(64)]
    if name == "shared1500":
        table = Table()
        table.add("W9XYZ")
        rows = {200: [_payload(t) for t in HASHED[:5] + HASHED[:2]],
                201: [_payload(t) for t in HASHED + ["CQ K1JT FN20"] * 3]}
        return _out(rows, 1500, rng), 1500, table
    if name == "hashed":
        # channel 0 learns PJ4/K1ABC after its first lookup; channel 1
        # looks it up without learning it; channel 2 has no table
        rows = {0: [_payload(t) for t in HASHED],
                1: [_payload(t) for t in HASHED[2:3] + HASHED[4:5]
                    + ["CQ K1JT FN20"]],
                2: [_payload(t) for t in HASHED[:4]]}
        return _out(rows, 3, rng), 3, [Table(), Table(), None]
    if name == "refused":
        bad = [_reserved_token(), _bad_field_day()]
        rows = {0: bad + [_payload("CQ K1JT FN20")] + bad,
                1: [_payload(t) for t in HASHED[:3]] + bad[::-1]}
        return _out(rows, 2, rng), 2, [Table(), Table()]
    assert name == "empty"
    return _out({}, 8, rng), 8, [Table() for _ in range(8)]


def _lookups(out, hashes):
    """The survivors with a table whose payload unpacks, by the JAX
    package's unpack_spot without a table, to a text that holds '<' (a
    hashed call to look up, which the bulk path unpacks in Python)."""
    n = 0
    for b, k in zip(*np.nonzero(out["ok"])):
        table = hashes[b] if isinstance(hashes, list) else hashes
        try:
            text = jax_unpack_spot(np.unpackbits(out["packed"][b, k])[:77])[0]
        except JaxUnpackError:
            continue
        n += table is not None and "<" in text
    return n


def _tables(hashes):
    hashes = hashes if isinstance(hashes, list) else [hashes]
    return [None if t is None else list(t._by22.items()) for t in hashes]


@pytest.mark.parametrize("lib", ["native", "python"])
@pytest.mark.parametrize("name", ["busy64", "shared1500", "hashed",
                                  "refused", "empty"])
def test_unpack_survivors_equals_the_jax_package(monkeypatch, name, lib):
    if lib == "native" and native.load() is None:
        pytest.skip("native lib unavailable")
    out, n_channels, hashes = _scene(name, np.random.default_rng(
        [len(name), 2**31 + 11]), CallsignHashTable)
    want_hashes = _scene(name, np.random.default_rng(
        [len(name), 2**31 + 11]), JaxTable)[2]
    want = jax_unpack(out, n_channels, want_hashes)
    n_lookups = _lookups(out, want_hashes)
    if lib == "python":
        monkeypatch.setattr(native, "load", lambda *a, **k: None)
    timer = StageTimer(detail=True)
    got = unpack_survivors(out, n_channels, hashes, timer=timer)
    n_ok = int(out["ok"].sum())
    if name == "busy64":
        assert n_ok >= 2000
    as_rows = lambda res: [[dataclasses.astuple(d) for d in ds]  # noqa: E731
                           for ds in res]
    assert as_rows(got[0]) == as_rows(want[0])
    assert (sum(map(len, got[0])) > 0) == (name != "empty")
    for ds in got[0]:
        for d in ds:
            assert [type(v) for v in dataclasses.astuple(d)] == \
                [str, float, float, int, float, str, str, bool]
    assert [len(s) for s in got[1]] == [len(s) for s in want[1]]
    for mine, ref in zip(got[1], want[1]):
        for (bits, f2, t2), (bits_r, f2_r, t2_r) in zip(mine, ref):
            assert np.array_equal(bits, bits_r)
            assert (type(f2), type(t2), f2, t2) == (int, int, f2_r, t2_r)
    assert _tables(hashes) == _tables(want_hashes)
    texts = [d.text for ds in got[0] for d in ds]
    if name in ("hashed", "shared1500"):
        assert any("<PJ4/K1ABC>" in t for t in texts)
        assert any("<...>" in t for t in texts)
    if name == "refused":
        assert [len(ds) for ds in got[0]] == [1, 3]
    assert timer.counters["unpack_fallbacks"] == \
        (n_ok if lib == "python" else n_lookups)
    assert (n_lookups > 0) == (name in ("busy64", "shared1500", "hashed",
                                      "refused"))


@pytest.mark.parametrize("lib", ["native", "python"])
def test_refused_payloads_unpack_to_none(monkeypatch, lib):
    if lib == "native" and native.load() is None:
        pytest.skip("native lib unavailable")
    if lib == "python":
        monkeypatch.setattr(native, "load", lambda *a, **k: None)
    rows = np.stack([_reserved_token(), _payload("CQ K1JT FN20"),
                     _bad_field_day()])
    assert unpack_spots_batch(rows, CallsignHashTable()) == \
        [None, ("CQ K1JT FN20", "K1JT", "FN20", True), None]


@pytest.mark.parametrize("seed", [1, 7, 2**31 + 5])
def test_hash_calls_22_equals_hash_callsign_on_busy_calls(seed):
    rng = np.random.default_rng(seed)
    calls = [messages.callsign(rng) for _ in range(3000)]
    h22, stored = hash_calls_22(np.array(calls, dtype=np.bytes_))
    assert h22 == [jax_hash(c, 22) for c in calls]
    assert stored == calls
    assert all(type(h) is int for h in h22)


EDGE = ["k1abc", "pj4/k1abc", "K1ABC/P", "ABCDEFGHIJKLMN", "3DA0/ZS6ABCDEF",
        "K1@BC", "K1-AB.C", "", " ", " K1ABC ", "\tw9xyz\n", "<K1ABC>",
        "<...>", "Q", "/", "a b", "Ab" * 8, "\x1fK1JT", "K1ABC", "k1abc"]


@pytest.mark.parametrize("call", EDGE)
def test_hash_calls_22_edge_cases(call):
    h22, stored = hash_calls_22(np.array([call, "K1JT"], dtype=np.bytes_))
    assert h22 == [jax_hash(call, 22), jax_hash("K1JT", 22)]
    assert stored == [call.strip().upper(), "K1JT"]


def test_add_hashed_stores_what_repeated_add_stores():
    rng = np.random.default_rng(3)
    calls = EDGE + [messages.callsign(rng) for _ in range(200)] + EDGE[::-1]
    one_by_one, bulk = JaxTable(), CallsignHashTable()
    one_by_one.add("W9XYZ")
    bulk.add("W9XYZ")
    for c in calls:
        one_by_one.add(c)
    bulk.add_hashed(*hash_calls_22(np.array(calls, dtype=np.bytes_)))
    assert list(bulk._by22.items()) == list(one_by_one._by22.items())
    assert "" not in bulk._by22.values()
    assert not any(c.startswith("<") for c in bulk._by22.values())
    empty = CallsignHashTable()
    empty.add_hashed(*hash_calls_22(np.array([], dtype=np.bytes_)))
    assert empty._by22 == {}


def test_spot_dtype_mirrors_the_record():
    """Every field of native.SPOT_DTYPE at the ctypes mirror's offset and
    size, the record's size the same."""
    rec = native.Ft8SpotText
    assert native.SPOT_DTYPE.names == tuple(n for n, _ in rec._fields_)
    for name, _ in rec._fields_:
        dt, offset = native.SPOT_DTYPE.fields[name][:2]
        assert (offset, dt.itemsize) == (getattr(rec, name).offset,
                                         getattr(rec, name).size)
    assert native.SPOT_DTYPE.itemsize == ctypes.sizeof(rec)


@pytest.fixture(scope="module")
def decoder():
    return WindowDecoder()


def _window(kind):
    """One channel as host float32 (i, q)."""
    if kind == "hashed":
        iq = synthesize_message(HASHED[0], f0_hz=800.0, amplitude=0.5)
        i, q = iq.real, iq.imag
    else:
        i, q = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    return (np.asarray(i, np.float32)[None], np.asarray(q, np.float32)[None])


@pytest.mark.parametrize("kind", ["standard", "hashed", "no_timer"])
def test_unpack_fallbacks_counter(decoder, kind):
    iq = _window("standard" if kind == "no_timer" else kind)
    timer = NO_TIMER if kind == "no_timer" else StageTimer(detail=True)
    with timer.stage("decode"):
        results = decode_window(iq, hashes=[CallsignHashTable()],
                                decoder=decoder, timer=timer)
    texts = {d.text for d in results[0]}
    if kind == "no_timer":
        assert "CQ K1JT FN20" in texts
        assert NO_TIMER.counters == {}
        return
    fallbacks = timer.counters["decode.unpack_fallbacks"]
    if kind == "standard":
        assert "CQ K1JT FN20" in texts and not any("<" in t for t in texts)
        assert fallbacks == 0
    else:
        assert "<...> W9XYZ -10" in texts
        assert fallbacks >= 1
