"""The port's elastic mesh (parallel/elastic.py) on 8 CPU slots: the seven
scenarios of tests/test_elastic.py, with slots killed by an injected
heartbeat (slots share the CPU, so they die by index), and the daemon's
--elastic decode (decode_window through WindowProcessor._decode_wideband
with the ElasticDecoder as its decoder) against the JAX package's
_decode_elastic on tests/test_elastic.py:130-159's batch: the same
decode lists (texts, frequency, time and score, in order) and window
counters."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu.host.daemon import WindowProcessor as JaxProcessor
from rtlsdr_ft8d_tpu.ops.ap import QsoTracker as JaxQsoTracker
from rtlsdr_ft8d_tpu_torch.host.daemon import WindowProcessor
from rtlsdr_ft8d_tpu_torch.host.synth import synthesize_message
from rtlsdr_ft8d_tpu_torch.ops.ap import QsoTracker
from rtlsdr_ft8d_tpu_torch.parallel import elastic
from rtlsdr_ft8d_tpu_torch.parallel.elastic import (ElasticDecoder,
                                                    device_heartbeat)
from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder
from rtlsdr_ft8d_tpu_torch.protocol.unpack import unpack77

from .torch_cpu import few_torch_threads  # noqa: F401

MSGS = ["CQ K1JT FN20", "K1ABC W9XYZ EN37"]
CPU8 = [torch.device("cpu")] * 8


def _texts(out, b):
    packed, ok = out["packed"].numpy(), out["ok"].numpy()
    return {unpack77(np.unpackbits(packed[b, k])[:77])
            for k in np.nonzero(ok[b])[0]}


def _batch(n=16, f0=250, step=60):
    chans = [synthesize_message(MSGS[b % 2], f0_hz=f0 + step * b,
                                noise_sigma=0.1,
                                rng=np.random.default_rng(b))
             for b in range(n)]
    batch = np.stack(chans)
    return (np.real(batch).astype(np.float32),
            np.imag(batch).astype(np.float32))


def _heartbeat(dead):
    return lambda slot, timeout=0.0: slot not in dead


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_heartbeat(device):
    """A live device answers; one whose fetch raises (meta tensors hold
    no data) is dead."""
    assert device_heartbeat(torch.device(device), 5.0) == (device == "cpu")


def test_decode_continues_after_half_mesh_dies():
    dead = set()
    dec = ElasticDecoder(CPU8, heartbeat=_heartbeat(dead))
    assert dec.mesh.size == 8
    i_s, q_s = _batch(16)
    out, mesh = dec(i_s, q_s, budget=400), dec.mesh
    assert mesh.size == 8
    for b in range(16):
        assert MSGS[b % 2] in _texts(out, b), b

    dead.update(range(4, 8))                  # half the slots go away
    out, mesh = dec(i_s, q_s, budget=400), dec.mesh
    assert mesh.size == 4 and dec.slots == [0, 1, 2, 3]
    assert dec.windows_recovered == 1
    for b in range(16):
        assert MSGS[b % 2] in _texts(out, b), b


def test_non_power_of_two_survivors_and_padding():
    dec = ElasticDecoder(CPU8, heartbeat=_heartbeat({5, 6, 7}))
    assert dec.mesh.size == 4 and dec.windows_recovered == 0
    i_s, q_s = _batch(6)                      # 6 % 4 != 0 -> pad 2
    out, mesh = dec(i_s, q_s, budget=400), dec.mesh
    assert out["packed"].shape[0] == 6 and out["n_ok"].shape == (6,)
    for b in range(6):
        assert MSGS[b % 2] in _texts(out, b), b


def test_padding_keeps_osd_rows():
    """Only channel-indexed outputs are trimmed: osd_* rows are flat
    candidates (6 channels x 2 = 12 rows, 8 slots x 1 each here). Every
    output is a tensor on the decoder's device, as WindowDecoder.forward
    returns it; the download is decode_window's."""
    dec = ElasticDecoder(CPU8, heartbeat=_heartbeat(set()))
    i_s, q_s = _batch(6)
    out = dec(torch.from_numpy(i_s), torch.from_numpy(q_s), budget=400,
              osd_cands=2)
    assert out["n_ok"].shape == (6,) and out["osd_chan"].shape == (8,)
    assert out["osd_post"].shape == out["osd_post_coh"].shape == (8, 174)
    for k, v in out.items():
        assert isinstance(v, torch.Tensor) and v.device == dec.device, k


def test_midwindow_failure_shrinks_and_retries(monkeypatch):
    dead = set()
    real = elastic.decode_window_dense
    state = {"fired": False}

    def flaky(i_s, q_s, mesh, budget, **kw):
        if not state["fired"]:
            state["fired"] = True
            dead.update({6, 7})               # 2 slots die mid-window
            raise RuntimeError("simulated collective failure")
        return real(i_s, q_s, mesh, budget, **kw)

    monkeypatch.setattr(elastic, "decode_window_dense", flaky)
    dec = ElasticDecoder(CPU8, heartbeat=_heartbeat(dead))
    i_s, q_s = _batch(8)
    out, mesh = dec(i_s, q_s, budget=400), dec.mesh
    assert state["fired"]
    assert mesh.size == 4                     # 6 survivors -> pow2 mesh
    assert dec.windows_recovered == 1
    for b in range(8):
        assert MSGS[b % 2] in _texts(out, b), b


def test_failure_with_no_device_loss_is_a_real_error(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("genuine graph bug")

    monkeypatch.setattr(elastic, "decode_window_dense", boom)
    dec = ElasticDecoder(CPU8, heartbeat=_heartbeat(set()))
    i_s, q_s = _batch(8)
    with pytest.raises(RuntimeError, match="genuine graph bug"):
        dec(i_s, q_s, budget=400)


def test_all_devices_dead_raises():
    dec = ElasticDecoder(CPU8, heartbeat=_heartbeat(set()))
    dec.heartbeat = _heartbeat(set(range(8)))
    i_s, q_s = _batch(8)
    with pytest.raises(RuntimeError, match="no devices left"):
        dec(i_s, q_s, budget=400)


def test_daemon_elastic_wideband_path_matches_jax():
    """The JAX test's batch and options (--ap --osd 4, call VA2GKA,
    budget 400) through JAX's _decode_elastic and the port's
    _decode_wideband with an ElasticDecoder, 8 slots each."""
    i_b, q_b = _batch(8, f0=300, step=50)
    args = SimpleNamespace(elastic=True, ap=True, osd=4, callsign="VA2GKA",
                           backend="cpu")
    ref, ref_stats = JaxProcessor._decode_elastic(
        SimpleNamespace(args=args, hashes=None, qso=JaxQsoTracker(),
                        _elastic=None), i_b, q_b, budget=400)
    me = SimpleNamespace(args=args, hashes=None, qso=QsoTracker(),
                         decoder=WindowDecoder(), timer=None)
    me._elastic = ElasticDecoder(CPU8, decoder=me.decoder)
    mine, stats = WindowProcessor._decode_wideband(
        me, torch.from_numpy(i_b), torch.from_numpy(q_b), budget=400)
    assert [[(d.text, d.freq_hz, d.time_sec, d.score) for d in r]
            for r in mine] == \
        [[(d.text, d.freq_hz, d.time_sec, d.score) for d in r] for r in ref]
    for b in range(8):
        assert MSGS[b % 2] in {d.text for d in mine[b]}, b
    for k in ("channels", "candidates_scored", "ldpc_converged",
              "crc_passed", "messages_unique"):
        assert getattr(stats, k) == getattr(ref_stats, k), k
    assert stats.extra == ref_stats.extra == {
        "windows_recovered": 0, "mesh_devices": 8, "osd_recovered": 0}
