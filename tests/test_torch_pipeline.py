"""The port's single-pass decode path and CLI against the JAX package.

On the golden fixtures, a 4-channel bench-style batch (unbudgeted and
with a global budget below B*K) and the self-test signal, the port's
decode lists must equal rtlsdr_ft8d_tpu.pipeline.decode_window's: same
texts in the same order with equal frequency, time and score, and SNR
within 0.5 dB (one step of its 0.5 dB rounding). The single-pass oracle
fixtures, which the GPU smoke test reads where JAX is absent, must hold
what the JAX package decodes.
"""

import os

import numpy as np
import pytest
import torch

from rtlsdr_ft8d_tpu.host.io import read_iq
from rtlsdr_ft8d_tpu.host.synth import synthesize_message
from rtlsdr_ft8d_tpu.pipeline import decode_window as jax_decode_window
from rtlsdr_ft8d_tpu_torch.host import cli
from rtlsdr_ft8d_tpu_torch.host.selftest import run_selftest
from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder, decode_window

from .torch_cpu import few_torch_threads  # noqa: F401

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDEN = ["golden_10sig", "golden_busy"]
MSGS = ["CQ K1JT FN20", "K1ABC W9XYZ EN37", "CQ VA2GKA FN35",
        "W9XYZ K1ABC R-09"]


@pytest.fixture(scope="module")
def decoder():
    return WindowDecoder()


@pytest.fixture(scope="module")
def jax_golden():
    return {name: jax_decode_window(read_iq(os.path.join(FIX, f"{name}.iq")))
            for name in GOLDEN}


def _assert_same(mine, ref):
    assert [d.text for d in mine] == [d.text for d in ref]
    for a, b in zip(mine, ref):
        assert (a.freq_hz, a.time_sec, a.score) == \
            (b.freq_hz, b.time_sec, b.score), a.text
        assert abs(a.snr_db - b.snr_db) <= 0.5, (a.text, a.snr_db, b.snr_db)


def _bench4():
    """bench.py:42-48 at 4 channels."""
    rng = np.random.default_rng(5)
    return np.stack([synthesize_message(
        MSGS[b % 4], f0_hz=100 + 17.5 * b % 1300, noise_sigma=0.3, rng=rng)
        for b in range(4)])


@pytest.mark.parametrize("name", GOLDEN)
def test_oracle_fixture_holds_jax_single_pass(jax_golden, name):
    with open(os.path.join(FIX, f"{name}.single_pass.txt")) as f:
        oracle = [line.rstrip("\n") for line in f]
    assert oracle == [d.text for d in jax_golden[name]]


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_single_pass_matches_jax(jax_golden, decoder, name):
    mine = decode_window(read_iq(os.path.join(FIX, f"{name}.iq")),
                         decoder=decoder)
    _assert_same(mine, jax_golden[name])


@pytest.mark.parametrize("budget", [None, 256])
def test_bench_batch_matches_jax(decoder, budget):
    batch = _bench4()
    ref = jax_decode_window(batch, budget=budget)
    mine = decode_window(batch, budget=budget, decoder=decoder)
    assert len(mine) == 4
    for b in range(4):
        _assert_same(mine[b], ref[b])
        assert MSGS[b] in {d.text for d in mine[b]}


def test_selftest_matches_jax(decoder, tmp_path, monkeypatch, capsys):
    iq = synthesize_message("CQ K1JT FN20QI", f0_hz=50.0, amplitude=0.5,
                            noise_sigma=0.02, rng=np.random.default_rng(1))
    _assert_same(decode_window(iq, decoder=decoder), jax_decode_window(iq))
    monkeypatch.chdir(tmp_path)
    assert run_selftest(device="cpu")
    assert (tmp_path / "selftest.iq").exists()
    assert "Self-test PASSED" in capsys.readouterr().out


def test_cli_selftest_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-t", "--device", "cpu"]) == 0
    assert "Self-test PASSED" in capsys.readouterr().out


def test_cli_replay_on_cpu(capsys):
    path = os.path.join(FIX, "golden_10sig.iq")
    assert cli.main(["-r", path, "-f", "20m", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    with open(os.path.join(FIX, "golden_10sig.single_pass.txt")) as f:
        for line in f:
            assert line.rstrip("\n") in out
    assert "1407" in out          # spot frequencies offset by the 20m dial


def test_cli_cuda_without_cuda_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-t"]) != 0
    assert cli.main(["-t", "--device", "cuda"]) != 0
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [["-t", "-c", "K1ABC"], ["-t", "--osd", "8"],
                                  ["-r", "x.iq", "--multipass", "2"]])
def test_cli_refuses_unported_options(argv, capsys):
    assert cli.main(argv + ["--device", "cpu"]) == 2
    assert "not supported by the PyTorch port" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [{"passes": 2}, {"osd_cands": 8},
                                {"ap_cq": True}, {"ap_call": "K1ABC"},
                                {"ap_texts": ["K1ABC W9XYZ RR73"]}])
def test_decode_window_refuses_unported_options(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        decode_window(np.zeros(48000, np.complex64), device="cpu", **kw)
