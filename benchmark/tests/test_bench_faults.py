"""A run with the timed path broken underneath must come out not
correct: the harness's look for a chip skipped (device "cpu", the port's
plain versions), the rest of a run driven at a small size, once for each
fault a cell can have. One chip, so no exchange between chips to leave
out; the baseband cell carries no state across windows that its decode
lists depend on."""

import pytest

import harness
from faults import (altered_answer, centre_shifted, half_batch,
                    one_decode_moved, state_unchanged)
from reference.decoder import Decode

BASEBAND = {"config": {"channels": 4, "warmup_windows": 1},
            "traffic": {"windows": 2, "signals_per_channel": [2, 4]}}
WIDEBAND = {"config": {"argv": ["-f", "20m", "-c", "T1ST", "-l", "AA00",
                                "-x", "--wideband",
                                "--wideband-channels", "200,201"],
                       "warmup_windows": 2},
            "traffic": {"windows": 2, "signals_per_window": [8, 8]}}
CELLS = {"baseband64.busy": BASEBAND, "wideband1500.subband": WIDEBAND}


def run(cell, seed=2**31 + 11):
    out = harness.run(cell, seed, 0.2, False, "cpu",
                      overrides=CELLS[cell], log=lambda m: None)
    return out["result"], out["record"]["numbers"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    result, nums = run(cell)
    assert result["correct"], result["checks"]
    assert nums["reference_decodes"] > 0


FAULTS = [("baseband64.busy", half_batch, "decode_diff_pct"),
          ("baseband64.busy", altered_answer, "false_decodes"),
          ("wideband1500.subband", half_batch, "decode_diff_pct"),
          ("wideband1500.subband", altered_answer, "false_decodes"),
          ("wideband1500.subband", one_decode_moved, "decode_diff_pct"),
          ("wideband1500.subband", centre_shifted, "decode_diff_pct"),
          ("wideband1500.subband", state_unchanged, "bank_rel_err")]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f, _ in FAULTS])
def test_fault_comes_out_not_correct(monkeypatch, cell, fault, number):
    fault(monkeypatch.setattr)
    result, _ = run(cell)
    assert not result["correct"]
    c = result["checks"][number]
    assert c["value"] > c["limit"], result["checks"]


def test_decode_tuple_fields_match_the_program():
    from rtlsdr_ft8d_tpu_torch.pipeline import Decode as ProgramDecode

    d = ProgramDecode(text="CQ K1JT FN20", freq_hz=1.0, time_sec=0.5,
                      score=20, snr_db=-3.0)
    r = Decode("CQ K1JT FN20", 1.0, 0.5, 20, -3.0)
    from reference.compare import as_tuple
    assert as_tuple(d) == as_tuple(r)
