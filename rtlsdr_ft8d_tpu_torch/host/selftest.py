"""Decoder self-test: encode -> modulate -> decode loopback.

Copy of rtlsdr_ft8d_tpu/host/selftest.py:17-32 (that module imports jax
through its pipeline) on the port's decode_window: pack
"CQ K1JT FN20QI", synthesize at f0 = 50 Hz with noise, write
selftest.iq, decode, and pass only if both the call and the locator
match.
"""

import numpy as np

from rtlsdr_ft8d_tpu.host.io import write_iq
from rtlsdr_ft8d_tpu.host.synth import synthesize_message

from ..pipeline import decode_window


def run_selftest(write_file: bool = True, verbose: bool = True,
                 device="cuda") -> bool:
    iq = synthesize_message("CQ K1JT FN20QI", f0_hz=50.0, amplitude=0.5,
                            noise_sigma=0.02, rng=np.random.default_rng(1))
    i_s = np.real(iq).astype(np.float32)
    q_s = np.imag(iq).astype(np.float32)
    if write_file:
        write_iq("selftest.iq", i_s, q_s)
    decodes = decode_window((i_s, q_s), device=device)
    if verbose:
        for d in decodes:
            print(f"  score={d.score} freq={d.freq_hz:.1f}Hz "
                  f"dt={d.time_sec:+.2f}s  {d.text}")
    ok = any(d.call == "K1JT" and d.loc == "FN20" for d in decodes)
    if verbose:
        print("Self-test PASSED" if ok else "Self-test FAILED")
    return ok
