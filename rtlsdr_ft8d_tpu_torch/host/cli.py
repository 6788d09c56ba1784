"""Command line of the PyTorch port: self-test and file replay.

A thin twin of rtlsdr_ft8d_tpu/host/cli.py and its daemon.decode_file
(rtlsdr_ft8d_tpu/host/daemon.py:45-84) for the ported single-pass path:

    python -m rtlsdr_ft8d_tpu_torch.host.cli -t
    python -m rtlsdr_ft8d_tpu_torch.host.cli -r FILE [-f BAND] [--budget N]

`--device` picks cuda (the default) or cpu. Without CUDA the command
fails unless `--device cpu` is given. The reference CLI's other options
(live capture, reporting, multipass, OSD, AP, wideband, ...) are refused.
"""

import argparse
import sys
from datetime import datetime, timezone

import numpy as np

from rtlsdr_ft8d_tpu.host.cli import BAND_PLAN, parse_frequency
from rtlsdr_ft8d_tpu.host.io import read_any
from rtlsdr_ft8d_tpu.host.reporter import print_spots
from rtlsdr_ft8d_tpu.protocol.constants import (SIGNAL_LENGTH_S,
                                                SIGNAL_SAMPLE_RATE)
from rtlsdr_ft8d_tpu.protocol.text import CallsignHashTable

WINDOW = SIGNAL_LENGTH_S * SIGNAL_SAMPLE_RATE


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_ft8d_torch", allow_abbrev=False,
        description="FT8 decode on PyTorch + CUDA (single pass): self-test "
                    "or replay of a recorded capture")
    mode = p.add_mutually_exclusive_group(required=True)
    mode.add_argument("-t", "--selftest", action="store_true",
                      help="decoder self-test (generate a signal & decode)")
    mode.add_argument("-r", "--readfile", metavar="FILE",
                      help="read .iq/.c2/.wav capture, decode and exit")
    p.add_argument("-f", "--frequency", default=None,
                   help="dial frequency [(k,M,G) Hz] or band string for "
                        "the printed spot frequencies. Bands: "
                        + " ".join(BAND_PLAN))
    p.add_argument("--budget", type=int, default=None, metavar="N",
                   help="global candidate budget: LLRs and LDPC only for "
                        "the N best-scoring candidates across all windows")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to decode (default: cuda)")
    return p


def decode_file(path, frequency=None, budget=None, device="cuda") -> int:
    """`-r file`: decode every 15-s window of a capture as one batch and
    print the spots (copy of rtlsdr_ft8d_tpu/host/daemon.py:45-84 without
    multipass, OSD or AP)."""
    from ..pipeline import decode_window

    i_s, q_s, dial = read_any(path)
    dial_freq = int(dial) if dial else (
        parse_frequency(frequency, 0)[0] if frequency else 0)
    n_windows = max(1, -(-i_s.shape[0] // WINDOW))
    pad = n_windows * WINDOW - i_s.shape[0]
    if pad:
        i_s = np.pad(i_s, (0, pad))
        q_s = np.pad(q_s, (0, pad))
    # the same >=512-window auto-budget rule as the reference replay
    if budget is None and n_windows >= 512:
        budget = 4096
    results = decode_window(
        (i_s.reshape(n_windows, WINDOW), q_s.reshape(n_windows, WINDOW)),
        hashes=CallsignHashTable(), budget=budget, device=device)
    total = 0
    when = datetime.now(timezone.utc)
    for w, decodes in enumerate(results):
        if n_windows > 1:
            print(f"-- window {w} (t={w * 15}s)")
        print_spots(decodes, when, dial_freq)
        total += len(decodes)
    return 0 if total > 0 else 1


def main(argv=None) -> int:
    args, rest = build_parser().parse_known_args(argv)
    if rest:
        print(f"tpu_ft8d_torch: {' '.join(rest)}: not supported by the "
              "PyTorch port, which takes -t, -r FILE, -f BAND, --budget N "
              "and --device; the other options of rtlsdr_ft8d_tpu.host.cli "
              "are queued in ROADMAP.md", file=sys.stderr)
        return 2
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("tpu_ft8d_torch: CUDA is not available; pass --device cpu "
                  "to decode on the CPU", file=sys.stderr)
            return 1

    from rtlsdr_ft8d_tpu.host.log import setup_logging
    setup_logging()

    if args.selftest:
        from .selftest import run_selftest
        return 0 if run_selftest(device=args.device) else 1
    return decode_file(args.readfile, args.frequency, args.budget,
                       args.device)


if __name__ == "__main__":
    sys.exit(main())
