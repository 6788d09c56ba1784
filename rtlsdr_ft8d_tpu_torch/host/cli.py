"""Command line of the PyTorch port: the daemon, file replay, self-test.

A twin of rtlsdr_ft8d_tpu/host/cli.py with its option set and dispatch:

    python -m rtlsdr_ft8d_tpu_torch.host.cli -f 20m -c CALL -l LOC
    python -m rtlsdr_ft8d_tpu_torch.host.cli -r FILE [-f BAND] [--multipass N]
    python -m rtlsdr_ft8d_tpu_torch.host.cli -t

Every option means what it means there (`-i/--device` is the RTL-SDR
device index). One option is added: `--backend` picks where to compute,
cuda (the default) or cpu; without CUDA the command fails unless
`--backend cpu` is given. `--elastic` decodes the wideband channels over
an elastic mesh of the backend's cards (parallel/elastic.py);
`--coordinator`, `--num-processes` and `--process-id` join a
torch.distributed process group before anything else runs
(parallel/distributed.py; gloo with `--backend cpu`, else nccl). Under
`-r`, `--wideband` does nothing, as in the reference: the replay never
reads it.
`--compile-cache` / `--no-compile-cache` are accepted and do nothing:
the port has no XLA compile cache, and the kernel build is cached by
source hash (ops/build.py).
"""

import argparse
import sys

# Copied from rtlsdr_ft8d_tpu/host/cli.py:15-61.
VERSION = "0.2.0"

# Band plan table (reference rtlsdr_ft8d.c:1047-1102).
# name -> (dial freq Hz, auto direct-sampling mode)
BAND_PLAN = {
    "160m": (1_840_000, 2),
    "80m": (3_573_000, 2),
    "60m": (5_357_000, 2),
    "40m": (7_074_000, 2),
    "30m": (10_136_000, 2),
    "20m": (14_074_000, 2),
    "17m": (18_100_000, 2),
    "15m": (21_074_000, 2),
    "12m": (24_915_000, 2),
    "10m": (28_074_000, 2),
    "6m": (50_313_000, 0),
    "4m": (70_100_000, 0),
    "2m": (144_174_000, 0),
    "1m25": (222_065_000, 0),
    "70cm": (432_065_000, 0),
    "23cm": (1_296_174_000, 0),
}


def atofs(s: str) -> float:
    """Suffix parser like the reference's atofs (c:688-713): k/M/G."""
    s = s.strip()
    mult = 1.0
    if s and s[-1] in "kKmMgG":
        mult = {"k": 1e3, "m": 1e6, "g": 1e9}[s[-1].lower()]
        s = s[:-1]
    try:
        return float(s) * mult
    except ValueError:
        raise SystemExit(f"bad frequency/number: {s!r}\n --help for usage...")


def parse_frequency(value: str, direct_sampling: int):
    """Returns (dial_freq_hz, direct_sampling)."""
    key = value.lower()
    if key in BAND_PLAN:
        freq, auto_ds = BAND_PLAN[key]
        if not direct_sampling and auto_ds:
            direct_sampling = auto_ds
        return freq, direct_sampling
    return int(atofs(value)), direct_sampling


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_ft8d_torch", allow_abbrev=False,
        description="FT8 daemon on PyTorch + CUDA with the capabilities of "
                    "rtlsdr_ft8d (batched decode of many channels per "
                    "15-s window)")
    # rtlsdr_ft8d_tpu/host/cli.py:70-168, same dest, default, type, choices
    p.add_argument("-f", "--frequency", action="append", default=[],
                   help="dial frequency [(k,M,G) Hz] or band string; "
                        "repeatable for multi-channel operation. Bands: "
                        + " ".join(BAND_PLAN))
    p.add_argument("-c", "--callsign", default="", help="your callsign")
    p.add_argument("-l", "--locator", default="", help="your locator grid")
    p.add_argument("-g", "--gain", type=int, default=29,
                   help="gain [0-49] (default: 29)")
    p.add_argument("-a", "--autogain", action="store_true",
                   help="auto gain (off by default)")
    p.add_argument("-o", "--offset", type=int, default=0,
                   help="frequency offset (default: 0)")
    p.add_argument("-p", "--ppm", type=int, default=0,
                   help="crystal correction factor (ppm)")
    p.add_argument("-u", "--upconverter", type=str, default="0",
                   help="upconverter frequency (default: 0)")
    p.add_argument("-d", "--directsampling", type=int, default=0,
                   choices=[0, 1, 2], help="direct sampling mode")
    p.add_argument("-n", "--maxloop", type=int, default=0,
                   help="max 15-s windows (default: 0 = infinite)")
    p.add_argument("-i", "--device", type=int, default=0,
                   help="device index")
    p.add_argument("-x", "--noreport", action="store_true",
                   help="do not report spots (reporting is also off unless "
                        "--report is given, matching the reference default)")
    p.add_argument("--report", action="store_true",
                   help="enable the PSKreporter uplink")
    p.add_argument("-t", "--selftest", action="store_true",
                   help="decoder self-test (generate a signal & decode)")
    p.add_argument("-w", "--writefile", metavar="PREFIX",
                   help="write received windows to timestamped .iq files")
    p.add_argument("-r", "--readfile", metavar="FILE",
                   help="read .iq/.c2/.wav capture, decode and exit")
    p.add_argument("--save-c2", metavar="FILE", help="also save .c2 format")
    p.add_argument("--wideband", action="store_true",
                   help="decode ALL 1500 channels (1600 Hz spacing) of the "
                        "2.4 MHz capture via the polyphase filterbank "
                        "channelizer instead of just the dial sub-band")
    p.add_argument("--wideband-channels", type=str, default=None,
                   help="comma-separated channel indices to decode in "
                        "--wideband mode (default: all 1500)")
    p.add_argument("--pallas-ingest", action="store_true",
                   help="decimate raw int8 IQ on the backend with the int8 "
                        "ingest kernel (csrc/decimate.cu; 4x less "
                        "host->device bandwidth)")
    p.add_argument("--ingest", choices=("auto", "device", "host"),
                   default="auto",
                   help="narrow-band decimation placement: 'device' = "
                        "polyphase product on the backend, 'host' = same "
                        "bank on the CPU (no full-rate upload), 'auto' = "
                        "device")
    p.add_argument("--osd", type=int, default=0, metavar="M",
                   help="deep decode of the M best BP-failed candidates per "
                        "channel: matched-filter refinement, BP and "
                        "ordered-statistics decoding on the backend "
                        "(default 0 = off)")
    p.add_argument("--ap", action="store_true",
                   help="a-priori decoding: BP again with the known 'CQ' "
                        "prefix bits and your callsign's bits clamped, and "
                        "the next messages of QSOs heard in earlier windows "
                        "scored as a codeword bank (WSJT-X-style)")
    p.add_argument("--budget", type=int, default=None, metavar="N",
                   help="global candidate budget: run LDPC only on the N "
                        "best-scoring candidates ACROSS all channels (big "
                        "win on quiet wide bands; default: no budget)")
    p.add_argument("--multipass", type=int, default=1, metavar="N",
                   help="decode passes with signal subtraction between "
                        "passes (WSJT-X-style; default 1 = single pass)")
    p.add_argument("--synthetic", action="store_true",
                   help="run the daemon loop from a synthetic full-rate "
                        "source (no hardware needed; for integration tests)")
    p.add_argument("--synthetic-pace", action="store_true",
                   help="with --synthetic: pace windows to real 15-s UTC "
                        "boundaries (soak realism) instead of free-running")
    p.add_argument("--stats", action="store_true",
                   help="emit per-window JSON stats records to stderr")
    p.add_argument("--compile-cache", metavar="DIR", nargs="?",
                   const="", default="",
                   help="accepted for compatibility; the port has no XLA "
                        "compile cache (its kernel build is cached by "
                        "source hash)")
    p.add_argument("--no-compile-cache", dest="compile_cache",
                   action="store_const", const=None,
                   help="accepted for compatibility; does nothing")
    p.add_argument("--psk-host", default=None, help="PSKreporter host")
    p.add_argument("--psk-port", type=int, default=4739)
    p.add_argument("--elastic", action="store_true",
                   help="wideband mode: decode over an elastic mesh of the "
                        "backend's cards that shrinks (and keeps decoding) "
                        "when a card dies instead of exiting like the "
                        "reference")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host mode: torch.distributed rendezvous "
                        "address (run one process per host; host 0's "
                        "address)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-host mode: total number of processes")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-host mode: this process's rank (0-based)")
    p.add_argument("--version", action="version",
                   version=f"tpu_ft8d_torch v{VERSION}")
    # the port's own option
    p.add_argument("--backend", choices=("cuda", "cpu"), default="cuda",
                   help="where to decimate and decode (default: cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.backend == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("tpu_ft8d_torch: CUDA is not available; pass --backend cpu "
                  "to run on the CPU", file=sys.stderr)
            return 1

    from .log import setup_logging
    setup_logging()

    if args.coordinator or args.num_processes:
        from ..parallel import distributed
        distributed.initialize(args.coordinator, args.num_processes,
                               args.process_id,
                               "gloo" if args.backend == "cpu" else "nccl")

    # dispatch as rtlsdr_ft8d_tpu/host/cli.py:188-210
    if args.selftest:
        from .selftest import run_selftest
        return 0 if run_selftest(device=args.backend) else 1

    if args.readfile:
        from .daemon import decode_file
        return decode_file(args)

    if not args.frequency:
        print("Please specify a dial frequency.\n --help for usage...",
              file=sys.stderr)
        return 1
    if not args.callsign:
        print("Please specify your callsign.\n --help for usage...",
              file=sys.stderr)
        return 1
    if not args.locator:
        print("Please specify your locator.\n --help for usage...",
              file=sys.stderr)
        return 1

    from .daemon import run_daemon
    return run_daemon(args)


if __name__ == "__main__":
    sys.exit(main())
