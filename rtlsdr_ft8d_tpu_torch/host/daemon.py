"""Daemon main loop of the PyTorch port: 15-s UTC-aligned capture ->
decimation -> decode -> report.

A twin of rtlsdr_ft8d_tpu/host/daemon.py (which imports jax through its
pipeline and decimator): the source pushes full-rate u8 I/Q into the
native ring (native.py, whose int8 fs/4 mixer yields int8 I/Q), each
window drains exactly 15 s of samples, decimates them to 3,200 sps with
overlap-save state carried across windows (ops/decimate.py), and decodes
all bands as one batch. The whole process holds ONE WindowDecoder on the
backend (`--backend`), so the DFT tables are built once, not every
window.

With `--wideband`, each window's int8 I/Q is channelized instead
(ops/channelize.py: 1500 channels, 1600 Hz apart), the selected channels
(`--wideband-channels`, default all) are decoded as one batch straight
from the channel bank on the backend, with a global budget of 4096
candidates from 512 channels up unless `--budget` is given, and the
decodes, at absolute frequencies, are deduplicated across channels.

With `--ap`, one QsoTracker (ops/ap.py), shared by every band, turns the
QSOs heard in each window into the next window's codeword bank; it
observes every band's decodes of a window at once, so a QSO ages one
step a window (`decode_multiband`). It keeps its `max_pairs` (4) pairs
heard last, in band order, so with many bands the bank holds the QSOs of
the last bands that had one.
With `--wideband --elastic`, decode_window decodes the channels in one
pass with parallel/elastic.ElasticDecoder as its decoder: the dense
global-budget decode over an elastic mesh of the backend's cards, which
keeps decoding when a card dies.
`--ingest auto` means the backend: the reference's transfer-leak probe
of its TPU relay client (daemon.py:87-100) has no counterpart here.
"""

import ctypes
import json
import signal
import sys
import time
from datetime import datetime, timezone

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.ap import QsoTracker
from ..ops.channelize import (NUM_CHANNELS, StreamingChannelizerInt8,
                              channel_center_hz, dedup_wideband)
from ..ops.decimate import R, StreamingDecimator, StreamingDecimatorInt8
from ..ops.tables import polyphase_bank
from ..parallel.elastic import ElasticDecoder
from ..parallel.sharding import local_devices
from ..pipeline import WindowDecoder, decode_window
from ..protocol.constants import (CAPTURE_RATE, SIGNAL_LENGTH_S,
                                  SIGNAL_SAMPLE_RATE)
from ..protocol.text import CallsignHashTable
from .cli import atofs, parse_frequency
from .io import read_any, timestamped_name, write_c2, write_iq
from .log import StageTimer, logger
from .reporter import PskReporter, print_spots

WINDOW = SIGNAL_LENGTH_S * SIGNAL_SAMPLE_RATE
FULLRATE_WINDOW = SIGNAL_LENGTH_S * CAPTURE_RATE

# Injectable clock (tests drive the live loop with a simulated clock whose
# sleep() also produces samples).
_now = time.time
_sleep = time.sleep


# Copied from rtlsdr_ft8d_tpu/host/daemon.py:39-42.
def seconds_to_next_window(now=None) -> float:
    """Time until the next 15-s UTC boundary (reference c:1339-1347)."""
    now = now if now is not None else _now()
    return (15.0 - (now % 15.0)) % 15.0


def _pad_window(i_bb, q_bb):
    if i_bb.shape[-1] < WINDOW:
        pad = [(0, 0)] * (i_bb.ndim - 1) + [(0, WINDOW - i_bb.shape[-1])]
        i_bb, q_bb = np.pad(i_bb, pad), np.pad(q_bb, pad)
    return i_bb[..., :WINDOW], q_bb[..., :WINDOW]


def decode_file(args) -> int:
    """`-r file`: decode every 15-s window of a capture as one batch and
    print the spots (rtlsdr_ft8d_tpu/host/daemon.py:45-84; --multipass,
    --budget, --osd and --ap honoured, --ap with the CQ and own-call clamp
    rows and no bank)."""
    i_s, q_s, dial = read_any(args.readfile)
    dial_freq = int(dial) if dial else (
        parse_frequency(args.frequency[0], 0)[0] if args.frequency else 0)
    n_windows = max(1, -(-i_s.shape[0] // WINDOW))
    pad = n_windows * WINDOW - i_s.shape[0]
    if pad:
        i_s = np.pad(i_s, (0, pad))
        q_s = np.pad(q_s, (0, pad))
    # the same >=512-window auto-budget rule as the reference replay
    budget = args.budget
    if budget is None and n_windows >= 512:
        budget = 4096
    results = decode_window(
        (i_s.reshape(n_windows, WINDOW), q_s.reshape(n_windows, WINDOW)),
        hashes=CallsignHashTable(), budget=budget, passes=args.multipass,
        device=args.backend, **ap_options(args, None))
    total = 0
    when = datetime.now(timezone.utc)
    for w, decodes in enumerate(results):
        if n_windows > 1:
            print(f"-- window {w} (t={w * 15}s)")
        print_spots(decodes, when, dial_freq)
        total += len(decodes)
    return 0 if total > 0 else 1


def _make_decimator(args):
    """Float decimator per --ingest: 'host' decimates on the CPU (no
    full-rate upload), 'device' and 'auto' on the backend."""
    device = "cpu" if args.ingest == "host" else args.backend
    return StreamingDecimator(polyphase_bank(), device)


def wideband_channels(sel: str | None) -> list[int]:
    """--wideband-channels -> channel indices, all 1500 if not given
    (rtlsdr_ft8d_tpu/host/daemon.py:136-151, the same SystemExit texts)."""
    if not sel:
        return list(range(NUM_CHANNELS))
    try:
        chans = [int(c) for c in sel.split(",") if c.strip()]
    except ValueError:
        raise SystemExit(
            f"--wideband-channels must be a comma-separated "
            f"list of integers, got {sel!r}")
    bad = [c for c in chans if not 0 <= c < NUM_CHANNELS]
    if bad or not chans:
        raise SystemExit(
            f"--wideband-channels out of range 0.."
            f"{NUM_CHANNELS - 1}: {bad or sel!r}")
    return chans


class WindowProcessor:
    """Decimates (or channelizes), decodes and reports one band's windows
    (rtlsdr_ft8d_tpu/host/daemon.py:114-353). With
    --ap, `qso` tracks the QSOs heard; run_daemon gives every band the
    first band's tracker."""

    def __init__(self, args, dial_freq_hz, decoder: WindowDecoder,
                 elastic: ElasticDecoder | None = None):
        self.args = args
        self.dial_freq = dial_freq_hz
        self.decoder = decoder
        self.hashes = CallsignHashTable()
        self.qso = QsoTracker() if args.ap else None
        self.decimator = _make_decimator(args)
        self._int8_decimator = None
        self.wideband = args.wideband
        if self.wideband:
            self.channelizer = StreamingChannelizerInt8(args.backend)
            self.wb_channels = wideband_channels(args.wideband_channels)
        self.reporter = PskReporter(
            args.callsign, args.locator,
            enabled=args.report and not args.noreport,
            host=args.psk_host or "report.pskreporter.info",
            port=args.psk_port)
        # --elastic acts in wideband mode only, as in the reference;
        # run_daemon passes every band the process's one ElasticDecoder
        self._elastic = None
        if self.wideband and args.elastic:
            self._elastic = elastic or ElasticDecoder(
                local_devices(args.backend), decoder=decoder)
        self.windows_done = 0
        self.epoch = None              # of the last window emitted
        self.timer = StageTimer()      # run_daemon swaps in each window's

    def reset_streams(self):
        """Drop overlap-save filter state after a resync gap (the carried
        history no longer abuts the next window's samples)."""
        self.decimator = _make_decimator(self.args)
        self._int8_decimator = None
        if self.wideband:
            self.channelizer = StreamingChannelizerInt8(self.args.backend)

    def _int8(self):
        if self._int8_decimator is None:
            self._int8_decimator = StreamingDecimatorInt8(
                polyphase_bank(), self.args.backend)
        return self._int8_decimator

    def pop_buffers(self, i8: np.ndarray, q8: np.ndarray):
        """Where the ring pop writes one full-rate window: with --wideband
        the channelizer's staging buffer, with the int8 ingest the
        decimator's (pinned on the card, so the upload needs no host
        copy); else the daemon's own (i8, q8)."""
        if self.wideband:
            return self.channelizer.staging(i8.shape[0])
        if not self.args.pallas_ingest:
            return i8, q8
        return self._int8().staging(i8.shape[0])

    def pop_window(self, lib, ring, i8: np.ndarray, q8: np.ndarray):
        """Pop one full-rate window of i8.shape[0] samples from the native
        ring into `pop_buffers`, timed as the window's "pop" part:
        (pop_i, pop_q, the samples popped). The int8 decimator's set-up
        in the first window (its pinned staging buffer) is timed with the
        pop it serves."""
        ptr = ctypes.POINTER(ctypes.c_int8)
        with self.timer.stage("pop"):
            pop_i, pop_q = self.pop_buffers(i8, q8)
            got = lib.ingest_ring_pop(ring, pop_i.ctypes.data_as(ptr),
                                      pop_q.ctypes.data_as(ptr), i8.shape[0])
        return pop_i, pop_q, got

    def _decimate(self, i8: np.ndarray, q8: np.ndarray):
        n = (i8.shape[0] // R) * R
        with self.timer.stage("decimate"):
            if self.args.pallas_ingest:
                return self._int8().process(i8[:n], q8[:n])
            return self.decimator.process(
                i8[:n].astype(np.float32) / 128.0,
                q8[:n].astype(np.float32) / 128.0)

    def process_fullrate(self, i8: np.ndarray, q8: np.ndarray):
        """One 15-s window of mixed int8 baseband at 2.4 Msps."""
        if self.wideband:
            # int8 straight through: the channelizer dequantizes on the
            # backend
            n = (i8.shape[0] // R) * R
            return self.process_wideband(i8[:n], q8[:n])
        return self.process_baseband(*self._decimate(i8, q8))

    def process_wideband(self, i8: np.ndarray, q8: np.ndarray):
        """Channelize the whole capture and decode every selected channel
        (rtlsdr_ft8d_tpu/host/daemon.py:186-243): the channel bank stays
        on the backend through selection, padding and the decode."""
        # full-band default: a global candidate budget; --budget wins
        budget = self.args.budget
        if budget is None and len(self.wb_channels) >= 512:
            budget = 4096
        with self.timer.stage("channelize"):
            with self.timer.stage("bank", device=self.channelizer.device):
                i_ch, q_ch = self.channelizer.process(i8, q8)
            sel = torch.as_tensor(self.wb_channels, device=i_ch.device)
            i_b, q_b = i_ch.index_select(0, sel), q_ch.index_select(0, sel)
            if i_b.shape[1] < WINDOW:
                i_b = F.pad(i_b, (0, WINDOW - i_b.shape[1]))
                q_b = F.pad(q_b, (0, WINDOW - q_b.shape[1]))
            i_b, q_b = i_b[:, :WINDOW], q_b[:, :WINDOW]
            if i_b.is_cuda:        # the part's time is the device's
                torch.cuda.synchronize(i_b.device)
        epoch = int(_now()) - SIGNAL_LENGTH_S + 1
        with self.timer.stage("decode") as part:
            results, stats = self._decode_wideband(i_b, q_b, budget)
        per_channel = []
        for k, decodes in zip(self.wb_channels, results):
            for d in decodes:
                d.freq_hz += channel_center_hz(k)
            per_channel.append((k, decodes))
        all_decodes = dedup_wideband(per_channel)
        if self.qso:
            self.qso.observe(all_decodes)
        return self.emit(all_decodes, epoch, stats, part.ms)

    def _decode_wideband(self, i_b, q_b, budget):
        """decode_window of the (B, 48000) channels (i_b, q_b), on the
        backend, with the process's WindowDecoder or, with --elastic, its
        ElasticDecoder (rtlsdr_ft8d_tpu/host/daemon.py:245-297: the dense
        global-budget decode over a mesh of the backend's cards that
        shrinks when one dies; no multipass), whose shrinks and mesh size
        the stats carry in `extra`. The ElasticDecoder, and its decoder
        per card, are built once per process (run_daemon passes it to
        every band). Returns (per-channel decode lists, WindowStats)."""
        elastic = self._elastic
        results, stats = decode_window(
            (i_b, q_b), hashes=self.hashes, return_stats=True,
            passes=1 if elastic else self.args.multipass, budget=budget,
            decoder=elastic or self.decoder, timer=self.timer,
            **ap_options(self.args, self.qso))
        if elastic is not None:
            stats.extra.update(windows_recovered=elastic.windows_recovered,
                               mesh_devices=int(elastic.mesh.size))
        return results, stats

    def decimate_fullrate(self, i8: np.ndarray, q8: np.ndarray):
        """Full-rate int8 -> padded 48000-sample baseband (no decode)."""
        return _pad_window(*self._decimate(i8, q8))

    def emit(self, decodes, epoch, stats=None, decode_ms=0.0,
             i_bb=None, q_bb=None):
        """Print/report/save one window's results."""
        self.epoch = epoch
        with self.timer.stage("spots"):
            when = datetime.fromtimestamp(epoch, timezone.utc)
            if stats is not None and self.args.stats:
                stats.epoch = epoch
                stats.decode_ms = decode_ms
                logger.info(stats.to_json())
            print_spots(decodes, when, self.dial_freq)
            if self.args.writefile and i_bb is not None:
                write_iq(timestamped_name(self.args.writefile, when),
                         i_bb, q_bb)
            if self.args.save_c2 and i_bb is not None:
                write_c2(self.args.save_c2, i_bb, q_bb, self.dial_freq)
            self.reporter.report(decodes, self.dial_freq, epoch)
        self.windows_done += 1
        return decodes

    def process_baseband(self, i_bb: np.ndarray, q_bb: np.ndarray):
        """One band's window: decode_multiband on a batch of one."""
        i_bb, q_bb = _pad_window(i_bb, q_bb)
        epoch = int(_now()) - SIGNAL_LENGTH_S + 1
        results, stats, decode_ms = decode_multiband(
            self.args, i_bb[None], q_bb[None], [self.hashes], self.qso,
            self.decoder, self.timer)
        return self.emit(results[0], epoch, stats, decode_ms, i_bb, q_bb)


def ap_options(args, qso: QsoTracker | None) -> dict:
    """decode_window's AP and OSD options for one window
    (rtlsdr_ft8d_tpu/host/daemon.py:342-349): the CQ and own-call clamp
    rows and the tracker's codeword bank with --ap, the deep decode's
    quota with --osd."""
    return dict(ap_cq=args.ap, osd_cands=args.osd,
                ap_call=args.callsign if args.ap else None,
                ap_texts=qso.bank() if qso else None)


def decode_multiband(args, i_b, q_b, hashes, qso: QsoTracker | None,
                     decoder: WindowDecoder, timer: StageTimer):
    """One multiband window (run_daemon's body for several -f bands): ONE
    batched decode_window of the (bands, 48000) float32 (i_b, q_b) in the
    part "decode" of `timer`, each band resolving hashed calls against
    its own table of `hashes`, with --multipass, --osd and --ap as
    `args` gives them; then the tracker `qso` shared by every band (None
    without --ap) observes all the bands' decodes at once, so a pair ages
    once a window, as its ttl counts; of the pairs heard, it keeps the
    last `max_pairs` in band order. Returns (per-band decode lists, the
    window's WindowStats, the decode part's ms)."""
    with timer.stage("decode") as part:
        results, stats = decode_window(
            (i_b, q_b), hashes=hashes, return_stats=True,
            passes=args.multipass, decoder=decoder, timer=timer,
            **ap_options(args, qso))
    if qso is not None:
        qso.observe([d for decodes in results for d in decodes])
    return results, stats, part.ms


def run_daemon(args) -> int:
    """Live mode: RTL-SDR (or synthetic) -> ring -> windows
    (rtlsdr_ft8d_tpu/host/daemon.py:356-571).

    With several -f arguments, one device per band (device indices
    counting up from -i) feeds one ring each, and all bands decode as ONE
    batched window, each band resolving hashed calls against its own
    table; with --wideband each band decodes its own channels. With
    --stats, each window also logs its host-clock seconds by part (ring
    pop, upload + decimation or channelization, decode, spots) as one
    JSON record, and a second with the window's spans (host and device
    milliseconds by dotted path, the parts' and decode_window's) and
    counters.
    """
    from .. import native
    from .sources import RtlSdrSource, SourceError, SyntheticSource

    bands = [parse_frequency(f, args.directsampling)
             for f in args.frequency]
    decoder = WindowDecoder().to(args.backend)
    # one elastic mesh per process
    elastic = (ElasticDecoder(local_devices(args.backend), decoder=decoder)
               if args.wideband and args.elastic else None)
    procs = [WindowProcessor(args, dial, decoder, elastic)
             for dial, _ in bands]
    # one QsoTracker for all bands: QSOs are per station, not per band
    for p in procs[1:]:
        p.qso = procs[0].qso
    if args.elastic and args.multipass > 1:
        print("warning: --multipass is not available on the --elastic "
              "path; running single-pass", file=sys.stderr)

    lib = native.load()
    if lib is None:
        print("native ingest library unavailable", file=sys.stderr)
        return 1
    rings = [lib.ingest_ring_create(1 << 26) for _ in bands]

    synthetic = args.synthetic
    sources = []
    try:
        for bi, (dial_freq, ds) in enumerate(bands):
            if synthetic:
                sources.append(SyntheticSource())
            else:
                sources.append(RtlSdrSource(
                    device_index=args.device + bi, dial_freq_hz=dial_freq,
                    gain=args.gain, autogain=args.autogain, ppm=args.ppm,
                    direct_sampling=ds, offset=args.offset,
                    upconverter=int(atofs(args.upconverter))))
    except SourceError as e:
        print(f"source error: {e}", file=sys.stderr)
        for r in rings:
            lib.ingest_ring_destroy(r)
        return 1

    def push_fn(ring):
        def push(u8):
            lib.ingest_ring_push_u8(
                ring, u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                u8.shape[0] // 2)
        return push

    if not synthetic:
        for src, ring in zip(sources, rings):
            src.start(push_fn(ring))

    stop = False

    # SIGTERM (systemd stop) / SIGHUP must cancel the USB read and close
    # the device, not just KeyboardInterrupt (reference c:1203-1208).
    def _graceful(signum, frame):
        nonlocal stop
        stop = True

    installed = {}
    for sig in (signal.SIGINT, signal.SIGTERM, signal.SIGHUP):
        try:
            installed[sig] = signal.signal(sig, _graceful)
        except (ValueError, OSError):
            pass                      # non-main thread / unsupported

    def align_to_boundary():
        """Sleep to the next 15-s UTC boundary in 0.1-s slices (so a
        SIGTERM is seen), then flush everything captured before it: window
        0 starts AT the boundary (reference c:1349-1352)."""
        deadline = _now() + seconds_to_next_window()
        while not stop and _now() < deadline:
            _sleep(min(0.1, max(deadline - _now(), 0.0)))
        for ring in rings:
            lib.ingest_ring_discard(ring, lib.ingest_ring_available(ring))

    def resync(reason):
        print(f"{reason}, resyncing to next UTC boundary", file=sys.stderr)
        align_to_boundary()
        for proc in procs:
            proc.reset_streams()

    try:
        i8 = np.zeros(FULLRATE_WINDOW, dtype=np.int8)
        q8 = np.zeros(FULLRATE_WINDOW, dtype=np.int8)
        multiband = len(bands) > 1 and not args.wideband
        pace = synthetic and args.synthetic_pace
        if not synthetic or pace:
            align_to_boundary()
        dropped_seen = [0] * len(rings)
        consecutive_short = 0
        while not stop:
            if pace:
                # one window per real 15-s UTC boundary (plain --synthetic
                # free-runs)
                deadline = _now() + seconds_to_next_window()
                while not stop and _now() < deadline:
                    _sleep(min(0.1, max(deadline - _now(), 0.0)))
            timer = StageTimer(detail=args.stats,
                               window=procs[0].windows_done)
            basebands = []
            short = None
            for src, ring, proc in zip(sources, rings, procs):
                proc.timer = timer
                if synthetic:
                    with timer.stage("source"):
                        push_fn(ring)(src.read(FULLRATE_WINDOW))
                else:
                    # after a boundary flush the ring needs a full 15 s;
                    # allow 2 s of slack before declaring the window short
                    deadline = _now() + SIGNAL_LENGTH_S + 2.0
                    while (lib.ingest_ring_available(ring) < FULLRATE_WINDOW
                           and _now() < deadline and not stop):
                        _sleep(0.1)
                pop_i, pop_q, got = proc.pop_window(lib, ring, i8, q8)
                if got < FULLRATE_WINDOW:
                    short = got
                    break
                if multiband:
                    basebands.append(proc.decimate_fullrate(pop_i, pop_q))
                else:
                    proc.process_fullrate(pop_i, pop_q)
            if stop:
                break
            if short is not None:
                # missed deadline: discard the partial window and realign
                # (the reference skips partial buffers, c:235-237)
                consecutive_short += 1
                if consecutive_short >= 2:
                    # pump looks dead, not just late: reopen the device(s)
                    for src in sources:
                        if hasattr(src, "restart"):
                            try:
                                src.restart()
                                print("device restarted", file=sys.stderr)
                            except Exception as e:  # keep the daemon up
                                print(f"device restart failed: {e}",
                                      file=sys.stderr)
                    consecutive_short = 0
                resync(f"short window ({short} samples)")
                continue
            consecutive_short = 0
            if multiband:
                # ONE batched decode across all bands; each band resolves
                # hashed calls against its OWN table
                i_b = np.stack([b[0] for b in basebands])
                q_b = np.stack([b[1] for b in basebands])
                epoch = int(_now()) - SIGNAL_LENGTH_S + 1
                results, mb_stats, decode_ms = decode_multiband(
                    args, i_b, q_b, [p.hashes for p in procs], procs[0].qso,
                    decoder, timer)
                for bi, (proc, decodes, bb) in enumerate(
                        zip(procs, results, basebands)):
                    # ONE WindowStats across all bands, logged once
                    proc.emit(decodes, epoch, mb_stats if bi == 0 else None,
                              decode_ms, i_bb=bb[0], q_bb=bb[1])
            if args.stats:
                logger.info(json.dumps({"window_seconds": {
                    k: v / 1000.0 for k, v in timer.timings.items()},
                    "bands": len(bands)}, sort_keys=True))
                logger.info(json.dumps({"window_spans": {
                    path: {"host_ms": v["host_ms"],
                           "device_ms": v["device_ms"]}
                    for path, v in timer.by_path().items()},
                    "counters": timer.counters, "epoch": procs[0].epoch},
                    sort_keys=True))
            if args.maxloop and procs[0].windows_done >= args.maxloop:
                stop = True
            if not stop and not synthetic:
                # drift control: a ring overrun means samples were lost and
                # every later window would be permanently offset
                over = False
                for bi, ring in enumerate(rings):
                    d = lib.ingest_ring_dropped(ring)
                    if d != dropped_seen[bi]:
                        dropped_seen[bi] = d
                        over = True
                if over:
                    resync("ring overrun (samples dropped)")
    except KeyboardInterrupt:
        pass
    finally:
        for sig, old in installed.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        if not synthetic:
            for src in sources:
                try:
                    src.stop()
                except SourceError as e:    # wedged pump: leak, keep going
                    print(f"source stop: {e}", file=sys.stderr)
        for r in rings:
            lib.ingest_ring_destroy(r)
    return 0
