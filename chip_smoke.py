#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --nccl-ranks   # phase 8 (f) across the cards

Needs one CUDA card of compute capability 9.0 (H100), nvcc and g++;
imports nothing of JAX or of the JAX package. Phases, one line each, any
failure exits non-zero:

  1. device   the card, its name and power limit (nvidia-smi), full-f32
              matmuls (TF32 off);
  2. build    compiles rtlsdr_ft8d_tpu_torch/csrc/*.cu for sm_90a (one
              nvcc per source, in parallel) and, beside it, the native
              ingest/codec library native/*.cc into the port's build
              directory, where the port's bindings (native.py) load it;
  3. kernels  each kernel against its plain PyTorch version on the card at
              the main paths' shapes (64 channels; 1024 and 7680 flat
              candidates; one full 15-s band window of 36,005,250 int8
              samples for the decimator), with CUDA-event median times of
              both, each kernel's device time from one torch.profiler
              pass, its bound (bytes over HBM rate or operations over the
              FP32 rate, whichever is larger) and, where one PyTorch call
              computes the same function, that call's time (torch.fft.fft
              for the waterfall, F.conv1d for the decimator; the port
              calls neither); sync fused with find_sync's first top-K
              stage, bit-exact against the plain stage and faster on the
              device than its scores-only mode plus the PyTorch chunk
              stage, find_sync's dict on the bench batch, the ladder and
              the golden fixtures identical in order to the plain path's;
              BP on synthetic rows and on the bench forward's own LLRs,
              hard bits and errors equal on every row, the posterior
              bit-equal; a profiler pass over one tone_llrs_cuda call
              shows one kernel launch and no host->device copy; and the
              int8 decimator on aligned and unaligned rows, its
              registers, shared memory, share of the bound and GB/s, the
              streaming decimator across chunks of 48,000, 1 and 300
              frames, and the host->device copy of one window as int8
              (pageable and pinned) and as float32;
  4. main     the decode path through decode_window: the golden fixtures
              give exactly the single-pass oracle texts, the bench batch
              (bench.py:42-48) decodes 64/64 unbudgeted and at budget=1024,
              the bench ladder (bench.py:73-107) gives strong 40/40 and weak
              >= 12/24; every decode kernel's launch count from that run is
              > 0; the launches of one forward (1 each of sync and bp);
              then end-to-end windows/s at 64 channels and budget=1024 and
              a torch.profiler breakdown of 5 forwards (device busy, idle
              share, time by kernel, gatherTopK, sync and bp per forward);
              then the knife-edge A/B (scripts/wf_fast_compare.py:28-73:
              8 seeds x 64 channels at -15..-20 dB, budget=1024) decodes
              each batch through decode_from_waterfall from the kernel's
              waterfall and from the plain version's: the sorted decode
              lists must be identical on all 512 channels;
  5. daemon   the port's CLI in-process, 4 bands x 2 synthetic windows with
              --pallas-ingest: CQ K1JT FN20 in every band's spots of both
              windows, every kernel's launch count from that run > 0 but
              the OSD's (0: no --osd), the seconds per window by part and the decimate part per band;
              one band, one window with the
              float --ingest device path gives the same texts, frequencies
              and DTs; then multipass: on the masked scene of
              tests/test_multipass.py one pass finds the strong signal
              only, two passes find both;
  6. deep     the deep decode (--osd: refinement, one BP launch with
              posteriors over every rung, OSD on the card) and the a-priori stack
              (--ap: clamp rows, codeword bank) through decode_window, every
              decode kernel's launch count from that run > 0: golden_10sig
              with osd_cands=8 and 2 passes gives exactly golden_10sig.txt;
              golden_busy with 3 passes, osd_cands=8 and the continuation
              bank all 18 texts of golden_busy.txt and no other; the
              bench's busy band (bench.py:205-260, 64 channels, n_osd 512)
              meets the bench's deep floors at one launch (bench.py:343-354)
              with --osd 8, and again with the CQ and K1ABC clamp rows and
              a 1024-row bank (9 rungs), with no text the scene did not
              send; ldpc.cu with posteriors on that run's 9 x 512 rungs
              against the plain version (hard bits, errors, posterior
              bit-equal); one deep forward's launches, device busy, idle
              share and device ms by part (refinement, stacked-rung BP,
              the bank, the llr.cu SNR launch, held against its plain
              version at that shape); osd.cu on that forward's own
              posteriors (512 rows, both flavors; and its valid rows)
              and on 2,400 synthetic rows (accepts on flavor A and on
              flavor B both > 0) bit-equal to native ft8_osd_batch, with
              its times, the native calls' and its bound, and the OSD +
              merge ms with the posteriors on the card; the
              daemon with --ap --osd 8 --multipass 3 on 2 bands x 2
              windows finds CQ K1JT FN20 in every band with one QSO
              tracker; the busy band's one pass launches no subtraction,
              the multipass runs do; subtract.cu at the deep cell's shape
              (one window of its weak traffic, 64 channels, the first
              pass's ~300 pairs): its refine and residual launches timed
              beside the plain version on the card and the bound, the
              host ms of the pair list, the cost of sincosf's slow path,
              the share of pairs whose start or shift differs from the
              plain version's, and its residual at the plain version's
              refinement within 1e-5 of the window's RMS;
  7. wideband the 1500-channel channelizer and the full-band decode: (a)
              channelize and channelize_int8 on the card against the CPU
              on 64 and 480 random frames (rtol, atol 1e-4), the int8
              stream over chunks of 23, 17 and 24 frames against the
              one-shot call, and one full-band channelize_int8 timed
              (CUDA events; device ms of the GEMMs and of the polyphase
              sums; share of the bound; peak allocated memory); (b) the
              bench's wideband scene (bench.py:356-385: 1500 channels,
              41 seeded, budget 4096) decodes 41/41 from device-resident
              I/Q, with its ms per window, the device graph's ms, one
              forward's launches and profile, and each decode kernel
              against its plain version on that forward's operands; (c)
              the same with osd_cands=1 (bench.py:387-408) decodes 41/41,
              the OSD launched on the card, with the download, unpack,
              OSD + merge ms; (d) the full-band capture of
              tests/test_channelize.py:87-111 through the channelizer, all
              1500 channels decoded and deduplicated, gives exactly its two
              texts; (e) the daemon with --wideband over all 1500 channels,
              2 windows: one CQ K1JT FN20 per window, every decode kernel
              launched, each window inside 15 s, its seconds by part.
  8. parallel the parallel layer (rtlsdr_ft8d_tpu_torch/parallel/) on the
              card, its slots all cuda:0 (slots on one card measure no
              scaling): (a) the wideband scene through the dense
              global-budget decode at budget 4096 over a (2, 2) mesh (the
              launch counts of exactly that run) and over one slot, 41/41
              in both and their outputs equal; llr.cu and ldpc.cu at one
              slot's N = 45,000 rows against their plain versions, every
              row, the all-zero rows included, with times and bounds; the
              window's device busy and idle share; (b) the deep dense
              decode (1024 OSD rows, CQ + K1ABC clamp rows, 1024-row bank):
              >= 41/41 with the OSD on the card (its OSD + merge ms),
              osd_chan inside the band, the rungs' posterior
              launch bit-equal; (c) the sharded decode of the bench batch
              (budget 1024, osd_cands 2) over 4 slots: every field of the
              one-slot forward equal but the posteriors, within POST_ATOL;
              (d) the elastic mesh 4 -> 2 -> 1 under an injected
              heartbeat, decode lists unchanged, and one window with OSD
              rows whose OSD runs on the card; (e) the halo decimator (a
              full window) and channelizer (odd frames per slot), 4 slots
              against 1; (f) two processes on gloo, each decoding its half
              of the scene over the global (2, 2) mesh, equal to (a), and
              the halo across the rank boundary; (g) the daemon with
              --wideband --elastic over 1500 channels x 2 windows.

The last three lines are a JSON record of the kernels, the card's name and
power limit, and {"ok": true, "device": {...}}.

With --nccl-ranks (two cards or more) only phases 1, 2 and 8 (f) run:
one process per card joined by NCCL, each decoding its share of the
scene over the global (cards, 1) mesh and carrying the halo to the next
card, held against the one-process dense decode over as many slots.
"""

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")
B = 64
BUDGET = 1024
BENCH_MSGS = ["CQ K1JT FN20", "K1ABC W9XYZ EN37", "CQ VA2GKA FN35",
              "W9XYZ K1ABC R-09"]
LADDER_SNRS = [-10.0, -11.5, -13.0, -14.5, -16.0, -17.0, -18.0, -19.0]
PER_RUNG = 8
DECODE_KERNELS = ("waterfall", "sync", "llr", "bp")
# phase 6 (g)'s synthetic OSD rows: the deep cell's rows a window
OSD_SYNTHETIC_ROWS = 2400
DAEMON_BANDS = ("20m", "40m", "30m", "17m")
DAEMON_WINDOWS = 2
SPOT = "CQ K1JT FN20"
KNIFE_SEEDS = 8
KNIFE_MSGS = BENCH_MSGS + ["CQ TEST K1ABC FN42", "K1ABC W9XYZ RR73"]
# BP kernel vs bp_decode_plain: both run the same round-to-nearest float32
# operations in the same order, so the posterior is held bit-equal
POST_ULP = 0
# the deep phase: bench.py:205-260's busy band (64 channels), --osd 8
OSD_CANDS = 8
WEAK_MSG = "CQ W1AW FN31"
WEAK_SNRS = [-19.0, -19.5, -20.0, -20.5]
OSD_MSG = "K1ABC W9XYZ EN37"
OSD_REGIME = [(4.4, 3, 610.0), (4.4, 9, 1030.0), (4.7, 26, 1117.5),
              (4.0, 33, 470.0), (5.0, 26, 1135.0)]
AP_CALL = "K1ABC"
DEEP_DAEMON_BANDS = ("20m", "40m")
# the wideband phase: the bench's full band (bench.py:356-408)
WB_CHANNELS = 1500
WB_BUDGET = 4096
# the sharded decode's posteriors against the one-slot forward's: the
# H100 at 700 W read 0.0053 at most on the bench batch (largest magnitude
# about 30); a shard refining wrong rows moves them by units
POST_ATOL = 0.05
# H100 SXM published peaks at a 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# integer operations: 64 INT32 lanes an SM x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 16.7e12
# each kernel's function in the profiler's kernel names (the subtraction
# launches two)
KERNEL_SYMBOLS = {"waterfall": "waterfall_kernel", "sync": "sync_kernel",
                  "llr": "llr_kernel", "bp": "bp_kernel",
                  "decimate": "decimate_kernel", "osd": "osd_kernel",
                  "subtract": ("refine_kernel", "residual_kernel")}
# phase 6 (h): window 0 of the deep cell's weak traffic at this seed
SUBTRACT_SEED = 2147600013


class Failure(Exception):
    pass


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def require(cond, msg):
    if not cond:
        raise Failure(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def sigma_for_snr(snr_db, amp=0.5):
    """Noise sigma for an SNR in dB re 2500 Hz at 3,200 sps (bench.py)."""
    return np.sqrt(amp ** 2 / (2 * 10 ** (snr_db / 10.0) * (2500.0 / 3200.0)))


def bound(nbytes, ops):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for `nbytes` moved and `ops` FP32-class operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def waterfall_bound(wf):
    """The waterfall's bound for a (B, 92, 2, 2, 256) output: both
    components' used samples in, the waterfall out; the FFT's operations
    (5 N log2 N per 1024-point frame)."""
    from rtlsdr_ft8d_tpu_torch.ops import waterfall

    b = wf.shape[0]
    return bound(2 * b * waterfall.USED_SAMPLES * 4 + wf.numel(),
                 5 * 1024 * 10 * waterfall.NUM_FRAMES * b)


def llr_bound(cand_flat, chan, s2, valid, llrs):
    """llr.cu's bound for N flat candidates: the tone cells read, the
    fields read, s2, valid and the LLRs written; per symbol 3 x 8 tone
    magnitudes and 3 x 3 max-log terms, 2 per LLR."""
    n = chan.shape[0]
    fields = sum(x.element_size() for x in (chan, *cand_flat.values())) * n
    return bound(n * 58 * 8 + fields + s2.numel() * 4 + valid.numel()
                 + llrs.numel() * 4, n * 58 * (3 * 8 + 3 * 3) + n * 174 * 2)


def bp_bound(x, outputs, row_iterations):
    """ldpc.cu's bound: the LLRs in and `outputs` out; 32 FP32 operations
    per edge and iteration (posterior add, difference, scale, clamp 2,
    tanh 10, products 3, clamp 2, atanh 11, scale), 522 edges, over
    `row_iterations`, the iterations the rows' outputs need."""
    return bound(x.numel() * 4 + sum(t.numel() * t.element_size()
                                     for t in outputs),
                 32 * 522 * row_iterations)


def osd_bound(n_rows, n_runs, depth=24, pair_depth=10):
    """osd.cu's bound: both flavors' posteriors in, messages and accept
    out; and the iterations of native/osd.cc's inner loops, one integer
    operation each, for the `n_runs` rows and flavors run, at the least
    the inputs need: 91 basis steps of 91 reduce and 91 back-eliminate
    checks, the solve's 91 parities, 1 + depth encodes of 83 parities,
    depth inverse columns of 91 bits, the two sorts' comparisons (174 x 8
    and 91 x 7), the 174 summed reliabilities, and per pattern its three
    words compared and its shortlist insertion. Returns (ms, bound by)."""
    n_pat = 1 + depth + pair_depth * (pair_depth - 1) // 2
    per_run = (2 * 91 * 91 + 91 + 83 * (1 + depth) + 91 * depth + 174 * 8
               + 91 * 7 + 174 + 4 * n_pat)
    t_bytes = (2 * n_rows * 174 * 4 + n_rows * 92) / HBM_BYTES_PER_S * 1e3
    t_ops = per_run * n_runs / INT32_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "integer operations"))


def subtract_bound(n_pairs, n_rows):
    """subtract.cu's bound for n_pairs pairs over (n_rows, 48000)
    windows: both components in once and the residual out once; 8 FP32
    operations (two complex products summed) a sample of each of the
    refinement's 31 variants and 6 a sample of the reconstruction, over
    79 x 512 samples a pair."""
    return bound(2 * 2 * n_rows * 48000 * 4,
                 n_pairs * 79 * 512 * (31 * 8 + 6))


def profiled(torch, fn, calls, enough=bool, tries=3, required=True):
    """torch.profiler over `calls` calls of fn (warmed up once), ending in
    a synchronize; returns (device events, wall seconds of the region).
    The profiler has been seen to drop device records on the card, once
    all of a pass's: a pass whose events fail `enough` runs again, up to
    `tries` passes; then it raises, or returns None if not `required`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ev = device_events(torch, prof)
        if enough(ev):
            return ev, wall
    if not required:
        say("profile", f"torch.profiler recorded {len(ev)} device events in "
            f"{calls} calls, {tries} passes running: not recorded")
        return None
    raise Failure(f"torch.profiler recorded {len(ev)} device events in "
                  f"{calls} calls, {tries} passes running")


def device_events(torch, prof):
    """(name, start us, end us) of every event that ran on the card."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def is_copy(name):
    return name.startswith("Memcpy") or name.startswith("Memset")


def fmt_ms(x):
    return "not recorded" if x is None else f"{x:.4f}"


def device_ms(torch, fn, symbol, calls=10, required=True):
    """Device milliseconds per launch of the kernel named `symbol`, for fn
    that launches it once per call; the mean over the launches the
    profiler recorded, at least half of them (None if not `required` and
    the profiler dropped them)."""
    def mine(ev):
        return [e for e in ev if symbol in e[0]]

    got = profiled(torch, fn, calls,
                   lambda ev: calls // 2 <= len(mine(ev)) <= calls,
                   required=required)
    if got is None:
        return None
    ev = mine(got[0])
    return sum(end - start for _, start, end in ev) / len(ev) / 1e3


def bench_batch():
    """bench.py:42-48: 64 channels, one strong message each, seed 5."""
    from rtlsdr_ft8d_tpu_torch.host.synth import synthesize_message

    rng = np.random.default_rng(5)
    batch = np.stack([
        synthesize_message(BENCH_MSGS[b % 4], f0_hz=100 + 17.5 * b % 1300,
                           noise_sigma=0.3, rng=rng) for b in range(B)])
    return batch, [BENCH_MSGS[b % 4] for b in range(B)]


def ladder_batch():
    """bench.py:73-90: 8 SNR rungs x 8 channels, -10 .. -19 dB."""
    from rtlsdr_ft8d_tpu_torch.host.synth import synthesize_message

    chans, msgs = [], []
    for r, snr in enumerate(LADDER_SNRS):
        for t in range(PER_RUNG):
            b = r * PER_RUNG + t
            chans.append(synthesize_message(
                BENCH_MSGS[b % 4], f0_hz=250 + 16.5 * b,
                noise_sigma=sigma_for_snr(snr),
                rng=np.random.default_rng(1000 + b)))
            msgs.append(BENCH_MSGS[b % 4])
    return np.stack(chans), msgs


def bp_rows(n):
    """Codewords at three noise levels mixed with pure noise, in the
    proportions of tests/test_kernels_vs_reference.py:135-145."""
    from rtlsdr_ft8d_tpu_torch.protocol.crc import add_crc
    from rtlsdr_ft8d_tpu_torch.protocol.encode import ldpc_encode

    rng = np.random.default_rng(7)
    rows = []
    for t in range(n):
        if t % 64 < 40:
            payload = rng.integers(0, 2, 77).astype(np.uint8)
            cw = ldpc_encode(add_crc(payload)).astype(np.float32)
            rows.append((2.0 * cw - 1.0) * [4.0, 1.2, 0.7][t % 3]
                        + rng.normal(0, 1.0, 174).astype(np.float32))
        else:
            rows.append(rng.normal(0, 2.0, 174).astype(np.float32))
    return np.stack(rows).astype(np.float32) * 2.0


def median_ms(torch, fn, reps=5, calls=20, warmup=3):
    """Milliseconds per call: CUDA events around `calls` back-to-back
    calls, median over `reps` runs. Where a call's device work is shorter
    than its host-side launch cost, this measures the host."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def count_decoded(results, msgs):
    return sum(1 for r, m in zip(results, msgs) if m in {d.text for d in r})


def check_kernels(torch, dec, i_n, q_n):
    """Phase 3: every decode kernel against its plain version on the card,
    with its device time, bound and library yardstick."""
    from rtlsdr_ft8d_tpu_torch.ops import llr, sync, waterfall

    rec = {}
    bases = (dec.wf_cos, dec.wf_sin, dec.wf_cos_minus_sin)
    fft_tables = (dec.wf_twiddle, dec.wf_window)

    def wf_kernel():
        return waterfall.waterfall_cuda(i_n, q_n, *fft_tables)

    wf_k = wf_kernel()
    wf_p = waterfall.waterfall_plain(i_n, q_n, *bases)
    d = (wf_k.int() - wf_p.int()).abs()
    exact = (d == 0).double().mean().item()
    require(d.max().item() <= 1 and exact > 0.999,
            f"waterfall: max step {d.max().item()}, exact {exact:.6f}")
    # library yardstick: one complex FFT of the windowed frames, prepared
    # outside the timed loop (the port never calls it)
    frames = waterfall._frames(torch.complex(i_n, q_n)) * dec.wf_window
    wf_bound = waterfall_bound(wf_k)
    rec["waterfall"] = {
        "max_abs_err": float(d.max().item()), "exact_cells": exact,
        "ms": median_ms(torch, wf_kernel),
        "plain_ms": median_ms(torch, lambda: waterfall.waterfall_plain(
            i_n, q_n, *bases)),
        "library_ms": median_ms(torch, lambda: torch.fft.fft(frames)),
        "device_ms": device_ms(torch, wf_kernel, KERNEL_SYMBOLS["waterfall"]),
        "bound_ms": wf_bound[0], "bound_by": wf_bound[1], "shape": f"B={B}"}
    r = rec["waterfall"]
    require(r["ms"] < r["plain_ms"],
            f"waterfall: kernel {r['ms']:.3f} ms is not below the plain "
            f"version's {r['plain_ms']:.3f} ms")
    say("kernels", f"waterfall B={B}: max step {d.max().item()}, exact "
        f"cells {exact:.6f}, {r['ms']:.4f} ms (device {r['device_ms']:.4f})"
        f" vs plain {r['plain_ms']:.3f} ms, torch.fft.fft "
        f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")

    rec["sync"] = check_sync(torch, dec, wf_k)
    cand = sync.find_sync(wf_k, dec.sync_count)
    flat, chan, _, K = llr.flatten_grid(cand)
    _, sel = sync.top_k(cand["score"].reshape(-1), BUDGET)
    shapes = {7680: (flat, chan),
              BUDGET: ({k: v[sel] for k, v in flat.items()}, sel // K)}
    rec["llr"] = {"max_abs_err": 0.0, "ms_by_shape": {}, "library_ms": None}
    fwd_llrs = {}      # the bench forward's own LLRs, budgeted and not
    for n, (cf, ch) in sorted(shapes.items()):
        def llr_kernel(cf=cf, ch=ch):
            return llr.tone_llrs_cuda(wf_k, cf, ch)

        s2_k, v_k, l_k = llr_kernel()
        fwd_llrs[n] = l_k
        s2_p, v_p, l_p = llr.tone_llrs_plain(wf_k, cf, ch)
        require(torch.equal(s2_k, s2_p) and torch.equal(v_k, v_p),
                f"llr N={n}: s2 or valid not bit-exact")
        require(torch.allclose(l_k, l_p, rtol=1e-5, atol=1e-5),
                f"llr N={n}: LLRs differ beyond 1e-5")
        err = (l_k - l_p).abs().max().item()
        ms = median_ms(torch, llr_kernel)
        pms = median_ms(torch, lambda: llr.tone_llrs_plain(wf_k, cf, ch))
        dms = device_ms(torch, llr_kernel, KERNEL_SYMBOLS["llr"])
        b_ms, b_by = llr_bound(cf, ch, s2_k, v_k, l_k)
        rec["llr"]["max_abs_err"] = max(rec["llr"]["max_abs_err"], err)
        rec["llr"]["ms_by_shape"][f"N={n}"] = {
            "ms": ms, "plain_ms": pms, "device_ms": dms, "bound_ms": b_ms,
            "bound_by": b_by}
        say("kernels", f"llr N={n} ({str(ch.dtype)[6:]} fields): s2 and "
            f"valid bit-exact, LLR max err {err:.3g}, {ms:.4f} ms (device "
            f"{dms:.4f}) vs plain {pms:.3f} ms, bound {b_ms:.5f} ms ({b_by})")
    rec["llr"].update(rec["llr"]["ms_by_shape"][f"N={BUDGET}"])

    # one call, profiled: one kernel launch and no host->device copy
    cf, ch = shapes[BUDGET]
    ev, _ = profiled(torch, lambda: llr.tone_llrs_cuda(wf_k, cf, ch), 1,
                     lambda ev: any(not is_copy(e[0]) for e in ev))
    names = [e[0] for e in ev]
    launched = [x for x in names if not is_copy(x)]
    htod = [x for x in names if "HtoD" in x]
    require(len(launched) == 1 and KERNEL_SYMBOLS["llr"] in launched[0]
            and not htod, f"llr: one call ran {names} on the card")
    rec["llr"]["launches_per_call"] = len(launched)
    say("kernels", f"llr: one tone_llrs_cuda call ran {len(launched)} "
        f"kernel ({KERNEL_SYMBOLS['llr']}) and {len(htod)} host->device "
        f"copies on the card (torch.profiler)")

    rec["bp"] = check_bp(torch, dec, fwd_llrs)
    return rec


def all_device_ms(torch, fn, calls=10, required=True):
    """Device milliseconds per call summed over every kernel fn runs (None
    if not `required` and the profiler dropped records)."""
    got = profiled(torch, fn, calls, lambda ev: len(ev) >= calls,
                   required=required)
    if got is None:
        return None
    return sum(end - start for name, start, end in got[0]
               if not is_copy(name)) / calls / 1e3


def same_candidates(torch, got, want):
    """find_sync dicts identical key by key, in order."""
    return all(torch.equal(got[k].cpu(), want[k].cpu()) for k in want)


def check_sync(torch, dec, wf_k):
    """Phase 3, sync: the fused kernel (scores and find_sync's first top-K
    stage, sync_survivors_cuda) against the plain stage on the plain
    scores, the scores-only mode against sync_scores_plain, both
    bit-exact, and find_sync's dict against the plain path's on the CPU;
    times against the yardstick the kernel replaces: the scores-only mode
    plus the PyTorch chunk stage (pad, key, torch.topk, gather)."""
    from rtlsdr_ft8d_tpu_torch.ops import sync

    count = dec.sync_count

    def fused():
        return sync.sync_survivors_cuda(wf_k, count)

    def yardstick():
        return sync.chunk_survivors(sync.sync_scores_cuda(wf_k, count))

    def scores_only():
        return sync.sync_scores_cuda(wf_k, count)

    s_p = sync.sync_scores_plain(wf_k, count)
    require(torch.equal(scores_only(), s_p),
            "sync: the scores-only mode is not bit-exact")
    v1_k, g_k = fused()
    v1_p, g_p = sync.chunk_survivors(s_p)
    require(torch.equal(v1_k, v1_p) and torch.equal(g_k, g_p),
            "sync: the fused first stage differs from chunk_survivors")
    require(same_candidates(torch, sync.find_sync(wf_k, count),
                            sync.find_sync(wf_k.cpu(), count.cpu())),
            "sync: find_sync on the card differs from the plain path")
    # bytes: the waterfall in, the survivors out; operations: 3 Costas
    # blocks x 7 tones x 4 neighbour differences per score cell
    nbytes = wf_k.numel() + (v1_k.numel() + g_k.numel()) * 4
    ops = s_p.numel() * 84
    b_ms, b_by = bound(nbytes, ops)
    rec = {
        "max_abs_err": 0.0, "ms": median_ms(torch, fused),
        "plain_ms": median_ms(torch, lambda: sync.chunk_survivors(
            sync.sync_scores_plain(wf_k, count))),
        "library_ms": None,
        "device_ms": device_ms(torch, fused, KERNEL_SYMBOLS["sync"]),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_ops_ms": ops / F32_OPS_PER_S * 1e3,
        "yardstick_ms": median_ms(torch, yardstick),
        "yardstick_device_ms": all_device_ms(torch, yardstick),
        "scores_only_ms": median_ms(torch, scores_only),
        "scores_only_device_ms": device_ms(torch, scores_only,
                                           KERNEL_SYMBOLS["sync"]),
        "shape": f"B={B}"}
    require(rec["device_ms"] < rec["yardstick_device_ms"],
            f"sync: fused device {rec['device_ms']:.4f} ms is not below the "
            f"scores-only mode + PyTorch chunk stage's "
            f"{rec['yardstick_device_ms']:.4f} ms")
    say("kernels", f"sync B={B}: scores-only mode, fused survivors and "
        f"find_sync bit-exact; fused {rec['ms']:.4f} ms (device "
        f"{rec['device_ms']:.4f}) vs scores-only + PyTorch chunk stage "
        f"{rec['yardstick_ms']:.4f} ms (device "
        f"{rec['yardstick_device_ms']:.4f}), plain {rec['plain_ms']:.3f} "
        f"ms, scores-only {rec['scores_only_ms']:.4f} ms (device "
        f"{rec['scores_only_device_ms']:.4f}); bound {b_ms:.4f} ms ({b_by};"
        f" bytes {rec['bound_bytes_ms']:.4f}, operations "
        f"{rec['bound_ops_ms']:.4f})")
    return rec


def check_candidates(torch, dec, ladder):
    """Phase 3: find_sync's dict from the kernel's waterfall of the bench
    ladder and of the golden fixtures, on the card (the fused kernel)
    against the plain path on the CPU: identical, in order."""
    from rtlsdr_ft8d_tpu_torch.host.io import read_iq
    from rtlsdr_ft8d_tpu_torch.ops import sync

    inputs = {"ladder": (np.real(ladder), np.imag(ladder))}
    for name in ("golden_10sig", "golden_busy"):
        i, q = read_iq(os.path.join(FIX, f"{name}.iq"))
        inputs[name] = (i[None], q[None])
    for name, (i, q) in inputs.items():
        wf = dec.waterfall(*(torch.from_numpy(np.ascontiguousarray(
            x, np.float32)).to(dec.device) for x in (i, q)))
        require(same_candidates(
            torch, sync.find_sync(wf, dec.sync_count),
            sync.find_sync(wf.cpu(), dec.sync_count.cpu())),
            f"sync: find_sync on {name} differs from the plain path")
    say("kernels", f"sync: find_sync identical in order to the plain path "
        f"on {', '.join(inputs)} (and the bench batch above)")


def max_ulp(torch, a, b):
    """Largest distance of two float32 tensors in units in the last place
    (+0 and -0 are one value)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def bp_iterations(torch, ldpc, x, graph, max_iters=20):
    """Row-iterations the kernel's posterior-free launch runs on x: each
    row stops at the first iteration whose best error count is 0 (from
    the plain version run for 1 .. max_iters - 1 iterations)."""
    need = torch.full((x.shape[0],), max_iters, dtype=torch.int64,
                      device=x.device)
    for it in range(max_iters - 1, 0, -1):
        errors = ldpc.bp_decode_plain(x, *graph, it)[1]
        need = torch.where(errors == 0, it, need)
    return int(need.sum().item())


def check_bp(torch, dec, fwd_llrs):
    """Phase 3, BP: the kernel against bp_decode_plain on synthetic rows
    (bp_rows) and on the bench forward's own LLRs (budget=1024 and
    unbudgeted). Hold: hard bits and error counts equal on every row, the
    posterior within POST_ULP float32 ulps. A diagnostic times the forward
    rows again with their exact-zero LLRs (out-of-window symbols) nudged
    to 1e-3, to show whether zero operands cost time."""
    from rtlsdr_ft8d_tpu_torch.ops import ldpc

    graph = (dec.ldpc_edge_var, dec.ldpc_edge_slot, dec.ldpc_slot_edge)
    dev = dec.device
    inputs = {f"N={BUDGET}": torch.from_numpy(bp_rows(BUDGET)).to(dev),
              "N=7680": torch.from_numpy(bp_rows(7680)).to(dev),
              f"N={BUDGET} forward": fwd_llrs[BUDGET],
              "N=7680 forward": fwd_llrs[7680]}
    rec = {"max_abs_err": 0.0, "post_max_ulp": 0, "ms_by_shape": {},
           "library_ms": None}
    for shape, x in inputs.items():
        n = x.shape[0]

        def bp_kernel(x=x):
            return ldpc.bp_decode_cuda(x, *graph, 20)

        h_k, e_k, p_k = ldpc.bp_decode_cuda(x, *graph, 20, True)
        h_p, e_p, p_p = ldpc.bp_decode_plain(x, *graph, 20, True)
        require(torch.equal(e_k, e_p), f"bp {shape}: error counts differ")
        require(torch.equal(h_k, h_p), f"bp {shape}: hard bits differ")
        ulp = max_ulp(torch, p_k, p_p)
        err = (p_k - p_p).abs().max().item()
        require(ulp <= POST_ULP, f"bp {shape}: posteriors differ by {ulp} "
                f"ulp (max abs {err})")
        h_e, e_e = bp_kernel()
        require(torch.equal(h_e, h_k) and torch.equal(e_e, e_k),
                f"bp {shape}: the posterior-free launch disagrees")
        ms = median_ms(torch, bp_kernel)
        pms = median_ms(torch, lambda: ldpc.bp_decode_plain(x, *graph, 20))
        dms = device_ms(torch, bp_kernel, KERNEL_SYMBOLS["bp"])
        # the timed launch has no posterior, so a row runs until its best
        # error count is 0
        iters = bp_iterations(torch, ldpc, x, graph)
        b_ms, b_by = bp_bound(x, (h_k, e_k), iters)
        zeros = (x == 0).double().mean().item()
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["post_max_ulp"] = max(rec["post_max_ulp"], ulp)
        rec["ms_by_shape"][shape] = {
            "ms": ms, "plain_ms": pms, "device_ms": dms, "bound_ms": b_ms,
            "bound_by": b_by, "successes": int((e_k == 0).sum()),
            "iterations": iters, "zero_llr_share": zeros}
        say("kernels", f"bp {shape}: {int((e_k == 0).sum())} successes, "
            f"errors and hard bits identical on all {n} rows, posterior max "
            f"{ulp} ulp ({err:.3g}), {ms:.4f} ms (device {dms:.4f}) vs "
            f"plain {pms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, {iters} "
            f"row-iterations of {20 * n}); exact-zero LLRs {zeros:.4f}")
    x = inputs[f"N={BUDGET} forward"]
    nudged = torch.where(x == 0, torch.full_like(x, 1e-3), x)
    rec["forward_zeros_nudged_device_ms"] = device_ms(
        torch, lambda: ldpc.bp_decode_cuda(nudged, *graph, 20),
        KERNEL_SYMBOLS["bp"])
    say("kernels", f"bp N={BUDGET} forward with exact-zero LLRs nudged to "
        f"1e-3: device {rec['forward_zeros_nudged_device_ms']:.4f} ms")
    rec.update(rec["ms_by_shape"][f"N={BUDGET}"])
    return rec


def check_decimate(torch, dev):
    """Phase 3, int8 ingest: the kernel against its plain version at one
    full band window (HISTORY + 750 x 48,000 int8 samples per component,
    seed 11), hold rtol 1e-4, atol 1e-5, on rows in the kernel's layout
    (the streaming decimator's buffer) and on unaligned rows (full[1] of a
    (2, n) tensor, which the wrapper copies first); the kernel's registers,
    shared memory and blocks per SM, its share of the bound and achieved
    GB/s; the streaming decimator on the card against the plain version
    across chunks of 48,000, 1 and 300 frames, and its wall time per
    window; and the host->device copy of one window as int8 from pageable
    and from pinned memory, and as float32 (--ingest device) from
    pageable memory."""
    from rtlsdr_ft8d_tpu_torch.ops import decimate, tables

    m = 48_000
    n = decimate.HISTORY + decimate.R * m
    rng = np.random.default_rng(11)
    host8 = rng.integers(-128, 128, (2, n), dtype=np.int8)
    x8 = torch.from_numpy(host8).to(dev)
    bank = decimate.DecimatorBank(device=dev)
    lay = torch.zeros((2, -(-n // decimate.ALIGN) * decimate.ALIGN),
                      dtype=torch.int8, device=dev)
    lay[:, :n] = x8
    ai, aq = lay[0, :n], lay[1, :n]
    p_i, p_q = decimate.decimate_int8_plain(x8[0], x8[1], bank.f32)
    require(x8[1].data_ptr() % 16 != 0, "x8[1] should be unaligned")
    errs = {}
    for name, (i, q, want) in (("aligned", (ai, aq, (p_i, p_q))),
                               ("unaligned", (x8[1], x8[0], (p_q, p_i)))):
        got = decimate.decimate_int8_cuda(i, q, bank)
        errs[name] = max((a - b).abs().max().item()
                         for a, b in zip(got, want))
        require(got[0].shape == (m,) and all(
            torch.allclose(a, b, rtol=1e-4, atol=1e-5)
            for a, b in zip(got, want)),
            f"decimate {name} rows: kernel and plain differ (max err "
            f"{errs[name]})")
    err = max(errs.values())

    def dec_kernel():
        return decimate.decimate_int8_cuda(ai, aq, bank)

    # library yardstick: one strided convolution of both components'
    # float copies with the 6000-tap prototype (the bank's columns end to
    # end), cuDNN's TF32 off; the port never calls it
    xf = (x8.to(torch.float32) / 128.0)[:, None, :]
    taps = bank.f32.t().reshape(1, 1, -1).contiguous()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        lib_ms = median_ms(torch, lambda: torch.nn.functional.conv1d(
            xf, taps, stride=decimate.R))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    nbytes = x8.numel() + 2 * m * 4 + bank.f32.numel() * 4
    b_ms, b_by = bound(nbytes, 2 * m * taps.numel() * 2)
    rec = {
        "max_abs_err": err, "max_abs_err_by_rows": errs,
        "ms": median_ms(torch, dec_kernel),
        "plain_ms": median_ms(torch, lambda: decimate.decimate_int8_plain(
            x8[0], x8[1], bank.f32)),
        "library_ms": lib_ms,
        "device_ms": device_ms(torch, dec_kernel,
                               KERNEL_SYMBOLS["decimate"]),
        "unaligned_ms": median_ms(torch, lambda: decimate.decimate_int8_cuda(
            x8[1], x8[0], bank)),
        "bound_ms": b_ms, "bound_by": b_by, "shape": f"n={n} x 2",
        "kernel_info": decimate.kernel_info()}
    rec["bound_share"] = b_ms / rec["device_ms"]
    rec["achieved_gb_s"] = nbytes / rec["device_ms"] / 1e6

    # the streaming decimator on the card against the plain version on
    # the same [history, chunk], the history carried in numpy
    stream = decimate.StreamingDecimatorInt8(tables.polyphase_bank(), dev)
    hist = np.zeros((2, decimate.HISTORY), np.int8)
    for frames in (48_000, 1, 300):
        chunk = rng.integers(-128, 128, (2, frames * decimate.R),
                             dtype=np.int8)
        full = np.concatenate([hist, chunk], axis=1)
        hist = full[:, -decimate.HISTORY:]
        want = decimate.decimate_int8_plain(
            *torch.from_numpy(full).to(dev), bank.f32)
        got = stream.process(chunk[0], chunk[1])
        s_err = max(float(np.abs(a - b.cpu().numpy()).max())
                    for a, b in zip(got, want))
        require(all(np.allclose(a, b.cpu().numpy(), rtol=1e-4, atol=1e-5)
                    for a, b in zip(got, want)),
                f"decimate: the streaming decimator differs from the plain "
                f"version on a {frames}-frame chunk (max err {s_err})")
        rec["max_abs_err"] = max(rec["max_abs_err"], s_err)
    # a window through the pinned staging buffer, as the daemon's pop
    # writes it: the wall time of process(), which ends synchronized
    i_st, q_st = stream.staging(m * decimate.R)
    i_st[:], q_st[:] = host8[0, decimate.HISTORY:], host8[1, decimate.HISTORY:]
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        stream.process(i_st, q_st)
        times.append((time.perf_counter() - t0) * 1e3)
    rec["stream_window_ms"] = statistics.median(times[1:])

    host32 = host8.astype(np.float32) / 128.0
    pinned = torch.from_numpy(host8).pin_memory()
    rec["h2d_ms"] = {
        "int8": median_ms(torch, lambda: torch.from_numpy(host8).to(dev),
                          calls=3),
        "int8_pinned": median_ms(torch, lambda: pinned.to(
            dev, non_blocking=True), calls=3),
        "float32": median_ms(torch, lambda: torch.from_numpy(host32).to(dev),
                             calls=3)}
    info = rec["kernel_info"]
    say("kernels", f"decimate n={n} x 2: max err {errs['aligned']:.3g} "
        f"(unaligned rows {errs['unaligned']:.3g}, streaming chunks of "
        f"48000, 1, 300 frames held), {rec['ms']:.4f} ms (device "
        f"{rec['device_ms']:.4f}; unaligned rows with the wrapper's copy "
        f"{rec['unaligned_ms']:.4f}) vs plain {rec['plain_ms']:.3f} ms, "
        f"F.conv1d {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}): "
        f"{rec['bound_share']:.3f} of it, {rec['achieved_gb_s']:.0f} GB/s; "
        f"{info['registers']} registers, {info['dynamic_shared_bytes']} B "
        f"shared, {info['blocks_per_sm']} blocks/SM, "
        f"{info['spill_bytes']} B spills; streaming window "
        f"{rec['stream_window_ms']:.3f} ms wall; H2D of one window: int8 "
        f"{rec['h2d_ms']['int8']:.3f} ms pageable, "
        f"{rec['h2d_ms']['int8_pinned']:.3f} ms pinned ({host8.nbytes} B), "
        f"float32 {rec['h2d_ms']['float32']:.3f} ms ({host32.nbytes} B)")
    return rec


SPOT_ROW = re.compile(r"\s+(-?\d+)\s+([+-][\d.]+)\s+(\d+)\s+([+-][\d.]+) ")


def parse_spot_tables(out):
    """print_spots output -> one list per table of (freq_hz, dt, text)."""
    tables, rows = [], None
    for line in out.splitlines():
        if line.startswith("  Score") or line.startswith("No spot"):
            rows = []
            tables.append(rows)
            continue
        m = SPOT_ROW.match(line)
        if m and rows is not None:
            # after DT: call (10 wide), space, locator (6 wide), 2 spaces
            rows.append((int(m.group(3)), float(m.group(4)),
                         line[m.end() + 19:]))
    return tables


def run_cli(argv):
    """The port's CLI in-process; returns (rc, stdout, stderr)."""
    from rtlsdr_ft8d_tpu_torch.host import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def run_daemon_path(torch, build):
    """Phase 5: the live daemon as a user runs it, 4 bands x 2 synthetic
    windows through the int8 ingest, with the launch counts of exactly
    that run; then the float ingest on one band for the same spots."""
    from rtlsdr_ft8d_tpu_torch.host.cli import BAND_PLAN

    common = ["-c", "T1ST", "-l", "AA00", "--synthetic", "-x", "--stats"]
    bands = [a for band in DAEMON_BANDS for a in ("-f", band)]
    for k in build.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    rc, out, err = run_cli(bands + common + ["-n", str(DAEMON_WINDOWS),
                                             "--pallas-ingest"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    require(rc == 0, f"daemon exited {rc}: {err[-2000:]}")
    # without --osd and with one pass the daemon runs every kernel but
    # the OSD's and the subtraction's
    idle = ("osd", "subtract")
    require(all(launches[k] == 0 for k in idle)
            and all(n > 0 for k, n in launches.items() if k not in idle),
            f"a kernel was not launched on the daemon path, or the OSD "
            f"or the subtraction was: {launches}")
    tables = parse_spot_tables(out)
    require(len(tables) == len(DAEMON_BANDS) * DAEMON_WINDOWS,
            f"daemon printed {len(tables)} spot tables")
    for t, rows in enumerate(tables):
        band = DAEMON_BANDS[t % len(DAEMON_BANDS)]
        dial = BAND_PLAN[band][0]
        require(any(text == SPOT and 0 <= f - dial < 3000
                    for f, _, text in rows),
                f"window {t // len(DAEMON_BANDS)}, {band}: no {SPOT} in "
                f"{rows}")
    parts = [json.loads(line.split(": ", 1)[1])["window_seconds"]
             for line in err.splitlines() if '"window_seconds"' in line]
    require(len(parts) == DAEMON_WINDOWS, f"{len(parts)} timing records")
    say("daemon", f"{len(DAEMON_BANDS)} bands x {DAEMON_WINDOWS} windows, "
        f"--pallas-ingest: {SPOT} in all {len(tables)} spot tables; "
        f"launches {launches}; {wall:.1f} s with set-up")
    for w, p in enumerate(parts):
        say("daemon", f"window {w} seconds: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(p.items()))
            + f", total {sum(p.values()):.4f}; decimate (upload + kernel) "
            f"per band {p['decimate'] / len(DAEMON_BANDS):.4f}")

    rc, out1, err1 = run_cli(bands[:2] + common + ["-n", "1", "--ingest",
                                                   "device"])
    require(rc == 0, f"float-ingest daemon exited {rc}: {err1[-2000:]}")
    float_rows = parse_spot_tables(out1)
    require(len(float_rows) == 1 and float_rows[0] == tables[0],
            f"--ingest device {float_rows} differs from --pallas-ingest "
            f"{tables[0]}")
    say("daemon", f"one band, --ingest device: the same {len(tables[0])} "
        f"spots (text, frequency, DT) as --pallas-ingest")
    return launches, parts


def check_multipass(dec):
    """Multipass on the card: tests/test_multipass.py's masked scene."""
    from rtlsdr_ft8d_tpu_torch.host.synth import synthesize_message
    from rtlsdr_ft8d_tpu_torch.pipeline import decode_window

    rng = np.random.default_rng(7)
    weak_text = "K1ABC W9XYZ EN37"
    iq = (synthesize_message(SPOT, f0_hz=500.0, amplitude=0.5,
                             noise_sigma=0.0)
          + synthesize_message(weak_text, f0_hz=506.25, amplitude=0.035,
                               noise_sigma=0.0)
          + 0.004 * (rng.standard_normal(48000)
                     + 1j * rng.standard_normal(48000))).astype(np.complex64)
    one = {d.text for d in decode_window(iq, decoder=dec)}
    two = {d.text for d in decode_window(iq, passes=2, decoder=dec)}
    require(SPOT in one and weak_text not in one,
            f"multipass scene, one pass: {one}")
    require({SPOT, weak_text} <= two, f"multipass scene, two passes: {two}")
    say("daemon", f"multipass: one pass {sorted(one)}, two passes "
        f"{sorted(two)}")


def run_main_path(torch, dec, batch, msgs, ladder, lmsgs):
    """Phase 4: the decode path as a user calls it."""
    from rtlsdr_ft8d_tpu_torch.host.io import read_iq
    from rtlsdr_ft8d_tpu_torch.pipeline import decode_window

    for name in ("golden_10sig", "golden_busy"):
        i, q = read_iq(os.path.join(FIX, f"{name}.iq"))
        with open(os.path.join(FIX, f"{name}.single_pass.txt")) as f:
            want = sorted(line.rstrip("\n") for line in f if line.strip())
        got = sorted(d.text for d in decode_window((i, q), decoder=dec))
        require(got == want, f"{name}: got {got}, want {want}")
        say("main", f"{name}: {len(got)} texts, exactly the oracle's")

    for budget in (None, BUDGET):
        n_ok = count_decoded(decode_window(batch, budget=budget,
                                           decoder=dec), msgs)
        require(n_ok == B, f"bench batch budget={budget}: {n_ok}/{B}")
        say("main", f"bench batch budget={budget}: {n_ok}/{B}")

    lres = decode_window(ladder, budget=BUDGET, decoder=dec)
    rung = [count_decoded(lres[r * PER_RUNG:(r + 1) * PER_RUNG],
                          lmsgs[r * PER_RUNG:(r + 1) * PER_RUNG])
            for r in range(len(LADDER_SNRS))]
    strong, weak = sum(rung[:5]), sum(rung[5:])
    require(strong == 40 and weak >= 12,
            f"ladder: strong {strong}/40, weak {weak}/24, rungs {rung}")
    say("main", f"ladder budget={BUDGET}: strong {strong}/40, weak "
        f"{weak}/24, rungs {dict(zip(LADDER_SNRS, rung))}")


def merged_busy(intervals):
    """Total length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_e is None or start > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def forward_profile(torch, build, dec, batch, calls=5):
    """Launches of one forward, and a torch.profiler breakdown of `calls`
    forwards at 64 channels and budget=1024: wall and device busy ms per
    forward, the device's idle share, and device ms per forward by name."""
    dev = dec.device
    i_t = torch.from_numpy(np.real(batch).astype(np.float32)).to(dev)
    q_t = torch.from_numpy(np.imag(batch).astype(np.float32)).to(dev)

    def forward():
        with torch.no_grad():
            dec(i_t, q_t, budget=BUDGET)

    forward()
    torch.cuda.synchronize()
    for k in build.KERNELS.values():
        k.launches = 0
    forward()
    torch.cuda.synchronize()
    per_forward = {name: k.launches for name, k in build.KERNELS.items()}
    ev, wall = profiled(torch, forward, calls)
    busy = merged_busy([(s, e) for _, s, e in ev]) / 1e3 / calls
    by_name = {}       # by the name's first 120 characters
    for name, s, e in ev:
        by_name[name[:120]] = (by_name.get(name[:120], 0.0)
                               + (e - s) / 1e3 / calls)
    require(per_forward["sync"] == 1 and per_forward["bp"] == 1,
            f"launches per forward: {per_forward}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    wall_ms = wall * 1e3 / calls
    # torch.topk's kernels and the two redesigned kernels, per forward
    watch = {w: [e - s for name, s, e in ev if w in name]
             for w in ("gatherTopK", KERNEL_SYMBOLS["sync"],
                       KERNEL_SYMBOLS["bp"])}
    watched = {w: {"launches": len(d) / calls, "ms": sum(d) / 1e3 / calls}
               for w, d in watch.items()}
    out = {"launches_per_forward": per_forward, "wall_ms": wall_ms,
           "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
           "device_ms_by_name": dict(top),
           "watched_per_forward": watched}
    say("main", f"one forward at B={B}, budget={BUDGET}: launches "
        f"{per_forward}; profiled over {calls}: wall {wall_ms:.3f} ms, "
        f"device busy {busy:.3f} ms, idle share {out['idle_share']:.3f}; "
        "per forward: " + "; ".join(
            f"{w} {v['launches']:g} launches {v['ms']:.4f} ms"
            for w, v in watched.items())
        + "; device ms by name: " + "; ".join(f"{n[:90]} {v:.4f}"
                                             for n, v in top))
    return out


def knife_edge_batch(seed):
    """scripts/wf_fast_compare.py:28-73: 64 channels at -15..-20 dB."""
    from rtlsdr_ft8d_tpu_torch.host.synth import synthesize_message

    chans = []
    for b in range(B):
        snr = -15.0 - 5.0 * b / (B - 1)
        chans.append(synthesize_message(
            KNIFE_MSGS[(b + seed) % len(KNIFE_MSGS)],
            f0_hz=250 + (17.0 * b + 31.0 * seed) % 1100,
            noise_sigma=sigma_for_snr(snr),
            rng=np.random.default_rng(seed * 1000 + b)))
    return np.stack(chans)


def check_knife_edge(torch, dec):
    """Phase 4: decode lists from the kernel's waterfall against those
    from the plain version's, on 8 seeds x 64 knife-edge channels."""
    from rtlsdr_ft8d_tpu_torch.ops import waterfall
    from rtlsdr_ft8d_tpu_torch.pipeline import (normalize_peak,
                                                unpack_survivors)

    dev = dec.device
    counts, differ = [0, 0], []
    for seed in range(KNIFE_SEEDS):
        batch = knife_edge_batch(seed)
        i_n, q_n = normalize_peak(
            torch.from_numpy(np.real(batch).astype(np.float32)).to(dev),
            torch.from_numpy(np.imag(batch).astype(np.float32)).to(dev))
        lists = []
        with torch.no_grad():
            for wf in (waterfall.waterfall_cuda(i_n, q_n, dec.wf_twiddle,
                                                dec.wf_window),
                       waterfall.waterfall_plain(i_n, q_n, dec.wf_cos,
                                                 dec.wf_sin,
                                                 dec.wf_cos_minus_sin)):
                out = dec.decode_from_waterfall(wf, budget=BUDGET)
                res, _ = unpack_survivors(
                    {k: v.cpu().numpy() for k, v in out.items()}, B)
                lists.append([sorted(d.text for d in r) for r in res])
        for side in (0, 1):
            counts[side] += sum(len(x) for x in lists[side])
        differ += [(seed, c, a, b) for c, (a, b) in
                   enumerate(zip(*lists)) if a != b]
    n = KNIFE_SEEDS * B
    say("main", f"knife-edge A/B, {n} channels at -15..-20 dB, "
        f"budget={BUDGET}: {counts[0]} decodes from the kernel's waterfall, "
        f"{counts[1]} from the plain version's, {len(differ)} channels "
        f"differ")
    require(not differ, f"knife-edge decode lists differ: {differ[:4]}")
    return {"channels": n, "decodes_kernel": counts[0],
            "decodes_plain": counts[1], "channels_differ": len(differ)}


def throughput(torch, dec, batch):
    """Windows/s at 64 channels and budget=1024: the device graph alone
    (forward + synchronize) and decode_window end to end (host arrays in,
    Decode lists out); median of 5 runs each."""
    from rtlsdr_ft8d_tpu_torch.pipeline import decode_window

    dev = dec.device
    i_t = torch.from_numpy(np.real(batch).astype(np.float32)).to(dev)
    q_t = torch.from_numpy(np.imag(batch).astype(np.float32)).to(dev)

    def device_graph():
        with torch.no_grad():
            dec(i_t, q_t, budget=BUDGET)
        torch.cuda.synchronize()

    def end_to_end():
        decode_window(batch, budget=BUDGET, decoder=dec)

    out = {}
    for name, fn in (("device", device_graph), ("e2e", end_to_end)):
        fn()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        out[name] = B / statistics.median(times)
    return out


def busy_band_batch():
    """bench.py:205-260 with the port's synth: 64 channels of three strong
    signals each, a weak CQ W1AW FN31 at -19 .. -20.5 dB on every fourth
    channel, and five quiet channels in the OSD-only regime. Returns
    (batch, weak channels, OSD-regime channels)."""
    from rtlsdr_ft8d_tpu_torch.host.synth import synthesize_message

    busy = np.zeros((B, 48000), np.complex64)
    weak_chans, osd_chans = [], []
    for b in range(B):
        if b % 8 == 2 and len(osd_chans) < len(OSD_REGIME):
            sig, seed, f0 = OSD_REGIME[len(osd_chans)]
            busy[b] = synthesize_message(
                OSD_MSG, f0_hz=f0, noise_sigma=sig,
                rng=np.random.default_rng(seed))
            osd_chans.append(b)
            continue
        for s in range(3):
            busy[b] += synthesize_message(
                BENCH_MSGS[(b + s) % 4], f0_hz=120 + 430 * s + 11.3 * b % 400,
                noise_sigma=0.1 if s == 0 else 0.0,
                rng=np.random.default_rng(b * 3 + s))
        if b % 4 == 0:
            snr = WEAK_SNRS[(b // 4) % len(WEAK_SNRS)]
            amp = 0.1 * np.sqrt(2 * (2500.0 / 3200.0) * 10 ** (snr / 10.0))
            busy[b] += synthesize_message(
                WEAK_MSG, f0_hz=1450.0 + ((b // 4) % 8) * 12.5,
                amplitude=amp, noise_sigma=0.0,
                rng=np.random.default_rng(7000 + b))
            weak_chans.append(b)
    return busy, weak_chans, osd_chans


def ap_bank():
    """QsoTracker.bank()'s shape for a K1ABC <-> W9XYZ QSO: (1024, 174)."""
    from rtlsdr_ft8d_tpu_torch.ops.ap import codeword_signs, continuation_texts

    return codeword_signs(continuation_texts(AP_CALL, "W9XYZ", "EN37")
                          + continuation_texts("W9XYZ", AP_CALL), h_pad=1024)


def fixture_rows(name):
    with open(os.path.join(FIX, f"{name}.txt")) as f:
        return [line.rstrip("\n").split("\t") for line in f if line.strip()]


@contextlib.contextmanager
def deep_capture(dec):
    """Records the operands of the deep decode's stages while a forward
    runs: the stacked rungs of the posterior BP launch, the refinement's
    and the OSD SNR's arguments, the bank's on the refined LLRs."""
    from rtlsdr_ft8d_tpu_torch import pipeline

    got = {}
    real = {n: getattr(pipeline, n) for n in
            ("refine_llrs_flat", "estimate_snr_flat", "bank_correlate")}

    def spy(name):
        def fn(*args):
            if name != "bank_correlate" or args[0].dim() == 2:
                got[name] = args
            return real[name](*args)
        return fn

    def bp(llr, max_iters=20, return_posterior=False):
        if return_posterior:
            got["rungs"] = llr.detach().clone()
        return type(dec).bp(dec, llr, max_iters, return_posterior)

    for n in real:
        setattr(pipeline, n, spy(n))
    dec.bp = bp
    try:
        yield got
    finally:
        for n, fn in real.items():
            setattr(pipeline, n, fn)
        del dec.bp


def run_deep_path(torch, build, dec):
    """Phase 6: the deep decode (--osd) and the a-priori stack (--ap)
    through decode_window, with the launch counts of exactly that run:
    (a) golden_10sig, osd_cands=8, 2 passes: exactly its list, each
    frequency within 7 Hz of f0 - 21.875; (b) golden_busy, 3 passes,
    osd_cands=8 and the VA2AAA <-> PY2CCC bank: all 18 texts and no
    other; (c) the bench's busy band (bench.py:205-260) unbudgeted with
    osd_cands=8 (n_osd = 512), then again with the CQ and K1ABC clamp
    rows and the K1ABC <-> W9XYZ bank (9 rungs): the bench's floors at
    one launch (bench.py:343-354: OSD recoveries >= 2 on the first run,
    OSD-only >= 3/5, weak >= 4/16 on both), and every text one of the
    scene's transmitted messages. Returns (record, the stacked rungs of
    the second run's posterior BP launch, the busy batch)."""
    from rtlsdr_ft8d_tpu_torch.host.io import read_iq
    from rtlsdr_ft8d_tpu_torch.ops.ap import codeword_signs, continuation_texts
    from rtlsdr_ft8d_tpu_torch.pipeline import decode_window

    for k in build.KERNELS.values():
        k.launches = 0
    rec = {}
    iq = read_iq(os.path.join(FIX, "golden_10sig.iq"))
    got = decode_window(iq, osd_cands=OSD_CANDS, passes=2, decoder=dec)
    rows = fixture_rows("golden_10sig")
    texts = {d.text for d in got}
    want = {r[0] for r in rows}
    require(texts == want, f"golden_10sig deep: missing {want - texts}, "
            f"extra {texts - want}")
    by_text = {d.text: d for d in got}
    off = max(abs(by_text[t].freq_hz - (float(f0) - 21.875))
              for t, f0, *_ in rows)
    require(off < 7.0, f"golden_10sig deep: a frequency {off:.3f} Hz off")
    rec["golden_10sig"] = {"texts": len(texts), "max_freq_off_hz": off}
    say("deep", f"golden_10sig, osd_cands={OSD_CANDS}, 2 passes: exactly "
        f"the {len(want)} texts of golden_10sig.txt, frequencies within "
        f"{off:.3f} Hz of f0 - 21.875")

    iq = read_iq(os.path.join(FIX, "golden_busy.iq"))
    bank = codeword_signs(continuation_texts("VA2AAA", "PY2CCC")
                          + continuation_texts("PY2CCC", "VA2AAA"), h_pad=256)
    texts = {d.text for d in decode_window(
        iq, passes=3, osd_cands=OSD_CANDS, ap_texts=bank, decoder=dec)}
    want = {r[0] for r in fixture_rows("golden_busy")}
    require(texts == want, f"golden_busy full stack: missing "
            f"{want - texts}, extra {texts - want}")
    rec["golden_busy"] = {"texts": len(texts)}
    say("deep", f"golden_busy, 3 passes, osd_cands={OSD_CANDS}, bank "
        f"h_pad=256: all {len(want)} texts, no other")

    busy, weak_chans, osd_chans = busy_band_batch()
    allowed = set(BENCH_MSGS) | {WEAK_MSG, OSD_MSG}
    rungs = None
    subtract_before = build.KERNELS["subtract"].launches
    for name, kw in (("osd", {}),
                     ("osd+ap", dict(ap_cq=True, ap_call=AP_CALL,
                                     ap_texts=ap_bank()))):
        with deep_capture(dec) as cap:
            res, stats = decode_window(busy, osd_cands=OSD_CANDS,
                                       return_stats=True, decoder=dec, **kw)
        recovered = stats.extra["osd_recovered"]
        weak = sum(WEAK_MSG in {d.text for d in res[b]} for b in weak_chans)
        osd_only = sum(OSD_MSG in {d.text for d in res[b]} for b in osd_chans)
        phantoms = {d.text for r in res for d in r} - allowed
        r = {"osd_recovered": recovered, "weak": f"{weak}/{len(weak_chans)}",
             "osd_only": f"{osd_only}/{len(osd_chans)}",
             "rungs": tuple(cap["rungs"].shape),
             "spots": sum(len(x) for x in res)}
        rec[f"busy_{name}"] = r
        say("deep", f"busy band {name}, {B} channels unbudgeted, n_osd "
            f"{cap['rungs'].shape[1]}, rungs {r['rungs'][0]}: OSD recovered "
            f"{recovered}, OSD-only {r['osd_only']}, weak {r['weak']}, "
            f"{r['spots']} spots, phantoms {sorted(phantoms)}")
        require(not phantoms, f"busy band {name}: phantoms {phantoms}")
        require(osd_only >= 3 and weak >= 4,
                f"busy band {name}: OSD-only {osd_only}/5 (floor 3), weak "
                f"{weak}/16 (floor 4)")
        if name == "osd":
            # with the K1ABC clamp row and the bank, the clamp and the bank
            # take the OSD-regime channels (K1ABC W9XYZ EN37) before OSD
            require(recovered >= 2, f"busy band: OSD recovered {recovered} "
                    f"(floor 2 at one launch)")
        rungs = cap["rungs"]
    torch.cuda.synchronize()
    require(build.KERNELS["subtract"].launches == subtract_before,
            "the busy band's one pass launched the subtraction")
    launches = {n: build.KERNELS[n].launches
                for n in DECODE_KERNELS + ("osd", "subtract")}
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched on the deep path: {launches}")
    rec["launches"] = launches
    say("deep", f"kernel launches on the deep path: {launches}")
    return rec, rungs, busy


def check_bp_rungs(torch, dec, rungs, required=True):
    """Phase 6 (d): ldpc.cu with the posterior against bp_decode_plain on
    the busy band's own stacked rungs (R x 512 x 174): hard bits and
    error counts equal on every row, the posterior within POST_ULP; the
    bound counts all 20 iterations of every row. The device ms is None
    where the profiler dropped it and not `required`."""
    from rtlsdr_ft8d_tpu_torch.ops import ldpc

    graph = (dec.ldpc_edge_var, dec.ldpc_edge_slot, dec.ldpc_slot_edge)

    def kernel():
        return ldpc.bp_decode_cuda(rungs, *graph, 20, True)

    h_k, e_k, p_k = kernel()
    h_p, e_p, p_p = ldpc.bp_decode_plain(rungs, *graph, 20, True)
    shape = "x".join(str(n) for n in rungs.shape[:-1])
    require(torch.equal(e_k, e_p), f"bp rungs {shape}: error counts differ")
    require(torch.equal(h_k, h_p), f"bp rungs {shape}: hard bits differ")
    ulp = max_ulp(torch, p_k, p_p)
    err = (p_k - p_p).abs().max().item()
    require(ulp <= POST_ULP, f"bp rungs {shape}: posteriors differ by {ulp} "
            f"ulp (max abs {err})")
    n = e_k.numel()
    b_ms, b_by = bp_bound(rungs, (h_k, e_k, p_k), 20 * n)
    r = {"ms": median_ms(torch, kernel),
         "plain_ms": median_ms(torch, lambda: ldpc.bp_decode_plain(
             rungs, *graph, 20, True), reps=3, calls=3),
         "device_ms": device_ms(torch, kernel, KERNEL_SYMBOLS["bp"],
                                required=required),
         "bound_ms": b_ms, "bound_by": b_by, "codewords": n,
         "successes": int((e_k == 0).sum()), "post_max_ulp": ulp,
         "max_abs_err": err}
    say("deep", f"bp rungs {shape} ({n} codewords) with posteriors: errors "
        f"and hard bits identical on every row, posterior max {ulp} ulp "
        f"({err:.3g}), {r['successes']} successes; {r['ms']:.4f} ms (device "
        f"{fmt_ms(r['device_ms'])}) vs plain {r['plain_ms']:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}, 20 iterations x {n} rows)")
    return r


def deep_profile(torch, build, dec, busy, calls=3):
    """Phase 6 (f): one deep forward of the busy band with the full AP
    stack (9 rungs): launches of each kernel, a torch.profiler breakdown
    of `calls` forwards (wall, device busy, idle share, device ms by
    name), device ms by part from the forward's own operands (the
    refinement, the stacked-rung bp_kernel, the bank on the refined
    LLRs, the llr.cu SNR launch), the llr.cu launch at that shape against
    its plain version, osd.cu on the forward's posteriors against native
    ft8_osd_batch (check_osd_kernel), and the OSD + merge ms with the
    posteriors on the card (the lists equal to the host OSD's)."""
    from rtlsdr_ft8d_tpu_torch.ops import ap, ldpc, llr
    from rtlsdr_ft8d_tpu_torch.pipeline import (OSD_POSTERIORS,
                                                _merge_osd_decodes,
                                                ap_tensors, refine_llrs_flat,
                                                unpack_survivors)
    from rtlsdr_ft8d_tpu_torch.protocol.text import CallsignHashTable

    dev = dec.device
    i_t = torch.from_numpy(np.real(busy).astype(np.float32)).to(dev)
    q_t = torch.from_numpy(np.imag(busy).astype(np.float32)).to(dev)
    clamp, cw = ap_tensors(True, AP_CALL, ap_bank(), dev)

    def forward():
        with torch.no_grad():
            return dec(i_t, q_t, osd_cands=OSD_CANDS, ap_clamp_signs=clamp,
                       ap_cw_signs=cw)

    forward()
    torch.cuda.synchronize()
    for k in build.KERNELS.values():
        k.launches = 0
    with deep_capture(dec) as cap:
        out = forward()
    torch.cuda.synchronize()
    per_forward = {n: k.launches for n, k in build.KERNELS.items()}
    # bp: the main pass with the clamp rows, then every rung; llr: the
    # LLRs, the survivors' SNR, the OSD selection's SNR
    require((per_forward["waterfall"], per_forward["sync"], per_forward["llr"],
             per_forward["bp"]) == (1, 1, 3, 2),
            f"deep forward launches {per_forward}, want waterfall 1, sync 1, "
            f"llr 3, bp 2")
    graph = (dec.ldpc_edge_var, dec.ldpc_edge_slot, dec.ldpc_slot_edge)
    rungs = cap["rungs"]
    wf, cand_sel, chan_f = cap["estimate_snr_flat"]
    b_llr, b_cw, b_score = cap["bank_correlate"]
    refine_args = cap["refine_llrs_flat"]
    part_fns = {
        "refine": (lambda: refine_llrs_flat(*refine_args), None),
        "bp_rungs": (lambda: ldpc.bp_decode_cuda(rungs, *graph, 20, True),
                     KERNEL_SYMBOLS["bp"]),
        "bank": (lambda: ap.bank_correlate(b_llr, b_cw, b_score), None),
        "llr_snr": (lambda: llr.tone_llrs_cuda(wf, cand_sel, chan_f),
                    KERNEL_SYMBOLS["llr"])}
    # each part alone on the forward's own operands: its stream ms (CUDA
    # events, 20 calls x 5) and its device ms (torch.profiler, all its
    # kernels or the one named; None where the profiler dropped records)
    parts, stream = {}, {}
    for name, (fn, symbol) in part_fns.items():
        stream[name] = median_ms(torch, fn)
        parts[name] = (device_ms(torch, fn, symbol, required=False) if symbol
                       else all_device_ms(torch, fn, required=False))
    # the refinement on the card against the CPU on the OSD selection:
    # max abs difference of each LLR flavor, relative of the Costas power
    cpu_args = [x.cpu() if torch.is_tensor(x) else
                {k: v.cpu() for k, v in x.items()} for x in refine_args]
    refine_err = {}
    for name, a, b in zip(("noncoherent", "costas_power_rel",
                           "pair_coherent", "block_coherent"),
                          refine_llrs_flat(*refine_args),
                          refine_llrs_flat(*cpu_args)):
        d = (a.cpu() - b).abs()
        refine_err[name] = (d / b.abs() if name.endswith("rel")
                            else d).max().item()
    fwd_stream_ms = median_ms(torch, forward, reps=3, calls=5)

    # last, as the profiler has lost records after a large pass: the
    # deep forward's device busy, held to every port launch recorded
    def enough(ev):
        return ([sum(KERNEL_SYMBOLS[k] in e[0] for e in ev)
                 for k in ("bp", "llr")] == [2 * calls, 3 * calls])

    prof = profiled(torch, forward, calls, enough, required=False)
    if prof is None:
        wall_ms = busy_ms = None
        top = []
    else:
        ev, wall = prof
        busy_ms = merged_busy([(s, e) for _, s, e in ev]) / 1e3 / calls
        by_name = {}
        for name, s, e in ev:
            by_name[name[:120]] = (by_name.get(name[:120], 0.0)
                                   + (e - s) / 1e3 / calls)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        wall_ms = wall * 1e3 / calls
    n_osd = chan_f.shape[0]

    # llr.cu at the OSD SNR's shape against its plain version
    s2_k, v_k, l_k = llr.tone_llrs_cuda(wf, cand_sel, chan_f)
    s2_p, v_p, l_p = llr.tone_llrs_plain(wf, cand_sel, chan_f)
    require(torch.equal(s2_k, s2_p) and torch.equal(v_k, v_p)
            and torch.allclose(l_k, l_p, rtol=1e-5, atol=1e-5),
            f"llr N={n_osd} (OSD SNR): kernel and plain differ")
    b_ms, b_by = llr_bound(cand_sel, chan_f, s2_k, v_k, l_k)
    llr_rec = {"ms": median_ms(torch, lambda: llr.tone_llrs_cuda(
                   wf, cand_sel, chan_f)),
               "plain_ms": median_ms(torch, lambda: llr.tone_llrs_plain(
                   wf, cand_sel, chan_f)),
               "device_ms": parts["llr_snr"], "bound_ms": b_ms,
               "bound_by": b_by,
               "max_abs_err": (l_k - l_p).abs().max().item()}

    osd_rec = check_osd_kernel(torch, out)

    # unpack, then OSD + merge on this forward's output with the
    # posteriors left on the card (as _decode_pass leaves them), timed;
    # once with everything downloaded (the host's OSD), untimed: the
    # same lists
    out_np = {k: v.cpu().numpy() for k, v in out.items()}
    out_card = {k: v if k in OSD_POSTERIORS else out_np[k]
                for k, v in out.items()}
    merge, lists = [], []
    for o in [out_card] * 5 + [out_np]:
        hashes = CallsignHashTable()
        res, sub = unpack_survivors(o, B, hashes)
        t0 = time.perf_counter()
        n_rec = _merge_osd_decodes(o, res, sub, hashes)
        merge.append((time.perf_counter() - t0) * 1e3)
        lists.append((n_rec, res, sub))
    require(all(str(x) == str(lists[0]) for x in lists),
            "the OSD merge differs between the card's posteriors and the "
            "host's")
    rec = {"launches_per_forward": per_forward, "wall_ms": wall_ms,
           "device_busy_ms": busy_ms,
           "idle_share": None if prof is None else 1.0 - busy_ms / wall_ms,
           "stream_ms": fwd_stream_ms, "device_ms_by_name": dict(top),
           "device_ms_by_part": parts, "stream_ms_by_part": stream,
           "refine_card_vs_cpu_max_err": refine_err,
           "rung_codewords": int(rungs.shape[0] * rungs.shape[1]),
           "n_osd": n_osd, "osd_rows": int(out_np["osd_valid"].sum()),
           "osd_merge_ms": statistics.median(merge[:5]),
           "osd_recovered": n_rec, "llr_osd_snr": llr_rec,
           "osd_kernel": osd_rec}
    say("deep", f"one deep forward at B={B}, osd_cands={OSD_CANDS}, CQ + "
        f"{AP_CALL} rows, bank 1024: launches {per_forward}; stream "
        f"{fwd_stream_ms:.3f} ms (CUDA events); profiled over {calls}: wall "
        f"{fmt_ms(wall_ms)} ms, device busy {fmt_ms(busy_ms)} ms, idle share "
        f"{fmt_ms(rec['idle_share'])}")
    say("deep", "parts alone, device ms (stream ms): " + "; ".join(
        f"{n} {fmt_ms(parts[n])} ({stream[n]:.4f})" for n in parts)
        + f"; bp rungs {rec['rung_codewords']} codewords, llr SNR N={n_osd}; "
        f"refinement on the card vs the CPU: " + ", ".join(
            f"{n} {v:.3g}" for n, v in refine_err.items()) + "; "
        f"OSD + merge {rec['osd_merge_ms']:.3f} ms with the posteriors on "
        f"the card ({rec['osd_rows']} rows), the lists equal to the host "
        f"OSD's")
    say("deep", "deep forward device ms by name: " + "; ".join(
        f"{n[:90]} {v:.4f}" for n, v in top))
    say("deep", f"llr N={n_osd} (OSD SNR): s2 and valid bit-exact, LLR max "
        f"err {llr_rec['max_abs_err']:.3g}, {llr_rec['ms']:.4f} ms (device "
        f"{fmt_ms(llr_rec['device_ms'])}) vs plain {llr_rec['plain_ms']:.3f} ms, "
        f"bound {b_ms:.5f} ms ({b_by})")
    return rec


def osd_synthetic_rows(seed, n=OSD_SYNTHETIC_ROWS):
    """(flavor A, flavor B) posteriors of n rows in five kinds, cycled,
    as tests/test_torch_osd.py's _flavor_rows: codewords with LLRs
    quantized to steps of 0.5 (ties in |llr| and exact zeros), pure
    noise, noisy codewords either side of the max_norm gate, rows whose
    flavor A is noise and whose flavor B carries the codeword (A
    rejects, B accepts), and two noisy views of one codeword."""
    from rtlsdr_ft8d_tpu_torch.protocol.crc import add_crc
    from rtlsdr_ft8d_tpu_torch.protocol.encode import ldpc_encode

    rng = np.random.default_rng(seed)
    s = np.stack([2.0 * ldpc_encode(add_crc(rng.integers(0, 2, 77).astype(
        np.uint8))) - 1.0 for _ in range(n)])
    noise = lambda sigma: rng.normal(0, 1.0, s.shape) * sigma  # noqa: E731
    kind = (np.arange(n) % 5)[:, None]
    sigma = rng.uniform(1.9, 2.7, (n, 1))
    quant = np.round((2.0 * s + noise(2.2)) * 2.0) / 2.0
    a = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                  [quant, noise(2.0), 2.0 * s + noise(sigma), noise(2.0)],
                  2.0 * s + noise(1.8))
    b = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                  [np.round(quant + noise(1.0)), noise(2.0),
                   2.0 * s + noise(sigma), 2.0 * s + noise(1.5)],
                  2.0 * s + noise(2.0))
    return a.astype(np.float32), b.astype(np.float32)


def check_osd_kernel(torch, out):
    """Phase 6 (g): osd.cu against native ft8_osd_batch's two calls
    (flavor B on the rows A rejects) on one deep forward's own posteriors
    (n_osd 512, both flavors, every row and the valid rows alone) and on
    OSD_SYNTHETIC_ROWS synthetic rows (osd_synthetic_rows), where both
    flavors must accept somewhere: messages and accept bit-equal; the
    wrapper's ms (CUDA events), the kernel's device ms, the native calls'
    host ms and the bound. The kernel is bound by the latency of each
    row's chain, not by bytes or operations."""
    from rtlsdr_ft8d_tpu_torch import native
    from rtlsdr_ft8d_tpu_torch.ops import osd

    require(native.load() is not None, "the native library did not load")
    post_a, post_b = out["osd_post"], out["osd_post_coh"]
    valid = np.flatnonzero(out["osd_valid"].cpu().numpy())
    syn_a, syn_b = osd_synthetic_rows(2026)
    sets = {"all": (post_a, post_b, np.arange(post_a.shape[0])),
            "valid": (post_a, post_b, valid),
            "synthetic": (torch.from_numpy(syn_a).to(post_a.device),
                          torch.from_numpy(syn_b).to(post_a.device),
                          np.arange(syn_a.shape[0]))}
    rec = {}
    for name, (set_a, set_b, rows) in sets.items():
        a_np, b_np = set_a.cpu().numpy(), set_b.cpu().numpy()
        idx = torch.from_numpy(rows).to(set_a.device)
        pa, pb = set_a[idx].contiguous(), set_b[idx].contiguous()
        before = osd.KERNEL.launches
        msgs, accept = osd.osd_rows(pa, pb)
        torch.cuda.synchronize()
        require(osd.KERNEL.launches == before + (rows.size > 0),
                "osd_rows on the card did not launch the kernel once")
        want_m, want_a = (t.numpy() for t in osd.osd_rows_plain(
            a_np[rows], b_np[rows]))
        got_a = accept.cpu().numpy()
        require(np.array_equal(got_a, want_a)
                and np.array_equal(msgs.cpu().numpy(), want_m),
                f"osd.cu differs from native ft8_osd_batch on "
                f"{int(np.count_nonzero(got_a != want_a))} of {rows.size} "
                f"accepts ({name} rows)")
        n_runs = rows.size + int(np.count_nonzero(want_a != 1))
        n_acc = np.bincount(want_a, minlength=3).tolist()
        require(name != "synthetic" or (n_acc[1] > 0 and n_acc[2] > 0),
                f"synthetic rows: accepts none/A/B {n_acc}, want some "
                f"on both flavors")
        host = []
        for _ in range(3):
            t0 = time.perf_counter()
            osd.osd_rows_plain(a_np[rows], b_np[rows])
            host.append((time.perf_counter() - t0) * 1e3)
        b_ms, b_by = osd_bound(rows.size, n_runs)
        r = {"rows": int(rows.size), "runs": n_runs,
             "accept": n_acc,
             "ms": median_ms(torch, lambda: osd.osd_rows(pa, pb)),
             "device_ms": device_ms(torch, lambda: osd.osd_rows(pa, pb),
                                    KERNEL_SYMBOLS["osd"], required=False),
             "native_host_ms": statistics.median(host),
             "bound_ms": b_ms, "bound_by": b_by}
        rec[name] = r
        say("deep", f"osd.cu, {name} rows "
            f"({r['rows']} rows, {r['runs']} row-flavors run, accepts none/"
            f"A/B {r['accept']}): messages and accept bit-equal to native "
            f"ft8_osd_batch; {r['ms']:.4f} ms (device "
            f"{fmt_ms(r['device_ms'])}) vs native {r['native_host_ms']:.2f} "
            f"ms on the host; bound {b_ms:.5f} ms ({b_by}); the kernel is "
            f"bound by each row's chain of dependent steps")
    return rec


def weak_window(seed=SUBTRACT_SEED):
    """Window 0 of the deep cell's `weak` traffic at 64 channels
    (benchmark/traffic/weak.json through benchmark/generators/qso_ft8.py,
    rendered on the card): host float32 (i, q)."""
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        import registry

        p = registry.traffic("weak")
        return registry.generator(p["generator"]).generate(
            p, seed, "cuda", channels=B)["windows"][0]
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmark"))


def check_subtract(torch, dec):
    """Phase 6 (h): csrc/subtract.cu at the deep cell's shape. One weak
    window (64 channels) decoded as the deep cell does (3 passes, --osd
    8, CQ and K1ABC clamp rows) launches the kernel twice a subtraction;
    on the first subtraction's operands (the first pass's pairs): the
    host ms of the pair list (the LDPC encodes), the CUDA-event ms of
    the refine and residual launches, of both (subtract_pairs) and of the
    refine launch with every tone-0 at 100 Hz (no sincosf argument past
    1e5 rad: the cost of its slow path), their device ms, the plain
    version's ms on the card and the bound; against refine_pairs on the
    card, the arithmetic of the benchmark's reference (and on the CPU),
    the share of pairs whose start or shift differs (at most 1%), and
    where they agree f + f_err within one float, f_err within 1e-4
    relative (1e-5 Hz near 0), the gains within 1e-4 relative where f +
    f_err is the same float and 5e-3 where it is one apart; the phases
    bit-equal to PyTorch's cumsum at the kernel's f_err; the residual
    launch at the plain refinement within 1e-5 of the window's RMS of
    reconstruct's residual, and the whole kernel path within 1e-5 of it
    on the channels whose pairs all agree to the float."""
    from rtlsdr_ft8d_tpu_torch import pipeline
    from rtlsdr_ft8d_tpu_torch.ops import subtract
    from rtlsdr_ft8d_tpu_torch.protocol.text import CallsignHashTable

    i_w, q_w = weak_window()
    seen = []
    real = pipeline._subtract_decoded

    def spy(i_t, q_t, sub_params, timer=pipeline.NO_TIMER):
        seen.append((i_t, q_t, [list(p) for p in sub_params]))
        return real(i_t, q_t, sub_params, timer)

    before = subtract.KERNEL.launches
    pipeline._subtract_decoded = spy
    try:
        pipeline.decode_window(
            (i_w, q_w), hashes=[CallsignHashTable() for _ in range(B)],
            passes=3, osd_cands=OSD_CANDS, ap_cq=True, ap_call=AP_CALL,
            decoder=dec)
    finally:
        pipeline._subtract_decoded = real
    torch.cuda.synchronize()
    launches = subtract.KERNEL.launches - before
    require(seen and launches == 2 * len(seen),
            f"weak window: {len(seen)} subtractions, {launches} launches")
    i_t, q_t, sub = seen[0]
    encode = []
    for _ in range(3):
        t0 = time.perf_counter()
        pairs_np = pipeline.subtraction_pairs(sub)
        encode.append((time.perf_counter() - t0) * 1e3)
    encode_ms = statistics.median(encode)
    n = len(pairs_np[0])
    cpu = [torch.from_numpy(a) for a in pairs_np]
    card = [t.to(i_t.device) for t in cpu]
    low = card[:2] + [torch.full_like(card[2], round((100 - 21.875) / 3.125)),
                      card[3]]
    fit = subtract.refine_pairs_cuda(i_t, q_t, *card)
    fns = {"refine": lambda: subtract.refine_pairs_cuda(i_t, q_t, *card),
           "residual": lambda: subtract.reconstruct_cuda(i_t, q_t, *card[:3],
                                                         fit),
           "subtract_pairs": lambda: subtract.subtract_pairs(i_t, q_t, *card),
           "refine_low_tones": lambda: subtract.refine_pairs_cuda(
               i_t, q_t, *low)}
    ms = {k: median_ms(torch, fn) for k, fn in fns.items()}
    symbols = dict(zip(("refine", "residual"), KERNEL_SYMBOLS["subtract"]))
    dev_ms = {k: device_ms(torch, fns[k], sym, required=False)
              for k, sym in symbols.items()}
    dev_ms["refine_low_tones"] = device_ms(
        torch, fns["refine_low_tones"], symbols["refine"], required=False)

    def plain():
        f = subtract.refine_pairs(i_t, q_t, *card)
        return subtract.reconstruct(i_t, q_t, *card[:3], f)

    ms["plain"] = median_ms(torch, plain, reps=3, calls=1, warmup=1)
    t0 = time.perf_counter()
    for _ in range(3):
        real(i_t, q_t, sub)
    torch.cuda.synchronize()
    span_ms = (time.perf_counter() - t0) / 3 * 1e3

    # the plain version on the card is what the benchmark's reference runs
    want = subtract.refine_pairs(i_t, q_t, *card)
    got = fit.choice.long()
    differ = (got != want.choice).any(-1).cpu()
    on_cpu = subtract.refine_pairs(i_t.cpu(), q_t.cpu(), *cpu)
    differ_cpu = (got.cpu() != on_cpu.choice).any(-1)
    agree = ~differ
    f_hz = subtract._freqs(card[1], card[2])
    f2, f2_want = (f_hz + p.fit[:, 0, None] for p in (fit, want))
    ulps = (f2.view(torch.int32) - f2_want.view(torch.int32)).abs() \
        .amax(-1).cpu()
    alike = agree & (ulps == 0)
    d_f = (fit.fit[:, 0] - want.fit[:, 0]).abs().cpu()
    f_err_excess = d_f - 1e-4 * want.fit[:, 0].abs().cpu()
    g, g_want = fit.fit[:, 1:].cpu(), want.fit[:, 1:].cpu()
    rel = (g - g_want).norm(dim=-1) / g_want.norm(dim=-1)

    def worst(t, mask):
        return t[mask].max().item() if mask.any() else 0.0

    gain_rel, gain_rel_ulp = worst(rel, alike), worst(rel, agree)
    f_err_hz = worst(d_f, agree)
    # the phases against PyTorch's cumsum on the card at the kernel's
    # f_err, over more than 64 rows, where the kernel follows its order
    k = -(-65 // max(n, 1))
    phase_equal = torch.equal(fit.phase0,
                              subtract._phase0(torch.cat([f2] * k))[:n])
    ref = subtract.reconstruct(i_t, q_t, *card[:3], want)
    stage = subtract.reconstruct_cuda(i_t, q_t, *card[:3], want)
    full = subtract.subtract_pairs(i_t, q_t, *card)
    rms = torch.sqrt(torch.mean(i_t ** 2 + q_t ** 2) / 2).item()
    stage_err = max((a - b).abs().max().item()
                    for a, b in zip(stage, ref)) / rms
    full_err = max((a - b).abs().max().item()
                   for a, b in zip(full, ref)) / rms
    # the whole path on the channels whose pairs all agree with the plain
    # refinement, f + f_err to the float
    keep = torch.ones(i_t.shape[0], dtype=torch.bool)
    keep[cpu[0][~alike].long()] = False
    keep = keep.to(i_t.device)
    full_err_alike = max((a - b)[keep].abs().max().item()
                         for a, b in zip(full, ref)) / rms \
        if keep.any() else 0.0
    bound_ms, by = subtract_bound(n, i_t.shape[0])
    counts = np.bincount(pairs_np[0], minlength=i_t.shape[0])
    rec = {"pairs": n, "pairs_max_per_channel": int(counts.max()),
           "pairs_later": [sum(min(len(p), pipeline.MAX_SUBTRACT)
                               for p in s) for _, _, s in seen[1:]],
           "launches_per_window": launches, "encode_host_ms": encode_ms,
           "subtract_decoded_ms": span_ms, "ms": ms, "device_ms": dev_ms,
           "bound_ms": bound_ms, "bound_by": by,
           "differ_share": differ.double().mean().item(),
           "differ_share_cpu_plain": differ_cpu.double().mean().item(),
           "f_plus_f_err_one_float_apart": int((agree & (ulps == 1)).sum()),
           "gain_max_rel_err": gain_rel,
           "gain_max_rel_err_one_float_apart": gain_rel_ulp,
           "f_err_max_abs_hz": f_err_hz, "phase0_bit_equal": phase_equal,
           "residual_stage_err_rms": stage_err,
           "full_path_err_rms": full_err,
           "full_path_err_rms_alike_channels": full_err_alike}
    say("deep", f"subtract.cu, weak window seed {SUBTRACT_SEED}: {n} pairs "
        f"(at most {rec['pairs_max_per_channel']} a channel; later "
        f"subtractions {rec['pairs_later']}), {launches} launches a window; "
        f"refine {ms['refine']:.4f} ms (device "
        f"{fmt_ms(dev_ms['refine'])}), residual {ms['residual']:.4f} "
        f"({fmt_ms(dev_ms['residual'])}), both {ms['subtract_pairs']:.4f}; "
        f"refine with tones at 100 Hz {ms['refine_low_tones']:.4f} "
        f"({fmt_ms(dev_ms['refine_low_tones'])}); plain on the card "
        f"{ms['plain']:.2f} ms; bound {bound_ms:.4f} ms ({by}); pair list "
        f"(encodes) {encode_ms:.2f} ms host, _subtract_decoded "
        f"{span_ms:.2f} ms; start or shift differs from the plain "
        f"version's on {differ.sum().item()} of {n} pairs (on the CPU "
        f"{differ_cpu.sum().item()}); where they agree f + f_err one float "
        f"apart on {rec['f_plus_f_err_one_float_apart']}, gains within "
        f"{gain_rel:.2e} relative ({gain_rel_ulp:.2e} with those), f_err "
        f"within {f_err_hz:.2e} Hz; phases bit-equal to PyTorch's cumsum: "
        f"{phase_equal}; residual launch at the plain refinement "
        f"{stage_err:.2e} of RMS from the plain residual, whole path "
        f"{full_err:.2e} ({full_err_alike:.2e} on the channels whose pairs "
        f"all agree)")
    require(differ.double().mean().item() <= 0.01,
            f"subtract.cu: start or shift differs on {differ.sum().item()} "
            f"of {n} pairs")
    require(worst(ulps.double(), agree) <= 1,
            f"subtract.cu: f + f_err {worst(ulps.double(), agree)} floats "
            f"from the plain version's")
    require(worst(f_err_excess, agree) <= 1e-5,
            f"subtract.cu: f_err {f_err_hz:.2e} Hz from the plain version's")
    require(gain_rel <= 1e-4 and gain_rel_ulp <= 5e-3,
            f"subtract.cu: gains {gain_rel:.2e} relative ({gain_rel_ulp:.2e} "
            f"where f + f_err is one float apart)")
    require(phase_equal, "subtract.cu: phases differ from PyTorch's cumsum")
    require(stage_err <= 1e-5, f"subtract.cu residual {stage_err:.2e} of "
            f"the window's RMS from reconstruct's")
    require(full_err_alike <= 1e-5, f"subtract.cu whole path "
            f"{full_err_alike:.2e} of the window's RMS from the plain path's")
    return rec


def run_deep_daemon(torch, build):
    """Phase 6 (e): the daemon with --ap --osd 8 --multipass 3 on two
    bands x two synthetic windows through the int8 ingest: CQ K1JT FN20
    in every band's spots of both windows, one QsoTracker fed once a
    window with every band's decodes, every kernel launched in that run
    (the subtraction's too)."""
    from rtlsdr_ft8d_tpu_torch.host import daemon
    from rtlsdr_ft8d_tpu_torch.host.cli import BAND_PLAN

    trackers = []
    real = daemon.QsoTracker.observe

    def observe(self, decodes):
        trackers.append((id(self), [d.text for d in decodes]))
        return real(self, decodes)

    bands = [a for band in DEEP_DAEMON_BANDS for a in ("-f", band)]
    for k in build.KERNELS.values():
        k.launches = 0
    daemon.QsoTracker.observe = observe
    try:
        rc, out, err = run_cli(bands + [
            "-c", AP_CALL, "-l", "FN42", "--synthetic", "-n",
            str(DAEMON_WINDOWS), "--pallas-ingest", "--ap", "--osd",
            str(OSD_CANDS), "--multipass", "3", "-x"])
    finally:
        daemon.QsoTracker.observe = real
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    require(rc == 0, f"daemon --ap --osd exited {rc}: {err[-2000:]}")
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched on the --ap --osd daemon: {launches}")
    tables = parse_spot_tables(out)
    n_tables = len(DEEP_DAEMON_BANDS) * DAEMON_WINDOWS
    require(len(tables) == n_tables, f"daemon --ap --osd printed "
            f"{len(tables)} spot tables")
    for t, rows in enumerate(tables):
        band = DEEP_DAEMON_BANDS[t % len(DEEP_DAEMON_BANDS)]
        dial = BAND_PLAN[band][0]
        require(any(text == SPOT and 0 <= f - dial < 3000
                    for f, _, text in rows),
                f"--ap --osd window {t // len(DEEP_DAEMON_BANDS)}, {band}: "
                f"no {SPOT} in {rows}")
    ids = {i for i, _ in trackers}
    require(len(trackers) == DAEMON_WINDOWS and len(ids) == 1
            and all(texts.count(SPOT) == len(DEEP_DAEMON_BANDS)
                    for _, texts in trackers),
            f"--ap: {len(ids)} trackers observed {len(trackers)} times in "
            f"{DAEMON_WINDOWS} windows, {SPOT} counts "
            f"{[texts.count(SPOT) for _, texts in trackers]}")
    say("deep", f"daemon {' '.join(bands)} --ap --osd {OSD_CANDS} "
        f"--multipass 3 --pallas-ingest, {DAEMON_WINDOWS} windows: {SPOT} in all "
        f"{n_tables} spot tables, one QsoTracker fed once a window with "
        f"every band's decodes; launches {launches}")
    return launches


def channelize_bound(frames):
    """(ms, 'bytes' or 'operations', GFLOP) of channelize_int8 on one
    full-band call: int8 I/Q in, the (1500, frames) float32 bank out; the
    64-tap polyphase sums (2 operations per tap, 2 components) and the
    eight (frames x 750) . (750 x 750) float32 DFT products."""
    from rtlsdr_ft8d_tpu_torch.ops import channelize as ch

    n = ch.WB_HISTORY + ch.R * frames
    ops = (2 * 2 * ch.WB_PHASES * frames * ch.R
           + 8 * 2 * frames * ch.R * ch.R)
    nbytes = 2 * n + 2 * ch.NUM_CHANNELS * frames * 4
    return (*bound(nbytes, ops), ops / 1e9)


def is_gemm(name):
    low = name.lower()
    return "gemm" in low or "cutlass" in low or "xmma" in low


def check_channelizer(torch, dev):
    """Phase 7 (a): the channelizer on the card against the port's own CPU
    run on 64- and 480-frame random inputs, float and int8 (rtol 1e-4,
    atol 1e-4); the int8 stream on the card across chunks of 23, 17 and
    24 frames against the one-shot call on the card; then one full-band
    channelize_int8 (36,000,000 samples per component after the history):
    CUDA-event median, device ms by part (torch.profiler: the polyphase
    sums alone, and the GEMMs of the whole call), its share of the bound,
    and the peak of allocated device memory during the call."""
    from rtlsdr_ft8d_tpu_torch.ops import channelize as ch

    rng = np.random.default_rng(31)
    errs = {}
    for frames in (64, 480):
        n = ch.WB_HISTORY + ch.R * frames
        x8 = rng.integers(-128, 128, (2, n), dtype=np.int8)
        xf = rng.standard_normal((2, n)).astype(np.float32)
        for kind, fn, x in (("int8", ch.channelize_int8, x8),
                            ("float", ch.channelize, xf)):
            cpu = fn(*torch.from_numpy(x))
            card = fn(*torch.from_numpy(x).to(dev))
            err = max((a.cpu() - b).abs().max().item()
                      for a, b in zip(card, cpu))
            errs[f"{kind} {frames} frames"] = err
            require(all(a.shape == (ch.NUM_CHANNELS, frames) and
                        torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4)
                        for a, b in zip(card, cpu)),
                    f"channelize {kind}, {frames} frames: card and CPU differ "
                    f"(max err {err})")
    chunks = (23, 17, 24)
    m = sum(chunks)
    x8 = rng.integers(-128, 128, (2, m * ch.R), dtype=np.int8)
    full = np.concatenate([np.zeros((2, ch.WB_HISTORY), np.int8), x8], 1)
    one_shot = ch.channelize_int8(*torch.from_numpy(full).to(dev))
    stream = ch.StreamingChannelizerInt8(dev)
    outs, pos = [], 0
    for frames in chunks:
        outs.append(stream.process(x8[0, pos:pos + frames * ch.R],
                                   x8[1, pos:pos + frames * ch.R]))
        pos += frames * ch.R
    got = [torch.cat([o[c] for o in outs], 1) for c in (0, 1)]
    stream_err = max((a - b).abs().max().item()
                     for a, b in zip(got, one_shot))
    require(all(torch.allclose(a, b, rtol=1e-4, atol=1e-5)
                for a, b in zip(got, one_shot)),
            f"channelize: the stream over chunks of {chunks} frames differs "
            f"from the one-shot call (max err {stream_err})")

    frames = 48_000
    n = ch.WB_HISTORY + ch.R * frames
    x8 = torch.from_numpy(rng.integers(-128, 128, (2, n), dtype=np.int8)
                          ).to(dev)

    def full_band():
        return ch.channelize_int8(x8[0], x8[1])

    full_band()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = full_band()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    require(all(o.shape == (ch.NUM_CHANNELS, frames)
                and torch.isfinite(o).all().item() for o in out),
            "channelize: full-band output not finite or of the wrong shape")
    del out
    ms = median_ms(torch, full_band, reps=5, calls=3)
    # device ms where the profiler kept the records (None where not)
    prof = profiled(torch, full_band, 3, lambda ev: len(ev) >= 3 * 100,
                    required=False)
    gemm_ms = all_ms = None
    if prof is not None:
        gemm_ms = sum(e - s for name, s, e in prof[0] if is_gemm(name)) / 3e3
        all_ms = sum(e - s for name, s, e in prof[0]
                     if not is_copy(name)) / 3e3
    bank_rows = ch._tables(dev)[0]
    xf = x8.to(torch.float32) / 128.0
    poly_ms = all_device_ms(torch, lambda: [
        ch._phase_partials(xf[c], bank_rows, frames) for c in (0, 1)],
        calls=3, required=False)
    del xf
    b_ms, b_by, gflop = channelize_bound(frames)
    rec = {"max_abs_err_card_vs_cpu": errs, "stream_max_abs_err": stream_err,
           "ms": ms, "device_ms": all_ms, "device_ms_gemm": gemm_ms,
           "device_ms_polyphase": poly_ms,
           "device_ms_other": (None if None in (all_ms, gemm_ms, poly_ms)
                               else all_ms - gemm_ms - poly_ms),
           "bound_ms": b_ms, "bound_by": b_by, "gflop": gflop,
           "bound_share": b_ms / (all_ms or ms),
           "dft_bound_ms": 8 * 2 * frames * ch.R * ch.R / F32_OPS_PER_S * 1e3,
           "peak_allocated_bytes": peak,
           "peak_above_inputs_bytes": peak - base,
           "shape": f"n={n} x 2 int8 -> (1500, {frames}) x 2"}
    say("wideband", "channelizer card vs CPU, max abs err: " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items()) + f"; stream over chunks "
        f"{chunks} vs one-shot {stream_err:.3g}; full band ({rec['shape']}):"
        f" {ms:.3f} ms (CUDA events), device {fmt_ms(all_ms)} ms = GEMMs "
        f"{fmt_ms(gemm_ms)} + polyphase {fmt_ms(poly_ms)} + other "
        f"{fmt_ms(rec['device_ms_other'])}; bound {b_ms:.3f} ms ({b_by}, "
        f"{gflop:.1f} GFLOP; DFT alone {rec['dft_bound_ms']:.3f}), "
        f"{rec['bound_share']:.3f} of it (of the device ms, else the CUDA-"
        f"event ms); peak allocated {peak / 2**20:.0f} "
        f"MiB ({(peak - base) / 2**20:.0f} MiB above the inputs)")
    return rec


def wideband_scene(n_channels=WB_CHANNELS):
    """bench.py:356-373: 1500 channels of 0.05-sigma noise (seed 1), every
    37th channel seeded with a bench message at amplitude 0.05. Returns
    (i, q) float32 (1500, 48000) and {channel: message}."""
    from rtlsdr_ft8d_tpu_torch.host.synth import synthesize_message

    rng = np.random.default_rng(1)
    wi = 0.05 * rng.standard_normal((n_channels, 48000)).astype(np.float32)
    wq = 0.05 * rng.standard_normal((n_channels, 48000)).astype(np.float32)
    seeded = {}
    for b in range(0, n_channels, 37):
        msg = BENCH_MSGS[b % 4]
        sig = synthesize_message(msg, f0_hz=300 + (b % 40) * 25,
                                 noise_sigma=0.0, amplitude=0.05,
                                 rng=np.random.default_rng(b))
        wi[b] += np.real(sig)
        wq[b] += np.imag(sig)
        seeded[b] = msg
    return wi, wq, seeded


@contextlib.contextmanager
def forward_capture(dec):
    """Records the operands of each kernel while one forward runs: the
    waterfall's normalized I/Q, the budgeted LLR launch's and the
    survivors' SNR launch's arguments, the BP launch's LLRs."""
    from rtlsdr_ft8d_tpu_torch import pipeline

    got = {}
    real = {n: getattr(pipeline, n) for n in ("extract_llrs_flat",
                                              "estimate_snr")}

    def spy(name):
        def fn(*args):
            got[name] = args
            return real[name](*args)
        return fn

    def wf(i_n, q_n):
        got["waterfall"] = (i_n, q_n)
        return type(dec)._waterfall(dec, i_n, q_n)

    def bp(llr, max_iters=20, return_posterior=False):
        got["bp"] = llr
        return type(dec).bp(dec, llr, max_iters, return_posterior)

    for n in real:
        setattr(pipeline, n, spy(n))
    dec._waterfall, dec.bp = wf, bp
    try:
        yield got
    finally:
        for n, fn in real.items():
            setattr(pipeline, n, fn)
        del dec._waterfall, dec.bp


def check_wideband_kernels(torch, dec, cap):
    """Phase 7 (b): each decode kernel against its plain version on one
    wideband forward's own operands (B = 1500, budget 4096), with wrapper
    and device ms and the bound at these shapes."""
    from rtlsdr_ft8d_tpu_torch.ops import ldpc, llr, sync, waterfall

    out = {}
    i_n, q_n = cap["waterfall"]
    fft = (dec.wf_twiddle, dec.wf_window)
    bases = (dec.wf_cos, dec.wf_sin, dec.wf_cos_minus_sin)
    wf_k = waterfall.waterfall_cuda(i_n, q_n, *fft)
    wf_p = waterfall.waterfall_plain(i_n, q_n, *bases)
    d = (wf_k.int() - wf_p.int()).abs()
    exact = (d == 0).double().mean().item()
    require(d.max().item() <= 1 and exact > 0.999,
            f"waterfall B={WB_CHANNELS}: max step {d.max().item()}, exact "
            f"{exact:.6f}")
    del wf_p
    b_ms, b_by = waterfall_bound(wf_k)
    out["waterfall"] = {
        "ms": median_ms(torch, lambda: waterfall.waterfall_cuda(i_n, q_n,
                                                               *fft)),
        "plain_ms": median_ms(torch, lambda: waterfall.waterfall_plain(
            i_n, q_n, *bases), reps=3, calls=2),
        "device_ms": device_ms(torch, lambda: waterfall.waterfall_cuda(
            i_n, q_n, *fft), KERNEL_SYMBOLS["waterfall"], required=False),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": float(
            d.max().item()), "exact_cells": exact}

    count = dec.sync_count
    v1_k, g_k = sync.sync_survivors_cuda(wf_k, count)
    s_p = sync.sync_scores_plain(wf_k, count)
    v1_p, g_p = sync.chunk_survivors(s_p)
    require(torch.equal(v1_k, v1_p) and torch.equal(g_k, g_p),
            f"sync B={WB_CHANNELS}: the fused first stage differs")
    b_ms, b_by = bound(wf_k.numel() + (v1_k.numel() + g_k.numel()) * 4,
                       s_p.numel() * 84)
    out["sync"] = {
        "ms": median_ms(torch, lambda: sync.sync_survivors_cuda(wf_k,
                                                               count)),
        "plain_ms": median_ms(torch, lambda: sync.chunk_survivors(
            sync.sync_scores_plain(wf_k, count)), reps=3, calls=2),
        "device_ms": device_ms(torch, lambda: sync.sync_survivors_cuda(
            wf_k, count), KERNEL_SYMBOLS["sync"], required=False),
        "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": 0.0}

    for key, (wf, cf, ch) in (
            ("llr", cap["extract_llrs_flat"]),
            ("llr snr", (cap["estimate_snr"][0],
                         *llr.flatten_grid(cap["estimate_snr"][1])[:2]))):
        s2_k, v_k, l_k = llr.tone_llrs_cuda(wf, cf, ch)
        s2_p, v_p, l_p = llr.tone_llrs_plain(wf, cf, ch)
        require(torch.equal(s2_k, s2_p) and torch.equal(v_k, v_p)
                and torch.allclose(l_k, l_p, rtol=1e-5, atol=1e-5),
                f"{key} N={ch.shape[0]}: kernel and plain differ")
        n = ch.shape[0]
        b_ms, b_by = llr_bound(cf, ch, s2_k, v_k, l_k)
        out[key] = {
            "ms": median_ms(torch, lambda: llr.tone_llrs_cuda(wf, cf, ch)),
            "plain_ms": median_ms(torch, lambda: llr.tone_llrs_plain(
                wf, cf, ch), reps=3, calls=3),
            "device_ms": device_ms(torch, lambda: llr.tone_llrs_cuda(
                wf, cf, ch), KERNEL_SYMBOLS["llr"], required=False),
            "bound_ms": b_ms, "bound_by": b_by, "n": n,
            "max_abs_err": (l_k - l_p).abs().max().item()}

    x = cap["bp"]
    graph = (dec.ldpc_edge_var, dec.ldpc_edge_slot, dec.ldpc_slot_edge)
    h_k, e_k = ldpc.bp_decode_cuda(x, *graph, 20)
    h_p, e_p = ldpc.bp_decode_plain(x, *graph, 20)
    require(torch.equal(h_k, h_p) and torch.equal(e_k, e_p),
            f"bp N={x.shape[0]}: kernel and plain differ")
    iters = bp_iterations(torch, ldpc, x, graph)
    b_ms, b_by = bp_bound(x, (h_k, e_k), iters)
    out["bp"] = {
        "ms": median_ms(torch, lambda: ldpc.bp_decode_cuda(x, *graph, 20)),
        "plain_ms": median_ms(torch, lambda: ldpc.bp_decode_plain(
            x, *graph, 20), reps=3, calls=3),
        "device_ms": device_ms(torch, lambda: ldpc.bp_decode_cuda(
            x, *graph, 20), KERNEL_SYMBOLS["bp"], required=False),
        "bound_ms": b_ms, "bound_by": b_by, "n": x.shape[0],
        "iterations": iters, "successes": int((e_k == 0).sum()),
        "max_abs_err": 0.0}
    for key, r in out.items():
        say("wideband", f"{key} at B={WB_CHANNELS}"
            + (f", N={r['n']}" if "n" in r else "") + f": held against the "
            f"plain version; {r['ms']:.4f} ms (device "
            f"{fmt_ms(r['device_ms'])}) "
            f"vs plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']})")
    return out


def run_wideband_scene(torch, build, dec, smi):
    """Phase 7 (b), (c): the bench's wideband scene (bench.py:356-408) on
    device-resident I/Q at budget 4096: 41/41 seeded texts, the decodes in
    unseeded channels, ms per window (decode_window end to end and the
    device graph, median of 4), the launches of one forward, its
    torch.profiler breakdown, each kernel on its operands; then the deep
    decode with osd_cands=1 (n_osd 1024): 41/41, the OSD launched on the
    card, ms per window and the download, unpack, OSD + merge ms."""
    from rtlsdr_ft8d_tpu_torch.pipeline import (OSD_POSTERIORS,
                                                _merge_osd_decodes,
                                                decode_window,
                                                unpack_survivors)
    from rtlsdr_ft8d_tpu_torch.protocol.text import CallsignHashTable

    wi, wq, seeded = wideband_scene()
    i_t, q_t = torch.from_numpy(wi).to(dec.device), \
        torch.from_numpy(wq).to(dec.device)
    del wi, wq
    rec = {"card": smi, "seeded": len(seeded)}

    def score(res):
        hit = sum(m in {d.text for d in res[b]} for b, m in seeded.items())
        other = sum(len(r) for b, r in enumerate(res) if b not in seeded)
        return hit, other

    for name, osd in (("scene", 0), ("deep", 1)):
        for k in build.KERNELS.values():
            k.launches = 0
        res = decode_window((i_t, q_t), budget=WB_BUDGET, osd_cands=osd,
                            decoder=dec)
        torch.cuda.synchronize()
        launches = {n: build.KERNELS[n].launches
                    for n in DECODE_KERNELS + ("osd",)}
        hit, other = score(res)
        require(hit == len(seeded), f"wideband {name}: {hit}/{len(seeded)}")
        # the OSD runs on the card with osd_cands, and only then
        require(all(n > 0 for k, n in launches.items() if k != "osd")
                and (launches["osd"] > 0) == bool(osd),
                f"wideband {name}: a kernel was not launched, or the OSD "
                f"was without osd_cands: {launches}")
        times, dev_times = [], []
        for _ in range(4):
            t0 = time.perf_counter()
            decode_window((i_t, q_t), budget=WB_BUDGET, osd_cands=osd,
                          decoder=dec)
            times.append((time.perf_counter() - t0) * 1e3)

        def forward(osd=osd):
            with torch.no_grad():
                return dec(i_t, q_t, budget=WB_BUDGET, osd_cands=osd)

        for _ in range(4):
            t0 = time.perf_counter()
            out = forward()
            torch.cuda.synchronize()
            dev_times.append((time.perf_counter() - t0) * 1e3)
        r = {"correct": f"{hit}/{len(seeded)}", "unseeded_decodes": other,
             "ms_per_window": statistics.median(times),
             "device_graph_ms": statistics.median(dev_times),
             "launches": launches}
        if osd:
            # as _decode_pass: the posteriors stay on the card
            host = []
            for _ in range(4):
                t0 = time.perf_counter()
                out_h = {k: v if k in OSD_POSTERIORS else v.cpu().numpy()
                         for k, v in out.items()}
                res_d, sub_d = unpack_survivors(out_h, WB_CHANNELS)
                _merge_osd_decodes(out_h, res_d, sub_d, CallsignHashTable())
                host.append((time.perf_counter() - t0) * 1e3)
            r.update(download_unpack_osd_merge_ms=statistics.median(host),
                     n_osd=int(out_h["osd_chan"].shape[0]),
                     osd_rows=int(out_h["osd_valid"].sum()))
        rec[name] = r
        say("wideband", f"bench wideband {name} ({WB_CHANNELS} channels, "
            f"budget {WB_BUDGET}, osd_cands={osd}): {r['correct']} seeded, "
            f"{other} decodes in unseeded channels; {r['ms_per_window']:.2f} "
            f"ms per "
            f"window end to end, device graph {r['device_graph_ms']:.2f} ms "
            f"(median of 4); launches {launches}"
            + (f"; download, unpack, OSD on the card + merge "
               f"{r['download_unpack_osd_merge_ms']:.2f} ms (n_osd "
               f"{r['n_osd']}, {r['osd_rows']} rows)" if osd else "")
            + f"; {smi}")

    # one forward: its launches, its profile, and its kernels' operands
    def forward():
        with torch.no_grad():
            return dec(i_t, q_t, budget=WB_BUDGET)

    forward()
    torch.cuda.synchronize()
    for k in build.KERNELS.values():
        k.launches = 0
    with forward_capture(dec) as cap:
        forward()
    torch.cuda.synchronize()
    per_forward = {n: k.launches for n, k in build.KERNELS.items()}
    require((per_forward["waterfall"], per_forward["sync"], per_forward["llr"],
             per_forward["bp"]) == (1, 1, 2, 1),
            f"wideband forward launches {per_forward}, want 1, 1, 2, 1")
    prof = profiled(torch, forward, 1, lambda ev: any(
        KERNEL_SYMBOLS["bp"] in e[0] for e in ev), required=False)
    if prof is not None:
        ev, wall = prof
        busy = merged_busy([(s, e) for _, s, e in ev]) / 1e3
        by_name = {}
        for name, s, e in ev:
            by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        rec["forward_profile"] = {
            "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (wall * 1e3),
            "device_ms_by_name": dict(top)}
        say("wideband", f"one wideband forward: launches {per_forward}; wall "
            f"{wall * 1e3:.3f} ms, device busy {busy:.3f} ms, idle share "
            f"{1.0 - busy / (wall * 1e3):.3f}; device ms by name: "
            + "; ".join(f"{n[:80]} {v:.4f}" for n, v in top))
    else:
        rec["forward_profile"] = None
    rec["launches_per_forward"] = per_forward
    with torch.no_grad():
        rec["kernels"] = check_wideband_kernels(torch, dec, cap)
    return rec


def wideband_ft8(message, abs_freq_hz, n, amp=0.3):
    """tests/test_channelize.py:71-84 with the port's encoder: one FT8
    burst at abs_freq_hz of a 2.4 Msps capture, starting after the
    history."""
    from rtlsdr_ft8d_tpu_torch.ops.channelize import WB_HISTORY
    from rtlsdr_ft8d_tpu_torch.protocol.constants import (
        BLOCK_SIZE, CAPTURE_RATE, DOWNSAMPLING, TONE_SPACING_HZ)
    from rtlsdr_ft8d_tpu_torch.protocol.encode import encode
    from rtlsdr_ft8d_tpu_torch.protocol.pack import pack77

    tones = encode(pack77(message))
    sps = BLOCK_SIZE * DOWNSAMPLING
    x = np.zeros(n, dtype=np.complex64)
    phi, idx = 0.0, WB_HISTORY
    for tone in tones:
        f = abs_freq_hz + (float(tone) - 3.5) * TONE_SPACING_HZ
        dphi = 2 * np.pi * f / CAPTURE_RATE
        end = min(idx + sps, n)
        x[idx:end] += amp * np.exp(1j * (phi + dphi * np.arange(end - idx)))
        phi = (phi + dphi * sps) % (2 * np.pi)
        idx += sps
    return x


def run_wideband_capture(torch, dec):
    """Phase 7 (d): tests/test_channelize.py:87-111 at full band: a 15-s
    capture with CQ K1JT FN20 in channel 17 (+500 Hz) and K1ABC W9XYZ EN37
    in channel 42 (+900 Hz), channelized on the card, all 1500 channels
    decoded with the daemon's auto-budget, then deduplicated: exactly
    those two texts, the CQ within 7 Hz of its frequency."""
    from rtlsdr_ft8d_tpu_torch.ops import channelize as ch
    from rtlsdr_ft8d_tpu_torch.pipeline import decode_window
    from rtlsdr_ft8d_tpu_torch.protocol.constants import TONE_SPACING_HZ

    n = ch.WB_HISTORY + ch.R * 48_000
    rng = np.random.default_rng(0)
    x = (wideband_ft8(SPOT, 17 * 1600 + 500.0, n)
         + wideband_ft8(OSD_MSG, 42 * 1600 + 900.0, n))
    x += 0.002 * (rng.standard_normal(n)
                  + 1j * rng.standard_normal(n)).astype(np.complex64)
    i_ch, q_ch = ch.channelize(
        torch.from_numpy(np.real(x).copy()).to(dec.device),
        torch.from_numpy(np.imag(x).copy()).to(dec.device))
    del x
    t0 = time.perf_counter()
    res = decode_window((i_ch, q_ch), budget=WB_BUDGET, decoder=dec)
    decode_ms = (time.perf_counter() - t0) * 1e3
    per_channel = []
    for k, decodes in enumerate(res):
        for d in decodes:
            d.freq_hz += ch.channel_center_hz(k)
        per_channel.append((k, decodes))
    raw = sorted({(k, d.text) for k, ds in per_channel for d in ds})
    final = ch.dedup_wideband(per_channel)
    texts = sorted(d.text for d in final)
    require(texts == sorted([SPOT, OSD_MSG]),
            f"full-band capture: {texts} after dedup (per channel {raw})")
    cq = next(d for d in final if d.text == SPOT)
    off = abs(cq.freq_hz - (17 * 1600 + 500.0 - 3.5 * TONE_SPACING_HZ))
    require(off < 7.0, f"full-band capture: CQ {off:.3f} Hz off")
    say("wideband", f"full-band capture through the channelizer, all "
        f"{ch.NUM_CHANNELS} channels, budget {WB_BUDGET}: {texts} after "
        f"dedup ({len(raw)} channel decodes before: {raw}), CQ "
        f"{off:.3f} Hz off; decode {decode_ms:.1f} ms")
    return {"texts": texts, "channel_decodes": raw, "cq_freq_off_hz": off,
            "decode_ms": decode_ms}


def run_wideband_daemon(torch, build):
    """Phase 7 (e): the port's CLI in-process with --wideband over all 1500
    channels for 2 synthetic windows: exactly one CQ K1JT FN20 in each
    window's spots, every decode kernel launched in that run, each window
    inside 15 s, its seconds by part."""
    common = ["-f", "20m", "-c", "T1ST", "-l", "AA00", "--synthetic", "-x",
              "--stats", "--wideband", "-n", str(DAEMON_WINDOWS)]
    for k in build.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    rc, out, err = run_cli(common)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    require(rc == 0, f"wideband daemon exited {rc}: {err[-2000:]}")
    require(all(launches[n] > 0 for n in DECODE_KERNELS),
            f"a decode kernel was not launched on the wideband daemon: "
            f"{launches}")
    tables = parse_spot_tables(out)
    require(len(tables) == DAEMON_WINDOWS,
            f"wideband daemon printed {len(tables)} spot tables")
    for w, rows in enumerate(tables):
        require([t for _, _, t in rows].count(SPOT) == 1,
                f"wideband window {w}: {rows}")
    parts = [json.loads(line.split(": ", 1)[1])["window_seconds"]
             for line in err.splitlines() if '"window_seconds"' in line]
    require(len(parts) == DAEMON_WINDOWS, f"{len(parts)} timing records")
    for w, p in enumerate(parts):
        require(sum(p.values()) < 15.0,
                f"wideband window {w} took {sum(p.values()):.2f} s")
        say("wideband", f"daemon --wideband window {w} seconds: " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(p.items()))
            + f", total {sum(p.values()):.4f}; {len(tables[w])} spots")
    say("wideband", f"daemon --wideband, {WB_CHANNELS} channels x "
        f"{DAEMON_WINDOWS} windows: one {SPOT} per window; launches "
        f"{launches}; {wall:.1f} s with set-up")
    return {"launches": launches, "window_seconds": parts,
            "spots_per_window": [len(t) for t in tables]}


@contextlib.contextmanager
def dense_capture(dec):
    """Records, while dense decodes run on slots that share `dec`, the
    last slot's LLR operands (waterfall and candidate grid), its main BP
    launch's LLRs and its rungs' posterior launch."""
    from rtlsdr_ft8d_tpu_torch.parallel import dense

    got = {}
    real = dense.extract_llrs

    def llrs(wf, cand):
        got["llr"] = (wf, cand)
        return real(wf, cand)

    def bp(llr, max_iters=20, return_posterior=False):
        got["rungs" if return_posterior else "bp"] = llr
        return type(dec).bp(dec, llr, max_iters, return_posterior)

    dense.extract_llrs, dec.bp = llrs, bp
    try:
        yield got
    finally:
        dense.extract_llrs = real
        del dec.bp


def seeded_hits(out, seeded, n_channels, osd=False):
    """Seeded texts decoded (after the OSD merge with osd, on the
    posteriors' card as _decode_pass runs it), from a dense or sharded
    output dict of tensors; and the decode lists and the OSD + merge ms
    (None without osd)."""
    from rtlsdr_ft8d_tpu_torch.pipeline import (OSD_POSTERIORS,
                                                _merge_osd_decodes,
                                                unpack_survivors)

    out_h = {k: v if k in OSD_POSTERIORS else v.cpu().numpy()
             for k, v in out.items()}
    res, sub = unpack_survivors(out_h, n_channels)
    osd_ms = None
    if osd:
        t0 = time.perf_counter()
        _merge_osd_decodes(out_h, res, sub, None)
        osd_ms = (time.perf_counter() - t0) * 1e3
    hit = sum(m in {d.text for d in res[b]} for b, m in seeded.items())
    return hit, res, osd_ms


def check_dense_kernels(torch, dec, cap):
    """Phase 8 (a): llr.cu and ldpc.cu on one slot's own operands from the
    4-slot dense window (N = 375 x 120 = 45,000 rows) against their plain
    versions: s2 and valid bit-exact and LLRs within 1e-5 (phase 3's
    hold); BP hard bits and errors equal on every row, the all-zero rows
    of the unselected candidates included. Times and bounds as phase 3.
    An all-zero row's outputs are fixed (errors 83, bits 0) with no
    arithmetic, so BP's bound counts the measured iterations of the
    other rows only, and the bytes of every row; the 20 iterations the
    launch runs on each all-zero row (it never converges) are reported
    apart as the work the launch runs."""
    from rtlsdr_ft8d_tpu_torch.ops import ldpc, llr

    out = {}
    wf, cand = cap["llr"]
    cf, ch, _, _ = llr.flatten_grid(cand)
    s2_k, v_k, l_k = llr.tone_llrs_cuda(wf, cf, ch)
    s2_p, v_p, l_p = llr.tone_llrs_plain(wf, cf, ch)
    require(torch.equal(s2_k, s2_p) and torch.equal(v_k, v_p)
            and torch.allclose(l_k, l_p, rtol=1e-5, atol=1e-5),
            f"dense llr N={ch.shape[0]}: kernel and plain differ")
    b_ms, b_by = llr_bound(cf, ch, s2_k, v_k, l_k)
    out["llr"] = {
        "n": ch.shape[0], "max_abs_err": (l_k - l_p).abs().max().item(),
        "ms": median_ms(torch, lambda: llr.tone_llrs_cuda(wf, cf, ch)),
        "plain_ms": median_ms(torch, lambda: llr.tone_llrs_plain(wf, cf, ch),
                              reps=3, calls=3),
        "device_ms": device_ms(torch, lambda: llr.tone_llrs_cuda(wf, cf, ch),
                               KERNEL_SYMBOLS["llr"], required=False),
        "bound_ms": b_ms, "bound_by": b_by}
    del s2_p, v_p, l_p

    graph = (dec.ldpc_edge_var, dec.ldpc_edge_slot, dec.ldpc_slot_edge)
    x = cap["bp"].reshape(-1, 174)
    h_k, e_k = ldpc.bp_decode_cuda(x, *graph, 20)
    h_p, e_p = ldpc.bp_decode_plain(x, *graph, 20)
    require(torch.equal(e_k, e_p) and torch.equal(h_k, h_p),
            f"dense bp N={x.shape[0]}: hard bits or errors differ")
    zero = (x == 0).all(-1)
    require(bool((e_k[zero] == 83).all()) and not bool(h_k[zero].any()),
            "dense bp: an all-zero row did not give errors 83, bits 0")
    n_zero = int(zero.sum())
    iters = bp_iterations(torch, ldpc, x[~zero], graph)
    b_ms, b_by = bp_bound(x, (h_k, e_k), iters)
    run_ms, _ = bp_bound(x, (h_k, e_k), iters + 20 * n_zero)
    out["bp"] = {
        "n": x.shape[0], "all_zero_rows": n_zero, "iterations": iters,
        "launch_iterations": iters + 20 * n_zero, "launch_work_ms": run_ms,
        "successes": int((e_k == 0).sum()), "max_abs_err": 0.0,
        "ms": median_ms(torch, lambda: ldpc.bp_decode_cuda(x, *graph, 20)),
        "plain_ms": median_ms(torch, lambda: ldpc.bp_decode_plain(
            x, *graph, 20), reps=3, calls=2),
        "device_ms": device_ms(torch, lambda: ldpc.bp_decode_cuda(
            x, *graph, 20), KERNEL_SYMBOLS["bp"], required=False),
        "bound_ms": b_ms, "bound_by": b_by}
    for key, r in out.items():
        t = r["device_ms"] or r["ms"]
        say("parallel", f"dense {key} N={r['n']} (one slot's operands): held "
            f"against the plain version"
            + (f" on every row, {r['all_zero_rows']} all-zero" if key == "bp"
               else "") + f"; {r['ms']:.4f} ms (device "
            f"{fmt_ms(r['device_ms'])}) vs plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{r['bound_ms'] / t:.4f} of it"
            + (f"; the work the launch runs, 20 iterations on each all-zero "
               f"row too: {r['launch_iterations']} row-iterations, "
               f"{r['launch_work_ms']:.4f} ms" if key == "bp" else ""))
    return out


def run_dense(torch, build, dec, smi):
    """Phase 8 (a), (b): the bench's wideband scene (bench.py:356-385),
    peak-normalized as rtlsdr_ft8d_tpu/host/daemon.py:264-268, through
    decode_window_dense at global_budget 4096 over a (2, 2) mesh of four
    cuda:0 slots (the launch counts of exactly that run) and over one
    slot: 41/41 in both, and ok, score, n_selected, n_ok and packed at
    every ok slot equal; llr.cu and ldpc.cu on one slot's operands; one
    window's device busy and idle share. Then the deep dense decode on
    four slots: osd_cands_global 1024, the CQ and K1ABC clamp rows and
    phase 6's 1024-row bank: >= 41/41 after the OSD, which must run on
    the card (its OSD + merge ms), every valid
    osd_chan in [0, 1500), and the rungs' ldpc.cu launch with posteriors
    held against its plain version."""
    from rtlsdr_ft8d_tpu_torch.parallel.dense import decode_window_dense
    from rtlsdr_ft8d_tpu_torch.parallel.sharding import Mesh
    from rtlsdr_ft8d_tpu_torch.pipeline import ap_tensors, normalize_peak

    dev = dec.device
    wi, wq, seeded = wideband_scene(WB_CHANNELS)
    i_n, q_n = normalize_peak(torch.from_numpy(wi).to(dev),
                              torch.from_numpy(wq).to(dev))
    del wi, wq
    # both meshes use the phase's decoder (slots of one device share one)
    meshes = {name: Mesh(np.asarray([dev] * (h * c), dtype=object)
                         .reshape(h, c), ("host", "chip"),
                         decoders={dev: dec})
              for name, h, c in (("4 slots", 2, 2), ("1 slot", 1, 1))}
    rec, outs = {"card": smi}, {}
    for name, mesh in meshes.items():
        for k in build.KERNELS.values():
            k.launches = 0
        t0 = time.perf_counter()
        with torch.no_grad(), dense_capture(dec) as cap:
            out = decode_window_dense(i_n, q_n, mesh, global_budget=WB_BUDGET)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {n: build.KERNELS[n].launches for n in build.KERNELS}
        hit, _, _ = seeded_hits(out, seeded, WB_CHANNELS)
        require(hit == len(seeded), f"dense {name}: {hit}/{len(seeded)}")
        require(all(launches[n] > 0 for n in DECODE_KERNELS),
                f"dense {name}: a decode kernel was not launched: {launches}")
        outs[name] = out
        rec[name] = {"correct": f"{hit}/{len(seeded)}", "launches": launches,
                     "first_call_ms": ms,
                     "selected": int(out["n_selected"].sum())}
        if name == "4 slots":
            kernels = check_dense_kernels(torch, dec, cap)
        say("parallel", f"dense {name}, {WB_CHANNELS} channels, global budget "
            f"{WB_BUDGET}: {hit}/{len(seeded)} seeded, "
            f"{rec[name]['selected']} candidates selected, launches "
            f"{launches}, {ms:.1f} ms first call")
    a, b = outs["4 slots"], outs["1 slot"]
    for k in ("ok", "score", "n_selected", "n_ok"):
        require(torch.equal(a[k], b[k]), f"dense: {k} differs, 4 slots vs 1")
    require(torch.equal(a["packed"][a["ok"]], b["packed"][b["ok"]]),
            "dense: packed differs at an ok slot, 4 slots vs 1")
    rec["launches"] = rec["4 slots"]["launches"]
    rec["dense_out_4"] = {k: a[k].cpu().numpy() for k in
                          ("ok", "score", "n_selected", "n_ok", "packed")}

    mesh = meshes["4 slots"]

    def window():
        with torch.no_grad():
            decode_window_dense(i_n, q_n, mesh, global_budget=WB_BUDGET)

    rec["ms_per_window"] = median_ms(torch, window, reps=3, calls=2,
                                     warmup=1)
    prof = profiled(torch, window, 1, lambda ev: sum(
        KERNEL_SYMBOLS["bp"] in e[0] for e in ev) == 4, required=False)
    if prof is not None:
        ev, wall = prof
        busy = merged_busy([(s, e) for _, s, e in ev]) / 1e3
        rec["window_profile"] = {"wall_ms": wall * 1e3,
                                 "device_busy_ms": busy,
                                 "idle_share": 1.0 - busy / (wall * 1e3)}
    else:
        rec["window_profile"] = None
    p = rec["window_profile"]
    say("parallel", f"dense window, 4 slots: {rec['ms_per_window']:.2f} ms "
        f"(CUDA events, median of 3); profiled: " + (
            f"wall {p['wall_ms']:.2f} ms, device busy {p['device_busy_ms']:.2f}"
            f" ms, idle share {p['idle_share']:.3f}" if p else "not recorded")
        + f"; {smi}")

    # (b) the deep dense decode
    clamp, cw = ap_tensors(True, AP_CALL, ap_bank(), dev)
    with torch.no_grad(), dense_capture(dec) as cap:
        out = decode_window_dense(i_n, q_n, mesh, global_budget=WB_BUDGET,
                                  osd_cands_global=1024, ap_clamp_signs=clamp,
                                  ap_cw_signs=cw)
    osd_before = build.KERNELS["osd"].launches
    hit, _, osd_ms = seeded_hits(out, seeded, WB_CHANNELS, osd=True)
    osd_launches = build.KERNELS["osd"].launches - osd_before
    chan = out["osd_chan"][out["osd_valid"]]
    require(hit >= len(seeded), f"dense deep: {hit}/{len(seeded)}")
    require(osd_launches > 0, "dense deep: the OSD did not run on the card")
    require(chan.numel() == 0 or (int(chan.min()) >= 0
                                  and int(chan.max()) < WB_CHANNELS),
            f"dense deep: osd_chan outside [0, {WB_CHANNELS})")
    rungs = cap["rungs"]
    rec["deep"] = {"correct": f"{hit}/{len(seeded)}",
                   "osd_launches": osd_launches, "osd_merge_ms": osd_ms,
                   "osd_rows": int(out["osd_valid"].sum()),
                   "n_osd": int(out["osd_chan"].shape[0]),
                   "bp_rungs": check_bp_rungs(torch, dec, rungs,
                                              required=False)}
    say("parallel", f"dense deep, 4 slots, osd_cands_global 1024, CQ + "
        f"{AP_CALL} rows, bank 1024: {hit}/{len(seeded)} seeded after the "
        f"OSD on the card ({osd_launches} launch, OSD + merge {osd_ms:.2f} "
        f"ms), {rec['deep']['osd_rows']} OSD rows of "
        f"{rec['deep']['n_osd']}, osd_chan inside [0, {WB_CHANNELS}); rungs "
        f"{tuple(rungs.shape[:-1])} held bit-equal")
    del i_n, q_n
    return rec, kernels


def run_sharded(torch, dec, batch):
    """Phase 8 (c): decode_window_sharded on the bench batch (64 channels,
    budget 1024, osd_cands 2) over four cuda:0 slots against
    WindowDecoder.forward on one: every field but the posteriors equal,
    and the decode lists after the OSD. Each shard refines its own
    rows, and the card's float32 products and sums round by row count,
    so the posteriors (largest magnitude about 30) are held within
    POST_ATOL of the forward's."""
    from rtlsdr_ft8d_tpu_torch.parallel.sharding import (
        Mesh, decode_window_sharded)

    dev = dec.device
    mesh = Mesh([dev] * 4, ("ch",), decoders={dev: dec})
    kw = dict(budget=BUDGET, osd_cands=2)
    i_np = np.real(batch).astype(np.float32)
    q_np = np.imag(batch).astype(np.float32)
    with torch.no_grad():
        got = decode_window_sharded(i_np, q_np, mesh, **kw)
        want = dec(torch.from_numpy(i_np).to(dev),
                   torch.from_numpy(q_np).to(dev), **kw)
    require(set(got) == set(want), f"sharded fields {sorted(got)}")
    post, scale = {}, {}
    for k in want:
        if k in ("osd_post", "osd_post_coh"):
            post[k] = (got[k] - want[k]).abs().max().item()
            scale[k] = want[k].abs().max().item()
            require(post[k] <= POST_ATOL, f"sharded: {k} differs by "
                    f"{post[k]}, more than {POST_ATOL}")
        else:
            require(torch.equal(got[k], want[k]), f"sharded: {k} differs")
    lists = []
    for out in (got, want):
        _, res, _ = seeded_hits(out, {}, B, osd=True)
        lists.append([[(d.text, d.freq_hz, d.score) for d in r]
                      for r in res])
    require(lists[0] == lists[1], "sharded: decode lists differ")
    say("parallel", f"sharded, {B} channels over 4 slots, budget {BUDGET}, "
        f"osd_cands 2: every field of the one-slot forward equal but the "
        f"posteriors, within {POST_ATOL} (max diff {post}, largest "
        f"magnitude {scale}); decode lists equal")
    return {"posterior_max_diff": post, "posterior_max_abs": scale,
            "posterior_atol": POST_ATOL}


def run_elastic(torch, dec, batch):
    """Phase 8 (d): ElasticDecoder over four cuda:0 slots with an injected
    heartbeat: two slots die between windows (mesh 4 -> 2), one during a
    window through a failing first call (-> 1); the decode lists stay
    those of the first window. The real device_heartbeat of cuda:0. Then
    one window with OSD rows (as the daemon's --elastic --osd): the
    posteriors stay on the card and the OSD of the merge runs there."""
    from rtlsdr_ft8d_tpu_torch.ops import osd
    from rtlsdr_ft8d_tpu_torch.parallel import elastic
    from rtlsdr_ft8d_tpu_torch.pipeline import (OSD_POSTERIORS,
                                                _merge_osd_decodes,
                                                unpack_survivors)

    dev = dec.device
    require(elastic.device_heartbeat(dev, 10.0),
            f"device_heartbeat({dev}) is False")
    dead = set()
    ed = elastic.ElasticDecoder([dev] * 4,
                                heartbeat=lambda s, t: s not in dead,
                                decoder=dec)
    i_t = torch.from_numpy(np.real(batch).astype(np.float32)).to(dev)
    q_t = torch.from_numpy(np.imag(batch).astype(np.float32)).to(dev)

    def download(out):
        """decode_window's download: all but the posteriors to numpy."""
        return {k: v if k in OSD_POSTERIORS else v.cpu().numpy()
                for k, v in out.items()}

    real = elastic.decode_window_dense
    state = {"fired": False}

    def flaky(*args, **kw):
        if not state["fired"]:
            state["fired"] = True
            dead.add(1)
            raise RuntimeError("simulated slot loss during a window")
        return real(*args, **kw)

    sizes, lists = [], []
    for window in range(3):
        if window == 1:
            dead.update({2, 3})
        if window == 2:
            elastic.decode_window_dense = flaky
        try:
            with torch.no_grad():
                out = download(ed(i_t, q_t, budget=BUDGET))
        finally:
            elastic.decode_window_dense = real
        sizes.append(ed.mesh.size)
        res, _ = unpack_survivors(out, B)
        lists.append([sorted(d.text for d in r) for r in res])
    require(sizes == [4, 2, 1] and state["fired"]
            and ed.windows_recovered == 2,
            f"elastic: meshes {sizes}, recovered {ed.windows_recovered}")
    require(lists[1] == lists[0] and lists[2] == lists[0],
            "elastic: the decode lists changed with the mesh")
    with torch.no_grad():
        out = download(ed(i_t, q_t, budget=BUDGET, osd_cands=2))
    res, sub = unpack_survivors(out, B)
    before = osd.KERNEL.launches
    t0 = time.perf_counter()
    n_rec = _merge_osd_decodes(out, res, sub, None)
    osd_ms = (time.perf_counter() - t0) * 1e3
    require(out["osd_post"].is_cuda and osd.KERNEL.launches == before + 1,
            f"elastic with OSD rows: posteriors on {out['osd_post'].device},"
            f" {osd.KERNEL.launches - before} OSD launches, want the card "
            f"and 1")
    say("parallel", f"elastic, 4 cuda:0 slots: meshes {sizes} (2 killed "
        f"between windows, 1 during one), windows_recovered "
        f"{ed.windows_recovered}, decode lists unchanged "
        f"({sum(map(len, lists[0]))} texts); device_heartbeat({dev}) True; "
        f"osd_cands 2 ({2 * B} rows): OSD on the card, 1 launch, OSD + merge "
        f"{osd_ms:.2f} ms, {n_rec} recovered")
    return {"meshes": sizes, "windows_recovered": ed.windows_recovered,
            "osd_merge_ms": osd_ms, "osd_recovered": n_rec}


def run_halo(torch, dev):
    """Phase 8 (e): decimate_time_sharded on one full window of random
    float I/Q (36,000,000 samples) and channelize_time_sharded with an
    odd frame count per slot (4,001), each over four cuda:0 slots against
    one slot, within rtol 1e-4, atol 1e-5."""
    from rtlsdr_ft8d_tpu_torch.parallel import halo

    rng = np.random.default_rng(41)
    one, four = (halo.make_time_mesh(devices=[dev] * n) for n in (1, 4))
    rec = {}
    for name, fn, n in (
            ("decimate", halo.decimate_time_sharded, 36_000_000),
            ("channelize", halo.channelize_time_sharded, 4 * 4001 * 750)):
        x = torch.from_numpy(rng.standard_normal((2, n), np.float32)).to(dev)
        with torch.no_grad():
            t0 = time.perf_counter()
            got = fn(x[0], x[1], four)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            want = fn(x[0], x[1], one)
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        require(all(a.shape == b.shape and torch.allclose(
            a, b, rtol=1e-4, atol=1e-5) for a, b in zip(got, want)),
            f"halo {name}: 4 slots vs 1 differ (max err {err})")
        rec[name] = {"samples": n, "max_abs_err": err, "ms_4_slots": ms,
                     "out_shape": list(got[0].shape)}
        say("parallel", f"halo {name}, {n} samples, 4 slots vs 1: max err "
            f"{err:.3g}, out {tuple(got[0].shape)}, {ms:.1f} ms")
        del x, got, want
    return rec


_RANK_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[4])
import numpy as np
import torch
import torch.distributed as dist
import chip_smoke as cs
from rtlsdr_ft8d_tpu_torch.ops import build
from rtlsdr_ft8d_tpu_torch.ops.decimate import HISTORY, R, \
    polyphase_decimate_plain
from rtlsdr_ft8d_tpu_torch.ops.tables import polyphase_bank
from rtlsdr_ft8d_tpu_torch.parallel import distributed as pd
from rtlsdr_ft8d_tpu_torch.parallel.dense import decode_window_dense
from rtlsdr_ft8d_tpu_torch.parallel.halo import decimate_time_sharded
from rtlsdr_ft8d_tpu_torch.pipeline import normalize_peak, unpack_survivors

pid, coord, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
n_channels, world, backend = int(sys.argv[5]), int(sys.argv[6]), sys.argv[7]
devs = [torch.device(d) for d in sys.argv[8].split(",")]
dev = devs[0]
if dev.type == "cuda":
    torch.cuda.set_device(dev)      # NCCL's communicator uses this card
pd.initialize(coord, world, pid, backend=backend, timeout=60.0)
staged = pd.stages_through_host(torch.zeros(1, device=dev))
print(f"rank {pid} on {sys.argv[8]}: backend {dist.get_backend()}, host "
      f"staging {staged}", flush=True)
mesh = pd.make_global_grid_mesh(devices=devs)
per = n_channels // world
wi, wq, seeded = cs.wideband_scene(n_channels)
rows = slice(pid * per, (pid + 1) * per)
i_n, q_n = normalize_peak(torch.from_numpy(wi[rows]).to(dev),
                          torch.from_numpy(wq[rows]).to(dev))
del wi, wq
i_g, q_g = pd.shard_channels(mesh, i_n, q_n)
for k in build.KERNELS.values():
    k.launches = 0
with torch.no_grad():
    out = decode_window_dense(i_g, q_g, mesh, global_budget=cs.WB_BUDGET)
launches = {f"launches_{n}": k.launches for n, k in build.KERNELS.items()}
local = {k: pd.local_rows(v)[0] for k, v in out.items()}
idx = pd.local_rows(out["ok"])[1]
assert idx == list(range(pid * per, (pid + 1) * per)), idx[:3]
mine = {b: m for b, m in seeded.items() if b in idx}
res, _ = unpack_survivors(local, per)
hit = sum(m in {d.text for d in res[b - idx[0]]} for b, m in mine.items())
assert hit == len(mine), (pid, hit, len(mine))

n = world * len(devs) * 3000 * R
rng = np.random.default_rng(77)
x = rng.standard_normal((2, n), np.float32)
span = n // world
tmesh = pd.make_global_time_mesh(devs)
gx, gy = pd.shard_channels(tmesh, *(
    torch.from_numpy(x[c, pid * span:(pid + 1) * span]).to(dev)
    for c in (0, 1)))
di, _ = decimate_time_sharded(gx, gy, tmesh)
full = torch.from_numpy(np.concatenate([np.zeros(HISTORY, np.float32), x[0]]))
ref = polyphase_decimate_plain(full.to(dev), torch.from_numpy(
    polyphase_bank()).to(dev))
got, t_idx = pd.local_rows(di)
err = float(np.abs(got - ref.cpu().numpy()[t_idx]).max())
assert np.allclose(got, ref.cpu().numpy()[t_idx], rtol=1e-4, atol=1e-5), err
np.savez(out_path, start=idx[0], halo_err=err, hit=hit, seeded=len(mine),
         **launches, **local)
dist.destroy_process_group()
print(f"rank {pid} OK: {hit}/{len(mine)} seeded, halo max err {err:.3g}",
      flush=True)
"""


def run_ranks(torch, rank_devices, backend, dense_ref,
              n_channels=WB_CHANNELS):
    """Processes joined by `backend` through
    parallel.distributed.initialize (127.0.0.1 and a free port, 60-s
    timeouts, every wait bounded), rank p on the slots rank_devices[p]:
    each decodes its share of the wideband scene through
    decode_window_dense over the global ('host', 'chip') mesh, whose score
    all-gather crosses the ranks, and its rows must equal `dense_ref`, the
    one-process dense decode over as many slots; then the decimator's
    halo crosses each rank boundary, against the whole stream decimated
    at once. Returns each rank's seeded hits, halo error and kernel
    launches."""
    import socket
    import tempfile

    world = len(rank_devices)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{p}.npz") for p in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RANK_CHILD, str(p), f"127.0.0.1:{port}",
             paths[p], ROOT, str(n_channels), str(world), backend,
             ",".join(str(d) for d in rank_devices[p])],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for p in range(world)]
        outs, deadline = [], time.monotonic() + 240
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1.0))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        for p, (proc, out) in enumerate(zip(procs, outs)):
            require(proc.returncode == 0,
                    f"rank {p} exited {proc.returncode}: {out[-3000:]}")
        ranks = [dict(np.load(path)) for path in paths]
    rec = {"backend_lines": [line for out in outs for line in
                             out.splitlines() if "backend" in line]}
    for p, r in enumerate(ranks):
        rows = slice(int(r["start"]), int(r["start"]) + r["ok"].shape[0])
        for k in ("ok", "score", "n_selected", "n_ok", "packed"):
            require(np.array_equal(r[k], dense_ref[k][rows]),
                    f"rank {p}: {k} differs from the one-process run")
        rec[f"rank{p}"] = {
            "seeded": f"{int(r['hit'])}/{int(r['seeded'])}",
            "halo_max_abs_err": float(r["halo_err"]),
            "launches": {k.split("_", 1)[1]: int(v) for k, v in r.items()
                         if k.startswith("launches_")}}
    for line in rec["backend_lines"]:
        say("parallel", line)
    say("parallel", f"{world} ranks over {backend}: each decoded its "
        f"{n_channels // world} channels (" + ", ".join(
            rec[f"rank{p}"]["seeded"] for p in range(world))
        + " seeded), rows equal to the one-process run; halo across the "
        "rank boundaries, max err " + ", ".join(
            f"{rec[f'rank{p}']['halo_max_abs_err']:.3g}"
            for p in range(world)))
    return rec


def run_elastic_daemon(torch, build):
    """Phase 8 (g): the CLI with --wideband --elastic over all 1500
    channels, 2 synthetic windows, --backend cuda: CQ K1JT FN20 in each
    window, every decode kernel launched in that run, the seconds per
    window by part, mesh_devices and windows_recovered."""
    common = ["-f", "20m", "-c", "T1ST", "-l", "AA00", "--synthetic", "-x",
              "--stats", "--wideband", "--elastic", "-n",
              str(DAEMON_WINDOWS), "--backend", "cuda"]
    for k in build.KERNELS.values():
        k.launches = 0
    rc, out, err = run_cli(common)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    require(rc == 0, f"--elastic daemon exited {rc}: {err[-2000:]}")
    require(all(launches[n] > 0 for n in DECODE_KERNELS),
            f"a decode kernel was not launched on the --elastic daemon: "
            f"{launches}")
    tables = parse_spot_tables(out)
    require(len(tables) == DAEMON_WINDOWS,
            f"--elastic daemon printed {len(tables)} spot tables")
    for w, rows in enumerate(tables):
        require(SPOT in [t for _, _, t in rows],
                f"--elastic window {w}: {rows}")
    parts = [json.loads(line.split(": ", 1)[1])["window_seconds"]
             for line in err.splitlines() if '"window_seconds"' in line]
    stats = [json.loads(line.split(": ", 1)[1])["window_stats"]["extra"]
             for line in err.splitlines() if '"window_stats"' in line]
    require(len(parts) == DAEMON_WINDOWS and len(stats) == DAEMON_WINDOWS,
            f"{len(parts)} timing records, {len(stats)} stats records")
    for w, (p, st) in enumerate(zip(parts, stats)):
        say("parallel", f"daemon --wideband --elastic window {w} seconds: "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(p.items()))
            + f", total {sum(p.values()):.4f}; mesh_devices "
            f"{st['mesh_devices']}, windows_recovered "
            f"{st['windows_recovered']}; {len(tables[w])} spots")
    say("parallel", f"daemon --wideband --elastic, {WB_CHANNELS} channels x "
        f"{DAEMON_WINDOWS} windows: {SPOT} in each; launches {launches}")
    return {"launches": launches, "window_seconds": parts, "stats": stats}


def run_parallel(torch, build, dec, batch, smi):
    """Phase 8: the parallel layer on the card, (a)-(g)."""
    t0 = time.perf_counter()
    rec, kernels = run_dense(torch, build, dec, smi)
    rec["sharded"] = run_sharded(torch, dec, batch)
    rec["elastic"] = run_elastic(torch, dec, batch)
    rec["halo"] = run_halo(torch, dec.device)
    # (f) two processes sharing the card over gloo
    rec["two_ranks"] = run_ranks(torch, [[dec.device] * 2] * 2, "gloo",
                                 rec.pop("dense_out_4"))
    rec["daemon"] = run_elastic_daemon(torch, build)
    rec["seconds"] = time.perf_counter() - t0
    say("parallel", f"phase 8 in {rec['seconds']:.1f} s")
    return rec, kernels


def run_nccl_ranks(torch, build, smi):
    """`--nccl-ranks`: one rank per visible card over NCCL, each decoding
    its share of the wideband scene through the dense decode over the
    global (cards, 1) mesh, and the halo across the cards; every rank's
    rows equal the one-process dense decode over as many slots of
    cuda:0, and every decode kernel launched in every rank."""
    from rtlsdr_ft8d_tpu_torch.parallel.dense import decode_window_dense
    from rtlsdr_ft8d_tpu_torch.parallel.sharding import Mesh
    from rtlsdr_ft8d_tpu_torch.pipeline import normalize_peak

    n = torch.cuda.device_count()
    require(n >= 2, f"--nccl-ranks needs two cards or more, {n} visible")
    dev = torch.device("cuda", 0)
    wi, wq, _ = wideband_scene(WB_CHANNELS)
    i_n, q_n = normalize_peak(torch.from_numpy(wi).to(dev),
                              torch.from_numpy(wq).to(dev))
    del wi, wq
    mesh = Mesh(np.asarray([dev] * n, dtype=object).reshape(n, 1),
                ("host", "chip"))
    with torch.no_grad():
        out = decode_window_dense(i_n, q_n, mesh, global_budget=WB_BUDGET)
    ref = {k: v.cpu().numpy() for k, v in out.items()}
    del i_n, q_n, out
    t0 = time.perf_counter()
    rec = run_ranks(torch, [[torch.device("cuda", p)] for p in range(n)],
                    "nccl", ref)
    rec["seconds"] = time.perf_counter() - t0
    for p in range(n):
        got = rec[f"rank{p}"]["launches"]
        require(all(got.get(k, 0) > 0 for k in DECODE_KERNELS),
                f"rank {p}: a decode kernel was not launched: {got}")
    rec["card"] = smi
    return rec


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nccl-ranks", action="store_true",
                    help="run only the dense decode and the halo with one "
                         "process per visible card over NCCL, against one "
                         "process (needs two cards or more)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA card", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "rtlsdr_ft8d_tpu_torch")):
        print(f"chip_smoke: no rtlsdr_ft8d_tpu_torch package beside "
              f"{__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)

    # 1. device
    cap = torch.cuda.get_device_capability(0)
    require(cap == (9, 0), f"need compute capability 9.0, got {cap}")
    smi = nvidia_smi()
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "float32 matmuls must run in full precision (TF32 is on)")
    say("device", f"{torch.cuda.get_device_name(0)}, capability {cap}, "
        f"count {torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build: the kernels (one nvcc per source) beside the native lib
    from rtlsdr_ft8d_tpu_torch.ops import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        kernels_job = pool.submit(build.build)
        native_job = pool.submit(build.build_native)
        (path, secs), (native_path, native_secs) = \
            kernels_job.result(), native_job.result()
    build_wall = time.perf_counter() - t0
    os.environ["FT8_TPU_REQUIRE_NATIVE"] = "1"
    from rtlsdr_ft8d_tpu_torch import native
    require(native.load() is not None and native._SO == native_path,
            f"native library {native_path} did not load")
    from rtlsdr_ft8d_tpu_torch.ops import decimate  # noqa: F401 (kernel 5)
    from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder, normalize_peak

    build.load()
    require(len(build.KERNELS) == 7, f"kernels: {sorted(build.KERNELS)}")
    say("build", f"{os.path.relpath(path, ROOT)} ({len(build.KERNELS)} "
        f"kernels) in {secs:.1f} s, nvcc {' '.join(build.NVCC_FLAGS)}; "
        f"{os.path.relpath(native_path, ROOT)} in {native_secs:.1f} s; "
        f"{build_wall:.1f} s wall")

    if args.nccl_ranks:
        rec = run_nccl_ranks(torch, build, smi)
        print(json.dumps({"nccl_ranks": rec}))
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # 3. kernels
    dev = torch.device("cuda", 0)
    dec = WindowDecoder().to(dev)
    batch, msgs = bench_batch()
    ladder, lmsgs = ladder_batch()
    i_n, q_n = normalize_peak(
        torch.from_numpy(np.real(batch).astype(np.float32)).to(dev),
        torch.from_numpy(np.imag(batch).astype(np.float32)).to(dev))
    with torch.no_grad():
        rec = check_kernels(torch, dec, i_n, q_n)
        check_candidates(torch, dec, ladder)
        rec["decimate"] = check_decimate(torch, dev)

    # 4. the decode path, with the launch counts of exactly that run
    for k in build.KERNELS.values():
        k.launches = 0
    run_main_path(torch, dec, batch, msgs, ladder, lmsgs)
    torch.cuda.synchronize()
    decode_launches = {name: build.KERNELS[name].launches
                       for name in DECODE_KERNELS}
    require(all(n > 0 for n in decode_launches.values()),
            f"a kernel was not launched on the decode path: "
            f"{decode_launches}")
    say("main", f"kernel launches on the decode path: {decode_launches}")
    wps = throughput(torch, dec, batch)
    say("main", f"windows/s at B={B}, budget={BUDGET}: device graph "
        f"{wps['device']:.1f}, decode_window end to end {wps['e2e']:.1f} "
        f"(median of 5; {smi})")
    fwd = forward_profile(torch, build, dec, batch)
    knife = check_knife_edge(torch, dec)

    # 5. the live daemon, with the launch counts of exactly that run
    launches, window_seconds = run_daemon_path(torch, build)
    check_multipass(dec)

    # 6. the deep decode and the AP stack, with the launch counts of
    # exactly that run
    deep, rungs, busy = run_deep_path(torch, build, dec)
    rec["subtract"] = check_subtract(torch, dec)
    with torch.no_grad():
        rec["bp"]["ms_by_shape"]["rungs " + "x".join(
            str(n) for n in rungs.shape[:-1]) + " posterior"] = \
            check_bp_rungs(torch, dec, rungs)
        deep["forward"] = deep_profile(torch, build, dec, busy)
    rec["osd"] = deep["forward"]["osd_kernel"]
    llr_snr = deep["forward"]["llr_osd_snr"]
    rec["llr"]["ms_by_shape"][f"N={deep['forward']['n_osd']} osd snr"] = \
        llr_snr
    rec["llr"]["max_abs_err"] = max(rec["llr"]["max_abs_err"],
                                    llr_snr["max_abs_err"])
    rec["bp"]["post_max_ulp"] = max(
        rec["bp"]["post_max_ulp"],
        *(r.get("post_max_ulp", 0) for r in rec["bp"]["ms_by_shape"].values()))
    deep["daemon_launches"] = run_deep_daemon(torch, build)

    # 7. wideband: the channelizer, the bench's full band, the full-band
    # capture and the --wideband daemon, each run with its own counts
    with torch.no_grad():
        wb = {"channelizer": check_channelizer(torch, dev)}
    wb.update(run_wideband_scene(torch, build, dec, smi))
    with torch.no_grad():
        wb["capture"] = run_wideband_capture(torch, dec)
    wb["daemon"] = run_wideband_daemon(torch, build)
    for name in DECODE_KERNELS:
        rec[name]["wideband"] = wb["kernels"][name]
    rec["llr"]["wideband_snr"] = wb["kernels"]["llr snr"]

    # 8. the parallel layer, its launch counts from the 4-slot dense
    # window of (a)
    par, dense_kernels = run_parallel(torch, build, dec, batch, smi)
    for name, r in dense_kernels.items():
        rec[name]["dense"] = r
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "rtlsdr_ft8d_tpu"))
    require(not loaded, f"JAX or the JAX package was imported: {loaded}")

    kernels = []
    for name, k in build.KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "decode_path_launches": decode_launches.get(name, 0),
            "launches_per_forward": fwd["launches_per_forward"][name],
            "deep_path_launches": deep["launches"].get(name, 0),
            "launches_per_deep_forward":
                deep["forward"]["launches_per_forward"][name],
            "wideband_path_launches": wb["daemon"]["launches"][name],
            "launches_per_wideband_forward":
                wb["launches_per_forward"][name],
            "parallel_path_launches": par["launches"][name],
            **rec[name]})
    print(json.dumps({"kernels": kernels, "windows_per_s": wps,
                      "forward_profile": fwd, "knife_edge": knife,
                      "daemon_window_seconds": window_seconds, "deep": deep,
                      "wideband": wb, "parallel": par, "card": smi}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Failure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        rc = 1
    sys.exit(rc)
