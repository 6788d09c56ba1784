#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

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
              windows, every kernel's launch count from that run > 0, the
              seconds per window by part and the decimate part per band;
              one band, one window with the
              float --ingest device path gives the same texts, frequencies
              and DTs; then multipass: on the masked scene of
              tests/test_multipass.py one pass finds the strong signal
              only, two passes find both.

The last three lines are a JSON record of the kernels, the card's name and
power limit, and {"ok": true, "device": {...}}.
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
DAEMON_BANDS = ("20m", "40m", "30m", "17m")
DAEMON_WINDOWS = 2
SPOT = "CQ K1JT FN20"
KNIFE_SEEDS = 8
KNIFE_MSGS = BENCH_MSGS + ["CQ TEST K1ABC FN42", "K1ABC W9XYZ RR73"]
# BP kernel vs bp_decode_plain: both run the same round-to-nearest float32
# operations in the same order, so the posterior is held bit-equal
POST_ULP = 0
# H100 SXM published peaks at a 700 W limit (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# each kernel's function in the profiler's kernel names
KERNEL_SYMBOLS = {"waterfall": "waterfall_kernel", "sync": "sync_kernel",
                  "llr": "llr_kernel", "bp": "bp_kernel",
                  "decimate": "decimate_kernel"}


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


def profiled(torch, fn, calls, enough=bool, tries=3):
    """torch.profiler over `calls` calls of fn (warmed up once), ending in
    a synchronize; returns (device events, wall seconds of the region).
    The profiler has been seen to drop device records on the card, once
    all of a pass's: a pass whose events fail `enough` runs again, up to
    `tries` passes."""
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
    raise Failure(f"torch.profiler recorded {len(ev)} device events in "
                  f"{calls} calls, {tries} passes running")


def device_events(torch, prof):
    """(name, start us, end us) of every event that ran on the card."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def is_copy(name):
    return name.startswith("Memcpy") or name.startswith("Memset")


def device_ms(torch, fn, symbol, calls=10):
    """Device milliseconds per launch of the kernel named `symbol`, for fn
    that launches it once per call; the mean over the launches the
    profiler recorded, at least half of them."""
    def mine(ev):
        return [e for e in ev if symbol in e[0]]

    ev, _ = profiled(torch, fn, calls,
                     lambda ev: calls // 2 <= len(mine(ev)) <= calls)
    ev = mine(ev)
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
    n_used = waterfall.USED_SAMPLES
    wf_bound = bound(2 * B * n_used * 4 + wf_k.numel(),
                     5 * 1024 * 10 * waterfall.NUM_FRAMES * B)
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
        # tone bytes read, fields read, s2 + valid + LLRs written
        field_bytes = sum(x.element_size() for x in (ch, *cf.values())) * n
        nbytes = (n * 58 * 8 + field_bytes + s2_k.numel() * 4
                  + v_k.numel() + l_k.numel() * 4)
        b_ms, b_by = bound(nbytes, n * 58 * (3 * 8 + 3 * 3) + n * 174 * 2)
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


def all_device_ms(torch, fn, calls=10):
    """Device milliseconds per call summed over every kernel fn runs."""
    ev, _ = profiled(torch, fn, calls, lambda ev: len(ev) >= calls)
    return sum(end - start for name, start, end in ev
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
        # error count is 0; 32 FP32 operations per edge and iteration
        # (posterior add, difference, scale, clamp 2, tanh 10, products 3,
        # clamp 2, atanh 11, scale), 522 edges
        iters = bp_iterations(torch, ldpc, x, graph)
        b_ms, b_by = bound(x.numel() * 4 + h_k.numel() * h_k.element_size()
                           + e_k.numel() * e_k.element_size(),
                           32 * 522 * iters)
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
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched on the daemon path: {launches}")
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


def main() -> int:
    import torch

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
    require(len(build.KERNELS) == 5, f"kernels: {sorted(build.KERNELS)}")
    say("build", f"{os.path.relpath(path, ROOT)} ({len(build.KERNELS)} "
        f"kernels) in {secs:.1f} s, nvcc {' '.join(build.NVCC_FLAGS)}; "
        f"{os.path.relpath(native_path, ROOT)} in {native_secs:.1f} s; "
        f"{build_wall:.1f} s wall")

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
            **rec[name]})
    print(json.dumps({"kernels": kernels, "windows_per_s": wps,
                      "forward_profile": fwd, "knife_edge": knife,
                      "daemon_window_seconds": window_seconds, "card": smi}))
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
