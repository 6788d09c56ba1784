#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card of compute capability 9.0 (H100) and nvcc; imports no
JAX. Phases, one line each, any failure exits non-zero:

  1. device   the card, its name and power limit (nvidia-smi), full-f32
              matmuls (TF32 off);
  2. build    compiles rtlsdr_ft8d_tpu_torch/csrc/*.cu for sm_90a;
  3. kernels  each kernel against its plain PyTorch version on the card at
              the main path's shapes (64 channels; 1024 and 7680 flat
              candidates), with CUDA-event median times of both;
  4. main     the decode path through decode_window: the golden fixtures
              give exactly the single-pass oracle texts, the bench batch
              (bench.py:42-48) decodes 64/64 unbudgeted and at budget=1024,
              the bench ladder (bench.py:73-107) gives strong 40/40 and weak
              >= 12/24; every kernel's launch count from that run is > 0;
              then end-to-end windows/s at 64 channels and budget=1024.

The last two lines are a JSON record of the kernels and
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(ROOT, "tests", "fixtures")
B = 64
BUDGET = 1024
BENCH_MSGS = ["CQ K1JT FN20", "K1ABC W9XYZ EN37", "CQ VA2GKA FN35",
              "W9XYZ K1ABC R-09"]
LADDER_SNRS = [-10.0, -11.5, -13.0, -14.5, -16.0, -17.0, -18.0, -19.0]
PER_RUNG = 8


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


def bench_batch():
    """bench.py:42-48: 64 channels, one strong message each, seed 5."""
    from rtlsdr_ft8d_tpu.host.synth import synthesize_message

    rng = np.random.default_rng(5)
    batch = np.stack([
        synthesize_message(BENCH_MSGS[b % 4], f0_hz=100 + 17.5 * b % 1300,
                           noise_sigma=0.3, rng=rng) for b in range(B)])
    return batch, [BENCH_MSGS[b % 4] for b in range(B)]


def ladder_batch():
    """bench.py:73-90: 8 SNR rungs x 8 channels, -10 .. -19 dB."""
    from rtlsdr_ft8d_tpu.host.synth import synthesize_message

    def sigma(snr_db, amp=0.5):
        return np.sqrt(amp ** 2
                       / (2 * 10 ** (snr_db / 10.0) * (2500.0 / 3200.0)))

    chans, msgs = [], []
    for r, snr in enumerate(LADDER_SNRS):
        for t in range(PER_RUNG):
            b = r * PER_RUNG + t
            chans.append(synthesize_message(
                BENCH_MSGS[b % 4], f0_hz=250 + 16.5 * b,
                noise_sigma=sigma(snr),
                rng=np.random.default_rng(1000 + b)))
            msgs.append(BENCH_MSGS[b % 4])
    return np.stack(chans), msgs


def bp_rows(n):
    """Codewords at three noise levels mixed with pure noise, in the
    proportions of tests/test_kernels_vs_reference.py:135-145."""
    from rtlsdr_ft8d_tpu.protocol.crc import add_crc
    from rtlsdr_ft8d_tpu.protocol.encode import ldpc_encode

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
    """Phase 3: every kernel against its plain version on the card."""
    from rtlsdr_ft8d_tpu_torch.ops import ldpc, llr, sync, waterfall

    rec = {}
    bases = (dec.wf_cos, dec.wf_sin, dec.wf_cos_minus_sin)

    wf_k = waterfall.waterfall_cuda(i_n, q_n, *bases)
    wf_p = waterfall.waterfall_plain(i_n, q_n, *bases)
    d = (wf_k.int() - wf_p.int()).abs()
    exact = (d == 0).double().mean().item()
    require(d.max().item() <= 1 and exact > 0.999,
            f"waterfall: max step {d.max().item()}, exact {exact:.6f}")
    rec["waterfall"] = {
        "max_abs_err": float(d.max().item()),
        "ms": median_ms(torch, lambda: waterfall.waterfall_cuda(
            i_n, q_n, *bases)),
        "plain_ms": median_ms(torch, lambda: waterfall.waterfall_plain(
            i_n, q_n, *bases)),
        "shape": f"B={B}"}
    say("kernels", f"waterfall B={B}: max step {d.max().item()}, "
        f"exact cells {exact:.6f}, {rec['waterfall']['ms']:.3f} ms vs plain "
        f"{rec['waterfall']['plain_ms']:.3f} ms")

    s_k = sync.sync_scores_cuda(wf_k, dec.sync_count)
    s_p = sync.sync_scores_plain(wf_k, dec.sync_count)
    require(torch.equal(s_k, s_p), "sync: scores are not bit-exact")
    rec["sync"] = {
        "max_abs_err": 0.0,
        "ms": median_ms(torch, lambda: sync.sync_scores_cuda(
            wf_k, dec.sync_count)),
        "plain_ms": median_ms(torch, lambda: sync.sync_scores_plain(
            wf_k, dec.sync_count)),
        "shape": f"B={B}"}
    say("kernels", f"sync B={B}: bit-exact, {rec['sync']['ms']:.3f} ms vs "
        f"plain {rec['sync']['plain_ms']:.3f} ms")

    cand = sync.find_sync(wf_k, dec.sync_count)
    flat, chan, _, K = llr.flatten_grid(cand)
    _, sel = sync.top_k(cand["score"].reshape(-1), BUDGET)
    shapes = {7680: (flat, chan),
              BUDGET: ({k: v[sel] for k, v in flat.items()}, sel // K)}
    rec["llr"] = {"max_abs_err": 0.0, "ms_by_shape": {}}
    for n, (cf, ch) in sorted(shapes.items()):
        s2_k, v_k, l_k = llr.tone_llrs_cuda(wf_k, cf, ch)
        s2_p, v_p, l_p = llr.tone_llrs_plain(wf_k, cf, ch)
        require(torch.equal(s2_k, s2_p) and torch.equal(v_k, v_p),
                f"llr N={n}: s2 not bit-exact")
        require(torch.allclose(l_k, l_p, rtol=1e-5, atol=1e-5),
                f"llr N={n}: LLRs differ beyond 1e-5")
        err = (l_k - l_p).abs().max().item()
        ms = median_ms(torch, lambda: llr.tone_llrs_cuda(wf_k, cf, ch))
        pms = median_ms(torch, lambda: llr.tone_llrs_plain(wf_k, cf, ch))
        rec["llr"]["max_abs_err"] = max(rec["llr"]["max_abs_err"], err)
        rec["llr"]["ms_by_shape"][f"N={n}"] = [ms, pms]
        say("kernels", f"llr N={n}: s2 bit-exact, LLR max err {err:.3g}, "
            f"{ms:.3f} ms vs plain {pms:.3f} ms")
    rec["llr"]["ms"], rec["llr"]["plain_ms"] = \
        rec["llr"]["ms_by_shape"][f"N={BUDGET}"]

    graph = (dec.ldpc_edge_var, dec.ldpc_edge_slot, dec.ldpc_slot_edge)
    rec["bp"] = {"max_abs_err": 0.0, "ms_by_shape": {}}
    for n in (BUDGET, 7680):
        x = torch.from_numpy(bp_rows(n)).to(i_n.device)
        h_k, e_k, p_k = ldpc.bp_decode_cuda(x, *graph, 20, True)
        h_p, e_p, p_p = ldpc.bp_decode_plain(x, *graph, 20, True)
        ok = e_p == 0
        require(torch.equal(e_k, e_p), f"bp N={n}: error counts differ")
        require(torch.equal(h_k[ok], h_p[ok]),
                f"bp N={n}: hard bits differ on a success")
        err = (p_k - p_p).abs().max().item()
        require(err <= 1e-4, f"bp N={n}: posteriors differ by {err}")
        ms = median_ms(torch, lambda: ldpc.bp_decode_cuda(x, *graph, 20))
        pms = median_ms(torch, lambda: ldpc.bp_decode_plain(x, *graph, 20))
        rec["bp"]["max_abs_err"] = max(rec["bp"]["max_abs_err"], err)
        rec["bp"]["ms_by_shape"][f"N={n}"] = [ms, pms]
        say("kernels", f"bp N={n}: {int(ok.sum())} successes, errors and "
            f"hard bits identical, posterior max err {err:.3g}, "
            f"{ms:.3f} ms vs plain {pms:.3f} ms")
    rec["bp"]["ms"], rec["bp"]["plain_ms"] = \
        rec["bp"]["ms_by_shape"][f"N={BUDGET}"]
    return rec


def run_main_path(torch, dec, batch, msgs, ladder, lmsgs):
    """Phase 4: the decode path as a user calls it."""
    from rtlsdr_ft8d_tpu.host.io import read_iq
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

    # 2. build
    from rtlsdr_ft8d_tpu_torch.ops import build
    from rtlsdr_ft8d_tpu_torch.pipeline import WindowDecoder, normalize_peak

    path, secs = build.build()
    build.load()
    say("build", f"{os.path.relpath(path, ROOT)} in {secs:.1f} s "
        f"(nvcc {' '.join(build.NVCC_FLAGS)})")

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

    # 4. main path, with the launch counts of exactly that run
    for k in build.KERNELS.values():
        k.launches = 0
    run_main_path(torch, dec, batch, msgs, ladder, lmsgs)
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in build.KERNELS.items()}
    require(all(n > 0 for n in launches.values()),
            f"a kernel was not launched on the main path: {launches}")
    say("main", f"kernel launches on the main path: {launches}")
    wps = throughput(torch, dec, batch)
    say("main", f"windows/s at B={B}, budget={BUDGET}: device graph "
        f"{wps['device']:.1f}, decode_window end to end {wps['e2e']:.1f} "
        f"(median of 5; {smi})")
    require("jax" not in sys.modules, "jax was imported")

    kernels = []
    for name, k in build.KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": k.source,
                        "replaces": k.replaces, "launches": launches[name],
                        **rec[name]})
    print(json.dumps({"kernels": kernels,
                      "windows_per_s": wps, "card": smi}))
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
