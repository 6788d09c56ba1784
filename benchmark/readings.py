"""The readings the limits of `correct` are set from, for one cell, in
one process: for each seed, the program's numbers over a short closed
loop at the cell's own size and load (warm-up windows, then `windows`
more, every one compared, as a run compares them), the control's (the
plain reference in the program's place computed in TF32), and the
program's with each fault of faults.py planted.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--faults a,b --fault-seeds 4,5,6] \
        [--windows 8]

Prints one JSON line per seed and reading, then the largest program
reading, the smallest control reading and each fault's smallest reading
of each number. The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def readings(workload: str, seed_list, control_seeds, windows: int,
             device: str = "cuda", overrides=None, log=print, faults=(),
             fault_seeds=()):
    """Yields {"seed", "kind": "program" | "control" | "fault:<name>",
    "numbers"}."""
    import faults as fault_mod
    import harness
    import registry

    _, cfg, traffic = registry.cell(registry.benchmark(), workload)
    cfg.update((overrides or {}).get("config", {}))
    traffic.update((overrides or {}).get("traffic", {}))
    drv_mod = registry.driver(cfg["driver"])
    runs = [(seed, None) for seed in sorted(set(seed_list)
                                            | set(control_seeds))]
    runs += [(seed, f) for f in faults for seed in fault_seeds]
    for seed, fault in runs:
        t0 = time.perf_counter()
        patch = fault_mod.Patcher()
        if fault:
            fault_mod.FAULTS[fault](patch)
        outputs = []
        try:
            drv = drv_mod.Driver(cfg, traffic, seed, device,
                                 harness.Spans(ranges=False))
            try:
                if fault or seed in seed_list:
                    for n in range(int(cfg["warmup_windows"]) + windows):
                        drv.ready()
                        out = drv.step()
                        if n:
                            outputs.append(out)
            finally:
                drv.close()
        finally:
            patch.undo()
        ref = drv.reference()
        if fault:
            yield {"seed": seed, "kind": "fault:" + fault,
                   "numbers": drv.checks(ref, outputs)}
        elif seed in seed_list:
            yield {"seed": seed, "kind": "program",
                   "numbers": drv.checks(ref, outputs)}
        if not fault and seed in control_seeds:
            yield {"seed": seed, "kind": "control",
                   "numbers": drv.control(ref)}
        log(f"seed {seed}: {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--faults", type=lambda t: [f for f in t.split(",") if f],
                   default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--windows", type=int, default=8)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    worst, least = {}, {}
    for rec in readings(args.workload, args.seeds, args.control_seeds,
                        args.windows,
                        log=lambda m: print(m, file=sys.stderr, flush=True),
                        faults=args.faults, fault_seeds=args.fault_seeds):
        print(json.dumps(rec), flush=True)
        for k, v in rec["numbers"].items():
            if k in ("reference_decodes", "windows"):
                continue
            if rec["kind"] == "program":
                worst[k] = max(worst.get(k, v), v)
            else:
                kind = least.setdefault(rec["kind"], {})
                kind[k] = min(kind.get(k, v), v)
    print(json.dumps({"program_largest": worst, "smallest": least}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
