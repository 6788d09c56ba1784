"""The benchmark of the PyTorch and CUDA port (rtlsdr_ft8d_tpu_torch):
one run of one cell, from the root of a checkout.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell named in BENCHMARK.json (its configuration, its traffic
made from the seed, the program's entry), warms it up, measures for
`seconds`, compares what the timed path produced with the plain
reference, and prints one line of JSON last on standard output: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics. Exits non-zero, printing no result, without enough CUDA
devices, when the run fails, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache of the run at a fixed path inside the checkout (the
    # port builds its kernels into its own build/ directory there)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    sys.path[:0] = [HERE, ROOT]

    import torch

    import harness
    import registry

    w = registry.cell(registry.benchmark(), args.workload)[0]
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(w["chips"]):
        print(f"the cell needs {w['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    result = out["result"]
    print(json.dumps({"record": out["record"]}), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
