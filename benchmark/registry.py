"""Finds the benchmark's parts by the names BENCHMARK.json and the
configuration and traffic files give: benchmark/configs/<name>.json,
benchmark/traffic/<name>.json, benchmark/generators/<name>.py,
benchmark/drivers/<name>.py and benchmark/metrics/<name>.py."""

import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(kind: str, name: str, ext: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    path = os.path.join(HERE, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return path


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def config(name: str) -> dict:
    return _load_json(_path("configs", name, ".json"))


def traffic(name: str) -> dict:
    return _load_json(_path("traffic", name, ".json"))


def _module(kind: str, name: str):
    path = _path(kind, name, ".py")
    mod_name = f"bench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def generator(name: str):
    return _module("generators", name)


def driver(name: str):
    return _module("drivers", name)


def metric(name: str):
    return _module("metrics", name)


def cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic) of a cell by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    return w, config(w["config"]), traffic(w["traffic"])
