"""Where the benchmark finds each piece, by the name BENCHMARK.json gives.

    configs/<config>.json      a configuration: sizes, scene, assets
    traffic/<mix>.json         a traffic mix: parameters, and the runner
                               ("runner": name) that runs it
    runners/<runner>.py        the code of a kind of traffic
    metrics/<metric>.py        one metric's reader: read(run) -> number
                               or None, and the program's counters it
                               reads (COUNTERS, optional)
    limits/<cell>.json         the limits of a cell's correctness numbers

A new configuration, mix, metric or cell is a new file and an entry in
BENCHMARK.json; no file that is there needs an edit.
"""
from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Registry:
    """The pieces under `bench_dir`, and the BENCHMARK.json at `root`:
    the one list of cells and metrics."""

    def __init__(self, root: str = ROOT, bench_dir: str = BENCH_DIR):
        self.root = root
        self.bench_dir = bench_dir
        self._modules = {}

    def benchmark(self) -> dict:
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            return json.load(f)

    def _json(self, folder: str, name: str) -> dict:
        with open(os.path.join(self.bench_dir, folder, f"{name}.json")) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        for cell in self.benchmark()["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def asset_path(self, rel: str) -> str:
        """A file a configuration names, relative to configs/."""
        return os.path.join(self.bench_dir, "configs", rel)

    def mix(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> dict:
        return self._json("limits", cell)

    def _module(self, folder: str, name: str):
        key = (folder, name)
        if key not in self._modules:
            path = os.path.join(self.bench_dir, folder, f"{name}.py")
            if not os.path.isfile(path):
                raise KeyError(f"no {folder[:-1]} {name!r} ({path})")
            spec = importlib.util.spec_from_file_location(
                f"rtbench_{folder}_{name.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def runner(self, name: str):
        return self._module("runners", name)

    def metric(self, name: str):
        return self._module("metrics", name)

    def metrics_for(self, cell: str, trace: bool) -> list:
        """The entries of BENCHMARK.json's end_to_end (trace off) or
        per_layer (trace on) that the cell reports: those that list it
        under "workloads", and those without the key."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.benchmark()[key]
                if "workloads" not in m or cell in m["workloads"]]

    def counters(self, cell: str) -> list:
        """The program counters ("module:attribute") that the cell's
        metrics read, end-to-end and per-layer, each once."""
        paths = []
        for m in self.metrics_for(cell, False) + self.metrics_for(cell, True):
            for path in getattr(self.metric(m["name"]), "COUNTERS", ()):
                if path not in paths:
                    paths.append(path)
        return paths

    def names(self, folder: str, suffix: str) -> list:
        path = os.path.join(self.bench_dir, folder)
        if not os.path.isdir(path):
            return []
        return sorted(f[: -len(suffix)] for f in os.listdir(path)
                      if f.endswith(suffix))
