"""rtbench's tests: the CPU ones run anywhere; those marked `cuda` need
a card and skip without one (decided in the fixture, never at import)."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def small_sizes(folder: str) -> dict:
    """Each cell's tiny size for runs on the CPU (the port's plain
    versions): small/<cell>.json, {"config": {...}, "mix": {...}}, the
    keys that override the cell's configuration and mix."""
    sizes = {}
    for f in sorted(os.listdir(folder)):
        if f.endswith(".json"):
            with open(os.path.join(folder, f)) as fh:
                sizes[f[: -len(".json")]] = json.load(fh)
    return sizes


SMALL = small_sizes(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "small"))


def control_readings(registry, cell: str, seed: int = 17):
    """(sound numbers, control numbers, limits) of a cell at its small
    size: set-up, two items through the window's own call, then the
    check, and the check with the control in the program's place."""
    from rtbench.harness import core

    cfg = {**registry.config(registry.cell(cell)["config"]),
           **SMALL[cell]["config"]}
    mix = {**registry.mix(registry.cell(cell)["traffic"]),
           **SMALL[cell]["mix"]}
    runner = registry.runner(mix["runner"])
    run = core.Run(cell, cfg, mix, seed, 0.2, False, "cpu", registry,
                   unit=runner.UNIT)
    state = runner.setup(run)
    try:
        for i in range(2):
            runner.step(state, i)
        sound = runner.check(state)
        low = runner.check(state, control=True)
    finally:
        runner.close(state)
    return sound, low, registry.limits(cell)


# Every cell of the BENCHMARK.json beside `root`, run in a process of its
# own whose `rtbench` is the one under `root`: untraced and traced, each
# correct, and the control not correct; the last line of its output says
# what each run gave and which top-level modules were loaded at the end.
EVERY_CELL = """
import json, sys
sys.path[:0] = [{root!r}, {tests!r}]
from conftest import SMALL, control_readings
from rtbench.harness import core
from rtbench.harness.registry import Registry
reg = Registry()
assert reg.root == {root!r}, reg.root
runs = {{}}
for cell in [w["name"] for w in reg.benchmark()["workloads"]]:
    runs[cell] = []
    for trace in (False, True):
        r, _ = core.run_cell(cell, 5, 0.2, trace, "cpu", reg,
                             overrides=SMALL[cell])
        assert r["correct"], (cell, trace, r["checks"])
        runs[cell].append(r)
    sound, low, limits = control_readings(reg, cell)
    assert all(v <= limits[k] for k, v in sound.items()), (cell, sound)
    assert any(not v <= limits[k] for k, v in low.items()), (cell, low)
print(json.dumps({{"runs": runs,
                  "modules": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def run_every_cell(root: str) -> dict:
    """EVERY_CELL over the checkout at `root`."""
    import subprocess

    code = EVERY_CELL.format(root=root,
                             tests=os.path.join(root, "rtbench", "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def with_held_out():
    """BENCHMARK.json's cells, and those held out of it (held_out/*.json:
    entries of the same form, measured but too noisy on the host to be
    bound), so that their checks keep being tested."""
    from rtbench.harness.registry import Registry

    class WithHeldOut(Registry):
        def benchmark(self):
            bench = super().benchmark()
            for name in self.names("held_out", ".json"):
                with open(os.path.join(self.bench_dir, "held_out",
                                       f"{name}.json")) as f:
                    held = json.load(f)
                for key in ("workloads", "end_to_end", "per_layer"):
                    bench[key] = bench[key] + held[key]
            return bench

    return WithHeldOut()


def cells(runner=None):
    """The names of the cells, held-out ones too, whose mix `runner`
    runs (every cell without `runner`)."""
    reg = with_held_out()
    return [w["name"] for w in reg.benchmark()["workloads"]
            if runner is None or reg.mix(w["traffic"])["runner"] == runner]


@pytest.fixture
def registry():
    return with_held_out()
