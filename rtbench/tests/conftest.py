"""rtbench's tests: the CPU ones run anywhere; those marked `cuda` need
a card and skip without one (decided in the fixture, never at import)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Tiny sizes of each cell for runs on the CPU (the port's plain versions).
SMALL = {
    "csg_showcase.turntable_aa5": {"config": {"width": 24, "height": 14},
                                   "mix": {"aa": 2, "check_pixels": 48}},
    "glass.turntable": {"config": {"width": 24, "height": 18},
                        "mix": {"check_pixels": 48}},
    "glass.adam": {"config": {"width": 24, "height": 18},
                   "mix": {"check_rows": 9}},
}


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture
def registry():
    """BENCHMARK.json's cells, and those held out of it (held_out/*.json:
    entries of the same form, measured but too noisy on the host to be
    bound), so that their checks keep being tested."""
    import json

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
