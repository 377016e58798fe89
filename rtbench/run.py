#!/usr/bin/env python3
"""The benchmark of rray_tpu_torch on NVIDIA GPUs.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It sets up the cell that BENCHMARK.json
names (configuration and traffic mix), drives the port's user entry for
`--seconds`, checks what the window produced against the plain
reference (rtbench/reference/), and prints one JSON line last on
standard output: correct, attempted, failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer metrics), device,
with --trace 1 a breakdown, and last the compared numbers beside their
limits, which also end standard error. Without CUDA, or with fewer
cards than the cell asks for, it exits 2 and prints no result; with a
module of JAX or the JAX package loaded once everything else is done,
it exits 1 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def written() -> int:
    """Bytes this process handed to write() (/proc/self/io wchar), or -1
    where the kernel does not say."""
    try:
        with open("/proc/self/io") as f:
            return int(next(line.split()[1] for line in f
                            if line.startswith("wchar")))
    except (OSError, StopIteration, ValueError):
        return -1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from rtbench.harness import core
    from rtbench.harness.registry import Registry

    registry = Registry()
    chips = int(registry.cell(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result, checks = core.run_cell(args.workload, args.seed,
                                       args.seconds, bool(args.trace),
                                       "cuda", registry, t_start=T_START)
    except RuntimeError as e:
        print(f"rtbench: {e}", file=sys.stderr)
        return 1
    print(f"rtbench: this process wrote {written()} bytes", file=sys.stderr)
    return finish(result, checks)


def finish(result, checks) -> int:
    """The last look, once the window, the check and the metric readers
    are done: with a module of JAX or the JAX package loaded, exit 1 and
    print no result; else the compared numbers on standard error and
    the result line on standard output."""
    from rtbench.harness.core import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"rtbench: modules of JAX or the JAX package are loaded: "
              f"{', '.join(found)}; no result", file=sys.stderr)
        return 1
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if value <= limit else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
