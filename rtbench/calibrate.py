#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card.

    python3 rtbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--fault-seeds 7,8,9] [--items N] \
        [--alter NAME:POINTER=JSON ... --alter-seeds 7,8,9]

For each seed, in one process: the cell's set-up, N items through the
window's own call (by default as many as a run compares), and the
check, as a run makes them. `--control-seeds`: the same, with the
control in the program's place (the plain reference computed in
bfloat16, the precision below the configurations' float32).
`--fault-seeds` (training cells): the reference with half of the rows
left out of its loss in the program's place. `--alter` (turntable
cells): a fault confined to one feature of the scene, planted in the
program: the port's YAML loader reads each frame with the value at
POINTER (a JSON pointer into the frame's YAML, such as
/scene/2/material/pattern/transforms/0/amount) replaced by JSON, while
the reference reads the frame as written; each alteration on each of
`--alter-seeds`. One JSON line per reading, then a summary: per
number the largest sound reading (the lower one), the smallest control
or fault reading (the upper one), and the smallest reading of each
alteration. The benchmark's runs do not run this.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def alteration(text):
    """NAME:POINTER=JSON -> (name, [keys of the pointer], value)."""
    name, _, rest = text.partition(":")
    pointer, _, value = rest.partition("=")
    keys = [int(k) if k.isdigit() else k for k in pointer.split("/")[1:]]
    return name, keys, json.loads(value)


@contextlib.contextmanager
def altered_loader(keys, value):
    """The port's `api.load_scene_file` reads a copy of each YAML with the
    value at `keys` replaced, written beside it (so its assets resolve)."""
    import yaml

    from rray_tpu_torch import api

    orig = api.load_scene_file

    def load(path):
        with open(path) as f:
            doc = yaml.safe_load(f)
        node = doc
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = value
        out = f"{path}.altered.yaml"
        with open(out, "w") as f:
            yaml.safe_dump(doc, f)
        return orig(out)

    api.load_scene_file = load
    try:
        yield
    finally:
        api.load_scene_file = orig


def reading(registry, cell, seed, items, device, alter=None, **kind):
    from rtbench.harness import core

    import torch

    entry = registry.cell(cell)
    cfg = registry.config(entry["config"])
    mix = registry.mix(entry["traffic"])
    runner = registry.runner(mix["runner"])
    run = core.Run(cell, cfg, mix, seed, 0.0, False, device, registry,
                   unit=runner.UNIT)
    t0 = time.perf_counter()
    state = runner.setup(run)
    try:
        n = items or (mix.get("check_frames", 0) + 1)
        with (altered_loader(*alter) if alter else contextlib.nullcontext()):
            for i in range(n):
                runner.step(state, i)
        t1 = time.perf_counter()
        numbers = runner.check(state, **kind)
        t2 = time.perf_counter()
        extra = getattr(state, "losses_compared", None)
        if extra is not None:  # (program's, reference's) followed losses
            numbers = {**numbers, "losses": extra}
    finally:
        runner.close(state)
        del state
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
    return numbers, t1 - t0, t2 - t1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--alter", type=alteration, action="append", default=[])
    p.add_argument("--alter-seeds", type=seeds, default=[])
    p.add_argument("--items", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from rtbench.harness.registry import Registry

    registry = Registry()
    limits = registry.limits(args.workload)
    plan = ([(s, "sound", {}) for s in args.seeds]
            + [(s, "control", {"control": True}) for s in args.control_seeds]
            + [(s, "half", {"fault": "half"}) for s in args.fault_seeds]
            + [(s, f"alter:{name}", {"alter": (keys, value)})
               for name, keys, value in args.alter for s in args.alter_seeds])
    got = {}
    for seed, kind, kw in plan:
        numbers, run_s, check_s = reading(registry, args.workload, seed,
                                          args.items, args.device, **kw)
        got.setdefault(kind, []).append(numbers)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "kind": kind, "numbers": numbers,
                          "setup_and_items_s": run_s, "check_s": check_s}),
              flush=True)
    summary = {}
    for name in limits:
        sound = [n[name] for n in got.get("sound", ())]
        upper = [n[name] for k in ("control", "half")
                 for n in got.get(k, ())]
        summary[name] = {"lower": max(sound) if sound else None,
                         "upper": min(upper) if upper else None,
                         "limit": limits[name]}
        for kind, numbers in got.items():
            if kind.startswith("alter:"):
                summary[name][kind] = min(n[name] for n in numbers)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
