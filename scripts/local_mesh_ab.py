#!/usr/bin/env python3
"""Where a local mesh's frame time goes, on the cards of this machine.

Usage (GPU machine, from the repository root):

    python3 scripts/local_mesh_ab.py [--entries 4] [--rounds 3]

A local mesh (rray_tpu_torch.parallel.mesh.make_mesh(devices=[...]),
entry i on cuda:(i % device_count)) renders glass, config 3, mesh4b,
glass4 and area21 at 800x600 through render_sharded, in rounds of
turns (forward, then backward order), against the single-process
frame; every frame must equal the single-process frame bit for bit.
Modes, each a run_entries in place of parallel/mesh.py's:

    single_first    render() on a fresh copy of the scene (its tables
                    built in the call)
    single_kept     render() on one scene (its tables kept)
    turn_first      mesh.run_entries (the entries in turn from this
                    thread, each on its device's current stream) over a
                    fresh copy of the scene: every entry builds its
                    replica's tables in the call
    turn_kept       the same over one scene (the replicas and tables
                    kept in its cache)
    turn_streams    in turn, each entry on a new stream, fresh scene
    threads         a thread and a new stream per entry (the design
                    first written for the local mesh), fresh scene

Prints one line per scene with the times of every round (host clock
between synchronizes, ms) and the card's name and power limit, then a
JSON line of the medians.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("glass", "area", "mesh4b", "glass4", "area21")


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def in_turn_on_new_streams(torch):
    """The entries in turn, each on a new stream of its device."""
    def run(mesh, fn):
        out = []
        for i, d in enumerate(mesh.devices):
            caller = torch.cuda.current_stream(d)
            s = torch.cuda.Stream(device=d)
            s.wait_stream(caller)
            with torch.cuda.device(d), torch.cuda.stream(s):
                out.append(fn(i, d))
            caller.wait_stream(s)
            out[-1].record_stream(caller)
        return out
    return run


def threads_and_streams(torch):
    """A thread per entry, each on a new stream of its device."""
    def run(mesh, fn):
        devices = mesh.devices
        streams = [torch.cuda.Stream(device=d) for d in devices]
        for d, s in zip(devices, streams):
            s.wait_stream(torch.cuda.current_stream(d))
        grad = torch.is_grad_enabled()

        def entry(i):
            with torch.set_grad_enabled(grad), \
                    torch.cuda.device(devices[i]), \
                    torch.cuda.stream(streams[i]):
                return fn(i, devices[i])

        with cf.ThreadPoolExecutor(len(devices)) as pool:
            futures = [pool.submit(entry, i) for i in range(len(devices))]
            out = [f.result() for f in futures]
        for d, s in zip(devices, streams):
            torch.cuda.current_stream(d).wait_stream(s)
        for r in out:
            r.record_stream(torch.cuda.current_stream(r.device))
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--entries", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("local_mesh_ab: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.io import mesh_scenes
    from rray_tpu_torch.kernels import build
    from rray_tpu_torch.parallel import mesh as pmesh
    from rray_tpu_torch.render import integrator

    print(card())
    build.load_library()
    n = torch.cuda.device_count()
    mesh = pmesh.make_mesh(devices=[f"cuda:{i % n}"
                                    for i in range(args.entries)])
    settings = RenderSettings()
    shipped = pmesh.run_entries
    runners = {"turn_first": shipped, "turn_kept": shipped,
               "turn_streams": in_turn_on_new_streams(torch),
               "threads": threads_and_streams(torch)}
    medians = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(ROOT, p) for k, p in cs.EXAMPLES}
        paths.update({k: mesh_scenes.write_scene(tmp, k, **cs.SCENES[k])
                      for k in ("mesh4b", "glass4", "area21")})
        for name in SCENES:
            scene, cam = cs.camera_data(paths[name], torch,
                                        (cs.WIDTH, cs.HEIGHT))

            def single(kept):
                with torch.no_grad():
                    return integrator.render(
                        scene if kept else pmesh.replica(scene, mesh.device),
                        cam, settings)

            def sharded(mode):
                pmesh.run_entries = runners[mode]
                try:
                    return pmesh.render_sharded(
                        scene if mode == "turn_kept"
                        else pmesh.replica(scene, mesh.device), cam, mesh,
                        settings)
                finally:
                    pmesh.run_entries = shipped

            fns = {"single_first": lambda: single(False),
                   "single_kept": lambda: single(True),
                   **{m: (lambda m=m: sharded(m)) for m in runners}}
            want = single(False)
            single(True)  # the kept modes' tables, built before the rounds
            pmesh.render_sharded(scene, cam, mesh, settings)
            times = {m: [] for m in fns}
            for r in range(args.rounds):
                for mode in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    image = fns[mode]()
                    torch.cuda.synchronize()
                    times[mode].append(round(
                        (time.perf_counter() - t0) * 1e3, 3))
                    if not torch.equal(image, want):
                        print(f"{name} {mode}: the frame differs",
                              file=sys.stderr)
                        return 1
            medians[name] = {m: statistics.median(v)
                             for m, v in times.items()}
            print(f"{name} {cs.WIDTH}x{cs.HEIGHT}, {args.entries} entries "
                  f"on {len(set(mesh.devices))} card(s): "
                  f"{json.dumps(times)} [{card()}]", flush=True)
            del scene, cam, want
            torch.cuda.empty_cache()
    print(json.dumps(medians))
    return 0


if __name__ == "__main__":
    sys.exit(main())
