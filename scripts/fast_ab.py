#!/usr/bin/env python3
"""Time the fast node's BVH kernel (B4) and area-shadow kernel (B5)
against another checkout's, in turns on one card, and sweep the BVH
kernel's leaf size and table placement.

    python3 scripts/fast_ab.py [--other DIR] [--leaves 4,8,16]

The inputs are the ones chip_smoke.py gives these kernels: mesh4b's
camera rays (closest hit seeded with the analytic hit, then shadow rays
toward the light), area4b's first shadow call of the fast node (a row
of 5 samples for each of 480 k origins), a 49,612-triangle sphere
(closest and shadow), and area21's first area-shadow call. DIR is the
root of another checkout of this repository (for example the parent
commit unpacked with `git archive`), imported under another name and
built from its own sources; its wrappers build their tables per call,
as they did. For each case the script checks that both kernels give the
same outputs, then times each kernel's device time per launch
(torch.profiler) in turns other, this, this, other, and prints the mean
of each side's turns and their ratio. The sweep then times this
checkout's BVH kernel with trees of each leaf size, with the tables
staged in shared memory where they fit and read through L1, in turns,
with the outputs held equal. Needs a CUDA card; exits non-zero without
one.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))


def device_ms(torch, cs, fn, name):
    """Device time per launch of the kernels whose name holds `name`."""
    _, reps = cs.window_ms(torch, fn)
    return cs.kernel_ms(torch, fn, name, reps)


def same(torch, a, b):
    a, b = (x if isinstance(x, (tuple, list)) else (x,) for x in (a, b))
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def cases(torch, cs, paths):
    """name -> (positional arguments, keyword arguments, this scene's BVH
    tables or None) of a call of the BVH or area-shadow wrapper, from the
    inputs the fast node gives the kernels."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.kernels import analytic, bvh
    from rray_tpu_torch.ops import jitter, soa
    from rray_tpu_torch.render import integrator

    out = {}
    for name in ("mesh4b", "mesh50b"):
        scene, (ro, rd) = cs.camera_scene(paths[name], torch)
        rays = ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z))
        tri, aux = soa._tri_comps(scene, True), soa._tri_aux(scene)
        t_an = soa.analytic_closest(scene, ro, rd)[0]
        tables = soa._bvh_tables(scene)
        closest = (rays[0], rays[1], tri)
        kw = dict(dist=t_an, aux=aux)
        out[f"{name} closest"] = (closest, kw, tables)
        t_hit = torch.minimum(t_an, bvh.bvh_closest_triangle(
            *closest, **kw, tables=tables)[0])
        light = scene.lights[0].position
        t_back = torch.where(torch.isfinite(t_hit), t_hit - 1e-3, 0.0)
        over = [o + d * t_back for o, d in zip(rays[0], rays[1])]
        to = [light[j] - over[j] for j in range(3)]
        dist = torch.sqrt(to[0] * to[0] + to[1] * to[1] + to[2] * to[2])
        out[f"{name} shadow"] = ((tuple(over), tuple(c / dist for c in to),
                                  tri[:9]), dict(dist=dist, any_hit=True),
                                 tables)
    scene, (ro, rd) = cs.camera_scene(paths["area4b"], torch)
    seeds = jitter.seed_table(0, 0, len(scene.lights))[0].tolist()
    calls = []
    kernel = bvh.bvh_closest_triangle
    bvh.bvh_closest_triangle = lambda *a, **k: (
        k.get("any_hit") and calls.append((a, k))) or kernel(*a, **k)
    try:
        integrator._fast_node_eval(scene, ro, rd, RenderSettings(), seeds)
    finally:
        bvh.bvh_closest_triangle = kernel
    a, k = calls[0]
    out["area4b shadow call"] = (a, {key: v for key, v in k.items()
                                     if key != "tables"}, k["tables"])
    scene, (ro, rd) = cs.camera_scene(paths["area21"], torch)
    calls = []
    kernel = analytic.area_shadow_fraction
    analytic.area_shadow_fraction = lambda *a, **k: calls.append(
        a + (k["bounds"],)) or kernel(*a, **k)
    try:
        integrator._fast_node_eval(scene, ro, rd, RenderSettings(), seeds)
    finally:
        analytic.area_shadow_fraction = kernel
    out["area21"] = (calls[0], {}, None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other")
    ap.add_argument("--leaves", default="4,8,16")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--cases", default="",
                    help="time only cases whose name holds one of these "
                         "comma-separated words")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    import chip_smoke as cs
    import whitted_ab
    from rray_tpu_torch.io import mesh_scenes
    from rray_tpu_torch.kernels import analytic, build, bvh

    build.load_library()
    other = None
    if args.other:
        pkg = whitted_ab.load_as("rray_other", os.path.abspath(args.other))
        other = {m: importlib.import_module(f"{pkg.__name__}.kernels.{m}")
                 for m in ("build", "bvh", "analytic")}
        other["build"].load_library()
    print(whitted_ab.card())
    tmp = tempfile.TemporaryDirectory()
    paths = {name: mesh_scenes.write_scene(tmp.name, name, **kw)
             for name, kw in {**cs.SCENES, **cs.PHASE_SCENES}.items()}
    for name, (a, kw, tables) in cases(torch, cs, paths).items():
        if args.cases and not any(w in name for w in args.cases.split(",")):
            continue
        if name == "area21":
            this = functools.partial(analytic.area_shadow_fraction, *a)
            that = other and functools.partial(  # it takes no bounds
                other["analytic"].area_shadow_fraction, *a[:6])
            filters = ("area_kernel", "area_kernel")
        else:
            this = functools.partial(bvh.bvh_closest_triangle, *a, **kw,
                                     tables=tables)
            that = other and functools.partial(
                other["bvh"].bvh_closest_triangle, *a, **kw)
            filters = ("bvh_", "bvh_")
        if other:
            equal = same(torch, this(), that())
            times = {"this": [], "other": []}
            for side in ("other", "this", "this", "other"):
                fn, flt = (this, filters[0]) if side == "this" else (
                    that, filters[1])
                times[side].append(device_ms(torch, cs, fn, flt))
            t, o = (sum(times[k]) / 2 for k in ("this", "other"))
            print(f"ab {name}: this {t:.5f} ms, other {o:.5f} ms, "
                  f"this/other {t / o:.4f}, outputs equal {equal}, turns "
                  f"this {times['this']} other {times['other']} "
                  f"[{whitted_ab.card()}]", flush=True)
        if name == "area21" or args.no_sweep:
            continue
        # The sweep: leaf sizes, staged (where the tables fit) and L1.
        variants = {}
        for leaf in (int(x) for x in args.leaves.split(",")):
            t = bvh.card_tables(a[2], kw.get("aux", ()), leaf)
            for staged in (True, False):
                if staged and 4 * t.block.numel() > bvh.STAGE_BYTES:
                    continue
                variants[(leaf, staged)] = functools.partial(
                    bvh.bvh_closest_triangle, *a, **kw, tables=t)
        limit = bvh.STAGE_BYTES
        want = None
        for key, fn in variants.items():
            bvh.STAGE_BYTES = limit if key[1] else 0
            got = fn()
            want = got if want is None else want
            if not same(torch, got, want):
                raise SystemExit(f"sweep {name} {key}: outputs differ")
        order = list(variants) + list(reversed(variants))
        times = {key: [] for key in variants}
        for key in order:
            bvh.STAGE_BYTES = limit if key[1] else 0
            times[key].append(device_ms(torch, cs, variants[key], "bvh_"))
        bvh.STAGE_BYTES = limit
        line = ", ".join(f"leaf {leaf} {'staged' if st else 'L1'} "
                         f"{sum(v) / len(v):.5f} ms"
                         for (leaf, st), v in times.items())
        print(f"sweep {name}: {line} (outputs equal) "
              f"[{whitted_ab.card()}]", flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
