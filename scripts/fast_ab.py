#!/usr/bin/env python3
"""Time the fast node's kernels, the triangle kernels (B2 closest_triangle,
B3 any_triangle), the BVH kernel (B4) and the area-shadow kernel (B5),
against another checkout's, in turns on one card, and sweep the triangle
kernels' cull group and the BVH kernel's leaf size and table placement.

    python3 scripts/fast_ab.py [--other DIR] [--groups 4,8,16,0]
        [--leaves 4,8,16] [--no-sweep] [--cases mesh9,area9]

The inputs are the ones chip_smoke.py gives these kernels: the camera
rays of mesh9 (nine 60-triangle spheres: B2, B3), mesh9k (1008
triangles: B2, B3), mesh4b and a 49,612-triangle sphere (B4), closest
hit seeded with the analytic hit, then shadow rays toward the light;
area9's and area4b's first shadow call of the fast node (a row of 5
samples for each of 480 k origins: B3, B4), and area21's first
area-shadow call (B5). DIR is the root of another checkout of this
repository (for example the parent commit unpacked with `git archive`),
imported under another name and built from its own sources; its
wrappers get the same arguments without this checkout's tables, and
build theirs as they did. For each case the script checks that both
kernels give the same outputs, then times each kernel's device time per
launch (torch.profiler) in turns other, this, this, other, and prints
the mean of each side's turns and their ratio. The sweeps then time this
checkout's kernel with each cull group (B2, B3; 0 is rray_tpu's
chunk_size, one level of boxes) or leaf size (B4), with the tables
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

# Each case's wrapper (module, function) and its kernels' name in the
# profiler.
WRAPPERS = {"closest": ("triangles", "closest_triangle", "closest_kernel"),
            "any": ("triangles", "any_triangle", "any_kernel"),
            "bvh": ("bvh", "bvh_closest_triangle", "bvh_"),
            "area": ("analytic", "area_shadow_fraction", "area_kernel")}


def device_ms(torch, cs, fn, name):
    """Device time per launch of the kernels whose name holds `name`."""
    _, reps = cs.window_ms(torch, fn)
    return cs.kernel_ms(torch, fn, name, reps)


def same(torch, a, b):
    a, b = (x if isinstance(x, (tuple, list)) else (x,) for x in (a, b))
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def first_call(torch, cs, path, module, attr, keep):
    """The positional and keyword arguments of the first call of
    module.attr for which keep(kwargs) holds, in the fast node's primary
    level on `path`'s camera rays."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.ops import jitter
    from rray_tpu_torch.render import integrator

    scene, (ro, rd) = cs.camera_scene(path, torch)
    seeds = jitter.seed_table(0, 0, len(scene.lights))[0].tolist()
    calls = []
    kernel = getattr(module, attr)
    setattr(module, attr, lambda *a, **k: (
        keep(k) and calls.append((a, k))) or kernel(*a, **k))
    try:
        integrator._fast_node_eval(scene, ro, rd, RenderSettings(), seeds)
    finally:
        setattr(module, attr, kernel)
    return calls[0]


def cases(torch, cs, paths):
    """name -> (wrapper kind, positional arguments, keyword arguments
    without tables, this scene's tables or None) of a call of a fast-node
    kernel's wrapper, from the inputs the fast node gives it."""
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.kernels import analytic, bvh, triangles
    from rray_tpu_torch.ops import soa

    out = {}
    for name in ("mesh9", "mesh9k", "mesh4b", "mesh50b"):
        scene, (ro, rd) = cs.camera_scene(paths[name], torch)
        rays = ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z))
        tri, aux = soa._tri_comps(scene, True), soa._tri_aux(scene)
        t_an = soa.analytic_closest(scene, ro, rd)[0]
        closest = (rays[0], rays[1], tri)
        if scene.counts[6] >= RenderSettings().bvh_min_tris:
            tables = soa._bvh_tables(scene)
            kw = dict(dist=t_an, aux=aux)
            out[f"{name} closest"] = ("bvh", closest, kw, tables)
            t_hit = bvh.bvh_closest_triangle(*closest, **kw,
                                             tables=tables)[0]
        else:
            tables = soa._tri_tables(scene)
            kw = dict(t_init=t_an, aux=aux)
            out[f"{name} closest"] = ("closest", closest, kw, tables)
            t_hit = triangles.closest_triangle(*closest, **kw,
                                               tables=tables)[0]
        t_hit = torch.minimum(t_an, t_hit)
        light = scene.lights[0].position
        t_back = torch.where(torch.isfinite(t_hit), t_hit - 1e-3, 0.0)
        over = [o + d * t_back for o, d in zip(rays[0], rays[1])]
        to = [light[j] - over[j] for j in range(3)]
        dist = torch.sqrt(to[0] * to[0] + to[1] * to[1] + to[2] * to[2])
        srays = (tuple(over), tuple(c / dist for c in to), tri[:9])
        if out[f"{name} closest"][0] == "bvh":
            out[f"{name} shadow"] = ("bvh", srays,
                                     dict(dist=dist, any_hit=True), tables)
        else:
            out[f"{name} shadow"] = ("any", srays + (dist,), {}, tables)
    a, k = first_call(torch, cs, paths["area9"], triangles, "any_triangle",
                      lambda k: True)
    out["area9 shadow call"] = ("any", a, {}, k["tables"])
    a, k = first_call(torch, cs, paths["area4b"], bvh, "bvh_closest_triangle",
                      lambda k: k.get("any_hit"))
    out["area4b shadow call"] = ("bvh", a, {key: v for key, v in k.items()
                                            if key != "tables"}, k["tables"])
    a, k = first_call(torch, cs, paths["area21"], analytic,
                      "area_shadow_fraction", lambda k: True)
    out["area21"] = ("area", a + (k["bounds"],), {}, None)
    return out


def sweep(torch, cs, name, kind, a, kw, sizes):
    """Time this checkout's kernel with tables of each cull group (B2, B3)
    or leaf size (B4), staged where they fit and through L1, in turns,
    the outputs held equal."""
    from rray_tpu_torch.kernels import bvh, triangles

    mod = bvh if kind == "bvh" else triangles
    wrapper = getattr(mod, WRAPPERS[kind][1])
    variants = {}
    for size in sizes:
        if kind == "bvh":
            t = bvh.card_tables(a[2], kw.get("aux", ()), size)
            words = t.block.numel()
        else:
            size = size or triangles.chunk_size(a[2][0].shape[0])
            t = triangles.chunk_tables(a[2], kw.get("aux", ()), size)
            words = t.words
        for staged in (True, False):
            if staged and 4 * words > mod.STAGE_BYTES:
                continue
            variants[(size, staged)] = functools.partial(wrapper, *a, **kw,
                                                         tables=t)
    limit = mod.STAGE_BYTES
    want = None
    try:
        for key, fn in variants.items():
            mod.STAGE_BYTES = limit if key[1] else 0
            got = fn()
            want = got if want is None else want
            if not same(torch, got, want):
                raise SystemExit(f"sweep {name} {key}: outputs differ")
        times = {key: [] for key in variants}
        for key in list(variants) + list(reversed(variants)):
            mod.STAGE_BYTES = limit if key[1] else 0
            times[key].append(device_ms(torch, cs, variants[key],
                                        WRAPPERS[kind][2]))
    finally:
        mod.STAGE_BYTES = limit
    what = "leaf" if kind == "bvh" else "group"
    return ", ".join(f"{what} {size} {'staged' if st else 'L1'} "
                     f"{sum(v) / len(v):.5f} ms"
                     for (size, st), v in times.items())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other")
    ap.add_argument("--groups", default="4,8,16,0")
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
    from rray_tpu_torch.kernels import analytic, build, bvh, triangles

    build.load_library()
    mods = {"triangles": triangles, "bvh": bvh, "analytic": analytic}
    other = None
    if args.other:
        pkg = whitted_ab.load_as("rray_other", os.path.abspath(args.other))
        other = {m: importlib.import_module(f"{pkg.__name__}.kernels.{m}")
                 for m in ("build", *mods)}
        other["build"].load_library()
    print(whitted_ab.card())
    tmp = tempfile.TemporaryDirectory()
    paths = {name: mesh_scenes.write_scene(tmp.name, name, **kw)
             for name, kw in {**cs.SCENES, **cs.PHASE_SCENES}.items()}
    sizes = {"bvh": [int(x) for x in args.leaves.split(",")],
             "closest": [int(x) for x in args.groups.split(",")]}
    sizes["any"] = sizes["closest"]
    for name, (kind, a, kw, tables) in cases(torch, cs, paths).items():
        if args.cases and not any(w in name for w in args.cases.split(",")):
            continue
        module, attr, kname = WRAPPERS[kind]
        if kind == "area":
            this = functools.partial(analytic.area_shadow_fraction, *a)
            that = other and functools.partial(  # it takes no bounds
                other["analytic"].area_shadow_fraction, *a[:6])
        else:
            this = functools.partial(getattr(mods[module], attr), *a, **kw,
                                     tables=tables)
            that = other and functools.partial(
                getattr(other[module], attr), *a, **kw)
        if other:
            equal = same(torch, this(), that())
            times = {"this": [], "other": []}
            for side in ("other", "this", "this", "other"):
                fn = this if side == "this" else that
                times[side].append(device_ms(torch, cs, fn, kname))
            t, o = (sum(times[k]) / 2 for k in ("this", "other"))
            print(f"ab {name}: this {t:.5f} ms, other {o:.5f} ms, "
                  f"this/other {t / o:.4f}, outputs equal {equal}, turns "
                  f"this {times['this']} other {times['other']} "
                  f"[{whitted_ab.card()}]", flush=True)
        if kind == "area" or args.no_sweep:
            continue
        line = sweep(torch, cs, name, kind, a, kw, sizes[kind])
        print(f"sweep {name}: {line} (outputs equal) "
              f"[{whitted_ab.card()}]", flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
