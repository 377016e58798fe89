"""Mesh scenes for the rray_tpu_torch mesh tests, written as YAML + OBJ
files (the form the CLI reads): a checker floor, a point light at
(-10, 10, -10) and the camera of rray_tpu's mesh benchmark cells
(benchmarks/bench_suite.py config4), with procedural UV-sphere meshes
(benchmarks/bench_mesh.py::uv_sphere_obj)."""
import os
import sys

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(BASE, "benchmarks"))
from bench_mesh import uv_sphere_obj  # noqa: E402

FLOOR = """  - type: plane
    material:
      pattern:
        type: checker
        color_a: [1, 1, 1]
        color_b: [0.2, 0.2, 0.2]
      specular: 0
      reflective: {reflective}
"""
MESH = """  - type: obj_file
    obj_file: {obj}
    transforms:
{transforms}    material:
      pattern:
        type: solid
        color: [{r}, {g}, {b}]
"""
SPHERE = """  - type: sphere
    transforms:
      - type: scale
        amount: [0.2, 0.2, 0.2]
      - type: translate
        amount: [{x}, 0.2, {z}]
    material:
      pattern:
        type: solid
        color: [0.3, 0.6, 0.9]
"""
HEADER = """camera:
  fov: 60
  from: [0, 1.5, -4]
  to: [0, 0.7, 0]
  up: [0, 1, 0]
lights:
  - type: point
    position: [-10, 10, -10]
    color: [1, 1, 1]
scene:
"""
NINE_COLORS = [(0.9, 0.2, 0.2), (0.2, 0.9, 0.2), (0.2, 0.2, 0.9),
               (0.9, 0.9, 0.2), (0.9, 0.2, 0.9), (0.2, 0.9, 0.9),
               (0.6, 0.4, 0.2), (0.4, 0.2, 0.6), (0.8, 0.8, 0.8)]


def _transforms(*ts):
    return "".join(f"      - type: {kind}\n        amount: [{a}, {b}, {c}]\n"
                   for kind, (a, b, c) in ts)


def write_scene(tmp, name, lat_lon=(11, 11), reflective=0.0, grid=False,
                spheres=0, smooth=True):
    """Write `name`.yaml (+ OBJ) under `tmp` and return its path.

    One mesh of uv_sphere_obj(*lat_lon) at (0, 1, 0), or none when
    lat_lon is None; grid=True places nine meshes of nine colours on a
    3x3 grid at scale 0.3 instead; `spheres` adds that many small
    analytic spheres; smooth=False drops the vertex normals (flat
    triangles)."""
    body = FLOOR.format(reflective=reflective)
    if lat_lon is not None:
        obj = os.path.join(tmp, f"{name}.obj")
        text = uv_sphere_obj(*lat_lon)
        if not smooth:
            text = "\n".join(" ".join(tok.split("/")[0]
                                      for tok in line.split())
                             for line in text.splitlines()
                             if not line.startswith("vn"))
        with open(obj, "w") as f:
            f.write(text)
        if grid:
            for k, (r, g, b) in enumerate(NINE_COLORS):
                x, z = (k % 3 - 1) * 0.9, (k // 3 - 1) * 0.9
                body += MESH.format(obj=obj, r=r, g=g, b=b,
                                    transforms=_transforms(
                                        ("scale", (0.3, 0.3, 0.3)),
                                        ("translate", (x, 0.5, z))))
        else:
            body += MESH.format(obj=obj, r=0.7, g=0.5, b=0.2,
                                transforms=_transforms(
                                    ("translate", (0, 1, 0))))
    for k in range(spheres):
        body += SPHERE.format(x=(k % 6 - 2.5) * 0.5, z=(k // 6 - 1) * 0.5)
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(HEADER + body)
    return path
