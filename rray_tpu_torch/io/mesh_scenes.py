"""Generated scenes as YAML + OBJ files (the form the CLI reads): a checker
floor, a point light at (-10, 10, -10) or config 3's area light, the
camera of rray_tpu's mesh benchmark cells (benchmarks/bench_suite.py
config4), procedural UV-sphere meshes (a copy of
benchmarks/bench_mesh.py::uv_sphere_obj) and a grid of small analytic
spheres; and variants of config 5 (examples/csg_showcase.yaml). The
tests and chip_smoke.py render the same scenes from here."""
from __future__ import annotations

import os

import numpy as np
import yaml

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "examples")

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
{glass}"""
SPHERE = """  - type: sphere
    transforms:
      - type: scale
        amount: [0.25, 0.25, 0.25]
      - type: translate
        amount: [{x}, 0.25, {z}]
    material:
      pattern:
        type: solid
        color: [{r}, {g}, {b}]
      specular: 0.3
{glass}"""
HEADER = """camera:
  fov: 60
  from: [0, 1.5, -4]
  to: [0, 0.7, 0]
  up: [0, 1, 0]
lights:
{light}scene:
"""
POINT_LIGHT = """  - type: point
    position: [-10, 10, -10]
    color: [1, 1, 1]
"""
# The area light of examples/area_light.yaml (rray_tpu BASELINE config 3).
AREA_LIGHT = """  - type: area
    corner: [-5, 5, -5]
    uvec: [1.5, 0, 0]
    vvec: [0, 1.5, 0]
    level: {level}
    color: [1, 1, 1]
"""
# The glass of examples/glass.yaml's large sphere, more transparent.
GLASS = """      reflective: 0.9
      transparency: 0.9
      refractive_index: 1.5
"""
# A tetrahedron, config 5's mesh operand (four faces, none coplanar
# with the floor).
TETRAHEDRON = ("v 0 1.6 -0.2\nv 0.9 0.3 -0.7\nv -0.9 0.3 -0.7\n"
               "v 0 0.3 1.0\nf 1 2 3\nf 1 3 4\nf 1 4 2\nf 2 4 3\n")
NINE_COLORS = [(0.9, 0.2, 0.2), (0.2, 0.9, 0.2), (0.2, 0.2, 0.9),
               (0.9, 0.9, 0.2), (0.9, 0.2, 0.9), (0.2, 0.9, 0.9),
               (0.6, 0.4, 0.2), (0.4, 0.2, 0.6), (0.8, 0.8, 0.8)]


def uv_sphere_obj(n_lat=40, n_lon=40):
    """OBJ text of a smooth UV sphere (~2 * n_lat * n_lon triangles)."""
    lines = []
    for i in range(n_lat + 1):
        theta = np.pi * i / n_lat
        for j in range(n_lon):
            phi = 2 * np.pi * j / n_lon
            x = np.sin(theta) * np.cos(phi)
            y = np.cos(theta)
            z = np.sin(theta) * np.sin(phi)
            lines.append(f"v {x} {y} {z}")
            lines.append(f"vn {x} {y} {z}")

    def vid(i, j):
        return i * n_lon + (j % n_lon) + 1

    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            if i > 0:
                lines.append(f"f {a}//{a} {b}//{b} {d}//{d}")
            if i < n_lat - 1:
                lines.append(f"f {b}//{b} {c}//{c} {d}//{d}")
    return "\n".join(lines)


def _transforms(*ts):
    return "".join(f"      - type: {kind}\n        amount: [{a}, {b}, {c}]\n"
                   for kind, (a, b, c) in ts)


def write_scene(tmp, name, lat_lon=(11, 11), reflective=0.0, grid=False,
                spheres=0, smooth=True, area_level=0, glass=False):
    """Write `name`.yaml (+ OBJ) under `tmp` and return its path.

    One mesh of uv_sphere_obj(*lat_lon) at (0, 1, 0), or none when
    lat_lon is None; grid=True places nine meshes of nine colours on a
    3x3 grid at scale 0.3 instead; `spheres` adds that many analytic
    spheres of radius 0.25 on the floor, five to a row, 0.6 apart;
    smooth=False drops the vertex normals (flat triangles); area_level > 0
    swaps the point light for config 3's area light at that level;
    glass=True makes the meshes and every other sphere (the even ones)
    GLASS and lifts the single mesh 0.01 off the floor, so that none of
    its faces touches it."""
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
        mat = GLASS if glass else ""
        if grid:
            for k, (r, g, b) in enumerate(NINE_COLORS):
                x, z = (k % 3 - 1) * 0.9, (k // 3 - 1) * 0.9
                body += MESH.format(obj=obj, r=r, g=g, b=b, glass=mat,
                                    transforms=_transforms(
                                        ("scale", (0.3, 0.3, 0.3)),
                                        ("translate", (x, 0.5, z))))
        else:
            body += MESH.format(obj=obj, r=0.7, g=0.5, b=0.2, glass=mat,
                                transforms=_transforms(
                                    ("translate",
                                     (0, 1.01 if glass else 1, 0))))
    for k in range(spheres):
        r, g, b = NINE_COLORS[k % len(NINE_COLORS)]
        body += SPHERE.format(x=(k % 5 - 2) * 0.6, z=(k // 5 - 1.5) * 0.6,
                              r=r, g=g, b=b,
                              glass=GLASS if glass and k % 2 == 0 else "")
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        light = (AREA_LIGHT.format(level=area_level) if area_level
                 else POINT_LIGHT)
        f.write(HEADER.format(light=light) + body)
    return path


# A perturbed stripe for config 5's torus in place of its image: the
# perturbed node scales its points by 500 so that FastNoiseLite's
# frequency (0.01) samples many lattice cells across the torus, and the
# stripe scales them back to a period of 0.25 (noise.rs:26-29).
PERTURBED_STRIPE = {
    "type": "perturbed", "scale": 40, "octaves": 3, "persistence": 0.5,
    "transforms": [{"type": "scale", "amount": [0.002, 0.002, 0.002]}],
    "pattern_a": {
        "type": "stripe", "color_a": [0.9, 0.5, 0.1],
        "color_b": [0.1, 0.3, 0.8],
        "transforms": [{"type": "scale", "amount": [125, 125, 125]}]}}


def write_config5(tmp, name, floor_reflective=0.0, area_level=0,
                  perturbed_torus=False, split_csg=False,
                  transparent_operand=0.0, mesh_operand=False):
    """Write a variant of config 5 (examples/csg_showcase.yaml) as
    `name`.yaml under `tmp` and return its path: the floor's
    `reflective`, config 3's area light at `area_level` in place of the
    point light, PERTURBED_STRIPE on the torus in place of its image,
    with `split_csg` the CSG node replaced by its two operands as
    top-level objects (each under the CSG's transforms), the CSG's right
    operand (a sphere) at transparency `transparent_operand`, and with
    `mesh_operand` a TETRAHEDRON OBJ as the CSG's right operand. The
    last two make CSG scenes that the whitted kernel rejects. The image
    path is made absolute."""
    with open(os.path.join(EXAMPLES, "csg_showcase.yaml")) as f:
        doc = yaml.safe_load(f)
    objs = doc["scene"]
    objs[0]["material"]["reflective"] = floor_reflective
    if area_level:
        doc["lights"] = [yaml.safe_load(AREA_LIGHT.format(
            level=area_level))[0]]
    csg = next(o for o in objs if o["type"] == "csg")
    torus = next(o for o in objs if o["type"] == "torus")
    pattern = torus["material"]["pattern"]
    if perturbed_torus:
        torus["material"]["pattern"] = PERTURBED_STRIPE
    elif pattern["type"] == "image":
        pattern["file"] = os.path.join(EXAMPLES, pattern["file"])
    if transparent_operand:
        csg["right"]["material"]["transparency"] = transparent_operand
    if mesh_operand:
        obj = os.path.join(tmp, f"{name}_tet.obj")
        with open(obj, "w") as f:
            f.write(TETRAHEDRON)
        csg["right"] = {"type": "obj_file", "obj_file": obj}
    if split_csg:
        operands = [dict(o, transforms=o.get("transforms", [])
                         + csg.get("transforms", []))
                    for o in (csg["left"], csg["right"])]
        i = objs.index(csg)
        objs[i:i + 1] = operands
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
    return path
