"""YAML scene format loader (scene_builder_yaml.rs:28-436).

Reproduces the reference schema exactly, including code-over-README
details (SURVEY.md §5): image pattern key `file`, area-light key `level`
(default 5), fov and rotations in degrees, transforms applied in listed
order via reversed right-multiplication, `hidden` on top-level objects and
group children, per-key material defaults, unknown pattern type -> solid
black, sub-patterns via color_a/color_b taking the parent's transform.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import yaml

from .. import mathutils as mu
from ..scene.data import AreaLight, Material, Pattern, PointLight, Shape
from ..utils import profiling
from .obj_loader import load_obj_file


def _vec(v):
    return np.asarray([float(v[0]), float(v[1]), float(v[2])], np.float64)


def _get_f64(node, key, default):
    if not isinstance(node, dict):
        return default
    value = node.get(key)
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value)
    return default


def create_matrix(t: dict) -> np.ndarray:
    kind = t["type"]
    if kind == "translate":
        return mu.translate(*_vec(t["amount"]))
    if kind == "scale":
        return mu.scale(*_vec(t["amount"]))
    if kind == "rotate":
        angle = mu.deg2rad(float(t["angle"]))
        axis = str(t["axis"])
        if axis == "x":
            return mu.rotate_x(angle)
        if axis == "y":
            return mu.rotate_y(angle)
        if axis == "z":
            return mu.rotate_z(angle)
        raise ValueError(f"Unknown axis: {axis}")
    if kind == "shear":
        return mu.shear(float(t["xy"]), float(t["xz"]), float(t["yx"]),
                        float(t["yz"]), float(t["zx"]), float(t["zy"]))
    raise ValueError(f"Unknown transform type: {kind}")


def create_transforms(transforms) -> np.ndarray:
    """Listed order applies first (scene_builder_yaml.rs:218-224)."""
    return mu.compose([create_matrix(t) for t in (transforms or [])])


def _sub_pattern(parent_transform, color, pattern_yaml, base_dir) -> Pattern:
    # get_sub_pattern (scene_builder_yaml.rs:301-308): a color_x key makes a
    # Solid carrying the *parent's* transform; otherwise recurse.
    if isinstance(color, (list, tuple)):
        return Pattern.solid(_vec(color), parent_transform.copy())
    return create_pattern(pattern_yaml, base_dir)


def _resolve(file: str, base_dir: str) -> str:
    """Resolve a scene-referenced file: absolute, relative to the YAML's
    directory, relative to CWD (the reference resolves against CWD), or
    relative to any ancestor of the YAML's directory (reference scenes
    use repo-root-relative paths like 'examples/foo.jpg')."""
    if os.path.isabs(file):
        return file
    candidates = [os.path.join(base_dir, file), file]
    parent = os.path.abspath(base_dir)
    for _ in range(4):
        parent = os.path.dirname(parent)
        candidates.append(os.path.join(parent, file))
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    return candidates[0]


def create_pattern(p: Optional[dict], base_dir: str) -> Pattern:
    if not isinstance(p, dict):
        raise ValueError("pattern type not found")
    transform = create_transforms(p.get("transforms"))
    ptype = p.get("type")
    color = p.get("color", [0.0, 0.0, 0.0])
    color_a, color_b = p.get("color_a"), p.get("color_b")
    pattern_a, pattern_b = p.get("pattern_a"), p.get("pattern_b")
    sub_a = lambda: _sub_pattern(transform, color_a, pattern_a, base_dir)
    sub_b = lambda: _sub_pattern(transform, color_b, pattern_b, base_dir)

    if ptype == "solid":
        return Pattern.solid(_vec(color), transform)
    if ptype in ("stripe", "gradient", "ring", "checker"):
        return Pattern(ptype, transform, a=sub_a(), b=sub_b())
    if ptype == "blend":
        return Pattern("blend", transform, a=sub_a(), b=sub_b(),
                       scale=_get_f64(p, "scale", 0.5))
    if ptype == "perturbed":
        return Pattern("perturbed", transform, a=sub_a(),
                       scale=_get_f64(p, "scale", 0.2),
                       octaves=int(_get_f64(p, "octaves", 3.0)),
                       persistence=_get_f64(p, "persistence", 0.5))
    if ptype == "noise":
        return Pattern("noise", transform, a=sub_a(), b=sub_b(),
                       scale=_get_f64(p, "scale", 1.0),
                       octaves=int(_get_f64(p, "octaves", 1.0)),
                       persistence=_get_f64(p, "persistence", 1.0))
    if ptype == "image":
        from ..render.canvas import read_image

        return Pattern("image", transform,
                       texture=read_image(_resolve(p["file"], base_dir)))
    # Unknown pattern -> solid black (scene_builder_yaml.rs:297).
    return Pattern.solid([0.0, 0.0, 0.0], transform)


def create_material(m: Optional[dict], base_dir: str) -> Material:
    if not isinstance(m, dict):
        return Material()
    return Material(
        ambient=_get_f64(m, "ambient", 0.1),
        diffuse=_get_f64(m, "diffuse", 0.9),
        specular=_get_f64(m, "specular", 0.9),
        shininess=_get_f64(m, "shininess", 200.0),
        reflective=_get_f64(m, "reflective", 0.0),
        transparency=_get_f64(m, "transparency", 0.0),
        refractive_index=_get_f64(m, "refractive_index", 1.0),
        pattern=create_pattern(m.get("pattern"), base_dir),
    )


def create_shape(s: dict, base_dir: str) -> Shape:
    kind = s["type"]
    transform = create_transforms(s.get("transforms"))
    material = create_material(s.get("material"), base_dir)

    if kind in ("sphere", "glass_sphere"):
        # Reference quirk: create_shape unconditionally calls set_material
        # with the YAML material (or Material::default() when absent)
        # AFTER constructing the shape (scene_builder_yaml.rs:363-364), so
        # the glass preset (sphere.rs:48-58) is always clobbered and
        # `glass_sphere` renders like `sphere`. We match the code, not the
        # README.
        shape = Shape("sphere", transform, material)
    elif kind == "plane":
        shape = Shape("plane", transform, material)
    elif kind == "cube":
        shape = Shape("cube", transform, material)
    elif kind in ("cylinder", "cone"):
        shape = Shape(kind, transform, material,
                      minimum=_get_f64(s, "minimum", -np.inf),
                      maximum=_get_f64(s, "maximum", np.inf),
                      closed=bool(s.get("closed", False)))
    elif kind == "triangle":
        shape = Shape("triangle", transform, material,
                      p1=_vec(s["p1"]), p2=_vec(s["p2"]), p3=_vec(s["p3"]))
    elif kind == "torus":
        shape = Shape("torus", transform, material,
                      minor_radius=float(s["minor_radius"]))
    elif kind == "obj_file":
        shape = load_obj_file(_resolve(s["obj_file"], base_dir), material)
        shape.transform = transform
    elif kind == "group":
        children = []
        for child in s.get("children", []):
            if not child.get("hidden", False):
                children.append(create_shape(child, base_dir))
        shape = Shape("group", transform, children=tuple(children))
    elif kind == "csg":
        shape = Shape("csg", transform, operation=s["operation"],
                      left=create_shape(s["left"], base_dir),
                      right=create_shape(s["right"], base_dir))
    else:
        raise ValueError(f"Unknown object type: {kind}")
    return shape


def load_scene_str(contents: str, base_dir: str = "."):
    """Parse a YAML scene -> (camera_spec, lights, shapes)."""
    with profiling.span("load"):
        return _parse_scene(contents, base_dir)


def _parse_scene(contents: str, base_dir: str):
    doc = yaml.safe_load(contents)

    cam = doc["camera"]
    camera_spec = {
        "fov": mu.deg2rad(float(cam["fov"])),
        "transform": mu.view_transform(_vec(cam["from"]), _vec(cam["to"]),
                                       _vec(cam["up"])),
    }

    lights = []
    for light in doc["lights"]:
        intensity = _vec(light["color"])
        if light["type"] == "point":
            lights.append(PointLight(_vec(light["position"]), intensity))
        elif light["type"] == "area":
            lights.append(AreaLight(_vec(light["corner"]), _vec(light["uvec"]),
                                    _vec(light["vvec"]), intensity,
                                    level=int(light.get("level", 5))))
        else:
            raise ValueError(f"Unknown light type: {light['type']}")
    if not lights:
        raise ValueError("No lights found in scene")

    shapes = []
    for obj in doc["scene"]:
        if not obj.get("hidden", False):
            shapes.append(create_shape(obj, base_dir))
    return camera_spec, lights, shapes


def load_scene_file(path: str):
    with profiling.span("load"):
        with open(path) as f:
            contents = f.read()
        return _parse_scene(contents,
                            os.path.dirname(os.path.abspath(path)))
