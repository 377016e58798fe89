"""Wavefront OBJ loader (load_obj.rs:9-139).

Parses v/vn/f records, fan-triangulates polygons (v0, vi, vi+1), and emits
smooth triangles when the face carries normal indices, flat triangles
otherwise — one Group per object/mesh, nested under a master group when
the file holds several, matching tobj + the reference's create_group.
"""
from __future__ import annotations

import numpy as np

from ..scene.data import Material, Shape


def _parse_index(token: str, count: int) -> int:
    idx = int(token)
    return idx - 1 if idx > 0 else count + idx


def parse_obj(text: str):
    """Returns a list of meshes: each a list of faces, each face a list of
    (vertex, normal-or-None) pairs."""
    positions: list[np.ndarray] = []
    normals: list[np.ndarray] = []
    meshes: list[list] = []
    current: list = []

    def flush():
        nonlocal current
        if current:
            meshes.append(current)
            current = []

    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        tag = parts[0]
        if tag == "v":
            positions.append(np.asarray([float(x) for x in parts[1:4]]))
        elif tag == "vn":
            normals.append(np.asarray([float(x) for x in parts[1:4]]))
        elif tag in ("o", "g"):
            flush()
        elif tag == "f":
            face = []
            for vert in parts[1:]:
                comps = vert.split("/")
                vi = _parse_index(comps[0], len(positions))
                ni = None
                if len(comps) >= 3 and comps[2]:
                    ni = _parse_index(comps[2], len(normals))
                face.append((vi, ni))
            current.append(face)
    flush()
    return positions, normals, meshes


def _shapes_from_tables(positions, normals, tri_v, tri_n, offsets, material):
    """Build per-mesh Groups from the native parser's flat tables."""
    groups = []
    start = 0
    for end in offsets:
        tris = []
        for k in range(start, end):
            v0, v1, v2 = tri_v[k]
            n0, n1, n2 = tri_n[k]
            if n0 >= 0 and n1 >= 0 and n2 >= 0:
                tris.append(Shape("smooth_triangle", material=material,
                                  p1=positions[v0], p2=positions[v1],
                                  p3=positions[v2], n1=normals[n0],
                                  n2=normals[n1], n3=normals[n2]))
            else:
                tris.append(Shape("triangle", material=material,
                                  p1=positions[v0], p2=positions[v1],
                                  p3=positions[v2]))
        groups.append(Shape("group", children=tuple(tris)))
        start = end
    if len(groups) == 1:
        return groups[0]
    return Shape("group", children=tuple(groups))


def load_obj_str(text: str, material: Material) -> Shape:
    from .native import parse_obj_native

    parsed = parse_obj_native(text)
    if parsed is not None:
        positions, normals, tri_v, tri_n, offsets = parsed
        if not offsets:
            raise ValueError("No models found in OBJ input")
        return _shapes_from_tables(positions, normals, tri_v, tri_n,
                                   offsets, material)

    positions, normals, meshes = parse_obj(text)
    if not meshes:
        raise ValueError("No models found in OBJ input")

    groups = []
    for mesh in meshes:
        tris = []
        for face in mesh:
            # Fan triangulation (load_obj.rs:57-76).
            for i in range(1, len(face) - 1):
                (v0, n0), (v1, n1), (v2, n2) = face[0], face[i], face[i + 1]
                if n0 is not None and n1 is not None and n2 is not None:
                    tris.append(Shape("smooth_triangle", material=material,
                                      p1=positions[v0], p2=positions[v1],
                                      p3=positions[v2], n1=normals[n0],
                                      n2=normals[n1], n3=normals[n2]))
                else:
                    tris.append(Shape("triangle", material=material,
                                      p1=positions[v0], p2=positions[v1],
                                      p3=positions[v2]))
        groups.append(Shape("group", children=tuple(tris)))

    if len(groups) == 1:
        return groups[0]
    return Shape("group", children=tuple(groups))


def load_obj_file(path: str, material: Material) -> Shape:
    with open(path) as f:
        return load_obj_str(f.read(), material)
