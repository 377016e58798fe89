# Frozen copy of rray_tpu_torch/mathutils.py at commit 6dfcb62 (imports made local).
"""Host-side transform math (NumPy, float64).

Scene construction happens on the host in f64 — transform chains are
composed and inverted once per scene, then shipped to the device as
affine [3,4] matrices. This replaces the reference's per-instance
Mutex-cached matrix inverses (matrix.rs:389-412) with build-time folding.

Constructor semantics mirror matrix.rs:430-603 (row-major, column-vector
convention, left-handed view_transform).
"""
from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(x: float, y: float, z: float) -> np.ndarray:
    m = identity()
    m[0, 3], m[1, 3], m[2, 3] = x, y, z
    return m


def scale(x: float, y: float, z: float) -> np.ndarray:
    m = identity()
    m[0, 0], m[1, 1], m[2, 2] = x, y, z
    return m


def rotate_x(r: float) -> np.ndarray:
    m = identity()
    c, s = np.cos(r), np.sin(r)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotate_y(r: float) -> np.ndarray:
    m = identity()
    c, s = np.cos(r), np.sin(r)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotate_z(r: float) -> np.ndarray:
    m = identity()
    c, s = np.cos(r), np.sin(r)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def shear(xy: float, xz: float, yx: float, yz: float, zx: float, zy: float) -> np.ndarray:
    m = identity()
    m[0, 1], m[0, 2] = xy, xz
    m[1, 0], m[1, 2] = yx, yz
    m[2, 0], m[2, 1] = zx, zy
    return m


def view_transform(from_pt, to_pt, up) -> np.ndarray:
    """Left-handed look-at (matrix.rs:582-603)."""
    from_pt = np.asarray(from_pt, dtype=np.float64)
    to_pt = np.asarray(to_pt, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    forward = _normalize(to_pt - from_pt)
    left = np.cross(forward, _normalize(up))
    true_up = np.cross(left, forward)
    orientation = identity()
    orientation[0, :3] = left
    orientation[1, :3] = true_up
    orientation[2, :3] = -forward
    return orientation @ translate(*(-from_pt))


def compose(transforms) -> np.ndarray:
    """Compose a YAML-order transform list into one matrix.

    The reference iterates the list in reverse and right-multiplies
    (scene_builder_yaml.rs:218-224), so listed transforms apply to points
    in listed order: compose([T1, T2]) == T2 @ T1.
    """
    m = identity()
    for t in reversed(list(transforms)):
        m = m @ t
    return m


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m)


def affine(m: np.ndarray) -> np.ndarray:
    """Pack a 4x4 (affine) matrix into [3,4]: 3x3 linear block + translation."""
    return np.ascontiguousarray(m[:3, :4], dtype=np.float64)


def normal_matrix(world: np.ndarray) -> np.ndarray:
    """3x3 matrix mapping object-space normals to (unnormalized) world space.

    Equals transpose of the 3x3 block of world^-1; composing parent chains
    into a single world matrix is exact vs. the reference's recursive
    normal_to_world walk (object.rs:129-138) because per-level
    normalization only rescales.
    """
    return np.ascontiguousarray(np.linalg.inv(world)[:3, :3].T, dtype=np.float64)


def apply_affine_point(aff: np.ndarray, p: np.ndarray) -> np.ndarray:
    return aff[:, :3] @ p + aff[:, 3]


def apply_affine_vector(aff: np.ndarray, v: np.ndarray) -> np.ndarray:
    return aff[:, :3] @ v


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def deg2rad(deg: float) -> float:
    return float(deg) * np.pi / 180.0
