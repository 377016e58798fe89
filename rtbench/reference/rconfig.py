# Frozen copy of rray_tpu_torch/config.py at commit 6dfcb62.
"""Global configuration for the rray_tpu_torch renderer.

Mirrors the reference's single global constant EPSILON = 1e-5
(reference src/main.rs:10). There is no kernel switch: the device of the
tensors decides. CUDA tensors run the hand-written kernels, CPU tensors
their plain PyTorch versions. The mesh settings and the sorted node's
(max_hits, containers_depth, tri_chunk, rows_per_tile, max_rc_elems,
wavefront) and remat are rray_tpu's, with its defaults (rray_tpu/config.py).
"""
from __future__ import annotations

import dataclasses

import torch

# Float comparison / shadow-acne epsilon (reference: src/main.rs:10).
EPSILON = 1e-5


def checked_device(device="cuda") -> torch.device:
    """`device` as a torch.device; a CUDA device where CUDA is missing is
    a RuntimeError (no path falls back to the CPU by itself: the caller
    passes "cpu" for the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested, but "
                           "torch.cuda.is_available() is False")
    return dev


def default_dtype():
    """Compute dtype of the render path (rray_tpu config.default_dtype):
    float32, the CUDA kernels' type. float64 runs only the plain
    versions on the CPU; callers pass it explicitly (parity tests)."""
    return torch.float32


def offset_eps(dtype) -> float:
    """Surface offset used for over_point/under_point.

    The reference offsets by EPSILON in f64 (intersection.rs:57-58). In f32
    that is below round-off at scene scale, so it widens to keep shadow
    and refraction rays off the originating surface.
    """
    if dtype == torch.float64:
        return EPSILON
    return 1e-3


def hit_match_tol(dtype) -> float:
    """Relative tolerance that matches the hit's own crossing in the
    n1/n2 walk (rray_tpu ops/soa.py refractive_indices_direct): the
    crossing is re-derived, so bitwise equality with the closest-hit t
    is not guaranteed."""
    if dtype == torch.float64:
        return 1e-9
    return 1e-4


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Settings for one render."""

    # Max sorted hit slots kept per ray (the sorted node's mesh slots:
    # the triangle crossings a CSG or n1/n2 walk can see).
    max_hits: int = 16
    # Containers stack depth for the n1/n2 walk (intersection.rs:61-92).
    containers_depth: int = 8
    # Recursion depth for reflection/refraction (camera.rs:113 hardcodes 5).
    depth: int = 5
    # Triangles per chunk of the sorted node's torch folds over a mesh
    # (its ties break in chunk order, as rray_tpu's do).
    tri_chunk: int = 512
    # Pixel rows per batch of the sorted node (rray_tpu's tile rule).
    rows_per_tile: int = 64
    # Cap on rays-per-batch x tri_chunk (and x slot) elements, which
    # bounds the sorted node's [R, C] and [K, R] intermediates.
    max_rc_elems: int = 32 * 1024 * 1024
    # Meshes with at least this many triangles take the BVH kernel on the
    # fast node; smaller ones the linear chunk kernels.
    bvh_min_tris: int = 1024
    # rray_tpu's BVH leaf size (triangles per leaf, raised to fit its
    # TPU kernel's 2048 leaves). The port's card tree does not read it: its
    # leaves hold kernels/bvh.py LEAF triangles, whatever the mesh size.
    bvh_leaf: int = 128
    # Compact-wavefront capacity: max live paths PER PIXEL per depth
    # level when both reflection and refraction spawn; a pixel holding
    # more nonzero-weight paths drops the lowest-weight ones. 2^depth
    # keeps every path.
    wavefront_capacity: int = 4
    # The sorted node's wavefront when both reflection and refraction
    # spawn: "compact" (per-pixel live-path compaction at
    # wavefront_capacity) or "scan" (the exhaustive 2^depth width).
    wavefront: str = "compact"
    # Recompute each level of the torch nodes' Whitted chain in the
    # backward pass (torch.utils.checkpoint around the level body)
    # instead of keeping its intermediates; an identity outside autograd,
    # and the gradients are the same either way (rray_tpu's remat).
    remat: bool = True
