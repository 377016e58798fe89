"""Rendering split over processes (rray_tpu parallel/mesh.py), on a
torch.distributed process group in place of a JAX device mesh.

A `Mesh` is one axis of ranks, each with its own device: rank r renders
its contiguous block of whole raster rows, ceil(vsize / n) of them,
against the whole scene, and the blocks are gathered to every rank.
Every rank renders with the same seed: area-light jitter is keyed by the
shadow origin's bits (ops/jitter.py), not by the split, so the frame
equals the single-process `render` whatever the number of ranks. Whole
rows keep the raster width, so the whitted kernel keeps its pixel
tiles and the sorted node its batches of rows (rray_tpu pads contiguous
ray blocks instead; the frame is the same).

Collectives take the tensors where they are: NCCL CUDA tensors, gloo
CPU tensors and (PyTorch 2.11 on an H100: all_gather, all_reduce and
broadcast) CUDA tensors too. The backend is the process group's, chosen
by the caller (parallel/distributed.py init_distributed).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..config import RenderSettings
from ..render import integrator
from ..render.camera import CameraData
from ..scene import data as sd

RAY_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of `size` ranks over the default process group (a single
    process, size 1, where torch.distributed is not initialized); this
    process is rank `rank` and renders on `device`."""

    axis: str
    rank: int
    size: int
    device: torch.device


def local_device(device="cuda") -> torch.device:
    """This process's device: "cuda" without an index is cuda:LOCAL_RANK
    (torchrun's variable; 0 when unset), one card per rank; any other
    name is taken as it is ("cuda:0" puts every rank on one card, "cpu"
    on the host)."""
    import os

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested, but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", "0") or 0)
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"LOCAL_RANK {local} with {torch.cuda.device_count()} "
                    "cards: name the card (e.g. cuda:0) to share one")
            dev = torch.device("cuda", local)
    return dev


def make_mesh(device="cuda", axis: str = RAY_AXIS) -> Mesh:
    """The 1-D mesh of the default process group (one process if
    torch.distributed is not initialized), this rank on `device`
    (local_device)."""
    rank, size = 0, 1
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    return Mesh(axis, rank, size, local_device(device))


def row_block(vsize: int, mesh: Mesh):
    """This rank's raster rows [r0, r1) and the rows of a full block,
    ceil(vsize / size); the last ranks' blocks may be short or empty."""
    per = -(-vsize // mesh.size)
    r0 = min(mesh.rank * per, vsize)
    return r0, min(r0 + per, vsize), per


def all_gather_rows(block, per: int, vsize: int, mesh: Mesh):
    """Every rank's [rows, W, C] block, padded to `per` rows for the
    collective -> the [vsize, W, C] frame on every rank, on the block's
    device."""
    if mesh.size == 1:
        return block
    pad = block.new_zeros((per - block.shape[0],) + tuple(block.shape[1:]))
    mine = torch.cat([block, pad])
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine)
    return torch.cat(parts)[:vsize]


def render_sharded(scene: sd.SceneData, cam: CameraData, mesh: Mesh,
                   settings: RenderSettings = RenderSettings(),
                   seed: int = 0):
    """Full-frame render with raster rows split over `mesh` -> image
    [vsize, hsize, 3] on every rank, on the scene's device. Each rank
    renders its block of rows (integrator.render_block), keyed by
    `seed`."""
    r0, r1, per = row_block(cam.vsize, mesh)
    with torch.no_grad():
        block = integrator.render_block(scene, cam, r0, r1, settings, seed)
    return all_gather_rows(block, per, cam.vsize, mesh)


def device_put_replicated(tree, mesh: Mesh):
    """A scene (SceneData) or camera (CameraData) on the mesh's device
    with rank 0's tensors on every rank (a broadcast over the group)."""
    if isinstance(tree, CameraData):
        fields = {k: _replicated(getattr(tree, k), mesh) for k in (
            "inv", "half_width", "half_height", "pixel_size")}
        return dataclasses.replace(tree, **fields)
    return sd.replace_leaves(tree, {k: _replicated(t, mesh)
                                    for k, t in sd.tensor_leaves(tree)})


def _replicated(t, mesh: Mesh):
    t = t.detach().to(mesh.device)
    if mesh.size > 1:
        t = t.clone()
        dist.broadcast(t, 0)
    return t
