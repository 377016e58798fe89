"""Rendering split over devices (rray_tpu parallel/mesh.py): over the
ranks of a torch.distributed process group, or over several devices of
this one process, in place of a JAX device mesh.

A `Mesh` is one axis of entries, each with its own device: entry i
renders its contiguous block of whole raster rows, ceil(vsize / n) of
them (`row_block`), against the whole scene. Two kinds, which do not
combine:

- over a process group (`make_mesh(device)`), an entry is a rank: each
  rank renders its block and the blocks are gathered to every rank;
- a local mesh (`make_mesh(devices=[...])`, rray_tpu's
  `make_mesh(jax.devices())`) holds every entry in this process:
  `render_sharded` gives each entry its own replica of the scene and
  camera (a new SceneData, so each entry builds its own kernel tables,
  kept for the scene's later frames), renders the blocks entry by entry
  from this thread (`run_entries`; entries on different cards overlap
  on the cards) and gathers them in entry order on the first entry's
  device. A device may repeat: ["cuda:0"] * 4 puts four blocks on one
  card.

Every entry renders with the same seed: area-light jitter is keyed by
the shadow origin's bits (ops/jitter.py), not by the split, so the frame
equals the single-process `render` whatever the number of entries.
Whole rows keep the raster width, so the whitted kernel keeps its pixel
tiles and the sorted node its batches of rows (rray_tpu pads contiguous
ray blocks instead; the frame is the same).

Collectives take the tensors where they are: NCCL CUDA tensors, gloo
CPU tensors and (PyTorch 2.11 on an H100: all_gather, all_reduce and
broadcast) CUDA tensors too. The backend is the process group's, chosen
by the caller (parallel/distributed.py init_distributed).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from ..config import RenderSettings, checked_device
from ..render import integrator
from ..render.camera import CameraData
from ..scene import data as sd

RAY_AXIS = "rays"
CAMERA_TENSORS = ("inv", "half_width", "half_height", "pixel_size")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One axis of `size` entries. Over the default process group (a
    single process, size 1, where torch.distributed is not initialized)
    the entries are ranks: this process is rank `rank` and renders on
    `device`, and `devices` is empty. A local mesh holds every entry in
    this process: `devices` are the entries' devices in entry order,
    `rank` is 0 and `device` the first entry's."""

    axis: str
    rank: int
    size: int
    device: torch.device
    devices: tuple = ()


def local_device(device="cuda") -> torch.device:
    """This process's device: "cuda" without an index is cuda:LOCAL_RANK
    (torchrun's variable; 0 when unset), one card per rank; any other
    name is taken as it is ("cuda:0" puts every rank on one card, "cpu"
    on the host)."""
    import os

    dev = checked_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0") or 0)
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} with {torch.cuda.device_count()} "
                "cards: name the card (e.g. cuda:0) to share one")
        dev = torch.device("cuda", local)
    return dev


def _entry_device(device) -> torch.device:
    """A local mesh entry's device: "cuda" without an index is the
    current card."""
    dev = checked_device(device)
    if dev.type == "cuda":
        index = dev.index
        if index is None:
            index = torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r} with "
                               f"{torch.cuda.device_count()} cards")
        dev = torch.device("cuda", index)
    return dev


def make_mesh(device="cuda", axis: str = RAY_AXIS, devices=None) -> Mesh:
    """The 1-D mesh of the default process group (one process if
    torch.distributed is not initialized), this rank on `device`
    (local_device). With `devices`, a list of devices or names, the
    local mesh over them instead, entry i on devices[i]; it does not
    combine with a process group (ValueError): a rank drives one
    device."""
    grouped = dist.is_available() and dist.is_initialized()
    if devices is not None:
        if grouped:
            raise ValueError(
                "devices= makes a local mesh, which does not combine with "
                "a process group: give each rank one device (make_mesh("
                "device)), or drive the devices from one process")
        devs = tuple(_entry_device(d) for d in devices)
        if not devs:
            raise ValueError("devices= names no device")
        return Mesh(axis, 0, len(devs), devs[0], devs)
    rank, size = 0, 1
    if grouped:
        rank, size = dist.get_rank(), dist.get_world_size()
    return Mesh(axis, rank, size, local_device(device))


def row_block(vsize: int, mesh: Mesh, rank: int = None):
    """Entry `rank`'s raster rows [r0, r1) (by default this rank's) and
    the rows of a full block, ceil(vsize / size); the last entries'
    blocks may be short or empty."""
    per = -(-vsize // mesh.size)
    r0 = min((mesh.rank if rank is None else rank) * per, vsize)
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


def run_entries(mesh: Mesh, fn):
    """fn(i, device) for every entry of a local mesh -> the results in
    entry order. The entries run in turn on this thread, each with its
    device current and on the caller's stream there. Entries on
    different cards still overlap on the cards, as far as their work
    is asynchronous: a card runs the launches queued for its entry
    while this thread queues the next entry's. On one H100 a thread and
    a new stream per entry was 2.8-7.3x slower, and a new stream per
    entry alone 1.1-2.6x (scripts/local_mesh_ab.py, PERF.md §6): the
    interpreter lock passes between the threads at each of the nodes'
    small ops."""
    out = []
    for i, d in enumerate(mesh.devices):
        with torch.cuda.device(d) if d.type == "cuda" else \
                contextlib.nullcontext():
            out.append(fn(i, d))
    return out


def replica(tree, device):
    """A scene (SceneData) or camera (CameraData) with its tensors,
    detached, on `device`: a new object, so a replica's SceneData starts
    with an empty kernel cache even where its tensors are the tree's own
    (`.to` on their own device)."""
    return _map_tensors(tree, lambda t: t.detach().to(device))


def _map_tensors(tree, fn):
    if isinstance(tree, CameraData):
        return dataclasses.replace(tree, **{k: fn(getattr(tree, k))
                                            for k in CAMERA_TENSORS})
    return sd.replace_leaves(tree, {k: fn(t)
                                    for k, t in sd.tensor_leaves(tree)})


def render_sharded(scene: sd.SceneData, cam: CameraData, mesh: Mesh,
                   settings: RenderSettings = RenderSettings(),
                   seed: int = 0):
    """Full-frame render with raster rows split over `mesh` -> image
    [vsize, hsize, 3]: over a process group on every rank, on the
    scene's device; over a local mesh on its first entry's device. Each
    entry renders its block of rows (integrator.render_block), keyed by
    `seed`. A local mesh's entries render replicas of the scene and
    camera (run_entries); an entry's scene replica, with the kernel
    tables it builds, is kept in the scene's cache, so the entries build
    their tables once per scene, as `render` does."""
    if mesh.devices:
        parts = [(scene.cached(("replica", i, d), lambda d=d: replica(
            scene, d)), replica(cam, d)) for i, d in enumerate(mesh.devices)]

        def block(i, device):
            r0, r1, _ = row_block(cam.vsize, mesh, i)
            with torch.no_grad():
                return integrator.render_block(*parts[i], r0, r1, settings,
                                               seed)

        return torch.cat([b.to(mesh.device)
                          for b in run_entries(mesh, block)])
    r0, r1, per = row_block(cam.vsize, mesh)
    with torch.no_grad():
        block = integrator.render_block(scene, cam, r0, r1, settings, seed)
    return all_gather_rows(block, per, cam.vsize, mesh)


def device_put_replicated(tree, mesh: Mesh):
    """A scene (SceneData) or camera (CameraData) on the mesh's device
    (a local mesh's first entry's) with rank 0's tensors on every rank
    (a broadcast over the group)."""
    return _map_tensors(tree, lambda t: _replicated(t, mesh))


def _replicated(t, mesh: Mesh):
    t = t.detach().to(mesh.device)
    if mesh.size > 1 and not mesh.devices:
        t = t.clone()
        dist.broadcast(t, 0)
    return t
