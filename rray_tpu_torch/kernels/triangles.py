"""Closest hit and shadow any-hit over a triangle table: CUDA kernels,
plain PyTorch versions, and the wrappers that pick between them.

Port of rray_tpu's Pallas kernels `rray_tpu/kernels/triangles.py::
closest_triangle` (ROADMAP B2) and `::any_triangle` (B3). The CUDA
source is kernels/csrc/triangles.cu (device code in mesh_device.cuh):
one thread per ray walks the Morton-ordered table chunk by chunk and
skips a chunk whose AABB it does not enter before its own best t (or
`dist`). The plain versions are rray_tpu's XLA chunk scan
(`ops/soa.py::_tri_chunks/_tri_chunk_best/_tri_chunk_eval`), which
rray_tpu's tests hold its kernels against, with the same Möller–Trumbore
expression order as the kernel.

Semantics (triangle.rs:72-94, scene.rs:97-136, 234-245): a hit has
EPSILON <= |det|, 0 <= u, v, u + v <= 1 and t >= 0; the closest hit
keeps the lowest triangle index on equal t. `t_init` bounds the search:
only hits with t < t_init are reported (rray_tpu's kernel may also
report hits behind its seed, which its caller's strict `<` merge then
discards; the merged result is the same). Misses carry t = +inf and zero
payloads.

The wrappers take the tensors' device as the switch: CPU tensors run the
plain version (dtype-generic, so tests run it in float64), CUDA tensors
launch the kernel (float32 only) or raise.
"""
from __future__ import annotations

import torch

from ..config import EPSILON
from ..ops.vec import V3

CHUNK = 256         # chunk for meshes of 1024 triangles and more
CHUNK_ALIGN = 8     # small meshes round their chunk up to this
FAR = 1e30          # padding sentinel (rray_tpu kernels/triangles.py _FAR)

# Kernel launches made by the wrappers in this process (CPU calls, which
# run the plain versions, do not count).
closest_launches = 0
any_launches = 0


def chunk_size(T: int) -> int:
    """rray_tpu's cull granularity for a T-triangle mesh: 256 from 1024
    triangles on, else the pad-free (or least-padded) of 64/56/48/40,
    and T rounded up to 8 for meshes of at most 64."""
    if T >= 1024:
        return CHUNK
    if T <= 64:
        return -(-T // CHUNK_ALIGN) * CHUNK_ALIGN
    return min((64, 56, 48, 40), key=lambda c: ((-T) % c, -c))


def chunk_boxes(tri_comps, chunk: int):
    """Per-chunk AABBs over the three vertices -> [6, n_chunks + 1]
    (lo xyz, hi xyz; the last column boxes the whole table). The last
    chunk may be partial: its box covers the triangles it has."""
    T = tri_comps[0].shape[0]
    n = -(-T // chunk)
    pad = n * chunk - T
    lo, hi = [], []
    for j in range(3):
        v1 = tri_comps[j]
        v2 = v1 + tri_comps[3 + j]
        v3 = v1 + tri_comps[6 + j]
        mn = torch.minimum(torch.minimum(v1, v2), v3)
        mx = torch.maximum(torch.maximum(v1, v2), v3)
        lo.append(torch.nn.functional.pad(mn, (0, pad), value=float("inf"))
                  .reshape(n, chunk).amin(1))
        hi.append(torch.nn.functional.pad(mx, (0, pad), value=float("-inf"))
                  .reshape(n, chunk).amax(1))
    boxes = torch.stack(lo + hi)
    whole = torch.cat([boxes[:3].amin(1), boxes[3:].amax(1)])
    return torch.cat([boxes, whole[:, None]], 1).contiguous()


# ---------------------------------------------------------------------------
# The plain versions.
# ---------------------------------------------------------------------------

def _tri_chunk_eval(ro: V3, rd: V3, p1, e1, e2):
    """Raw [R, C] Möller–Trumbore values (t, u, v, ok) for one chunk
    (rray_tpu ops/soa.py _tri_chunk_eval; the kernel's `mt` writes the
    same expressions)."""
    dx, dy, dz = rd.x[:, None], rd.y[:, None], rd.z[:, None]
    ox, oy, oz = ro.x[:, None], ro.y[:, None], ro.z[:, None]
    e1x, e1y, e1z = e1[0][None, :], e1[1][None, :], e1[2][None, :]
    e2x, e2y, e2z = e2[0][None, :], e2[1][None, :], e2[2][None, :]
    p1x, p1y, p1z = p1[0][None, :], p1[1][None, :], p1[2][None, :]
    cx = dy * e2z - dz * e2y
    cy = dz * e2x - dx * e2z
    cz = dx * e2y - dy * e2x
    det = e1x * cx + e1y * cy + e1z * cz
    ok = torch.abs(det) >= EPSILON
    f = 1.0 / torch.where(ok, det, 1.0)
    sx = ox - p1x
    sy = oy - p1y
    sz = oz - p1z
    u = f * (sx * cx + sy * cy + sz * cz)
    ok = ok & (u >= 0.0) & (u <= 1.0)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    ok = ok & (v >= 0.0) & (u + v <= 1.0)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    return t, u, v, ok


def _closest_scan(ro: V3, rd: V3, tri_comps, chunk: int):
    """Closest hit over every triangle -> (t, u, v, idx) [R]: per chunk
    the first argmin (rray_tpu _tri_chunk_best), across chunks a strict
    `<`, so ties go to the lowest index."""
    T = tri_comps[0].shape[0]
    best_t = torch.full_like(ro.x, float("inf"))
    best_u = torch.zeros_like(ro.x)
    best_v = torch.zeros_like(ro.x)
    best_i = torch.zeros(ro.x.shape, dtype=torch.long, device=ro.x.device)
    for c0 in range(0, T, chunk):
        cols = [c[c0:c0 + chunk] for c in tri_comps[:9]]
        t, u, v, ok = _tri_chunk_eval(ro, rd, cols[0:3], cols[3:6], cols[6:9])
        t = torch.where(ok & (t >= 0.0), t, float("inf"))
        idx = torch.argmin(t, dim=1, keepdim=True)
        take = lambda a: torch.gather(a, 1, idx)[:, 0]
        ct = take(t)
        better = ct < best_t
        best_t = torch.where(better, ct, best_t)
        best_u = torch.where(better, take(u), best_u)
        best_v = torch.where(better, take(v), best_v)
        best_i = torch.where(better, idx[:, 0] + c0, best_i)
    return best_t, best_u, best_v, best_i


def _payload(tri_comps, aux, u, v, idx, found):
    """The winner's interpolated vertex normal (when the table carries
    normals; smooth_triangle.rs:99-101, flat triangles store
    n1 = n2 = n3) and aux columns, zero where nothing was found."""
    outs = []
    if len(tri_comps) == 18:
        w1 = 1.0 - u - v
        for k in range(3):
            n = (w1 * tri_comps[9 + k][idx] + u * tri_comps[12 + k][idx]
                 + v * tri_comps[15 + k][idx])
            outs.append(torch.where(found, n, 0.0))
    for a in aux:
        outs.append(torch.where(found, a[idx], 0.0))
    return tuple(outs)


def closest_triangle_reference(ro_comps, rd_comps, tri_comps, t_init=None,
                               aux=(), chunk: int = 512):
    """Plain PyTorch version of `closest_triangle` (same arguments; the
    table is scanned `chunk` triangles at a time)."""
    ro, rd = V3(*ro_comps), V3(*rd_comps)
    t, u, v, idx = _closest_scan(ro, rd, tri_comps, max(1, chunk))
    found = torch.isfinite(t)
    if t_init is not None:
        found = found & (t < t_init)
    zero = torch.zeros_like(t)
    idx = torch.where(found, idx, 0)
    return (torch.where(found, t, float("inf")), torch.where(found, u, zero),
            torch.where(found, v, zero), idx.to(torch.int32)) \
        + _payload(tri_comps, aux, u, v, idx, found)


def any_triangle_reference(ro_comps, rd_comps, tri_comps, dist,
                           chunk: int = 512):
    """Plain PyTorch version of `any_triangle`."""
    ro, rd = V3(*ro_comps), V3(*rd_comps)
    hit = torch.zeros(ro.x.shape, dtype=torch.bool, device=ro.x.device)
    for c0 in range(0, tri_comps[0].shape[0], max(1, chunk)):
        cols = [c[c0:c0 + chunk] for c in tri_comps[:9]]
        t, _, _, ok = _tri_chunk_eval(ro, rd, cols[0:3], cols[3:6], cols[6:9])
        hit = hit | (ok & (t >= 0.0) & (t < dist[:, None])).any(1)
    return hit.to(torch.int32)


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers.
# ---------------------------------------------------------------------------

def pack_table(tri_comps, aux=()):
    """[T, K] row-major triangle table for the kernels: p1 e1 e2
    (0-8), the vertex normals n1 n2 n3 (9-17) when given, then the aux
    columns. One row per triangle, so the threads of a warp that test
    the same triangle read one broadcast row."""
    return torch.stack(tuple(tri_comps) + tuple(aux), dim=1).contiguous()


def check_rays(ro_comps, rd_comps, device, extra=()):
    from . import build

    R = ro_comps[0].shape[0]
    for k, c in enumerate(tuple(ro_comps) + tuple(rd_comps) + tuple(extra)):
        build.check_arg(f"ray input {k}", c, (R,), device)
    return R


def check_table(tri_comps, aux, device):
    from . import build

    if len(tri_comps) not in (9, 18):
        raise ValueError(f"{len(tri_comps)} triangle columns; the kernels "
                         "take 9 (p1 e1 e2) or 18 (with vertex normals)")
    T = tri_comps[0].shape[0]
    if T == 0:
        raise ValueError("an empty triangle table")
    for k, c in enumerate(tuple(tri_comps) + tuple(aux)):
        build.check_arg(f"triangle column {k}", c, (T,), device)
    return T


def hit_outputs(R, n_float, device):
    """[n_float, R] float32 rows and an [R] int32 index output."""
    return (torch.empty((n_float, R), dtype=torch.float32, device=device),
            torch.empty(R, dtype=torch.int32, device=device))


def _launch_closest(ro_comps, rd_comps, tri_comps, t_init, aux):
    global closest_launches
    from . import build

    device = ro_comps[0].device
    R = check_rays(ro_comps, rd_comps, device,
                   () if t_init is None else (t_init,))
    T = check_table(tri_comps, aux, device)
    normals = len(tri_comps) == 18
    n_float = 3 + (3 if normals else 0) + len(aux)
    fout, iout = hit_outputs(R, n_float, device)
    chunk = chunk_size(T)
    tbl = pack_table(tri_comps, aux)
    boxes = chunk_boxes(tri_comps, chunk)
    with torch.cuda.device(device):
        rc = build.load_library().closest_triangle_launch(
            *(build.ptr(c) for c in tuple(ro_comps) + tuple(rd_comps)),
            build.ptr(t_init), build.ptr(tbl), tbl.shape[1], T,
            build.ptr(boxes), boxes.shape[1] - 1, chunk, int(normals),
            len(aux), build.ptr(fout), build.ptr(iout), R,
            build.stream(device))
    build.check_launch("closest_triangle", rc)
    closest_launches += 1
    rows = fout.unbind(0)
    return rows[:3] + (iout,) + rows[3:]


def _launch_any(ro_comps, rd_comps, tri_comps, dist):
    global any_launches
    from . import build

    device = ro_comps[0].device
    R = check_rays(ro_comps, rd_comps, device, (dist,))
    T = check_table(tri_comps[:9], (), device)
    hit = torch.empty(R, dtype=torch.int32, device=device)
    chunk = chunk_size(T)
    tbl = pack_table(tri_comps[:9])
    boxes = chunk_boxes(tri_comps, chunk)
    with torch.cuda.device(device):
        rc = build.load_library().any_triangle_launch(
            *(build.ptr(c) for c in tuple(ro_comps) + tuple(rd_comps)),
            build.ptr(dist), build.ptr(tbl), tbl.shape[1], T,
            build.ptr(boxes), boxes.shape[1] - 1, chunk, build.ptr(hit), R,
            build.stream(device))
    build.check_launch("any_triangle", rc)
    any_launches += 1
    return hit


def closest_triangle(ro_comps, rd_comps, tri_comps, t_init=None, aux=()):
    """Closest hit over triangles -> (t, u, v, idx[, nx, ny, nz][, *aux])
    [R] tensors (idx int32).

    ro/rd_comps: 3-tuples of [R]; tri_comps: 9 [T] columns (p1, e1, e2
    xyz), or 18 with the vertex normals (n1, n2, n3 xyz), in which case
    the winner's interpolated normal (unnormalized) is returned; `t_init`
    ([R], optional) keeps only hits with t < t_init; `aux` ([T] columns,
    e.g. prim id and shade class as floats) is selected for the winner.
    The kernel culls by chunk_size(T) boxes."""
    if ro_comps[0].device.type == "cpu":
        return closest_triangle_reference(ro_comps, rd_comps, tri_comps,
                                          t_init, aux)
    return _launch_closest(ro_comps, rd_comps, tri_comps, t_init, tuple(aux))


def any_triangle(ro_comps, rd_comps, tri_comps, dist):
    """Shadow any-hit: is some triangle hit with 0 <= t < dist? -> [R]
    int32 (1 = occluded). tri_comps: at least the 9 geometry columns."""
    if ro_comps[0].device.type == "cpu":
        return any_triangle_reference(ro_comps, rd_comps, tri_comps, dist)
    return _launch_any(ro_comps, rd_comps, tri_comps, dist)
