"""Closest hit and shadow any-hit over a triangle table: CUDA kernels,
plain PyTorch versions, and the wrappers that pick between them.

Port of rray_tpu's Pallas kernels `rray_tpu/kernels/triangles.py::
closest_triangle` (ROADMAP B2) and `::any_triangle` (B3). The CUDA
source is kernels/csrc/triangles.cu (the fold is `group_fold` in
mesh_device.cuh). Its tables (`chunk_tables`) are built once per table
(the fast node: once per scene, ops/soa.py `_tri_tables`): the
Morton-ordered rows as p1 e1 e2 in 48 B rows, and cull boxes over
chunks of rows and over groups of GROUP rows inside each chunk. The 32
rays of a warp fold together: a box is entered when some lane enters it
before its best t (or `dist`), a group's rows are read once for the warp
and tested by the lanes that entered its box, and the payload (normal,
aux columns) is read for the winner only. The plain versions are
rray_tpu's XLA chunk scan (`ops/soa.py::_tri_chunks/_tri_chunk_best/
_tri_chunk_eval`), which rray_tpu's tests hold its kernels against, with
the same Möller–Trumbore expression order as the kernel.

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

from typing import NamedTuple, Optional

import torch

from . import build
from ..config import EPSILON
from ..ops.vec import V3
from ..utils import profiling

CHUNK = 256         # chunk for meshes of 1024 triangles and more
CHUNK_ALIGN = 8     # small meshes round their chunk up to this
FAR = 1e30          # padding sentinel (rray_tpu kernels/triangles.py _FAR)
# Rows per cull group of the CUDA kernels' tables (PERF.md: the group
# sweep); the kernels' chunks are whole groups.
GROUP = 4
BOX = 8        # floats per box row (csrc/mesh_device.cuh TRI_BOX)
ROW = 12       # floats per geometry row (BVH_TRI)
# Tables up to this size are staged in shared memory by a persistent
# grid (the 227 KB a block may opt in to); larger ones are read through
# L1.
STAGE_BYTES = 227 * 1024

# Kernel launches made by the wrappers in this process (CPU calls, which
# run the plain versions, do not count), and kernel tables built
# (`chunk_tables`).
closest_launches = 0
any_launches = 0
table_builds = 0


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
    """[T, K] row-major payload table of the kernels: p1 e1 e2 (0-8),
    the vertex normals n1 n2 n3 (9-17) when given, then the aux columns.
    The kernels read the winner's row only (write_hit)."""
    return torch.stack(tuple(tri_comps) + tuple(aux), dim=1).contiguous()


def check_rays(ro_comps, rd_comps, device, extra=()):
    """R, once every ray input is a contiguous float32 [R] tensor on
    `device` (build.check_arg raises, naming the input, where one is
    not)."""
    R = ro_comps[0].shape[0]
    shape = (R,)
    for k, c in enumerate((*ro_comps, *rd_comps, *extra)):
        if not (c.device == device and c.dtype == torch.float32
                and c.shape == shape and c.is_contiguous()):
            build.check_arg(f"ray input {k}", c, shape, device)
    return R


def check_table(tri_comps, aux, device):
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


class Tables(NamedTuple):
    """The CUDA kernels' tables for one triangle table (`chunk_tables`)."""

    block: torch.Tensor    # float32: box rows (whole, chunks, groups), rows
    payload: torch.Tensor  # [T, K] p1 e1 e2 [n1 n2 n3] [aux] (write_hit)
    T: int
    group: int             # rows per group box
    chunk: int             # rows per chunk box, a multiple of `group`
    normals: bool
    n_aux: int

    @property
    def words(self) -> int:
        """Floats of the block: the whole table's box, one box per chunk
        and per group, one row per triangle."""
        T = self.T
        return BOX * (1 + -(-T // self.chunk) + -(-T // self.group)) + ROW * T


def box_rows(boxes):
    """[6, n] component-major boxes -> [n * BOX] rows of lo xyz, 0, hi
    xyz, 0 (two 16-byte loads each on the card)."""
    zero = boxes.new_zeros((1, boxes.shape[1]))
    return torch.cat([boxes[:3], zero, boxes[3:], zero]).t().reshape(-1)


def chunk_tables(tri_comps, aux=(), group: int = GROUP) -> Tables:
    """The CUDA kernels' tables for a triangle table (9 or 18 [T]
    columns, and aux columns), built with torch ops on its device: one
    float32 block of box rows (the whole table's, then one per chunk of
    group * ceil(chunk_size(T) / group) rows, then one per group of
    `group` rows; each exactly as chunk_boxes computes it) and the
    geometry rows (p1 e1 e2 and three zeros), and the payload table
    (pack_table) that the kernels read for the winner only."""
    with profiling.span("tables"):
        T = tri_comps[0].shape[0]
        chunk = group * -(-chunk_size(T) // group)
        geom = [c.float() for c in tri_comps[:9]]
        chunks = chunk_boxes(geom, chunk)  # the last column: the whole table
        rows = torch.zeros((T, ROW), dtype=torch.float32,
                           device=geom[0].device)
        rows[:, :9] = torch.stack(geom, 1)
        block = torch.cat([box_rows(chunks[:, -1:]), box_rows(chunks[:, :-1]),
                           box_rows(chunk_boxes(geom, group)[:, :-1]),
                           rows.reshape(-1)])
        build.count(globals(), "table_builds")
        return Tables(block, pack_table(tri_comps, aux), T, group, chunk,
                      len(tri_comps) == 18, len(aux))


def check_tables(tables: Tables, T: int, normals: bool, n_aux: int,
                 any_hit: bool):
    """Refuse tables built for another triangle table (any-hit reads no
    payload, so it may take the closest call's tables)."""
    if tables.T != T or (not any_hit and (tables.normals, tables.n_aux)
                         != (normals, n_aux)):
        raise ValueError(f"the tables hold {tables.T} triangles, normals "
                         f"{tables.normals} and {tables.n_aux} aux columns; "
                         f"the call asks {T}, {normals} and {n_aux}")


def _launch(ro_comps, rd_comps, bound, tables: Tables, any_hit: bool):
    """Launch the closest-hit (bound: t_init or None) or any-hit (bound:
    dist) kernel over `tables`."""
    device = ro_comps[0].device
    R = check_rays(ro_comps, rd_comps, device,
                   () if bound is None else (bound,))
    words = tables.words
    build.check_arg("tables.block", tables.block, (words,), device)
    staged = 4 * words <= STAGE_BYTES
    # The int output (hit flags or winning rows) has one more word: the
    # persistent grid's chunk counter, which the launch zeroes.
    ints = torch.empty(R + 1, dtype=torch.int32, device=device)
    head = (*(c.data_ptr() for c in (*ro_comps, *rd_comps)),
            build.ptr(bound), tables.block.data_ptr(), words, tables.T,
            tables.group, tables.chunk)
    tail = (R, int(staged), ints.data_ptr() + 4 * R, build.stream(device))
    lib = build.load_library()
    if any_hit:
        with build.device_guard(device):
            rc = lib.any_triangle_launch(*head, ints.data_ptr(), *tail)
        build.check_launch("any_triangle", rc)
        build.count(globals(), "any_launches")
        return ints[:R]
    build.check_arg("tables.payload", tables.payload,
                    tuple(tables.payload.shape), device)
    n_float = 3 + (3 if tables.normals else 0) + tables.n_aux
    fout = torch.empty((n_float, R), dtype=torch.float32, device=device)
    with build.device_guard(device):
        rc = lib.closest_triangle_launch(
            *head, tables.payload.data_ptr(), tables.payload.shape[1],
            int(tables.normals), tables.n_aux, fout.data_ptr(),
            ints.data_ptr(), *tail)
    build.check_launch("closest_triangle", rc)
    build.count(globals(), "closest_launches")
    rows = fout.unbind(0)
    return rows[:3] + (ints[:R],) + rows[3:]


def closest_triangle(ro_comps, rd_comps, tri_comps, t_init=None, aux=(),
                     tables: Optional[Tables] = None):
    """Closest hit over triangles -> (t, u, v, idx[, nx, ny, nz][, *aux])
    [R] tensors (idx int32).

    ro/rd_comps: 3-tuples of [R]; tri_comps: 9 [T] columns (p1, e1, e2
    xyz), or 18 with the vertex normals (n1, n2, n3 xyz), in which case
    the winner's interpolated normal (unnormalized) is returned; `t_init`
    ([R], optional) keeps only hits with t < t_init; `aux` ([T] columns,
    e.g. prim id and shade class as floats) is selected for the winner.
    `tables`: the kernel's tables for these columns (chunk_tables);
    without them the kernel's are built for this call. The plain version
    takes no tables (it refuses tables built for other columns all the
    same)."""
    aux = tuple(aux)
    if tables is not None:
        check_tables(tables, tri_comps[0].shape[0], len(tri_comps) == 18,
                     len(aux), any_hit=False)
    if ro_comps[0].device.type == "cpu":
        return closest_triangle_reference(ro_comps, rd_comps, tri_comps,
                                          t_init, aux)
    if tables is None:
        check_table(tri_comps, aux, ro_comps[0].device)
        tables = chunk_tables(tri_comps, aux)
    return _launch(ro_comps, rd_comps, t_init, tables, any_hit=False)


def any_triangle(ro_comps, rd_comps, tri_comps, dist,
                 tables: Optional[Tables] = None):
    """Shadow any-hit: is some triangle hit with 0 <= t < dist? -> [R]
    int32 (1 = occluded). tri_comps: at least the 9 geometry columns;
    `tables`: as closest_triangle's (the closest call's may be shared)."""
    if tables is not None:
        check_tables(tables, tri_comps[0].shape[0], False, 0, any_hit=True)
    if ro_comps[0].device.type == "cpu":
        return any_triangle_reference(ro_comps, rd_comps, tri_comps, dist)
    if tables is None:
        check_table(tri_comps[:9], (), ro_comps[0].device)
        tables = chunk_tables(tri_comps[:9])
    return _launch(ro_comps, rd_comps, dist, tables, any_hit=True)
