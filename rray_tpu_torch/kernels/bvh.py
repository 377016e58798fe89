"""BVH-guided closest hit and shadow any-hit over large meshes: CUDA
kernel, plain PyTorch version, the trees and the wrapper.

Port of rray_tpu's Pallas kernel `rray_tpu/kernels/bvh.py::
bvh_closest_triangle` (ROADMAP B4). The tree is rray_tpu's: an implicit
complete binary heap over the power-of-two-padded list of leaves, each
leaf a run of `leaf` Morton-ordered triangles, node i's children 2i and
2i + 1, leaves the nodes [Lp, 2Lp), boxes unioned bottom up
(`build_tree`, here as torch ops on the table's device, with rray_tpu's
sub-leaf boxes).

The card's tree (`card_tables`) is that heap with leaves of LEAF
triangles: rray_tpu sizes its leaves (`RenderSettings.bvh_leaf`, raised
to fit 2048 leaves) for the TPU's SMEM and DMAs; the card reads its
tables through L1 or stages them in shared memory, and walks small
leaves. Each internal node's row holds both children's boxes and live
triangle counts (padding subtrees get count 0 and are never entered);
the walk table holds p1 e1 e2 only. The fast node builds the tables
once per scene (ops/soa.py `_bvh_tables`) and passes them in.

The CUDA source is kernels/csrc/bvh.cu (the walk is `bvh_walk` in
mesh_device.cuh): one thread per ray, and the 32 rays of a warp walk
together: a visit reads a node row once for the warp, every lane tests
both children against min(its best t, dist), and the warp walks the
child more lanes find nearer first and marks the other in a per-depth
bit trail (no stack). Hits compare on (t, triangle index), so the
lowest index wins ties in any visit order.

The plain version is the exhaustive scan of kernels/triangles.py: the
BVH changes which triangles are tested, not the result.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import profiling
from . import triangles as tri

# Triangles per leaf of the card's tree (PERF.md: the leaf-size sweep).
LEAF = 4
NODE = 16      # floats per node row (csrc/mesh_device.cuh BVH_NODE)
WALK = 12      # floats per walk row (BVH_TRI)
# Node and walk tables up to this size are staged in shared memory by a
# persistent grid (the 227 KB a block may opt in to); larger ones are
# read through L1.
STAGE_BYTES = 227 * 1024

# Kernel launches made by `bvh_closest_triangle` in this process, and
# card trees built (`card_tables`).
launches = 0
tree_builds = 0


def tree_sizes(T: int, leaf: int):
    """(leaves padded to a power of two, padded triangle count)."""
    L = -(-T // leaf)
    Lp = 1
    while Lp < L:
        Lp *= 2
    return Lp, Lp * leaf


def build_tree(p1, e1, e2, leaf: int, subl: int):
    """Implicit-heap BVH over Morton-ordered triangles.

    p1/e1/e2: 3-tuples of [T] component tensors. Returns (node boxes
    [6, 2Lp] (lo xyz, hi xyz; node 0 unused), sub-leaf boxes
    [6, Lp * leaf // subl], Lp). Leaves past the last triangle, and
    sub-leaves without one, get inverted boxes (+inf lo, -inf hi)."""
    T = p1[0].shape[0]
    Lp, Tp = tree_sizes(T, leaf)
    n_sub = Tp // subl
    pad = Tp - T
    inf = float("inf")
    live = torch.arange(Tp, device=p1[0].device) < T
    pad1 = lambda c, v: torch.nn.functional.pad(c, (0, pad), value=v)
    lo, hi, slo, shi = [], [], [], []
    for j in range(3):
        v1 = pad1(p1[j], tri.FAR)
        v2 = v1 + pad1(e1[j], 0.0)
        v3 = v1 + pad1(e2[j], 0.0)
        mn = torch.where(live, torch.minimum(torch.minimum(v1, v2), v3), inf)
        mx = torch.where(live, torch.maximum(torch.maximum(v1, v2), v3), -inf)
        for n, size, out_lo, out_hi in ((Lp, leaf, lo, hi),
                                        (n_sub, subl, slo, shi)):
            any_live = live.reshape(n, size).any(1)
            out_lo.append(torch.where(any_live, mn.reshape(n, size).amin(1),
                                      inf))
            out_hi.append(torch.where(any_live, mx.reshape(n, size).amax(1),
                                      -inf))
    nodes = []
    for j in range(3):
        for leaves, join, unused in ((lo[j], torch.minimum, inf),
                                     (hi[j], torch.maximum, -inf)):
            levels = [leaves]
            while levels[0].shape[0] > 1:
                levels.insert(0, join(levels[0][0::2], levels[0][1::2]))
            nodes.append(torch.cat([leaves.new_full((1,), unused)] + levels))
    node_boxes = torch.stack(nodes[0::2] + nodes[1::2])
    return node_boxes.contiguous(), torch.stack(slo + shi).contiguous(), Lp


def bvh_closest_triangle_reference(ro_comps, rd_comps, tri_comps, dist=None,
                                   aux=(), any_hit: bool = False,
                                   chunk: int = 512):
    """Plain PyTorch version of `bvh_closest_triangle` (the exhaustive
    scan; no tree)."""
    if not any_hit:
        return tri.closest_triangle_reference(ro_comps, rd_comps, tri_comps,
                                              dist, aux, chunk)
    hit = tri.any_triangle_reference(ro_comps, rd_comps, tri_comps, dist,
                                     chunk) != 0
    zero = torch.zeros_like(ro_comps[0])
    return (torch.where(hit, 0.0, float("inf")).to(zero.dtype), zero, zero,
            torch.zeros_like(hit, dtype=torch.int32))


class Tables(NamedTuple):
    """The card's tree for one triangle table (`card_tables`)."""

    block: torch.Tensor   # [Lp * NODE + T * WALK] float32: nodes, walk rows
    payload: torch.Tensor  # [T, K] p1 e1 e2 [n1 n2 n3] [aux] (write_hit)
    T: int
    Lp: int
    leaf: int
    normals: bool
    n_aux: int


def card_nodes(node_boxes, T: int, Lp: int, leaf: int):
    """Node rows [Lp, NODE] of the card's tree from build_tree's heap
    boxes [6, 2Lp]: row n (1 <= n < Lp) the x, y, z slabs of children 2n
    and 2n + 1 (lo, hi, lo, hi), then their live triangle counts as
    int32 bits and two zeros; row 0 the root's slabs and count in the
    left places. Children without a triangle get count 0 and a zero
    box."""
    device = node_boxes.device
    first = torch.arange(Lp, device=device) * leaf
    counts = [torch.clamp(T - first, 0, leaf).to(torch.int32)]
    while counts[0].shape[0] > 1:
        counts.insert(0, counts[0][0::2] + counts[0][1::2])
    count = torch.cat([counts[0].new_zeros(1)] + counts)  # heap index
    live = count > 0
    boxes = torch.where(live, node_boxes.float(), 0.0)
    left = torch.arange(2, 2 * Lp, 2, device=device)
    pair = lambda a: torch.stack([a[left], a[left + 1]], 1)
    rows = [torch.cat([pair(boxes[j]), pair(boxes[3 + j])], 1)[:, [0, 2, 1, 3]]
            for j in range(3)]
    meta = torch.zeros((Lp, 4), dtype=torch.int32, device=device)
    meta[0, 0] = count[1]
    meta[1:, 0], meta[1:, 1] = count[left], count[left + 1]
    root = torch.zeros((1, 12), dtype=torch.float32, device=device)
    root[0, 0::4], root[0, 1::4] = boxes[:3, 1], boxes[3:, 1]
    slabs = torch.cat([root, torch.cat(rows, 1)])
    return torch.cat([slabs, meta.view(torch.float32)], 1).contiguous()


def card_tables(tri_comps, aux=(), leaf: int = LEAF) -> Tables:
    """The card's tree and tables for a triangle table (9 or 18 [T]
    columns, and aux columns), built with torch ops on its device:
    rray_tpu's heap (`build_tree`) with leaves of `leaf` triangles, the
    node rows (`card_nodes`), the walk rows (p1 e1 e2 and three zeros)
    and the payload table (triangles.pack_table)."""
    from . import build

    with profiling.span("tables"):
        T = tri_comps[0].shape[0]
        node_boxes, _, Lp = build_tree(tri_comps[0:3], tri_comps[3:6],
                                       tri_comps[6:9], leaf, leaf)
        walk = torch.zeros((T, WALK), dtype=torch.float32,
                           device=tri_comps[0].device)
        walk[:, :9] = torch.stack([c.float() for c in tri_comps[:9]], 1)
        block = torch.cat([card_nodes(node_boxes, T, Lp, leaf).reshape(-1),
                           walk.reshape(-1)])
        build.count(globals(), "tree_builds")
        return Tables(block, tri.pack_table(tri_comps, aux), T, Lp, leaf,
                      len(tri_comps) == 18, len(aux))


def _launch(ro_comps, rd_comps, tri_comps, dist, aux, any_hit, tables):
    from . import build

    device = ro_comps[0].device
    R = tri.check_rays(ro_comps, rd_comps, device,
                       () if dist is None else (dist,))
    if any_hit and (len(tri_comps) == 18 or aux):
        raise ValueError("any-hit reports no payload: pass the 9 geometry "
                         "columns and no aux")
    normals = len(tri_comps) == 18
    T = tri_comps[0].shape[0]  # the kernel reads the tables, not these
    if tables.T != T or (not any_hit and (tables.normals, tables.n_aux)
                         != (normals, len(aux))):
        raise ValueError(f"the tables hold {tables.T} triangles, normals "
                         f"{tables.normals} and {tables.n_aux} aux columns; "
                         f"the call asks {T}, {normals} and {len(aux)}")
    build.check_arg("tables.block", tables.block,
                    (tables.Lp * NODE + T * WALK,), device)
    build.check_arg("tables.payload", tables.payload,
                    tuple(tables.payload.shape), device)
    n_float = 3 + (3 if normals else 0) + len(aux)
    fout, iout = tri.hit_outputs(R, n_float, device)
    words = tables.block.shape[0]
    staged = 4 * words <= STAGE_BYTES
    counter = (torch.zeros(1, dtype=torch.int32, device=device) if staged
               else None)
    with torch.cuda.device(device):
        rc = build.load_library().bvh_closest_launch(
            *(build.ptr(c) for c in tuple(ro_comps) + tuple(rd_comps)),
            build.ptr(dist), build.ptr(tables.block), tables.Lp * NODE,
            words, T, tables.Lp, tables.leaf, int(any_hit),
            build.ptr(tables.payload), tables.payload.shape[1], int(normals),
            len(aux), build.ptr(fout), build.ptr(iout), R, int(staged),
            build.ptr(counter), build.stream(device))
    build.check_launch("bvh_closest_triangle", rc)
    build.count(globals(), "launches")
    rows = fout.unbind(0)
    return rows[:3] + (iout,) + rows[3:]


def bvh_closest_triangle(ro_comps, rd_comps, tri_comps, dist=None, aux=(),
                         leaf: int = LEAF, any_hit: bool = False,
                         tables: Optional[Tables] = None):
    """BVH closest hit (or bounded any-hit) over triangles -> (t, u, v,
    idx[, nx, ny, nz][, *aux]), as kernels/triangles.closest_triangle
    returns them; `dist` ([R], optional) keeps only hits with t < dist.
    any_hit=True returns t = 0 where some triangle lies in [0, dist) and
    +inf elsewhere, with zero u, v and idx (and takes no normals or aux).
    `tables`: the card's tree for these columns (card_tables; any-hit may
    share the closest call's); without them the kernel's tree is built
    for this call with leaves of `leaf` triangles. The plain version
    scans without a tree."""
    if any_hit and dist is None:
        raise ValueError("any-hit needs `dist`")
    if ro_comps[0].device.type == "cpu":
        return bvh_closest_triangle_reference(ro_comps, rd_comps, tri_comps,
                                              dist, aux, any_hit)
    aux = tuple(aux)
    if tables is None:
        tri.check_table(tri_comps, aux, ro_comps[0].device)
        tables = card_tables(tri_comps, aux, leaf)
    return _launch(ro_comps, rd_comps, tri_comps, dist, aux, any_hit, tables)
