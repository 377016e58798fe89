"""BVH-guided closest hit and shadow any-hit over large meshes: CUDA
kernel, plain PyTorch version, the tree build and the wrapper.

Port of rray_tpu's Pallas kernel `rray_tpu/kernels/bvh.py::
bvh_closest_triangle` (ROADMAP B4). The tree is rray_tpu's: an implicit
complete binary heap over the power-of-two-padded list of leaves, each
leaf a run of `leaf` Morton-ordered triangles, node i's children 2i and
2i + 1, leaves the nodes [Lp, 2Lp), boxes unioned bottom up, and
sub-leaf boxes every `subl` triangles for a cull inside a leaf
(`build_tree`, here as torch ops on the table's device).

The CUDA source is kernels/csrc/bvh.cu (the walk is `bvh_walk` in
mesh_device.cuh). It ports what the TPU kernel returns, not its
block-synchronous schedule (one 512-ray block shares one stack and
DMAs each entered leaf): one thread walks the heap with its own stack,
left child first, and culls a node or sub-leaf it does not enter before
min(its best t, dist). Hits compare on (t, triangle index), so the
lowest index wins ties in any visit order.

The plain version is the exhaustive scan of kernels/triangles.py: the
BVH changes which triangles are tested, not the result.
"""
from __future__ import annotations

import torch

from ..config import RenderSettings
from . import triangles as tri

MAX_LEAVES = 2048   # leaf budget of the TPU kernel's SMEM node boxes
STACK = 32          # the walk's per-thread stack (depth <= log2(2048) + 1)

# Kernel launches made by `bvh_closest_triangle` in this process.
launches = 0


def auto_leaf(T: int, leaf: int) -> int:
    """Smallest multiple-of-8 leaf >= `leaf` whose padded leaf count
    fits MAX_LEAVES (rray_tpu bvh.auto_leaf)."""
    cap = 1
    while cap * 2 <= MAX_LEAVES:
        cap *= 2
    need = -(-T // cap)
    raised = -(-need // 8) * 8
    return max(leaf, raised)


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


def _launch(ro_comps, rd_comps, tri_comps, dist, aux, leaf, any_hit):
    global launches
    from . import build

    device = ro_comps[0].device
    R = tri.check_rays(ro_comps, rd_comps, device,
                       () if dist is None else (dist,))
    T = tri.check_table(tri_comps, aux, device)
    if any_hit and (len(tri_comps) == 18 or aux):
        raise ValueError("any-hit reports no payload: pass the 9 geometry "
                         "columns and no aux")
    leaf = auto_leaf(T, leaf)
    subl = min(leaf, 64)
    if leaf % subl:
        raise ValueError(f"leaf {leaf} is not a multiple of {subl}")
    nodes, subs, Lp = build_tree(tri_comps[0:3], tri_comps[3:6],
                                 tri_comps[6:9], leaf, subl)
    normals = len(tri_comps) == 18
    n_float = 3 + (3 if normals else 0) + len(aux)
    fout, iout = tri.hit_outputs(R, n_float, device)
    tbl = tri.pack_table(tri_comps, aux)
    with torch.cuda.device(device):
        rc = build.load_library().bvh_closest_launch(
            *(build.ptr(c) for c in tuple(ro_comps) + tuple(rd_comps)),
            build.ptr(dist), build.ptr(tbl), tbl.shape[1], T,
            build.ptr(nodes), build.ptr(subs), Lp, leaf, subl, int(any_hit),
            int(normals), len(aux), build.ptr(fout), build.ptr(iout), R,
            build.stream(device))
    build.check_launch("bvh_closest_triangle", rc)
    launches += 1
    rows = fout.unbind(0)
    return rows[:3] + (iout,) + rows[3:]


def bvh_closest_triangle(ro_comps, rd_comps, tri_comps, dist=None, aux=(),
                         leaf: int = RenderSettings.bvh_leaf,
                         any_hit: bool = False):
    """BVH closest hit (or bounded any-hit) over triangles -> (t, u, v,
    idx[, nx, ny, nz][, *aux]), as kernels/triangles.closest_triangle
    returns them; `dist` ([R], optional) keeps only hits with t < dist.
    any_hit=True returns t = 0 where some triangle lies in [0, dist) and
    +inf elsewhere, with zero u, v and idx (and takes no normals or aux).
    The kernel's tree has leaves of `leaf` triangles, raised by auto_leaf
    to fit MAX_LEAVES; the plain version scans without a tree."""
    if any_hit and dist is None:
        raise ValueError("any-hit needs `dist`")
    if ro_comps[0].device.type == "cpu":
        return bvh_closest_triangle_reference(ro_comps, rd_comps, tri_comps,
                                              dist, aux, any_hit)
    return _launch(ro_comps, rd_comps, tri_comps, dist, tuple(aux), leaf,
                   any_hit)
