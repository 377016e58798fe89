# Frozen copy of rray_tpu_torch/ops/hits.py at commit 6dfcb62 (imports made local).
"""Per-ray hit lists on [R, 3] rays (rray_tpu ops/hits.py, the port's
own): the per-ray (AoS) replacement for Scene::intersect.

The reference walks every object and sorts a Vec<Intersection> per ray
(scene.rs:97-106). Here every primitive type contributes fixed hit
slots, which merge into a per-ray sorted top-K list (ascending t, +inf
padding). That sorted prefix drives:

* hit selection: the first slot with t >= 0 (scene.rs:128-136, 249-259);
* CSG filtering: a replay of filter_intersections (csg.rs:177-195) per
  CSG node, innermost first;
* the n1/n2 containers walk for refraction (intersection.rs:61-92).

Meshes stream in chunks of settings.tri_chunk triangles with a running
top-K merge, so memory stays bounded for large OBJ models. All of it is
plain torch ops on the rays' device; none of it calls the port's CUDA
kernels (kernels/), which this path exists to check.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import data as sd
from . import intersect

_INF = float("inf")


@dataclasses.dataclass
class Slots:
    t: Any      # [R, K] ascending, +inf padded
    prim: Any   # [R, K] int32
    u: Any      # [R, K]
    v: Any      # [R, K]
    valid: Any  # [R, K] bool


def _sort_slots(t, prim, u, v, k):
    """Sort slots ascending by t, stably, and keep the first k. -0.0
    ranks with +0.0, as lax.sort ranks them (torch.sort puts it first)."""
    keys = torch.where(t == 0.0, torch.zeros_like(t), t)
    order = torch.sort(keys, dim=1, stable=True).indices[:, :k]
    return tuple(torch.gather(a, 1, order) for a in (t, prim, u, v))


def _analytic_slots(scene: sd.SceneData, ro, rd):
    """Every analytic prim's hit slots, unsorted: (t, prim, u, v) [R, S]."""
    ns, npl, ncu, ncy, nco, nto, _, _ = scene.counts
    R = ro.shape[0]
    ts, prims = [], []

    def add(t, valid, prim_ids):
        # t, valid: [R, N, k]; prim_ids: [N].
        ts.append(torch.where(valid, t, _INF).reshape(R, -1))
        prims.append(prim_ids.to(torch.int32)[None, :, None]
                     .expand(valid.shape).reshape(R, -1))

    if ns:
        o, d = intersect.transform_rays(scene.sph_inv, ro, rd)
        add(*intersect.spheres(o, d), scene.sph_prim)
    if npl:
        o, d = intersect.transform_rays(scene.pla_inv, ro, rd)
        add(*intersect.planes(o, d), scene.pla_prim)
    if ncu:
        o, d = intersect.transform_rays(scene.cub_inv, ro, rd)
        add(*intersect.cubes(o, d), scene.cub_prim)
    if ncy:
        o, d = intersect.transform_rays(scene.cyl_inv, ro, rd)
        add(*intersect.cylinders(o, d, scene.cyl_min[None, :],
                                 scene.cyl_max[None, :],
                                 scene.cyl_closed[None, :]), scene.cyl_prim)
    if nco:
        o, d = intersect.transform_rays(scene.con_inv, ro, rd)
        add(*intersect.cones(o, d, scene.con_min[None, :],
                             scene.con_max[None, :],
                             scene.con_closed[None, :]), scene.con_prim)
    if nto:
        o, d = intersect.transform_rays(scene.tor_inv, ro, rd)
        add(*intersect.tori(o, d, scene.tor_r[None, :]), scene.tor_prim)

    if ts:
        t = torch.cat(ts, dim=1)
        prim = torch.cat(prims, dim=1)
    else:
        t = ro.new_full((R, 0), _INF)
        prim = torch.zeros((R, 0), dtype=torch.int32, device=ro.device)
    return t, prim, torch.zeros_like(t), torch.zeros_like(t)


def _tri_chunks(scene: sd.SceneData, chunk: int):
    """The triangle tables in chunks of `chunk` rows, the last one
    padded with zero triangles: (p1, e1, e2, prim ids, live mask) per
    chunk, in table order."""
    T = scene.counts[6]
    live = torch.ones(T, dtype=torch.bool, device=scene.tri_p1.device)
    for s in range(0, T, chunk):
        n = min(chunk, T - s)
        parts = [scene.tri_p1[s:s + n], scene.tri_e1[s:s + n],
                 scene.tri_e2[s:s + n], scene.tri_prim[s:s + n].to(torch.int32),
                 live[s:s + n]]
        if n < chunk:
            parts = [torch.cat([a, a.new_zeros((chunk - n,) + a.shape[1:])])
                     for a in parts]
        yield parts


def _triangle_topk(scene: sd.SceneData, ro, rd, k, chunk):
    """A running top-k merge over triangle chunks -> sorted (t, prim, u,
    v) [R, min(k, T)], ties in chunk order."""
    T = scene.counts[6]
    R = ro.shape[0]
    kk = min(k, T)
    ct = ro.new_full((R, kk), _INF)
    cp = torch.zeros((R, kk), dtype=torch.int32, device=ro.device)
    cu = ro.new_zeros((R, kk))
    cv = ro.new_zeros((R, kk))
    for cp1, ce1, ce2, cpid, clive in _tri_chunks(scene, chunk):
        t, u, v, ok = intersect.triangles(ro, rd, cp1, ce1, ce2)
        t = torch.where(ok & clive[None, :], t, _INF)
        ct, cp, cu, cv = _sort_slots(
            torch.cat([ct, t], dim=1),
            torch.cat([cp, cpid[None, :].expand(t.shape)], dim=1),
            torch.cat([cu, u], dim=1), torch.cat([cv, v], dim=1), kk)
    return ct, cp, cu, cv


def gather_sorted_hits(scene: sd.SceneData, ro, rd, settings) -> Slots:
    """The sorted per-ray hit prefix, CSG filter applied."""
    t, prim, u, v = _analytic_slots(scene, ro, rd)
    S = t.shape[1]
    T = scene.counts[6]
    k = max(min(settings.max_hits, S + min(T, settings.max_hits)), 1)

    if T:
        tt, tp, tu, tv = _triangle_topk(scene, ro, rd, settings.max_hits,
                                        min(settings.tri_chunk, max(T, 1)))
        t = torch.cat([t, tt], dim=1)
        prim = torch.cat([prim, tp], dim=1)
        u = torch.cat([u, tu], dim=1)
        v = torch.cat([v, tv], dim=1)

    if t.shape[1] == 0:
        R = ro.shape[0]
        t = ro.new_full((R, 1), _INF)
        prim = torch.zeros((R, 1), dtype=torch.int32, device=ro.device)
        u = ro.new_zeros((R, 1))
        v = ro.new_zeros((R, 1))

    t, prim, u, v = _sort_slots(t, prim, u, v, k)
    slots = Slots(t=t, prim=prim, u=u, v=v, valid=torch.isfinite(t))
    return _apply_csg(scene, slots)


def _apply_csg(scene: sd.SceneData, slots: Slots) -> Slots:
    """Replay filter_intersections (csg.rs:177-195) per CSG node, slot by
    slot in t order. Innermost nodes run first; a hit they drop no
    longer toggles the in/out state of enclosing nodes (the reference's
    nested local_intersect composes the same way)."""
    if not scene.csg_ops:
        return slots
    valid = slots.valid
    R, K = valid.shape
    for ci, op in enumerate(scene.csg_ops):
        side = scene.csg_side[ci][slots.prim.long()]
        side = torch.where(valid, side, 0)
        inl = torch.zeros(R, dtype=torch.bool, device=valid.device)
        inr = torch.zeros_like(inl)
        keeps = []
        for j in range(K):
            s = side[:, j]
            lhit = s == 1
            if op == sd.CSG_UNION:
                allowed = (lhit & ~inr) | (~lhit & ~inl)
            elif op == sd.CSG_INTERSECTION:
                allowed = (lhit & inr) | (~lhit & inl)
            else:
                allowed = (lhit & ~inr) | (~lhit & inl)
            keeps.append(~(s > 0) | allowed)
            inl = inl ^ (s == 1)
            inr = inr ^ (s == 2)
        valid = valid & torch.stack(keeps, dim=1)
    return Slots(t=slots.t, prim=slots.prim, u=slots.u, v=slots.v,
                 valid=valid)


def _take(x, idx):
    return torch.gather(x, 1, idx[:, None])[:, 0]


def closest_hit(scene: sd.SceneData, ro, rd, settings):
    """The closest hit with t >= 0 without the sorted prefix -> (found,
    t, prim, u, v). Equal to select_hit(gather_sorted_hits(...)) where
    nothing needs the ordered list: no CSG filter (csg.rs:177-195) and
    no containers walk (intersection.rs:61-92). Ties go to the first
    slot, then to the first chunk and row."""
    t, prim, u, v = _analytic_slots(scene, ro, rd)
    t = torch.where(t >= 0.0, t, _INF)
    R = ro.shape[0]
    if t.shape[1]:
        best = torch.argmin(t, dim=1)
        best_t, best_prim = _take(t, best), _take(prim, best)
        best_u, best_v = _take(u, best), _take(v, best)
    else:
        best_t = ro.new_full((R,), _INF)
        best_prim = torch.zeros(R, dtype=torch.int32, device=ro.device)
        best_u = best_v = ro.new_zeros(R)

    T = scene.counts[6]
    if T:
        for cp1, ce1, ce2, cpid, clive in _tri_chunks(
                scene, min(settings.tri_chunk, T)):
            tt, uu, vv, ok = intersect.triangles(ro, rd, cp1, ce1, ce2)
            tt = torch.where(ok & clive[None, :] & (tt >= 0.0), tt, _INF)
            ci = torch.argmin(tt, dim=1)
            ct = _take(tt, ci)
            better = ct < best_t
            best_t = torch.where(better, ct, best_t)
            best_prim = torch.where(better, cpid[ci], best_prim)
            best_u = torch.where(better, _take(uu, ci), best_u)
            best_v = torch.where(better, _take(vv, ci), best_v)
    return torch.isfinite(best_t), best_t, best_prim, best_u, best_v


def select_hit(slots: Slots):
    """The first slot with t >= 0 (scene.rs:128-136) -> (found, slot
    index, t, prim, u, v)."""
    pos = slots.valid & (slots.t >= 0.0)
    found = torch.any(pos, dim=1)
    idx = torch.argmax(pos.to(torch.uint8), dim=1)
    return (found, idx, _take(slots.t, idx), _take(slots.prim, idx),
            _take(slots.u, idx), _take(slots.v, idx))


def shadow_hit(scene: sd.SceneData, ro, rd, distance, settings):
    """is_shadowed (scene.rs:234-245): some filtered hit with 0 <= t <
    distance -> bool [R]."""
    if scene.csg_ops:
        slots = gather_sorted_hits(scene, ro, rd, settings)
        hit = slots.valid & (slots.t >= 0.0) & (slots.t < distance[:, None])
        return torch.any(hit, dim=1)
    # Without CSG, any hit will do: no sort.
    t, _, _, _ = _analytic_slots(scene, ro, rd)
    any_hit = torch.any((t >= 0.0) & (t < distance[:, None])
                        & torch.isfinite(t), dim=1)
    T = scene.counts[6]
    if T:
        for cp1, ce1, ce2, _, clive in _tri_chunks(
                scene, min(settings.tri_chunk, T)):
            tt, _, _, ok = intersect.triangles(ro, rd, cp1, ce1, ce2)
            ok = ok & clive[None, :] & (tt >= 0.0) & (tt < distance[:, None])
            any_hit = any_hit | torch.any(ok, dim=1)
    return any_hit


def refractive_indices(scene: sd.SceneData, slots: Slots, hit_idx,
                       depth: int):
    """n1/n2 by the containers walk (intersection.rs:61-92) -> (n1, n2)
    [R]. An ordered container list per ray (append on enter, remove and
    shift on exit); the last element's refractive index is read just
    before and just after the hit's slot. The list holds
    min(max(depth, P), 64) entries: membership toggles per prim, so it
    never holds more than the scene's P prims."""
    R, K = slots.t.shape
    dtype = slots.t.dtype
    dev = slots.t.device
    cd = min(max(int(depth), int(scene.counts[7])), 64)
    arange_cd = torch.arange(cd, device=dev)
    one = torch.ones(R, dtype=dtype, device=dev)

    def top_ior(ids, size):
        last = _take(ids, torch.clamp_min(size - 1, 0))
        ior = scene.mat_ior[torch.clamp_min(last, 0).long()]
        return torch.where(size == 0, one, ior)

    ids = torch.full((R, cd), -1, dtype=torch.int32, device=dev)
    size = torch.zeros(R, dtype=torch.int64, device=dev)
    n1 = n2 = one
    for j in range(K):
        prim, valid = slots.prim[:, j], slots.valid[:, j]
        at_hit = (hit_idx == j) & valid
        n1 = torch.where(at_hit, top_ior(ids, size), n1)

        # Toggle `prim`'s membership of the ordered container list.
        occupied = arange_cd[None, :] < size[:, None]
        eq = (ids == prim[:, None]) & occupied
        present = torch.any(eq, dim=1)
        pos = torch.argmax(eq.to(torch.uint8), dim=1)
        shifted = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -1)],
                            dim=1)
        removed = torch.where(arange_cd[None, :] >= pos[:, None], shifted,
                              ids)
        pushed = torch.where(arange_cd[None, :] == size[:, None],
                             prim[:, None], ids)
        new_ids = torch.where(present[:, None], removed, pushed)
        new_size = torch.where(present, size - 1,
                               torch.clamp_max(size + 1, cd))
        ids = torch.where(valid[:, None], new_ids, ids)
        size = torch.where(valid, new_size, size)

        n2 = torch.where(at_hit, top_ior(ids, size), n2)
    return n1, n2
