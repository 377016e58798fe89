"""The sorted node's slot lists (rray_tpu_torch/ops/soa.py) against
rray_tpu's (ops/soa.py, pallas off) in float64 at atol 1e-9, integer
outputs exactly, on six scenes: glass, glass with its large sphere twice
(every slot of it ties in t), 17 spheres half of glass, config 5 with a
transparent CSG operand, config 5 with a tetrahedron as the CSG's
operand (folded in chunks of 2 triangles), and a transparent 16-triangle
mesh (folded in chunks of 8)."""
import numpy as np
import pytest
import torch

import torch_sorted_parity as sp
from rray_tpu.ops import soa as jsoa
from rray_tpu_torch.ops import soa


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("sorted_ops")


def _case(tmp, name):
    path, jscene, tscene, jset, tset = sp.scenes(tmp, name)
    (jo, jd), (to, td) = sp.both_rays(*sp.rays(path))
    return jscene, tscene, jset, tset, (jo, jd), (to, td)


@pytest.mark.parametrize("name", ["glassmesh", "csgmesh"])
def test_tri_chunks_and_chunk_eval(tmp, name):
    jscene, tscene, jset, tset, (jo, jd), (to, td) = _case(tmp, name)
    chunk = tset.tri_chunk
    want = jsoa._tri_chunks(jscene, chunk)
    got = soa._tri_chunks(tscene, chunk)
    assert got[:2] == want[:2] and got[0] == 2
    sp.assert_same(got[2:], want[2:], "chunks")
    n_chunks, _, p1, e1, e2 = got[:5]
    for ci in range(n_chunks):
        comps = [tuple(c[ci] for c in cols) for cols in (p1, e1, e2)]
        jcomps = [tuple(c[ci] for c in cols) for cols in want[2:5]]
        sp.assert_same(soa._tri_chunk_eval(to, td, *comps),
                       jsoa._tri_chunk_eval(jo, jd, *jcomps), f"chunk {ci}")


@pytest.mark.parametrize("name", ["glass", "twins", "glass17", "csgglass"])
def test_sorted_slots_select_and_containers_walk(tmp, name):
    """sorted_slots_soa (strict `>` swaps keep tied twins in prim
    order), the CSG filter where there is one, the first hit, and the
    n1/n2 walk at the default stack depth and at depth 1 (floored at
    the prim count)."""
    jscene, tscene, _, _, (jo, jd), (to, td) = _case(tmp, name)
    got, want = soa.sorted_slots_soa(tscene, to, td), \
        jsoa.sorted_slots_soa(jscene, jo, jd)
    sp.assert_same(got, want, "slots")
    if tscene.csg_ops:
        got, want = soa.apply_csg_soa(tscene, got), \
            jsoa.apply_csg_soa(jscene, want)
        sp.assert_same(got, want, "filtered")
        assert bool((got[2] != soa.sorted_slots_soa(tscene, to, td)[2]).any())
    sel, jsel = soa.select_hit_slots(got), jsoa.select_hit_slots(want)
    sp.assert_same(sel, jsel, "select")
    for depth in (8, 1):
        sp.assert_same(
            soa.refractive_indices_soa(tscene, got, sel[3], depth),
            jsoa.refractive_indices_soa(jscene, want, jsel[3], depth),
            f"n1/n2 depth {depth}")
    if name == "twins":
        t = got[0].numpy()
        assert ((t[1:] == t[:-1]) & np.isfinite(t[1:])).any()


@pytest.mark.parametrize("name", ["glassmesh", "csgmesh", "twins"])
def test_full_slots_filter_select_walk_and_shadow(tmp, name):
    """sorted_slots_full_soa (the top-max_hits triangle crossings, chunk
    by chunk), apply_csg_soa, select_hit_slots with (u, v, tri), the
    n1/n2 walk and the CSG-filtered any-hit."""
    jscene, tscene, jset, tset, (jo, jd), (to, td) = _case(tmp, name)
    got = soa.sorted_slots_full_soa(tscene, to, td, tset)
    want = jsoa.sorted_slots_full_soa(jscene, jo, jd, jset)
    sp.assert_same(got, want, "full slots")
    if tscene.csg_ops:
        got, want = soa.apply_csg_soa(tscene, got), \
            jsoa.apply_csg_soa(jscene, want)
        sp.assert_same(got, want, "filtered")
    sel, jsel = soa.select_hit_slots(got), jsoa.select_hit_slots(want)
    sp.assert_same(sel, jsel, "select")
    assert bool(sel[0].any())
    sp.assert_same(soa.refractive_indices_soa(tscene, got, sel[3]),
                   jsoa.refractive_indices_soa(jscene, want, jsel[3]), "n1/n2")
    dist = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 9.0, to.x.shape[0]))
    sp.assert_same(
        soa.any_hit_sorted_soa(tscene, to, td, dist, tset),
        jsoa.any_hit_sorted_soa(jscene, jo, jd, dist.numpy(), jset), "any")


def test_csg_operands_hybrid_path(tmp):
    """The hybrid CSG path: the operands' sorted slots, the pairwise
    filter without a sort, the filtered operand hit, the closest hit
    and any-hit with the operands skipped and merged back, and n1/n2
    from the filtered operand slots."""
    jscene, tscene, jset, tset, (jo, jd), (to, td) = _case(tmp, "csgglass")
    sp.assert_same(soa.sorted_member_slots(tscene, to, td),
                   jsoa.sorted_member_slots(jscene, jo, jd), "member slots")
    ts, pids, keeps = soa._member_slots_filtered_nosort(tscene, to, td)
    jts, jpids, jkeeps = jsoa._member_slots_filtered_nosort(jscene, jo, jd)
    assert pids == list(jpids)
    sp.assert_same((ts, keeps), (jts, jkeeps), "filtered, unsorted")
    got = soa.csg_filtered_member_hit(tscene, to, td)
    sp.assert_same(got, jsoa.csg_filtered_member_hit(jscene, jo, jd),
                   "member hit")
    dist = torch.from_numpy(np.random.default_rng(4).uniform(
        0.5, 9.0, to.x.shape[0]))
    for skip in (False, True):
        sp.assert_hit(soa.closest_hit_soa(tscene, to, td, tset, skip),
                      jsoa.closest_hit_soa(jscene, jo, jd, jset, skip),
                      f"closest skip={skip}")
        sp.assert_same(
            soa.any_hit_soa(tscene, to, td, dist, tset, skip),
            jsoa.any_hit_soa(jscene, jo, jd, dist.numpy(), jset, skip),
            f"any skip={skip}")
    hit, mslots = soa.closest_hit_hybrid(tscene, to, td, tset)
    jhit, jmslots = jsoa.closest_hit_hybrid(jscene, jo, jd, jset)
    sp.assert_hit(hit, jhit, "hybrid")
    sp.assert_same(mslots, jmslots, "hybrid slots")
    assert bool((hit.found != soa.closest_hit_soa(tscene, to, td,
                                                 tset).found).any())
    sp.assert_same(soa.any_hit_hybrid(tscene, to, td, dist, tset),
                   jsoa.any_hit_hybrid(jscene, jo, jd, dist.numpy(), jset),
                   "any hybrid")
    t_hit = torch.where(hit.found, hit.t, -1.0)
    sp.assert_same(
        soa.refractive_indices_direct(tscene, to, td, t_hit, hit.prim, tset,
                                      member_slots=mslots),
        jsoa.refractive_indices_direct(
            jscene, jo, jd, t_hit.numpy(), hit.prim.numpy(), jset,
            member_slots=jmslots), "n1/n2 direct")


@pytest.mark.parametrize("name", ["glass", "twins", "glass17", "glassmesh"])
def test_refractive_indices_direct(tmp, name):
    """n1/n2 without slots, from the port's closest hit given to both:
    per-prim crossing parities, a mesh folded chunk by chunk; on twins
    the hit's crossing ties with its twin's."""
    jscene, tscene, jset, tset, (jo, jd), (to, td) = _case(tmp, name)
    hit = soa.closest_hit_soa(tscene, to, td, tset)
    sp.assert_hit(hit, jsoa.closest_hit_soa(jscene, jo, jd, jset), "closest")
    t_hit = torch.where(hit.found, hit.t, -1.0)
    got = soa.refractive_indices_direct(tscene, to, td, t_hit, hit.prim,
                                        tset)
    sp.assert_same(got, jsoa.refractive_indices_direct(
        jscene, jo, jd, t_hit.numpy(), hit.prim.numpy(), jset), "n1/n2")
    assert bool((got[0] != got[1]).any())
