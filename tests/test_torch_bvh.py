"""The BVH kernel's card tree (kernels/bvh.py card_tables) and the
kernels' per-scene tables, on the CPU.

The tree's invariants are checked on the node rows as the walk
(csrc/mesh_device.cuh bvh_walk) reads them: every triangle lies in
exactly one live leaf, every box is the union of what lies under it,
and no padding subtree can be entered. The fast node builds the BVH
tables and the area-shadow kernel's prim rows once per scene and passes
them to every call of a render (both levels of a reflective scene,
closest and shadow calls alike)."""
import numpy as np
import pytest
import torch

from rray_tpu_torch import api
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.kernels import analytic, bvh


def _columns(T, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.0, 2.0, (3, T))
    cols = [*(centers + rng.uniform(-0.3, 0.3, (3, T))),
            *rng.uniform(-0.6, 0.6, (6, T))]
    return tuple(torch.from_numpy(np.float32(c)) for c in cols)


def _rows(tables):
    """(slab floats [Lp, 12], live counts [Lp, 4]) of the node rows."""
    nodes = tables.block[:tables.Lp * bvh.NODE].reshape(tables.Lp, bvh.NODE)
    return nodes[:, :12].numpy(), nodes[:, 12:].contiguous().view(
        torch.int32).numpy()


@pytest.mark.parametrize("T,leaf", [(1536, 8), (3120, 4), (37, 16), (5, 8),
                                    (20000, 8)])
def test_card_tree_invariants(T, leaf):
    cols = _columns(T, T)
    tables = bvh.card_tables(cols, leaf=leaf)
    Lp = tables.Lp
    assert (Lp, tables.leaf, tables.T) == (bvh.tree_sizes(T, leaf)[0], leaf,
                                           T)
    assert tables.block.shape == (Lp * bvh.NODE + T * bvh.WALK,)
    slabs, counts = _rows(tables)
    walk = tables.block[Lp * bvh.NODE:].reshape(T, bvh.WALK).numpy()
    np.testing.assert_array_equal(walk[:, :9], np.stack(cols, 1))
    assert not walk[:, 9:].any()
    v = [np.stack([walk[:, j], walk[:, j] + walk[:, 3 + j],
                   walk[:, j] + walk[:, 6 + j]]) for j in range(3)]
    lo = np.stack([x.min(0) for x in v])  # [3, T]
    hi = np.stack([x.max(0) for x in v])

    def box(n):  # heap node n's box (lo xyz, hi xyz) from its parent's row
        row, k = (slabs[0], 0) if n == 1 else (slabs[n >> 1], 2 * (n & 1))
        return (np.array([row[4 * j + k] for j in range(3)]),
                np.array([row[4 * j + k + 1] for j in range(3)]))

    def count(n):
        return counts[0, 0] if n == 1 else counts[n >> 1, n & 1]

    assert count(1) == T
    seen = np.zeros(T, np.int64)
    stack = [1]
    while stack:  # every live node, as the walk may enter it
        n = stack.pop()
        blo, bhi = box(n)
        first = n
        while first < Lp:
            first *= 2
        r0 = (first - Lp) * leaf
        span = min(T, r0 + count(n))
        assert 0 < count(n) and r0 < T
        # The box is the union of the triangles under it.
        np.testing.assert_array_equal(blo, lo[:, r0:span].min(1))
        np.testing.assert_array_equal(bhi, hi[:, r0:span].max(1))
        if n >= Lp:
            assert count(n) == min(leaf, T - r0)
            seen[r0:r0 + count(n)] += 1
            continue
        for c in (2 * n, 2 * n + 1):
            if count(c) == 0:
                # Padding: every leaf under c lies past the last triangle,
                # and its zeroed box is never tested.
                f = c
                while f < Lp:
                    f *= 2
                assert (f - Lp) * leaf >= T
                assert not box(c)[0].any() and not box(c)[1].any()
            else:
                assert count(c) <= count(n)
                stack.append(c)
        assert count(2 * n) + count(2 * n + 1) == count(n)
    np.testing.assert_array_equal(seen, 1)


def test_bvh_tables_built_once_per_scene(tmp_path, monkeypatch):
    """A reflective 1104-triangle mesh scene renders through the fast
    node's BVH calls (closest and shadow, primary and reflected levels),
    all with the one set of tables built for the scene."""
    path = ms.write_scene(str(tmp_path), "m", lat_lon=(24, 24),
                          reflective=0.3)
    seen = []
    kernel = bvh.bvh_closest_triangle

    def spy(*args, **kw):
        seen.append((kw["tables"], kw.get("any_hit", False)))
        return kernel(*args, **kw)

    monkeypatch.setattr(bvh, "bvh_closest_triangle", spy)
    before = bvh.tree_builds
    image = api.render_scene_from_file(path, 12, 9, "", device="cpu")
    assert np.isfinite(image).all()
    assert bvh.tree_builds == before + 1
    assert len({id(t) for t, _ in seen}) == 1
    assert {a for _, a in seen} == {False, True}
    assert len(seen) >= 4  # closest and shadow on at least two levels
    assert seen[0][0].T == 1104


def test_occluder_rows_built_once_per_scene(tmp_path, monkeypatch):
    """An area-light scene of 21 analytic prims (past the whitted
    kernel's 16: the fast node) over a reflective floor calls the
    area-shadow kernel on every level, with the prim rows built once."""
    path = ms.write_scene(str(tmp_path), "a", lat_lon=None, spheres=20,
                          reflective=0.3, area_level=2)
    built, calls = [], []
    rows, kernel = analytic.occlusion_params, analytic.area_shadow_fraction
    monkeypatch.setattr(analytic, "occlusion_params",
                        lambda *a: built.append(1) or rows(*a))
    monkeypatch.setattr(analytic, "area_shadow_fraction",
                        lambda *a, **k: calls.append(a[3]) or kernel(*a, **k))
    image = api.render_scene_from_file(path, 12, 9, "", device="cpu")
    assert np.isfinite(image).all()
    assert len(built) == 1 and len(calls) >= 2
    assert all(p is calls[0] for p in calls)
