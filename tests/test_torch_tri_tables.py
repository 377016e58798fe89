"""The triangle kernels' per-scene tables (kernels/triangles.py
chunk_tables), on the CPU.

The block is checked as the kernels' fold (csrc/mesh_device.cuh
group_fold) reads it: the whole table's box, one box per chunk and per
group, each computed exactly as chunk_boxes computes it and holding its
rows' three vertices, then the geometry rows. The fast node builds the
tables once per scene and passes them to every closest and any-hit call
of a render (ops/soa.py `_tri_tables`), and a wrapper refuses tables
built for another triangle table."""
import numpy as np
import pytest
import torch

from rray_tpu_torch import api
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.kernels import triangles


def _columns(T, seed, normals=False):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2.0, 2.0, (3, T))
    cols = [*(centers + rng.uniform(-0.3, 0.3, (3, T))),
            *rng.uniform(-0.6, 0.6, (6, T))]
    if normals:
        cols += list(rng.normal(size=(9, T)))
    return tuple(torch.from_numpy(np.float32(c)) for c in cols)


@pytest.mark.parametrize("T,group", [(200, 8), (333, 8), (333, 16),
                                     (1008, 8), (37, 4), (5, 8)])
def test_chunk_tables_layout_and_boxes(T, group):
    cols = _columns(T, T)
    aux = (torch.arange(T, dtype=torch.float32),)
    tables = triangles.chunk_tables(cols, aux, group)
    chunk = tables.chunk
    assert chunk % group == 0 and chunk >= triangles.chunk_size(T)
    assert chunk - group < triangles.chunk_size(T)
    n_chunks, n_groups = -(-T // chunk), -(-T // group)
    assert tables.block.shape == (tables.words,)
    assert tables.words == (triangles.BOX * (1 + n_chunks + n_groups)
                            + triangles.ROW * T)
    box = tables.block[:triangles.BOX * (1 + n_chunks + n_groups)]
    box = box.reshape(-1, triangles.BOX).numpy()
    assert not box[:, 3].any() and not box[:, 7].any()
    lo, hi = box[:, :3].T, box[:, 4:7].T  # [3, 1 + n_chunks + n_groups]
    chunks = triangles.chunk_boxes(cols, chunk).numpy()
    groups = triangles.chunk_boxes(cols, group).numpy()[:, :-1]
    np.testing.assert_array_equal(lo[:, 0], chunks[:3, -1])
    np.testing.assert_array_equal(hi[:, 0], chunks[3:, -1])
    np.testing.assert_array_equal(lo[:, 1:1 + n_chunks], chunks[:3, :-1])
    np.testing.assert_array_equal(hi[:, 1:1 + n_chunks], chunks[3:, :-1])
    np.testing.assert_array_equal(lo[:, 1 + n_chunks:], groups[:3])
    np.testing.assert_array_equal(hi[:, 1 + n_chunks:], groups[3:])
    rows = tables.block[box.size:].reshape(T, triangles.ROW).numpy()
    np.testing.assert_array_equal(rows[:, :9], np.stack(cols, 1))
    assert not rows[:, 9:].any()
    # Every box holds the three vertices of each of its rows.
    v = np.stack([[rows[:, j], rows[:, j] + rows[:, 3 + j],
                   rows[:, j] + rows[:, 6 + j]] for j in range(3)])
    for size, first in ((T, 0), (chunk, 1), (group, 1 + n_chunks)):
        k = first + np.arange(T) // size
        assert (lo[:, k][:, None] <= v).all() and (v <= hi[:, k][:, None]).all()
    np.testing.assert_array_equal(tables.payload.numpy(),
                                  np.stack(cols + aux, 1))
    assert (tables.T, tables.group, tables.normals, tables.n_aux) == (
        T, group, False, 1)


def test_tri_tables_built_once_per_scene(tmp_path, monkeypatch):
    """Nine 60-triangle meshes under an area light (level 2) render
    through the fast node's triangle calls: the closest call and every
    sample row's any-hit call, with the one set of tables built for the
    scene."""
    path = ms.write_scene(str(tmp_path), "a9", lat_lon=(6, 6), grid=True,
                          area_level=2)
    seen = []

    def spy(kernel, any_hit):
        def call(*args, **kw):
            seen.append((kw["tables"], any_hit))
            return kernel(*args, **kw)
        return call

    monkeypatch.setattr(triangles, "closest_triangle",
                        spy(triangles.closest_triangle, False))
    monkeypatch.setattr(triangles, "any_triangle",
                        spy(triangles.any_triangle, True))
    before = triangles.table_builds
    image = api.render_scene_from_file(path, 12, 9, "", device="cpu")
    assert np.isfinite(image).all()
    assert triangles.table_builds == before + 1
    assert len({id(t) for t, _ in seen}) == 1
    assert [a for _, a in seen].count(False) == 1
    assert [a for _, a in seen].count(True) == 2  # one call per sample row
    assert seen[0][0].T == 540 and seen[0][0].normals


def test_mismatched_tables_are_refused():
    cols = _columns(200, 1, normals=True)
    aux = (torch.arange(200, dtype=torch.float32),)
    tables = triangles.chunk_tables(cols, aux)
    rng = np.random.default_rng(2)
    rays = tuple(tuple(torch.from_numpy(np.float32(rng.normal(size=16)))
                       for _ in range(3)) for _ in range(2))
    dist = torch.full((16,), 10.0)
    want = triangles.closest_triangle(*rays, cols, aux=aux)
    got = triangles.closest_triangle(*rays, cols, aux=aux, tables=tables)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    # Any-hit reads no payload: the closest call's tables serve it.
    assert torch.equal(triangles.any_triangle(*rays, cols[:9], dist,
                                              tables=tables),
                       triangles.any_triangle(*rays, cols[:9], dist))
    short = tuple(c[:199] for c in cols)
    with pytest.raises(ValueError, match="200 triangles"):
        triangles.closest_triangle(*rays, short, aux=(aux[0][:199],),
                                   tables=tables)
    with pytest.raises(ValueError, match="200 triangles"):
        triangles.any_triangle(*rays, short[:9], dist, tables=tables)
    with pytest.raises(ValueError, match="normals True"):
        triangles.closest_triangle(*rays, cols[:9], aux=aux, tables=tables)
    with pytest.raises(ValueError, match="1 aux columns"):
        triangles.closest_triangle(*rays, cols, tables=tables)
