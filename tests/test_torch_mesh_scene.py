"""rray_tpu_torch's mesh tables against rray_tpu's: compile_scene on OBJ
scenes (smooth and flat triangles, a transformed group, several meshes)
in float64, the Morton order included; the whitted kernel's packed mesh
tables; the triangle kernels' chunk boxes; the BVH's sizes and boxes.
Every comparison is exact: both packages run the same numpy (compile)
or the same float32 operations in the same order (packing, boxes)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rray_tpu.io.yaml_loader as jax_yaml
import rray_tpu_torch.io.yaml_loader as torch_yaml
import torch_mesh_parity as mp
from rray_tpu import compile_scene as jax_compile_scene
from rray_tpu.kernels import bvh as jax_bvh
from rray_tpu.kernels import triangles as jax_triangles
from rray_tpu.kernels import whitted as jax_whitted
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.kernels import bvh, triangles, whitted
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy
from rray_tpu_torch.scene.data import compile_scene
from test_torch_host import _assert_tree_equal

SCENES = {"smooth": dict(lat_lon=(5, 6)),
          "flat_spheres_reflective": dict(lat_lon=(4, 5), smooth=False,
                                          spheres=3, reflective=0.3),
          "nine_groups": dict(lat_lon=(3, 4), grid=True)}


def _compile_both(path, jdtype, tdtype):
    _, lights, shapes = jax_yaml.load_scene_file(path)
    _, t_lights, t_shapes = torch_yaml.load_scene_file(path)
    return (jax_compile_scene(shapes, lights, dtype=jdtype),
            compile_scene(t_shapes, t_lights, dtype=tdtype, device="cpu"))


@pytest.mark.parametrize("name", list(SCENES))
def test_compile_scene_mesh_tables_match_f64(name, tmp_path):
    path = ms.write_scene(str(tmp_path), name, **SCENES[name])
    jscene, tscene = _compile_both(path, jnp.float64, torch.float64)
    assert tscene.counts[6] > 0
    _assert_tree_equal(scene_to_numpy(jscene), scene_to_numpy(tscene))
    carried = scene_from_numpy(*scene_to_numpy(jscene), device="cpu")
    _assert_tree_equal(scene_to_numpy(carried), scene_to_numpy(tscene))


def test_group_transform_and_flat_normals(tmp_path):
    """A triangle under a transformed group: world-space vertices, unit
    flat normals, the group's composed class row."""
    from rray_tpu import mathutils as jmu
    from rray_tpu.scene.data import Material as JMaterial
    from rray_tpu.scene.data import PointLight as JPointLight
    from rray_tpu.scene.data import Shape as JShape
    from rray_tpu_torch import mathutils as tmu
    from rray_tpu_torch.scene.data import Material, PointLight, Shape

    def scene(Sh, Mat, Light, mu):
        mat = Mat()
        tri = lambda a, b, c: Sh("triangle", material=mat, p1=np.array(a),
                                 p2=np.array(b), p3=np.array(c))
        group = Sh("group", transform=mu.compose(
            [mu.rotate_y(0.4), mu.scale(2.0, 1.0, 0.5),
             mu.translate(0.0, 1.0, 2.0)]),
            children=(tri([0, 0, 0], [1, 0, 0], [0, 1, 0]),
                      tri([0, 0, 0], [0, 1, 0], [0, 0, 1]),
                      Sh("sphere", material=Mat())))
        return [group], [Light(np.array([-10.0, 10.0, -10.0]), np.ones(3))]

    jscene = jax_compile_scene(*scene(JShape, JMaterial, JPointLight, jmu),
                               dtype=jnp.float64)
    tscene = compile_scene(*scene(Shape, Material, PointLight, tmu),
                           dtype=torch.float64, device="cpu")
    assert tscene.counts[6] == 2 and tscene.n_classes == 2
    np.testing.assert_allclose(
        np.linalg.norm(tscene.tri_n1.numpy(), axis=1), 1.0, atol=1e-12)
    _assert_tree_equal(scene_to_numpy(jscene), scene_to_numpy(tscene))


@pytest.mark.parametrize("name", list(SCENES))
def test_packed_mesh_tables_match_f32(name, tmp_path):
    """The whitted kernel's inputs: one prim row per analytic prim and
    per material group (rray_tpu packs one per triangle), the padded
    triangle table and chunk boxes, the pattern roots per row."""
    _, jscene, tscene = mp.scenes(tmp_path, name, "float32", **SCENES[name])
    rows = whitted.prim_rows(tscene)
    np.testing.assert_array_equal(
        np.asarray(jax_whitted.pack_prims(jscene))[rows],
        whitted.pack_prims(tscene).numpy())
    jtbl, jboxes = jax_whitted.pack_tris(jscene)
    ttbl, tboxes = whitted.pack_tris(tscene)
    np.testing.assert_array_equal(np.asarray(jtbl), ttbl.numpy())
    np.testing.assert_array_equal(np.asarray(jboxes), tboxes.numpy())
    Tp, reps = jax_whitted.mesh_meta(jscene)
    assert Tp == ttbl.shape[0] and rows[-len(reps):] == list(reps)
    assert whitted._tri_groups(tscene) == jax_whitted._tri_groups(jscene)


@pytest.mark.parametrize("T", [1, 40, 200, 333, 1024, 1536])
def test_chunk_size_and_boxes_match(T):
    assert triangles.chunk_size(T) == jax_triangles.chunk_size(T)
    _, _, cols, _ = mp.seeded_mesh(T, 1, seed=T)
    chunk = triangles.chunk_size(T)
    boxes = triangles.chunk_boxes([torch.from_numpy(c) for c in cols], chunk)
    n = -(-T // chunk)
    assert boxes.shape == (6, n + 1)
    if T % chunk == 0:
        np.testing.assert_array_equal(
            np.asarray(jax_triangles._chunk_boxes(
                [jnp.asarray(c) for c in cols], chunk)),
            boxes[:, :n].numpy())
    # The last column boxes the whole table.
    v = [cols[j] + np.zeros(1, np.float32) for j in range(3)]
    lo = [min(v[j].min(), (cols[j] + cols[3 + j]).min(),
              (cols[j] + cols[6 + j]).min()) for j in range(3)]
    np.testing.assert_array_equal(boxes[:3, -1].numpy(), np.float32(lo))


@pytest.mark.parametrize("T,leaf", [(1536, 128), (3120, 128), (5000, 256),
                                    (600, 64)])
def test_build_tree_matches(T, leaf):
    assert bvh.tree_sizes(T, leaf) == jax_bvh.tree_sizes(T, leaf)
    _, _, cols, _ = mp.seeded_mesh(T, 1, seed=T)
    subl = min(leaf, 64)
    _, nlo, nhi, jsub, jLp = jax_bvh.build_tree(
        *[tuple(jnp.asarray(c) for c in cols[k:k + 3]) for k in (0, 3, 6)],
        leaf=leaf, subl=subl)
    nodes, subs, Lp = bvh.build_tree(
        *[tuple(torch.from_numpy(c) for c in cols[k:k + 3])
          for k in (0, 3, 6)], leaf=leaf, subl=subl)
    assert Lp == jLp
    np.testing.assert_array_equal(np.asarray(jnp.stack([*nlo, *nhi])),
                                  nodes.numpy())
    np.testing.assert_array_equal(np.asarray(jsub), subs.numpy())
