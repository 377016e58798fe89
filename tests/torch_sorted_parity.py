"""Shared inputs for the sorted-node parity tests: the scenes the sorted
torch node renders (written by rray_tpu_torch/io/mesh_scenes.py, the
writer chip_smoke.py uses), compiled once in rray_tpu and handed to the
port through scene/convert.py, seeded and camera rays, and a
comparison of nested outputs: floats within ATOL in float64, integers
and masks exactly."""
import os

import jax.numpy as jnp
import numpy as np
import torch
import yaml

import rray_tpu.io.yaml_loader as jax_yaml
import torch_mesh_parity as mp
import torch_parity as tp
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu import compile_scene
from rray_tpu.ops.vec import V3 as JV3
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.ops.vec import V3
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy

ATOL = 1e-9


def _twins(tmp):
    """glass.yaml with its large sphere twice: every slot of that sphere
    ties in t with its twin's."""
    with open(tp.GLASS) as f:
        doc = yaml.safe_load(f)
    doc["scene"].insert(2, doc["scene"][1])
    path = os.path.join(tmp, "twins.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)
    return path


# name -> (writer of the scene file under a directory, tri_chunk).
# glassmesh folds its 16 triangles in two chunks of 8, csgmesh its
# tetrahedron in two chunks of 2, as rray_tpu folds them.
SCENES = {
    "glass": (lambda tmp: tp.GLASS, 512),
    "twins": (_twins, 512),
    "glass17": (lambda tmp: ms.write_scene(tmp, "glass17", lat_lon=None,
                                           spheres=17, glass=True), 512),
    "csgglass": (lambda tmp: ms.write_config5(tmp, "csgglass",
                                              transparent_operand=0.5), 512),
    "csgmesh": (lambda tmp: ms.write_config5(tmp, "csgmesh",
                                             mesh_operand=True), 2),
    "glassmesh": (lambda tmp: ms.write_scene(tmp, "glassmesh",
                                             lat_lon=(3, 4), glass=True), 8),
}


def scenes(tmp, name):
    """(path, rray_tpu SceneData, the port's SceneData of the same
    tables, rray_tpu's settings, the port's settings), float64."""
    write, chunk = SCENES[name]
    path = write(str(tmp))
    _, lights, shapes = jax_yaml.load_scene_file(path)
    jscene = compile_scene(shapes, lights, dtype=jnp.float64)
    tscene = scene_from_numpy(*scene_to_numpy(jscene), device="cpu")
    return (path, jscene, tscene,
            JaxSettings(pallas="off", tri_chunk=chunk),
            RenderSettings(tri_chunk=chunk))


def rays(path, n=256, w=16, h=12):
    """n seeded rays and the scene camera's w x h rays, float64 numpy
    (origin xyz, direction xyz)."""
    o, d = tp.seeded_rays(np.float64, n=n)
    co, cd = mp.camera_rays(path, w, h, "float64")
    return ([np.concatenate([a, b]) for a, b in zip(o, co)],
            [np.concatenate([a, b]) for a, b in zip(d, cd)])


def both_rays(o, d):
    """The same rays as (rray_tpu V3 pair, port V3 pair)."""
    return ((JV3(*(jnp.asarray(c) for c in o)),
             JV3(*(jnp.asarray(c) for c in d))),
            (V3(*(torch.from_numpy(c) for c in o)),
             V3(*(torch.from_numpy(c) for c in d))))


def to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(port, ref, what=""):
    """Nested tuples/lists of arrays: floats within ATOL (infinities in
    the same places), integers and masks equal."""
    if isinstance(port, (tuple, list)):
        assert len(port) == len(ref), what
        for i, (a, b) in enumerate(zip(port, ref)):
            assert_same(a, b, f"{what}[{i}]")
        return
    a, b = to_numpy(port), to_numpy(ref)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if np.issubdtype(b.dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                      err_msg=what)


def assert_hit(port, ref, what=""):
    """A port Hit against rray_tpu's: found, t, prim and class, and the
    triangle row where a triangle won."""
    assert_same((port.found, port.t, port.prim, port.cls),
                (ref.found, ref.t, ref.prim, ref.cls), what)
    if port.tri is not None:
        assert_same(port.tri, ref.tri, f"{what} tri")
