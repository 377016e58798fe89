"""Shared inputs for the rray_tpu_torch mesh parity tests: mesh scenes
(rray_tpu_torch/io/mesh_scenes.py) compiled once in rray_tpu and handed
to the port through scene/convert.py, so both packages compute on the
very same tables, and the scene camera's rays."""
import jax.numpy as jnp
import numpy as np
import torch

import rray_tpu.io.yaml_loader as jax_yaml
import torch_parity as tp
from rray_tpu import compile_scene
from rray_tpu.kernels import whitted as jax_whitted
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.kernels import whitted
from rray_tpu_torch.render import camera
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy


def scenes(tmp, name, dtype, **kw):
    """(path, rray_tpu SceneData, the port's SceneData of the same
    tables) for ms.write_scene(tmp, name, **kw)."""
    path = ms.write_scene(str(tmp), name, **kw)
    _, lights, shapes = jax_yaml.load_scene_file(path)
    jscene = compile_scene(shapes, lights, dtype=getattr(jnp, dtype))
    return path, jscene, scene_from_numpy(*scene_to_numpy(jscene),
                                          device="cpu")


def camera_rays(path, w, h, dtype):
    """The scene camera's rays as numpy (origin xyz, direction xyz)."""
    cam_spec, _, _ = load_scene_file(path)
    cam = camera.Camera(w, h, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    ro, rd = camera.all_rays_soa(camera.compile_camera(
        cam, getattr(torch, dtype), "cpu"))
    return ([c.numpy() for c in (ro.x, ro.y, ro.z)],
            [c.numpy() for c in (rd.x, rd.y, rd.z)])


def seeded_mesh(T, R, seed, normals=False, spread=2.0):
    """Clustered random triangles (p1 e1 e2[, n1 n2 n3] columns) and
    rays toward them, float32 numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (3, T))
    cols = [*(centers + rng.uniform(-0.3, 0.3, (3, T))),
            *rng.uniform(-0.6, 0.6, (6, T))]
    if normals:
        cols += list(rng.normal(size=(9, T)))
    o = rng.uniform(-1, 1, (3, R)) + np.array([[0.0], [0.0], [-8.0]])
    d = rng.uniform(-0.3, 0.3, (3, R)) + np.array([[0.0], [0.0], [1.0]])
    d /= np.linalg.norm(d, axis=0)
    f32 = lambda xs: [np.ascontiguousarray(x, np.float32) for x in xs]
    return f32(o), f32(d), f32(cols), rng


def check_mesh_kernel_parity(tmp_path, reflective, depth):
    """The whitted plain version with a 36-triangle mesh against
    rray_tpu's Pallas kernel (interpret mode) on 64x64 camera rays, in
    float32 under tests/torch_parity.py's budget."""
    path, jscene, tscene = scenes(tmp_path, "mesh36", "float32",
                                     lat_lon=(4, 6), reflective=reflective)
    assert tscene.counts[6] == 36 and whitted.applicable(tscene)
    o, d = camera_rays(path, 64, 64, "float32")
    inputs = whitted.kernel_inputs(tscene, RenderSettings(depth=depth))
    assert inputs["depth"] == depth
    port = whitted.whitted_compact(*(tuple(torch.from_numpy(c) for c in x)
                                     for x in (o, d)), **inputs)
    pat, descrs = jax_whitted.pack_patterns(jscene)
    tri_tbl, tri_boxes = jax_whitted.pack_tris(jscene)
    ref = jax_whitted.whitted_compact(
        tuple(jnp.asarray(c) for c in o), tuple(jnp.asarray(c) for c in d),
        jax_whitted.pack_prims(jscene), pat, jax_whitted.pack_lights(jscene),
        jnp.zeros((depth + 1, 1), jnp.int32), kinds=tuple(jscene.prim_kinds),
        pat_descrs=descrs, prim_pat=tuple(jscene.prim_pattern_static),
        lmeta=jax_whitted.light_meta(jscene), depth=depth, W=1,
        has_refl=jscene.has_reflective, has_refr=False, tri_tbl=tri_tbl,
        tri_boxes=tri_boxes, mesh=jax_whitted.mesh_meta(jscene),
        interpret=True)
    port = np.stack([c.numpy() for c in port])
    assert port.max() > 0.1
    tp.assert_f32_budget(port, np.stack([np.asarray(c) for c in ref]))
