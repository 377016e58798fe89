"""Shared helpers of the gradient tests: the same scene in rray_tpu and
in the port (compiled in rray_tpu, carried across with
scene/convert.py), the gradient of a render loss in each package keyed
by rray_tpu's key-path strings, and their comparison leaf by leaf."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rray_tpu import Camera as JaxCamera
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu import compile_camera as jax_compile_camera
from rray_tpu import compile_scene as jax_compile_scene
from rray_tpu.parallel import train as jax_train
from rray_tpu.render.integrator import render as jax_render
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.parallel import train
from rray_tpu_torch.render.camera import Camera, compile_camera
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy

# Gradients of the two packages agree to this share of max(1, |g|) in
# float64: the same operations, up to the order of a few sums.
GRAD_TOL = 1e-9


def pair(shapes, lights, width, height, fov, transform):
    """(rray_tpu scene, camera), (the port's scene, camera), float64."""
    jscene = jax_compile_scene(shapes, lights, dtype=jnp.float64)
    cam = JaxCamera(width, height, fov)
    cam.transform = transform
    tcam = Camera(width, height, fov)
    tcam.transform = transform
    return ((jscene, jax_compile_camera(cam, jnp.float64)),
            (scene_from_numpy(*scene_to_numpy(jscene), device="cpu"),
             compile_camera(tcam, torch.float64, "cpu")))


def jax_grads(scene, cam, settings: JaxSettings, seed=0):
    """{key path: gradient} of mean(render^2) in rray_tpu (jax.grad,
    pallas off)."""
    settings = dataclasses.replace(settings, pallas="off")
    params, rest = jax_train.partition_scene(scene)
    g = jax.grad(lambda p: jnp.mean(jax_render(
        jax_train.merge_scene(p, rest), cam, settings=settings,
        seed=seed) ** 2))(params)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        jax_train.merge_scene(g, rest))
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat
            if hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jnp.inexact)}


def port_loss(scene, cam, settings: RenderSettings, seed=0):
    """mean(render^2) of the port and its parameters, every float leaf
    as a leaf tensor that requires grad."""
    params, rest = train.partition_scene(scene)
    params = {k: v.detach().clone().requires_grad_() for k, v in
              params.items()}
    target = torch.zeros((cam.vsize, cam.hsize, 3), dtype=cam.inv.dtype)
    return train.render_loss(params, rest, cam, target, settings,
                             seed), params


def port_grads(scene, cam, settings: RenderSettings, seed=0):
    """{key path: gradient} of mean(render^2) in the port (autograd)."""
    loss, params = port_loss(scene, cam, settings, seed)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: (torch.zeros_like(v) if g is None else g).numpy()
            for (k, v), g in zip(params.items(), got)}


def assert_grads_match(got: dict, want: dict, tol=GRAD_TOL):
    """Every leaf of `want` in `got`, within tol * max(1, |g|) where |g|
    is the leaf's largest gradient; all finite."""
    assert set(got) == set(want), set(got) ^ set(want)
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        assert np.isfinite(g).all() and np.isfinite(w).all(), key
        if w.size:
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                       err_msg=key)
