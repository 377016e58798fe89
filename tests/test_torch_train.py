"""Inverse-rendering training in the port (rray_tpu_torch.parallel.train)
on the CPU, against rray_tpu: torch.optim.Adam's per-step losses against
optax.adam's over rray_tpu's test_training_reduces_loss; the
train-then-render invariance of rray_tpu's tests/test_wavefront.py
(a trained scene renders the same on the kernel route and the torch
route); the kernel tables after a step that moves the geometry; and a
trained scene carried back to rray_tpu through scene_to_numpy."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rray_tpu import Material, Pattern, PointLight, Shape
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu import mathutils as mu
from rray_tpu.io.obj_loader import load_obj_str
from rray_tpu.parallel import train as jax_train
from rray_tpu.render.integrator import render as jax_render
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io import mesh_scenes as ms
from rray_tpu_torch.kernels import analytic
from rray_tpu_torch.ops import jitter, soa
from rray_tpu_torch.parallel import train
from rray_tpu_torch.render import integrator
from rray_tpu_torch.render.camera import all_rays_soa
from rray_tpu_torch.scene import data as sd
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy
from torch_grad_parity import pair

KW = dict(rows_per_tile=16, max_hits=4, containers_depth=2)
VIEW = mu.view_transform([0, 1.5, -5], [0, 1, 0], [0, 1, 0])
LIGHT = PointLight(np.array([-10.0, 10.0, -10.0]), np.ones(3))
# Per-step losses of torch.optim.Adam and optax.adam agree to this
# relative share: the same update in exact arithmetic, in another order
# of float64 operations.
LOSS_RTOL = 1e-9


def _small_setup():
    floor = Shape("plane", material=Material(
        pattern=Pattern.solid([0.9, 0.9, 0.9]), specular=0.0))
    ball = Shape("sphere", transform=mu.translate(0, 1, 0),
                 material=Material(pattern=Pattern.solid([0.7, 0.2, 0.2]),
                                   diffuse=0.7, specular=0.3))
    return pair([floor, ball], [LIGHT], 16, 12, np.pi / 3, VIEW)


def _jax_losses(scene, bad, cam, steps):
    target = jax_render(scene, cam, settings=JaxSettings(**KW))
    optimizer = optax.adam(5e-2)
    state, rest = jax_train.init_train_state(bad, optimizer, _trainable)
    step = jax_train.make_train_step(rest, cam, JaxSettings(**KW), optimizer)
    key = jax.random.PRNGKey(0)
    losses = []
    for _ in range(steps):
        state, loss = step(state, target, key)
        losses.append(float(loss))
    return losses


def _trainable(key):
    return ".color" in key or ".intensity" in key


def _corrupt_jax(scene):
    """rray_tpu's corruption: the ball's colour and half the light."""
    pat = dataclasses.replace(scene.patterns[1],
                              color=jnp.asarray([0.2, 0.7, 0.7], jnp.float64))
    light = dataclasses.replace(scene.lights[0],
                                intensity=scene.lights[0].intensity * 0.5)
    return dataclasses.replace(scene, patterns=(scene.patterns[0], pat),
                               lights=(light,))


def test_training_reduces_loss_and_matches_optax():
    """rray_tpu's test_training_reduces_loss with torch.optim.Adam in
    place of optax.adam: 25 steps from a corrupted ball colour and light
    intensity cut the loss below 5% of the first, and every step's loss
    equals optax's within LOSS_RTOL."""
    (jscene, jcam), (scene, cam) = _small_setup()
    jbad = _corrupt_jax(jscene)
    want = _jax_losses(jscene, jbad, jcam, 25)
    bad = scene_from_numpy(*scene_to_numpy(jbad), device="cpu")
    settings = RenderSettings(**KW)
    with torch.no_grad():
        target = integrator.render(scene, cam, settings)
    adam = lambda params: torch.optim.Adam(params, lr=5e-2)
    state, rest = train.init_train_state(bad, adam, _trainable)
    assert list(state.params) == [".lights[0].intensity",
                                  ".patterns[0].color", ".patterns[1].color"]
    step = train.make_train_step(rest, cam, settings, adam)
    losses = []
    for _ in range(25):
        state, loss = step(state, target)
        losses.append(float(loss))
    assert state.step == 25
    assert losses[-1] < 0.05 * losses[0], losses[::6]
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL, atol=0)


def _tetrahedron_scene():
    tet = load_obj_str(ms.TETRAHEDRON,
                       Material(pattern=Pattern.solid([0.7, 0.5, 0.2])))
    floor = Shape("plane", material=Material(
        pattern=Pattern.solid([0.9, 0.9, 1.0]), specular=0.0))
    return pair([floor, tet], [LIGHT], 32, 24, np.pi / 3, VIEW)[1]


def _torch_route(scene, cam, settings):
    """The image of reference_node, the kernel-free torch route."""
    ro, rd = all_rays_soa(cam)
    seeds = jitter.seed_table(0, settings.depth, len(scene.lights))
    out = integrator.reference_node(sd.canonicalize(scene), ro, rd,
                                    settings.depth, settings, seeds)
    return torch.stack((out.x, out.y, out.z), -1).reshape(cam.vsize,
                                                         cam.hsize, 3)


def test_train_then_render_path_invariant():
    """rray_tpu's test_train_then_render_path_invariant, float32: one
    gradient step on the kernel route's gradients (WhittedKernel) leaves
    a scene that renders the same on the kernel route and on the torch
    route (its tolerance, 2e-6), and the step moved the frame."""
    scene, cam = _tetrahedron_scene()
    fields, meta = scene_to_numpy(scene)
    scene = scene_from_numpy(fields, meta, device="cpu", dtype=torch.float32)
    cam = dataclasses.replace(cam, **{k: getattr(cam, k).float() for k in (
        "inv", "half_width", "half_height", "pixel_size")})
    settings = RenderSettings(rows_per_tile=24)
    assert integrator.route(scene) == "kernel"
    params, rest = train.partition_scene(scene)
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss = (integrator.render(train.merge_scene(params, rest), cam,
                              settings) ** 2).sum()
    grads = torch.autograd.grad(loss, list(params.values()),
                                allow_unused=True)
    trained = train.merge_scene(
        {k: v.detach() - 0.05 * (0.0 if g is None else g)
         for (k, v), g in zip(params.items(), grads)}, rest)
    with torch.no_grad():
        a = _torch_route(trained, cam, settings)
        b = integrator.render(trained, cam, settings)
        before = integrator.render(scene, cam, settings)
    assert float((a - before).abs().max()) > 1e-4
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)


def _geometry_scene(lat_lon):
    """Three analytic spheres over a floor under an area light, with a
    UV-sphere mesh of `lat_lon` (None: no mesh), float64, 12x8."""
    import tempfile

    from rray_tpu_torch.io.yaml_loader import load_scene_file
    from rray_tpu_torch.render.camera import Camera, compile_camera

    with tempfile.TemporaryDirectory() as tmp:
        spec, lights, shapes = load_scene_file(ms.write_scene(
            tmp, "g", lat_lon=lat_lon, spheres=3, area_level=2))
    scene = sd.compile_scene(shapes, lights, dtype=torch.float64, device="cpu")
    cam = Camera(12, 8, spec["fov"])
    cam.transform = spec["transform"]
    return scene, compile_camera(cam, torch.float64, "cpu")


def _tables(scene):
    """The tables the kernels take for the scene, as their wrappers get
    them: B2's and B4's (soa._tri_tables, soa._bvh_tables) for a mesh,
    B5's (analytic.scene_occluders) for analytic prims alone."""
    if scene.counts[6]:
        tri, tree = soa._tri_tables(scene), soa._bvh_tables(scene)
        return [tri.block, tri.payload, tree.block, tree.payload]
    params, _, bounds = analytic.scene_occluders(scene)
    return [params, bounds]


@pytest.mark.parametrize("leaf", [".tri_p1", ".prim_inv"])
def test_kernel_tables_follow_a_train_step(leaf):
    """After a train step that moves `leaf` (a mesh's vertices: B2's and
    B4's tables; the analytic prims' affines: B5's), the scene the next
    step renders builds its kernel tables anew, equal to those of a
    freshly built copy; no table of the old scene carries over
    (dataclasses.replace hands over no cache), and no cached table holds
    an autograd graph."""
    scene, cam = _geometry_scene((6, 6) if leaf == ".tri_p1" else None)
    settings = RenderSettings()
    with torch.no_grad():
        target = integrator.render(scene, cam, settings) * 0.5
    old = _tables(scene)
    sgd = lambda params: torch.optim.SGD(params, lr=0.05)
    state, rest = train.init_train_state(scene, sgd, lambda k: k == leaf)
    step = train.make_train_step(rest, cam, settings, sgd)
    state, _ = step(state, target)
    assert float((state.params[leaf].detach() - getattr(scene, leaf[1:]))
                 .abs().max()) > 0
    moved = train.merge_scene(state.params, rest)
    assert moved.kernel_cache == {}
    assert dataclasses.replace(scene).kernel_cache == {}
    got = _tables(sd.canonicalize(moved))
    want = _tables(sd.canonicalize(scene_from_numpy(*scene_to_numpy(moved),
                                                   device="cpu")))
    assert not any(t.requires_grad for t in old + got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert any(not torch.equal(g, o) for g, o in zip(got, old))


def test_trained_scene_carries_back_to_rray_tpu():
    """scene_to_numpy takes a trained scene whose leaves require grad;
    rray_tpu renders the carried-back scene as the port does (float64,
    atol 1e-9)."""
    (jscene, jcam), (scene, cam) = _small_setup()
    adam = lambda params: torch.optim.Adam(params, lr=5e-2)
    state, rest = train.init_train_state(scene, adam)
    step = train.make_train_step(rest, cam, RenderSettings(**KW), adam)
    target = torch.zeros((cam.vsize, cam.hsize, 3), dtype=torch.float64)
    state, _ = step(state, target)
    trained = train.merge_scene(state.params, rest)
    assert trained.requires_grad()
    fields, _ = scene_to_numpy(trained)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jscene)
    leaves = dict(sd.tensor_leaves(trained))
    jtrained = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(leaves[jax.tree_util.keystr(p)].detach().numpy())
        for p, _ in flat])
    np.testing.assert_array_equal(np.asarray(jtrained.prim_inv),
                                  fields["prim_inv"])
    want = np.asarray(jax_render(jtrained, jcam, settings=JaxSettings(**KW)))
    with torch.no_grad():
        got = integrator.render(trained, cam, RenderSettings(**KW)).numpy()
    assert np.abs(got - integrator.render(scene, cam, RenderSettings(**KW))
                  .numpy()).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
