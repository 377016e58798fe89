"""One rank of the two-process gloo job of tests/test_torch_parallel.py.

Usage: python torch_mp_worker.py <host:port> <world size> <rank> <out.npz>

The rank joins the process group through parallel/distributed.py
init_distributed, renders every case of CASES with parallel/mesh.py
render_sharded on the CPU, runs TRAIN_STEPS Adam steps of
parallel/train.py's sharded make_train_step, and writes the frames, the
losses, every step's gradients and the final parameters into one npz.
The scene functions take the package's API as an argument (`api`), so
the test builds the very same scenes in rray_tpu_torch and in rray_tpu;
this worker imports rray_tpu_torch alone.
"""
import os
import sys
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

# rray_tpu's tests/test_parallel.py settings and scenes.
SET = dict(rows_per_tile=48, max_hits=4, containers_depth=2)
HARD_SET = dict(rows_per_tile=20, max_hits=12, containers_depth=4,
                wavefront_capacity=4)
TET_OBJ = """
v 0 1.6 -0.2
v 0.9 0.3 -0.7
v -0.9 0.3 -0.7
v 0 0.3 1.0
f 1 2 3
f 1 3 4
f 1 4 2
f 2 4 3
"""
# Case -> (scene function, its arguments, settings).
CASES = {
    "simple": ("setup", {}, SET),
    "uneven": ("setup", dict(width=63, height=37), SET),
    "glass_csg_mesh_area": ("hard_setup", {}, HARD_SET),
    "real_area": ("hard_setup", dict(area_extent=1.5), HARD_SET),
    "mesh_in_csg": ("hard_setup", dict(mesh_in_csg=True), HARD_SET),
    "buffer_caps": ("hard_setup", {}, dict(HARD_SET, max_rc_elems=1344)),
    # One raster row: the second rank's block is empty.
    "one_row": ("setup", dict(width=16, height=1), SET),
}
# The sharded train step: the simple scene at an odd height (blocks of
# 8 and 7 rows on two ranks), colours and intensities trained with Adam
# against a black target.
TRAIN_SIZE = (20, 15)
TRAIN_STEPS = 2
TRAIN_LR = 1e-2


def trainable(key):
    return ".color" in key or ".intensity" in key


def port_api():
    """rray_tpu_torch's scene API, float64 on the CPU (device_kw: the
    keywords that put its tables there; rray_tpu's API takes none)."""
    import torch

    import rray_tpu_torch as pkg
    from rray_tpu_torch import mathutils
    from rray_tpu_torch.io.obj_loader import load_obj_str

    return types.SimpleNamespace(
        pkg=pkg, mu=mathutils, load_obj_str=load_obj_str,
        dtype=torch.float64, device_kw=dict(device="cpu"))


def setup(api, width=32, height=24):
    """rray_tpu's test_parallel setup: a sphere over a checker floor,
    one point light."""
    p, mu = api.pkg, api.mu
    floor = p.Shape("plane", material=p.Material(
        pattern=p.Pattern("checker", a=p.Pattern.solid([1.0, 1.0, 1.0]),
                          b=p.Pattern.solid([0.2, 0.2, 0.2])), specular=0.0))
    ball = p.Shape("sphere", transform=mu.translate(0, 1, 0),
                   material=p.Material(pattern=p.Pattern.solid([0.7, 0.2,
                                                                0.2]),
                                       diffuse=0.7))
    light = p.PointLight(np.array([-10.0, 10.0, -10.0]), np.ones(3))
    scene = p.compile_scene([floor, ball], [light], dtype=api.dtype,
                            **api.device_kw)
    cam = p.Camera(width, height, np.pi / 3)
    cam.transform = mu.view_transform([0, 1.5, -5], [0, 1, 0], [0, 1, 0])
    return scene, p.compile_camera(cam, api.dtype, **api.device_kw)


def hard_setup(api, mesh_in_csg=False, area_extent=1e-6, width=28,
               height=20):
    """rray_tpu's test_parallel hard_setup: glass, a CSG, a tetrahedron
    mesh (inside the CSG with mesh_in_csg), a point and an area light."""
    p, mu = api.pkg, api.mu
    floor = p.Shape("plane", material=p.Material(
        pattern=p.Pattern("checker", a=p.Pattern.solid([1.0, 1.0, 1.0]),
                          b=p.Pattern.solid([0.2, 0.2, 0.2])),
        specular=0.0, reflective=0.15))
    glass = p.Shape("sphere", transform=mu.translate(-0.8, 1, 0.2),
                    material=p.Material(
                        pattern=p.Pattern.solid([0.05, 0.05, 0.05]),
                        transparency=0.9, refractive_index=1.5,
                        reflective=0.9, diffuse=0.1))
    tet = api.load_obj_str(TET_OBJ, p.Material(
        pattern=p.Pattern.solid([0.7, 0.5, 0.2])))
    if mesh_in_csg:
        tet.transform = mu.translate(1.6, 0, 0.5)
        csg = p.Shape("csg", operation="difference", left=tet,
                      right=p.Shape("sphere", transform=mu.compose(
                          [mu.translate(1.6, 0.9, 0.2),
                           mu.scale(0.5, 0.5, 0.5)]),
                          material=p.Material(
                              pattern=p.Pattern.solid([0.2, 0.6, 0.3]))))
        shapes = [floor, glass, csg]
    else:
        cube = p.Shape("cube", transform=mu.compose(
            [mu.translate(1.6, 0.5, 0.5), mu.scale(0.5, 0.5, 0.5)]),
            material=p.Material(pattern=p.Pattern.solid([0.8, 0.3, 0.3])))
        ball = p.Shape("sphere", transform=mu.compose(
            [mu.translate(1.9, 0.9, 0.2), mu.scale(0.45, 0.45, 0.45)]),
            material=p.Material(pattern=p.Pattern.solid([0.2, 0.6, 0.3])))
        csg = p.Shape("csg", operation="difference", left=cube, right=ball)
        tet.transform = mu.translate(0.6, 0, -1.2)
        shapes = [floor, glass, csg, tet]
    lights = [
        p.PointLight(np.array([-10.0, 10.0, -10.0]), np.full(3, 0.7)),
        p.AreaLight(np.array([5.0, 6.0, -5.0]),
                    np.array([area_extent, 0.0, 0.0]),
                    np.array([0.0, area_extent, 0.0]),
                    np.full(3, 0.4), level=2),
    ]
    scene = p.compile_scene(shapes, lights, dtype=api.dtype,
                            **api.device_kw)
    cam = p.Camera(width, height, np.pi / 3)
    cam.transform = mu.view_transform([0, 1.8, -4.5], [0.4, 0.8, 0],
                                      [0, 1, 0])
    return scene, p.compile_camera(cam, api.dtype, **api.device_kw)


def case(api, name):
    """(scene, camera, settings keywords) of a CASES entry."""
    scene_fn, kwargs, settings = CASES[name]
    scene, cam = {"setup": setup, "hard_setup": hard_setup}[scene_fn](
        api, **kwargs)
    return scene, cam, settings


def train_run(mesh=None):
    """TRAIN_STEPS steps of make_train_step (sharded over `mesh`, or on
    one process) -> {"loss_<i>", "grad_<i>_<key>", "param_<key>"}."""
    import torch

    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.parallel import train

    scene, cam = setup(port_api(), *TRAIN_SIZE)
    adam = lambda params: torch.optim.Adam(params, lr=TRAIN_LR)
    state, rest = train.init_train_state(scene, adam, trainable)
    step = train.make_train_step(rest, cam, RenderSettings(**SET), adam,
                                 mesh=mesh, axis="rays")
    target = torch.zeros((cam.vsize, cam.hsize, 3), dtype=torch.float64)
    out = {}
    for i in range(TRAIN_STEPS):
        state, loss = step(state, target)
        out[f"loss_{i}"] = loss.numpy()
        for k, t in state.params.items():
            out[f"grad_{i}_{k}"] = t.grad.numpy().copy()
    for k, t in state.params.items():
        out[f"param_{k}"] = t.detach().numpy().copy()
    return out


def main(coordinator, world, rank, out):
    import torch

    torch.set_num_threads(2)
    from rray_tpu_torch.config import RenderSettings
    from rray_tpu_torch.parallel import distributed, mesh as pmesh

    assert distributed.init_distributed(coordinator, world, rank)
    mesh = distributed.global_mesh("cpu")
    assert (mesh.rank, mesh.size) == (rank, world), mesh
    results = {}
    for name in CASES:
        scene, cam, settings = case(port_api(), name)
        scene = pmesh.device_put_replicated(scene, mesh)
        image = pmesh.render_sharded(scene, cam, mesh,
                                     RenderSettings(**settings))
        results[f"frame_{name}"] = distributed.host_local_image(image)
    results.update(train_run(mesh))
    np.savez(out, **results)
    torch.distributed.destroy_process_group()
    print("torch mp ok", rank, flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
