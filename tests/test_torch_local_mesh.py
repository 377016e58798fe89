"""The port's local mesh (rray_tpu_torch.parallel.mesh.make_mesh(devices=):
every entry in one process) on the CPU, against the port's
single-process frame and step and against rray_tpu's single-process
mesh (`make_mesh(jax.devices()[:8])`).

A local mesh of 8 "cpu" entries renders every case of
tests/torch_mp_worker.py's CASES (rray_tpu's own sharded cases) in
float64: each frame must equal the port's single-process render within
1e-12 (the bound tests/test_torch_parallel.py holds ranks to), the
simple and uneven frames rray_tpu's render_sharded_jit on conftest's 8
virtual devices within 1e-9. Two Adam steps of the local-mesh train step
must give the single-process step's gradients within 1e-9 x max(1, |g|)
per leaf and rray_tpu's sharded make_train_step's losses within 1e-9
relative. Also: the mesh's errors, replicas, and the kernel modules'
counters under threads."""
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rray_tpu
from rray_tpu import mathutils as jax_mu
from rray_tpu import RenderSettings as JaxSettings
from rray_tpu.io.obj_loader import load_obj_str as jax_load_obj_str
from rray_tpu.parallel import mesh as jax_mesh
from rray_tpu.parallel import train as jax_train
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.kernels import analytic, build, bvh, triangles, whitted
from rray_tpu_torch.parallel import distributed, mesh as pmesh
from rray_tpu_torch.render import integrator
from torch_grad_parity import assert_grads_match
import torch_mp_worker as worker

ENTRIES = 8


def jax_api():
    """rray_tpu's scene API, float64 (the worker's scene functions take
    it)."""
    return types.SimpleNamespace(pkg=rray_tpu, mu=jax_mu,
                                 load_obj_str=jax_load_obj_str,
                                 dtype=jnp.float64, device_kw={})


def local_mesh():
    return pmesh.make_mesh(devices=["cpu"] * ENTRIES)


@pytest.mark.parametrize("name", list(worker.CASES))
def test_local_mesh_frame_matches_single_process(name):
    scene, cam, settings = worker.case(worker.port_api(), name)
    settings = RenderSettings(**settings)
    got = pmesh.render_sharded(scene, cam, local_mesh(), settings)
    with torch.no_grad():
        want = integrator.render(scene, cam, settings)
    assert got.shape == (cam.vsize, cam.hsize, 3)
    assert got.device == torch.device("cpu")
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(distributed.host_local_image(got),
                               want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["simple", "uneven"])
def test_local_mesh_frame_matches_rray_tpu(name):
    scene_fn, kwargs, settings = worker.CASES[name]
    jscene, jcam = getattr(worker, scene_fn)(jax_api(), **kwargs)
    want = np.asarray(jax_mesh.render_sharded_jit(
        jscene, jcam, jax_mesh.make_mesh(jax.devices()[:ENTRIES]),
        settings=JaxSettings(**settings)))
    scene, cam, _ = worker.case(worker.port_api(), name)
    got = pmesh.render_sharded(scene, cam, local_mesh(),
                               RenderSettings(**settings))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


def test_local_mesh_train_step_matches():
    """Each step's gradients equal the single-process step's, the losses
    the single-process step's and rray_tpu's sharded step's; the loss
    falls."""
    got = worker.train_run(local_mesh())
    single = worker.train_run()
    for i in range(worker.TRAIN_STEPS):
        prefix = f"grad_{i}_"
        assert_grads_match(
            {k[len(prefix):]: v for k, v in got.items()
             if k.startswith(prefix)},
            {k[len(prefix):]: v for k, v in single.items()
             if k.startswith(prefix)})
        np.testing.assert_allclose(got[f"loss_{i}"], single[f"loss_{i}"],
                                   rtol=1e-9, atol=0)

    jscene, jcam = worker.setup(jax_api(), *worker.TRAIN_SIZE)
    optimizer = optax.adam(worker.TRAIN_LR)
    state, rest = jax_train.init_train_state(jscene, optimizer,
                                             worker.trainable)
    step = jax_train.make_train_step(
        rest, jcam, JaxSettings(**worker.SET), optimizer,
        mesh=jax_mesh.make_mesh(jax.devices()[:ENTRIES]),
        axis=jax_mesh.RAY_AXIS)
    target = jnp.zeros((jcam.vsize, jcam.hsize, 3), jnp.float64)
    for i in range(worker.TRAIN_STEPS):
        state, loss = step(state, target, jax.random.PRNGKey(0))
        np.testing.assert_allclose(got[f"loss_{i}"], float(loss),
                                   rtol=1e-9, atol=0)
    assert float(got["loss_1"]) < float(got["loss_0"])


def test_local_mesh_blocks_and_replicas():
    """Entry i takes row_block's rows of rank i (empty trailing blocks on
    a one-row raster); device_put_replicated puts the scene on the first
    entry's device; a replica is a new SceneData (its own kernel cache)
    over the same tensors on their own device; a device may repeat; the
    entries' replicas stay in the scene's cache across frames."""
    mesh = local_mesh()
    assert (mesh.rank, mesh.size, mesh.device) == (0, ENTRIES,
                                                   torch.device("cpu"))
    assert mesh.devices == (torch.device("cpu"),) * ENTRIES
    assert [pmesh.row_block(37, mesh, i)[:2] for i in range(ENTRIES)] == [
        (0, 5), (5, 10), (10, 15), (15, 20), (20, 25), (25, 30), (30, 35),
        (35, 37)]
    assert [pmesh.row_block(1, mesh, i)[:2] for i in range(3)] == [
        (0, 1), (1, 1), (1, 1)]
    scene, cam, _ = worker.case(worker.port_api(), "simple")
    scene.cached("probe", lambda: 1)
    placed = pmesh.device_put_replicated(scene, mesh)
    assert placed.device == torch.device("cpu")
    copy = pmesh.replica(scene, mesh.devices[3])
    assert copy is not scene and not copy.kernel_cache
    assert copy.prim_inv.data_ptr() == scene.prim_inv.data_ptr()
    assert pmesh.replica(cam, "cpu").inv.data_ptr() == cam.inv.data_ptr()
    # render_sharded keeps each entry's replica (and its tables) in the
    # scene's cache for the scene's later frames.
    pmesh.render_sharded(scene, cam, mesh)
    kept = {k: v for k, v in scene.kernel_cache.items()
            if k[0] == "replica"}
    assert sorted(k[1] for k in kept) == list(range(ENTRIES))
    assert len({id(v) for v in kept.values()} | {id(scene)}) == ENTRIES + 1
    assert all(v.kernel_cache for v in kept.values())
    pmesh.render_sharded(scene, cam, mesh)
    assert all(scene.kernel_cache[k] is v for k, v in kept.items())


def test_local_mesh_errors(monkeypatch):
    """devices= naming a CUDA device without CUDA is a RuntimeError, an
    empty list a ValueError, and devices= inside a process group a
    ValueError (the process-group mesh stays as it was)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for devices in (["cuda"], ["cpu", "cuda:0"]):
        with pytest.raises(RuntimeError, match="is_available"):
            pmesh.make_mesh(devices=devices)
    with pytest.raises(ValueError, match="no device"):
        pmesh.make_mesh(devices=[])
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="process group"):
            pmesh.make_mesh(devices=["cpu"] * 2)
        mesh = pmesh.make_mesh("cpu")
        assert (mesh.rank, mesh.size, mesh.devices) == (0, 1, ())
    finally:
        torch.distributed.destroy_process_group()


def test_kernel_counters_exact_under_threads(monkeypatch):
    """build.count adds under one lock: 16 threads (more than the cores)
    counting every kernel module's counters with a 1 us switch interval
    lose no update."""
    names = [(whitted, "launches"), (whitted, "table_builds"),
             (triangles, "closest_launches"), (triangles, "any_launches"),
             (triangles, "table_builds"), (bvh, "launches"),
             (bvh, "tree_builds"), (analytic, "launches")]
    for module, name in names:
        monkeypatch.setattr(module, name, 0)
    threads, per = 16, 500
    barrier = threading.Barrier(threads)

    def work():
        barrier.wait(timeout=30)
        for _ in range(per):
            for module, name in names:
                build.count(vars(module), name)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    for module, name in names:
        assert getattr(module, name) == threads * per, (module, name)
