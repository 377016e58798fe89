"""Rendering and training split over processes in the port
(rray_tpu_torch.parallel: mesh, distributed, train's sharded step) on
the CPU, against the port's single-process frame and against rray_tpu.

Two gloo ranks (tests/torch_mp_worker.py, started once for the module)
render rray_tpu's own sharded cases (tests/test_parallel.py:112-229:
the simple scene, the uneven 63x37 raster, glass + CSG + mesh + area,
a real-extent area light, a mesh inside a CSG, max_rc_elems = 1344
tiling each block) and take two Adam steps of the sharded train step.
Each rank's frame must equal the other's bit for bit and the port's
single-process render within 1e-12 (float64); the simple and uneven
frames also rray_tpu's render_sharded_jit on conftest's 8 virtual
devices within 1e-9. The sharded step's gradients must equal the
single-process step's within 1e-9 x max(1, |g|) per leaf, its losses
rray_tpu's sharded make_train_step's within 1e-9 relative, and the
ranks' parameters must be equal."""
import os
import socket
import subprocess
import sys
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
from rray_tpu_torch.parallel import distributed, mesh as pmesh
from rray_tpu_torch.render import integrator
from torch_grad_parity import assert_grads_match
import torch_mp_worker as worker

WORKER_TIMEOUT_S = 300


def jax_api():
    """rray_tpu's scene API, float64 (the worker's scene functions take it)."""
    return types.SimpleNamespace(pkg=rray_tpu, mu=jax_mu,
                                 load_obj_str=jax_load_obj_str,
                                 dtype=jnp.float64, device_kw={})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' npz results; the workers start with the module's
    first test and run while it computes its single-process frame."""
    tmp = tmp_path_factory.mktemp("torch_mp")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    outs = [str(tmp / f"rank{i}.npz") for i in range(2)]
    script = os.path.join(os.path.dirname(__file__), "torch_mp_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    procs = [subprocess.Popen(
        [sys.executable, script, f"localhost:{port}", "2", str(i), outs[i]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    results = []

    def wait():
        if not results:
            try:
                for p in procs:
                    out, _ = p.communicate(timeout=WORKER_TIMEOUT_S)
                    assert p.returncode == 0, out.decode()[-3000:]
            finally:
                for p in procs:
                    p.kill()
                    p.wait()
            results.extend(dict(np.load(o)) for o in outs)
        return results

    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("name", list(worker.CASES))
def test_sharded_frame_matches_single_process(ranks, name):
    scene, cam, settings = worker.case(worker.port_api(), name)
    with torch.no_grad():
        single = integrator.render(scene, cam, RenderSettings(**settings))
    single = single.numpy()
    r0, r1 = (r[f"frame_{name}"] for r in ranks())
    np.testing.assert_array_equal(r0, r1)
    assert r0.shape == (cam.vsize, cam.hsize, 3)
    assert np.isfinite(r0).all()
    np.testing.assert_allclose(r0, single, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["simple", "uneven"])
def test_sharded_frame_matches_rray_tpu(ranks, name):
    scene_fn, kwargs, settings = worker.CASES[name]
    jscene, jcam = getattr(worker, scene_fn)(jax_api(), **kwargs)
    mesh = jax_mesh.make_mesh(jax.devices()[:8])
    want = np.asarray(jax_mesh.render_sharded_jit(
        jscene, jcam, mesh, settings=JaxSettings(**settings)))
    got = ranks()[0][f"frame_{name}"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_sharded_train_step_matches(ranks):
    """Gradients of each step equal the single-process step's, the
    losses rray_tpu's sharded step's, the ranks' parameters each
    other's."""
    r0, r1 = ranks()
    single = worker.train_run()
    for k in single:
        if k.startswith("param_"):
            np.testing.assert_array_equal(r0[k], r1[k])
    for i in range(worker.TRAIN_STEPS):
        prefix = f"grad_{i}_"
        got = {k[len(prefix):]: v for k, v in r0.items()
               if k.startswith(prefix)}
        want = {k[len(prefix):]: v for k, v in single.items()
                if k.startswith(prefix)}
        assert_grads_match(got, want)
        np.testing.assert_allclose(r0[f"loss_{i}"], single[f"loss_{i}"],
                                   rtol=1e-9, atol=0)

    jscene, jcam = worker.setup(jax_api(), *worker.TRAIN_SIZE)
    optimizer = optax.adam(worker.TRAIN_LR)
    state, rest = jax_train.init_train_state(jscene, optimizer,
                                             worker.trainable)
    step = jax_train.make_train_step(
        rest, jcam, JaxSettings(**worker.SET), optimizer,
        mesh=jax_mesh.make_mesh(jax.devices()[:8]), axis=jax_mesh.RAY_AXIS)
    target = jnp.zeros((jcam.vsize, jcam.hsize, 3), jnp.float64)
    for i in range(worker.TRAIN_STEPS):
        state, loss = step(state, target, jax.random.PRNGKey(0))
        np.testing.assert_allclose(r0[f"loss_{i}"], float(loss), rtol=1e-9,
                                   atol=0)
    assert float(r0["loss_1"]) < float(r0["loss_0"])


def test_single_process_mesh_and_init(monkeypatch):
    """init_distributed() without a job's environment returns False and
    starts nothing; the mesh is then one rank, and render_sharded on it
    is the single-process render."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False
    assert not torch.distributed.is_initialized()
    mesh = distributed.global_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.axis) == (0, 1, pmesh.RAY_AXIS)
    scene, cam, settings = worker.case(worker.port_api(), "uneven")
    settings = RenderSettings(**settings)
    got = pmesh.render_sharded(pmesh.device_put_replicated(scene, mesh),
                               pmesh.device_put_replicated(cam, mesh), mesh,
                               settings)
    with torch.no_grad():
        want = integrator.render(scene, cam, settings)
    np.testing.assert_array_equal(distributed.host_local_image(got),
                                  want.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            pmesh.make_mesh("cuda")
