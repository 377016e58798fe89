"""rray_tpu_torch/kernels/analytic.py (B5): the area-shadow plain version
against rray_tpu's Pallas kernel (interpret mode, fed the point_jitter
draws of the same points and seed) and against rray_tpu's XLA sample
loop (`_shadow_fraction_soa`, pallas off), on the six analytic occluders
of tests/test_shadow_semantics.py's fused-kernel fixture. The CUDA
kernel runs only on the card (tests/test_torch_cuda.py, chip_smoke.py);
its per-origin body is checked on the CPU in test_torch_whitted_cuh.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rray_tpu import AreaLight, RenderSettings, Shape, compile_scene
from rray_tpu import mathutils as mu
from rray_tpu.kernels import analytic as jax_analytic
from rray_tpu.ops import jitter as jax_jitter
from rray_tpu.ops import soa as jax_soa
from rray_tpu.ops.vec import V3
from rray_tpu.render import integrator as jax_integrator
from rray_tpu_torch.kernels import analytic
from rray_tpu_torch.scene import data as sd
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy

SEED = 7  # jax.random.PRNGKey(7), as the fixture keys its draws


def _scenes(dtype, level):
    """(rray_tpu scene, the port's scene of the same tables)."""
    shapes = [
        Shape("sphere", transform=mu.translate(0, 1, 0)),
        Shape("plane"),
        Shape("cube", transform=mu.compose([mu.rotate_y(0.4),
                                            mu.translate(2.5, 1, 1)])),
        Shape("cylinder", minimum=0.0, maximum=2.0, closed=True,
              transform=mu.translate(-2.5, 0, 0)),
        Shape("cylinder", transform=mu.translate(-5, 0, 2)),
        Shape("cone", minimum=-1.0, maximum=0.0, closed=True,
              transform=mu.translate(0, 2, 3)),
    ]
    light = AreaLight(corner=np.array([-5.0, 5.0, -5.0]),
                      uvec=np.array([1.5, 0.0, 0.0]),
                      vvec=np.array([0.0, 1.5, 0.0]), level=level,
                      intensity=np.ones(3))
    jscene = compile_scene(shapes, [light], dtype=getattr(jnp, dtype))
    return jscene, scene_from_numpy(*scene_to_numpy(jscene), device="cpu")


def _over(n, dtype):
    rng = np.random.default_rng(2)
    return [rng.uniform(-4, 4, n).astype(dtype) for _ in range(3)]


def _port_fraction(tscene, over, seed):
    light = tscene.lights[0]
    return analytic.area_shadow_fraction(
        tuple(torch.from_numpy(c) for c in over), seed,
        torch.cat([light.corner, light.uvec, light.vvec]),
        analytic.occlusion_params(tscene, range(len(tscene.prim_kinds))),
        tscene.prim_kinds, light.level).numpy()


def _seed():
    return int(jax_jitter.seed_from_key(jax.random.PRNGKey(SEED)))


def test_occlusion_params_match_rray_tpu():
    jscene, tscene = _scenes("float32", 5)
    pids = range(len(jscene.prim_kinds))
    got = analytic.occlusion_params(tscene, pids)
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 16)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_soa._occlusion_params(jscene, pids)))


def test_plain_matches_pallas_kernel():
    """Level 3 (9 samples, unrolled at trace time in interpret mode) on
    2048 points: the same fraction, bit for bit."""
    level = 3
    jscene, tscene = _scenes("float32", level)
    over = _over(2048, np.float32)
    seed = _seed()
    light = jscene.lights[0]
    want = jax_analytic.area_shadow_fraction(
        tuple(jnp.asarray(c) for c in over),
        jax_jitter.point_jitter(jnp.int32(seed),
                                *(jnp.asarray(c) for c in over),
                                level * level),
        jnp.concatenate([light.corner, light.uvec, light.vvec]),
        jax_soa._occlusion_params(jscene, range(len(jscene.prim_kinds))),
        tuple(jscene.prim_kinds), level, interpret=True)
    got = _port_fraction(tscene, over, seed)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert 0.1 < got.mean() < 0.9


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_matches_xla_loop_level5(dtype):
    """Level 5 (25 samples) against rray_tpu's XLA sample loop with the
    same key: the same blocked count on every point. The fraction is
    count / n in both; XLA:CPU compiles that divide by the constant n
    into a multiply by its reciprocal, so where it rounds differently
    the two fractions differ by one ulp (measured: 0.7% of points in
    float32), never more."""
    jscene, tscene = _scenes(dtype, 5)
    over = _over(8192, getattr(np, dtype))
    want = np.asarray(jax.jit(lambda o: jax_integrator._shadow_fraction_soa(
        jscene, jscene.lights[0], o, RenderSettings(pallas="off"),
        jax.random.PRNGKey(SEED)))(V3(*(jnp.asarray(c) for c in over))))
    got = _port_fraction(tscene, over, _seed())
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(np.rint(got * 25), np.rint(want * 25))
    ulp = np.spacing(np.abs(want).astype(want.dtype))
    assert (np.abs(got - want) <= ulp).all()
    assert 0.1 < got.mean() < 0.9


def test_cpu_tensors_never_launch_and_the_wrapper_checks_first():
    """CPU tensors run the plain version; the CUDA wrapper's checks need
    no card: a float64 origin or a torus is refused before any library
    is loaded."""
    _, tscene = _scenes("float32", 2)
    over = tuple(torch.from_numpy(c) for c in _over(64, np.float32))
    light = tscene.lights[0]
    lp = torch.cat([light.corner, light.uvec, light.vvec])
    params = analytic.occlusion_params(tscene, range(6))
    before = analytic.launches
    analytic.area_shadow_fraction(over, 3, lp, params, tscene.prim_kinds, 2)
    assert analytic.launches == before
    with pytest.raises(TypeError, match="float32"):
        analytic._launch(tuple(c.double() for c in over), 3, lp, params,
                         tscene.prim_kinds, 2)
    with pytest.raises(ValueError, match="analytic"):
        analytic._launch(over, 3, lp, params,
                         (sd.TORUS,) + tuple(tscene.prim_kinds[1:]), 2)
    with pytest.raises(ValueError, match="int32 seed"):
        analytic._launch(over, 2 ** 31, lp, params, tscene.prim_kinds, 2)
    assert analytic.launches == before
