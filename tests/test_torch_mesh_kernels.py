"""The plain versions of the port's triangle kernels (ROADMAP B2-B4)
against rray_tpu's Pallas kernels in interpret mode, in float32, on
seeded rays and clustered random triangles: closest_triangle with and
without a t_init bound, with vertex normals and aux payload columns;
any_triangle; bvh_closest_triangle (T = 1536 >= bvh_min_tris, not a leaf
multiple) closest, bounded and any-hit.

Tolerances: the same winning triangle on every ray; t, u, v and the
payloads within 1e-5 * max(1, |value|). Both packages evaluate the same
Möller–Trumbore expressions, but rray_tpu's interpret mode runs compiled
XLA:CPU code that rounds some of them differently from PyTorch's eager
ops (measured: up to 7e-6 on t ~ 8, 3 ulps). With a bound, rray_tpu's
kernels may also report hits behind it (the caller's strict `<` merge
drops them); the port reports only hits in front of it, so the
comparison is made after that merge."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_parity as mp
from rray_tpu.kernels import bvh as jax_bvh
from rray_tpu.kernels import triangles as jax_triangles
from rray_tpu_torch.kernels import bvh, triangles

R = 512
TOL = 1e-5


def _j(xs):
    return tuple(jnp.asarray(x) for x in xs)


def _t(xs):
    return tuple(torch.from_numpy(x) for x in xs)


def _assert_hits_match(ref, port, bound=None):
    ref = [np.asarray(x) for x in ref]
    port = [x.numpy() for x in port]
    win = np.isfinite(ref[0])
    if bound is not None:
        win &= ref[0] < bound
    assert win.any() and (~win).any()
    np.testing.assert_array_equal(np.isfinite(port[0]), win)
    np.testing.assert_array_equal(port[3][win], ref[3][win])
    for k, (a, b) in enumerate(zip(ref, port)):
        if k == 3:
            continue
        err = np.abs(a[win] - b[win]) / np.maximum(1.0, np.abs(a[win]))
        assert err.max() <= TOL, (k, err.max())
        assert (b[~win] == (np.inf if k == 0 else 0.0)).all()


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("payload", [False, True])
def test_closest_triangle_matches_pallas_kernel(bounded, payload):
    T = 200  # chunk_size(200) = 40 divides it, as rray_tpu requires
    o, d, cols, rng = mp.seeded_mesh(T, R, seed=0, normals=payload)
    aux = [np.arange(T, dtype=np.float32),
           (np.arange(T) % 7).astype(np.float32)] if payload else []
    bound = rng.uniform(4.0, 12.0, R).astype(np.float32) if bounded else None
    ref = jax_triangles.closest_triangle(
        _j(o), _j(d), _j(cols), t_init=None if bound is None
        else jnp.asarray(bound), aux=_j(aux) or None, interpret=True)
    port = triangles.closest_triangle(
        _t(o), _t(d), _t(cols), t_init=None if bound is None
        else torch.from_numpy(bound), aux=_t(aux))
    assert len(port) == len(ref) == 4 + (3 + 2 if payload else 0)
    _assert_hits_match(ref, port, bound)


def test_any_triangle_matches_pallas_kernel():
    T = 200
    o, d, cols, rng = mp.seeded_mesh(T, R, seed=1)
    dist = rng.uniform(4.0, 12.0, R).astype(np.float32)
    ref = np.asarray(jax_triangles.any_triangle(
        _j(o), _j(d), _j(cols), jnp.asarray(dist), interpret=True))
    port = triangles.any_triangle(_t(o), _t(d), _t(cols),
                                  torch.from_numpy(dist)).numpy()
    assert 0 < ref.mean() < 1
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("mode", ["closest", "bounded", "any"])
def test_bvh_closest_triangle_matches_pallas_kernel(mode):
    T = 1536
    o, d, cols, rng = mp.seeded_mesh(T, R, seed=11, normals=mode != "any")
    aux = [] if mode == "any" else [np.arange(T, dtype=np.float32)]
    dist = None if mode == "closest" else \
        rng.uniform(4.0, 12.0, R).astype(np.float32)
    jd = None if dist is None else jnp.asarray(dist)
    td = None if dist is None else torch.from_numpy(dist)
    ref = jax_bvh.bvh_closest_triangle(
        _j(o), _j(d), _j(cols), dist=jd, aux=_j(aux) or None, leaf=128,
        any_hit=mode == "any", interpret=True)
    port = bvh.bvh_closest_triangle(_t(o), _t(d), _t(cols), dist=td,
                                    aux=_t(aux), leaf=128,
                                    any_hit=mode == "any")
    if mode == "any":
        hit = np.asarray(ref[0]) < dist
        assert 0 < hit.mean() < 1
        np.testing.assert_array_equal(port[0].numpy() < dist, hit)
        assert set(np.unique(port[0].numpy())) <= {0.0, np.inf}
        return
    _assert_hits_match(ref, port, dist)
