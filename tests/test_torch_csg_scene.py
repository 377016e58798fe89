"""Stage e's host tables and building blocks against rray_tpu: the CSG
compile (membership tables innermost first, with the reference's
`includes()` quirk), FastNoiseLite Perlin fBm, the torus's quartic
solver and the pairwise-parity CSG filter."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rray_tpu.io.yaml_loader as jax_yaml
from rray_tpu import compile_scene as jax_compile
from rray_tpu.ops import noise as jax_noise
from rray_tpu.ops import quartic as jax_quartic
from rray_tpu.ops import soa as jax_soa
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.ops import noise, quartic, soa
from rray_tpu_torch.scene import data as sd
from rray_tpu_torch.scene.data import compile_scene

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSG = os.path.join(BASE, "examples", "csg_showcase.yaml")

# A union whose left operand is a group holding a sphere and a nested
# difference, and whose right operand is an intersection with a grouped
# right operand: leaves under groups and under nested CSGs, three depths.
NESTED = """camera:
  fov: 60
  from: [0, 2, -6]
  to: [0, 1, 0]
  up: [0, 1, 0]
lights:
  - type: point
    position: [-10, 10, -10]
    color: [1, 1, 1]
scene:
  - type: plane
  - type: csg
    operation: union
    left:
      type: group
      children:
        - type: sphere
        - type: csg
          operation: difference
          left:
            type: cube
          right:
            type: sphere
            transforms:
              - type: scale
                amount: [1.3, 1.3, 1.3]
    right:
      type: csg
      operation: intersection
      transforms:
        - type: translate
          amount: [2, 1, 0]
      left:
        type: sphere
      right:
        type: group
        children:
          - type: cylinder
            minimum: -1
            maximum: 1
            closed: true
          - type: torus
            minor_radius: 0.3
"""


def _both(path):
    _, lights, shapes = jax_yaml.load_scene_file(path)
    jscene = jax_compile(shapes, lights, dtype=jnp.float32)
    _, lights, shapes = load_scene_file(path)
    return jscene, compile_scene(shapes, lights, dtype=torch.float32,
                                  device="cpu")


@pytest.mark.parametrize("name", ["csg_showcase", "nested"])
def test_csg_tables_match_rray_tpu(name, tmp_path):
    """Every CSG field of the compiled scene equals rray_tpu's exactly:
    the op codes and [C, P] sides innermost first (a stable sort on
    -depth), side 1 only for the leaves left.includes() reports, and the
    member flags."""
    path = CSG
    if name == "nested":
        path = tmp_path / "nested.yaml"
        path.write_text(NESTED)
    jscene, tscene = _both(str(path))
    assert tscene.csg_ops == tuple(int(o) for o in jscene.csg_ops)
    np.testing.assert_array_equal(tscene.csg_side.numpy(),
                                  np.asarray(jscene.csg_side))
    assert tscene.csg_side_static == jscene.csg_side_static
    assert tscene.csg_member_static == jscene.csg_member_static
    assert tscene.prim_kinds == jscene.prim_kinds
    np.testing.assert_array_equal(tscene.prim_inv.numpy(),
                                  np.asarray(jscene.prim_inv))
    if name == "nested":
        # The quirk: the group on the union's left reports its leaves
        # (side 1), the nested difference reports only its direct leaf
        # children, and the intersection's grouped right side is side 2.
        assert len(tscene.csg_ops) == 3 and sd.TORUS in tscene.prim_kinds
        assert {1, 2} <= set(np.unique(tscene.csg_side.numpy()))


def _points(dtype, n=20000):
    """Seeded points around the origin, negative ones included, some past
    the int32 range of the noise lattice."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-300.0, 300.0, (3, n)).astype(dtype)
    pts[:, :10] *= dtype(1e7)
    return pts


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_octave_perlin_matches_rray_tpu(dtype):
    """Bit for bit in float32 (integer hash, saturating floors, IEEE ops
    in the same order), within 1e-12 in float64."""
    pts = _points(dtype)
    tdtype = getattr(torch, np.dtype(dtype).name)
    for octaves, persistence in ((1, 0.5), (4, 0.5), (3, 0.8)):
        want = np.asarray(jax_noise.octave_perlin(
            *(jnp.asarray(c) for c in pts), octaves,
            jnp.asarray(persistence, dtype)))
        got = noise.octave_perlin(*(torch.from_numpy(c) for c in pts),
                                  octaves, torch.tensor(persistence,
                                                        dtype=tdtype)).numpy()
        if dtype == np.float32:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert np.abs(got).max() > 0.1


def _torus_coefficients(n=5000):
    """Quartic coefficients of seeded rays against a torus of minor
    radius 0.35 (soa._torus_slots' expressions), float64."""
    rng = np.random.default_rng(1)
    o = rng.normal(0.0, 3.0, (3, n))
    aim = rng.uniform(-1.3, 1.3, (3, n)) * np.array([[1.0], [1.0], [0.3]])
    d = aim - o
    d /= np.linalg.norm(d, axis=0)
    r = 0.35
    ss = (d * d).sum(0)
    e = (o * o).sum(0) - r * r + 1.0
    f = (o * d).sum(0)
    return (ss * ss, 4.0 * ss * f,
            2.0 * ss * e + 4.0 * f * f - 4.0 * (d[0] ** 2 + d[1] ** 2),
            4.0 * e * f - 8.0 * (o[0] * d[0] + o[1] * d[1]),
            e * e - 4.0 * (o[0] ** 2 + o[1] ** 2))


def test_quartic_matches_rray_tpu_f64():
    """solve_quartic_parts against rray_tpu's XLA form (acos, cos, cbrt)
    in float64: the same validity masks and roots within 1e-9."""
    cs = _torus_coefficients()
    jr, jv = jax_quartic.solve_quartic_parts(*(jnp.asarray(c) for c in cs))
    assert jr[0].dtype == jnp.float64
    tr, tv = quartic.solve_quartic_parts(*(torch.from_numpy(c) for c in cs))
    n_valid = 0
    for k in range(4):
        valid = np.asarray(jv[k])
        np.testing.assert_array_equal(tv[k].numpy(), valid)
        np.testing.assert_allclose(tr[k].numpy()[valid],
                                   np.asarray(jr[k])[valid], rtol=0,
                                   atol=1e-9)
        n_valid += int(valid.sum())
    assert n_valid > 1000


def test_quartic_gradients_are_finite():
    """The clamped derivatives keep the masked branches' inf out of the
    cotangents: gradients through every root are finite, also where the
    solver evaluates sqrt at 0 and acos at +-1 (rray_tpu's _gsqrt,
    _gcbrt, _gacos)."""
    cs = [torch.tensor(c, requires_grad=True)
          for c in _torus_coefficients(500)]
    roots, valids = quartic.solve_quartic_parts(*cs)
    loss = sum(torch.where(v, r, 0.0).sum() for r, v in zip(roots, valids))
    loss.backward()
    for c in cs:
        assert torch.isfinite(c.grad).all()
    z = torch.zeros(1, dtype=torch.float64, requires_grad=True)
    one = torch.ones(1, dtype=torch.float64)
    for fn, x in ((quartic.gsqrt, z), (quartic.gcbrt, z),
                  (quartic.gacos, z + 1.0)):
        g, = torch.autograd.grad(fn(x).sum(), z)
        assert torch.isfinite(g).all()
    assert float(quartic.gsqrt(one * 4.0)) == 2.0


@pytest.mark.parametrize("op", [sd.CSG_UNION, sd.CSG_INTERSECTION,
                                sd.CSG_DIFFERENCE])
def test_csg_keeps_matches_rray_tpu(op):
    """The pairwise-parity filter on seeded unsorted slot lists with ties
    (t drawn from a few values), two nested CSGs (the outer one also
    covering slots the inner leaves out): equal to rray_tpu's."""
    rng = np.random.default_rng(op)
    K, R = 9, 4000
    ts = rng.choice([-1.0, 0.5, 1.0, 1.5, 2.0, 3.0], (K, R))
    valids = rng.random((K, R)) < 0.7
    inner = tuple(int(s) for s in rng.choice([0, 1, 2], K))
    outer = tuple(int(s) if s else int(rng.choice([1, 2]))
                  for s in inner)
    ops_and_sides = ((op, inner), ((op + 1) % 3, outer))
    want = jax_soa.csg_keeps([jnp.asarray(t) for t in ts],
                             [jnp.asarray(v) for v in valids], ops_and_sides)
    got = soa.csg_keeps([torch.from_numpy(t) for t in ts],
                        [torch.from_numpy(v) for v in valids], ops_and_sides)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kept = np.stack([g.numpy() for g in got])
    assert 0 < kept.sum() < valids.sum()
