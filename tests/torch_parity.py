"""Shared inputs for the rray_tpu_torch parity tests: one seeded block of
rays and scenes compiled once in rray_tpu and handed to the port through
scene/convert.py, so both packages compute on the very same tables."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rray_tpu import compile_scene
from rray_tpu.io.yaml_loader import load_scene_file
from rray_tpu.kernels import whitted as jax_whitted
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.kernels import whitted
from rray_tpu_torch.ops import jitter
from rray_tpu_torch.scene.convert import scene_from_numpy, scene_to_numpy

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLASS = os.path.join(BASE, "examples", "glass.yaml")
EXAMPLE1 = os.path.join(BASE, "examples", "example1.yaml")
R = 4096  # one (8, 512) block of the TPU kernel


def seeded_rays(dtype=np.float32, n=R):
    """Rays from around the examples' camera toward their spheres."""
    rng = np.random.default_rng(0)
    o = np.array([0.0, 1.5, -5.0])[:, None] + rng.normal(0, 0.2, (3, n))
    d = np.array([0.0, 1.0, 0.0])[:, None] + rng.normal(0, 1.5, (3, n)) - o
    d /= np.linalg.norm(d, axis=0)
    return o.astype(dtype), d.astype(dtype)


def load(path, reflection_only=False):
    """(camera spec, lights, shapes); reflection_only zeroes every
    transparency, which makes glass a width-1 reflection chain."""
    cam, lights, shapes = load_scene_file(path)
    if reflection_only:
        for shape in shapes:
            shape.material.transparency = 0.0
    return cam, lights, shapes


def scenes(path, dtype, reflection_only=False):
    """(rray_tpu SceneData, the port's SceneData of the same tables)."""
    _, lights, shapes = load(path, reflection_only)
    jscene = compile_scene(shapes, lights, dtype=getattr(jnp, dtype))
    return jscene, scene_from_numpy(*scene_to_numpy(jscene), device="cpu")


def port_render_rays(tscene, o, d, depth=5, cap=4):
    """The port's whitted_compact on numpy rays (CPU: the plain
    version) -> [3, R] numpy."""
    pat, descrs = whitted.pack_patterns(tscene)
    D, W = whitted.wavefront_shape(
        tscene, RenderSettings(depth=depth, wavefront_capacity=cap))
    out = whitted.whitted_compact(
        tuple(torch.from_numpy(c) for c in o),
        tuple(torch.from_numpy(c) for c in d), whitted.pack_prims(tscene),
        pat, whitted.pack_lights(tscene), tscene.prim_kinds, descrs,
        tscene.prim_pattern_static, D, W, tscene.has_reflective,
        tscene.has_transparent, light_levels=whitted.light_levels(tscene),
        seeds=jitter.seed_table(0, D, len(tscene.lights)))
    return np.stack([c.numpy() for c in out]), (D, W)


def jax_kernel_rays(jscene, o, d, depth, W):
    """rray_tpu's Pallas kernel in interpret mode -> [3, R] numpy."""
    pat, descrs = jax_whitted.pack_patterns(jscene)
    out = jax_whitted.whitted_compact(
        tuple(jnp.asarray(c) for c in o), tuple(jnp.asarray(c) for c in d),
        jax_whitted.pack_prims(jscene), pat,
        jax_whitted.pack_lights(jscene),
        jnp.zeros((depth + 1, len(jscene.lights)), jnp.int32),
        kinds=tuple(jscene.prim_kinds), pat_descrs=descrs,
        prim_pat=tuple(jscene.prim_pattern_static),
        lmeta=jax_whitted.light_meta(jscene), depth=depth, W=W,
        has_refl=jscene.has_reflective, has_refr=jscene.has_transparent,
        interpret=True)
    return np.stack([np.asarray(c) for c in out])


def jax_xla_rays(jscene, o, d, depth=5, **settings):
    """rray_tpu's kernel-free XLA node (`_xla_reference_node`) -> [3, R]."""
    from rray_tpu import RenderSettings as JaxSettings
    from rray_tpu.ops.vec import V3
    from rray_tpu.render import integrator

    out = integrator._xla_reference_node(
        jscene, V3(*(jnp.asarray(c) for c in o)),
        V3(*(jnp.asarray(c) for c in d)), depth,
        JaxSettings(pallas="off", depth=depth, **settings),
        jax.random.PRNGKey(0))
    return np.stack([np.asarray(out.x), np.asarray(out.y),
                     np.asarray(out.z)])


def ray_diff(a, b):
    """Per-ray max |a - b| over the color channels."""
    return np.abs(a - b).max(axis=0)


# f32 budget of the port's plain version against rray_tpu's kernel (a
# compiled XLA:CPU program in interpret mode). Both evaluate the same
# expressions, but XLA's compiled code rounds some of them differently
# (rsqrt, and mul+add chains it may contract into FMAs) than PyTorch's
# eager elementwise ops. One-ulp differences in r.e (reflected light .
# eye) then grow by the shininess exponent in specular highlights
# (d pow(x, n) / pow = n dx / x, n = 200-300), which puts ~1% of rays
# (measured 0.3-1.1% on these rays) between 2e-6 and 1e-4. Past 1e-4
# are only boundary decisions (shadow, n1/n2 match, closest hit) that an
# ulp flipped: measured <= 2 of 4096 rays.
F32_TIGHT, F32_TIGHT_SHARE = 2e-6, 0.98
F32_LOOSE, F32_LOOSE_SHARE = 1e-4, 0.999


def assert_f32_budget(port, ref):
    diff = ray_diff(port, ref)
    assert np.isfinite(port).all()
    tight = float((diff <= F32_TIGHT).mean())
    loose = float((diff <= F32_LOOSE).mean())
    assert tight >= F32_TIGHT_SHARE and loose >= F32_LOOSE_SHARE, \
        (f"within {F32_TIGHT}: {tight:.4f}, within {F32_LOOSE}: {loose:.4f}, "
         f"max {diff.max():.3e}")
