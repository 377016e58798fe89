# shadow() replays the sample loop of rray_tpu_torch/kernels/analytic.py::area_sample under the seed
# table of rray_tpu_torch/kernels/whitted.py::kernel_inputs, at commit 9ecb365, over the reference's
# own any-hit (hits.shadow_hit); jitter.py and prng.py are frozen copies of the port's key chain.
"""The shadow fraction of an area light, as plain torch ops.

An area light of level n is sampled on an n x n grid, each cell
jittered by two uniform draws (light.rs:47-65); the fraction is the
share of the n^2 segments from the shadow origin to a sample that some
surface blocks in [0, dist).

Upstream rray draws its jitter from `thread_rng`. rray_tpu, and the
port after it, draw from a seeded chain instead (its documented
departure from rray), and this module follows the port: level l of the
Whitted tree and light li draw from seed_table(seed)[l, li] =
seed_from_key(fold_in(fold_in(PRNGKey(seed), l), 1000 + li)) (prng.py),
hashed with the float32 bits of each shadow origin (jitter.py
point_base), so one ulp of a hit point changes all of its pixel's
draws. That is the chain of the port's routed nodes (the whitted
kernel, the fast and sorted nodes), keyed per level; the port's per-ray
oracle keys per node, a different chain, which this does not replay.

Frames render under the port's default seed, SEED = 0. This holds for
one-shot frames only: a band of `render_scene_progressive` renders under
fold_in(PRNGKey(seed), row_start), which a progressive cell would have
to pass here.

The count is divided by n^2 once; the whitted kernel scales it by
float(1 / n^2), at most an ulp of the fraction apart.
"""
from __future__ import annotations

import torch

from . import hits
from .jitter import draw_unit, point_base, seed_table
from .vec import div

SEED = 0


def shadow(scene, li, light, over, settings, level):
    """The fraction of area light `li` blocked at the points `over`
    [R, 3] on tree level `level` -> [R]."""
    dtype = over.dtype
    key = int(seed_table(SEED, level, len(scene.lights))[level, li])
    hb = point_base(key, over[:, 0], over[:, 1], over[:, 2])
    side = int(light.level)
    n = side * side
    corner, uvec, vvec = (v[None, :] for v in (light.corner, light.uvec,
                                                light.vvec))
    count = torch.zeros_like(over[:, 0])
    for s in range(n):
        ur = div(s % side + draw_unit(hb, 2 * s, dtype), side)
        vr = div(s // side + draw_unit(hb, 2 * s + 1, dtype), side)
        seg = corner + uvec * ur[:, None] + vvec * vr[:, None] - over
        x, y, z = seg.unbind(-1)
        dist = torch.sqrt(x * x + y * y + z * z)
        direction = seg * (1.0 / torch.clamp_min(dist, 1e-30))[:, None]
        count = count + hits.shadow_hit(scene, over, direction, dist,
                                        settings).to(dtype)
    return div(count, n)
