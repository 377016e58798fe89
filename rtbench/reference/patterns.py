# Frozen copy of rray_tpu_torch/render/patterns.py at commit 6dfcb62 (imports made local).
"""Pattern-tree evaluation on [R, 3] points (rray_tpu render/patterns.py,
the port's own): the per-ray (AoS) form, beside render/shade_soa.py's
SoA form, which it checks.

The reference evaluates a recursive Pattern enum per shading point
(material/pattern.rs:145-215). A scene's pattern trees are fixed, so
each tree unrolls into straight-line torch ops, and the roots merge by
the hit prim's pattern id. Semantics kept exactly:

* every node applies its own transform inverse first (pattern.rs:146);
* stripe/ring/checker floor-parity tests (pattern.rs:154-181);
* gradient lerps by frac(x), so it repeats (pattern.rs:161-167);
* blend = a*(1-s) + b*s (pattern.rs:182-186);
* perturbed displaces the point by three fBm samples at (z, z+1, z+2)
  scaled by `scale` (pattern.rs:187-199);
* noise picks a or b scaled by |noise*scale| (pattern.rs:200-208);
* texture uses the object's uv_mapping on the pattern-space point and
  nearest-neighbour sampling with clamped uv and a v-flip
  (texture.rs:32-54).
"""
from __future__ import annotations

import torch

from . import intersect
from . import noise as fnl
from . import normals as nrm
from .vec import div
from . import data as sd


def _apply_inv(inv, pts):
    return intersect.affine(inv, pts, True)


def _even(x):
    # (floor(x) as i32) % 2 == 0; the remainder's sign does not matter.
    return torch.remainder(torch.floor(x), 2.0) == 0.0


def _sample_texture(texture, u, v, dtype):
    h, w = texture.shape[0], texture.shape[1]
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.clamp(v, 0.0, 1.0)
    x = torch.clamp_max((u * w).to(torch.int64), w - 1)
    y = torch.clamp_max((v * h).to(torch.int64), h - 1)
    y = h - y - 1  # v = 0 is the bottom row (texture.rs:41-42)
    px = texture[y, x]
    if texture.dtype == torch.int32:
        # Packed 8-bit RGB (scene/data.py): u8 / 255.
        rgb = torch.stack([(px >> 16) & 0xFF, (px >> 8) & 0xFF, px & 0xFF],
                          dim=-1)
        return div(rgb.to(dtype), 255.0)
    return px


def eval_pattern(node: sd.PatternData, pts, uv_ctx):
    """The colour of `node` at object-space points [R, 3] -> [R, 3].
    uv_ctx(pattern points [R, 3]) -> (u, v) serves image leaves: the hit
    prim's uv_mapping."""
    p = _apply_inv(node.inv, pts)
    t = node.ptype
    if t == "solid":
        return node.color[None, :].expand(p.shape)
    if t == "test":
        return p
    if t in ("stripe", "ring", "checker"):
        if t == "stripe":
            cond = _even(p[:, 0])
        elif t == "ring":
            cond = _even(torch.sqrt(p[:, 0] ** 2 + p[:, 2] ** 2))
        else:
            s = (torch.floor(p[:, 0]) + torch.floor(p[:, 1])
                 + torch.floor(p[:, 2]))
            cond = torch.remainder(s, 2.0) == 0.0
        return torch.where(cond[:, None], eval_pattern(node.a, p, uv_ctx),
                           eval_pattern(node.b, p, uv_ctx))
    if t == "gradient":
        a = eval_pattern(node.a, p, uv_ctx)
        b = eval_pattern(node.b, p, uv_ctx)
        frac = (p[:, 0] - torch.floor(p[:, 0]))[:, None]
        return a + (b - a) * frac
    if t == "blend":
        a = eval_pattern(node.a, p, uv_ctx)
        b = eval_pattern(node.b, p, uv_ctx)
        return a * (1.0 - node.scale) + b * node.scale
    if t == "perturbed":
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        oct_, pers = node.octaves, node.persistence
        nx = fnl.octave_perlin(x, y, z, oct_, pers) * node.scale
        ny = fnl.octave_perlin(x, y, z + 1.0, oct_, pers) * node.scale
        nz = fnl.octave_perlin(x, y, z + 2.0, oct_, pers) * node.scale
        return eval_pattern(node.a, p + torch.stack([nx, ny, nz], -1),
                            uv_ctx)
    if t == "noise":
        n = fnl.octave_perlin(p[:, 0], p[:, 1], p[:, 2], node.octaves,
                              node.persistence) * node.scale
        a = eval_pattern(node.a, p, uv_ctx)
        b = eval_pattern(node.b, p, uv_ctx)
        return torch.where((n <= 0.0)[:, None], a * (-n)[:, None],
                           b * n[:, None])
    if t == "image":
        u, v = uv_ctx(p)
        return _sample_texture(node.texture, u, v, p.dtype)
    raise ValueError(f"unknown pattern type {t!r}")


def pattern_at_object(scene: sd.SceneData, prim, world_pts):
    """pattern_at_object (material.rs:77-80): world points [R, 3] into
    the hit prims' object space, then each prim's pattern root; every
    root is evaluated and the roots merge by pattern id."""
    obj_pts = nrm.local_point(scene, prim, world_pts)

    def uv_ctx(pattern_pts):
        return nrm.uv_at(scene, prim, pattern_pts)

    if len(scene.patterns) == 1:
        return eval_pattern(scene.patterns[0], obj_pts, uv_ctx)
    pid = scene.pattern_id[prim.long()]
    out = torch.zeros_like(world_pts)
    for i, root in enumerate(scene.patterns):
        color = eval_pattern(root, obj_pts, uv_ctx)
        out = torch.where((pid == i)[:, None], color, out)
    return out
