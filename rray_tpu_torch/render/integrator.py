"""The Whitted integrator: camera rays through the whole-tree kernel.

rray_tpu's render() picks a node per scene: XLA for point-light scenes
with only analytic prims and cheap patterns (a TPU speed choice), the
fused Pallas kernel for the rest that kernels/whitted.py::applicable
accepts, XLA scans otherwise. This slice runs every scene that
`applicable()` accepts through the kernel (example1 included, at depth
0 with no spawn); both of rray_tpu's routes compute the same image.
Scenes the kernel does not take yet raise NotImplementedError naming
the ROADMAP item that will carry them.
"""
from __future__ import annotations

import torch

from ..config import RenderSettings
from ..kernels import whitted
from ..scene.data import SceneData
from .camera import CameraData, all_rays_soa


def render(scene: SceneData, cam: CameraData,
           settings: RenderSettings = RenderSettings()):
    """Full-frame render -> image [vsize, hsize, 3] (linear, unclamped),
    on the scene's device."""
    reason = whitted.unsupported(scene)
    if reason is not None:
        raise NotImplementedError(f"not ported yet: {reason}")
    ro, rd = all_rays_soa(cam)
    pat_tbl, descrs = whitted.pack_patterns(scene)
    depth, W = whitted.wavefront_shape(scene, settings)
    rgb = whitted.whitted_compact(
        (ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z), whitted.pack_prims(scene),
        pat_tbl, whitted.pack_lights(scene), kinds=scene.prim_kinds,
        pat_descrs=descrs, prim_pat=scene.prim_pattern_static, depth=depth,
        W=W, has_refl=scene.has_reflective, has_refr=scene.has_transparent)
    return torch.stack(rgb, dim=-1).reshape(cam.vsize, cam.hsize, 3)
