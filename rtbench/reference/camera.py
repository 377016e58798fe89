# Frozen copy of rray_tpu_torch/render/camera.py at commit 6dfcb62 (imports made local).
"""Pinhole camera (camera.rs:29-93): ray generation for the whole raster.

The camera is host-side data (its inverse view transform folds at build
time); ray generation is a vectorized ray_for_pixel — pixel centers on
the z=-1 canvas plane, +x to the left — in component (SoA) form.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import mathutils as mu
from .rconfig import checked_device
from .intersect import affine
from .vec import V3


@dataclasses.dataclass
class Camera:
    hsize: int
    vsize: int
    field_of_view: float
    transform: np.ndarray = dataclasses.field(default_factory=mu.identity)

    @property
    def _derived(self):
        half_view = np.tan(self.field_of_view / 2.0)
        aspect = self.hsize / self.vsize
        if aspect >= 1.0:
            half_width, half_height = half_view, half_view / aspect
        else:
            half_width, half_height = half_view * aspect, half_view
        pixel_size = half_width * 2.0 / self.hsize
        return half_width, half_height, pixel_size

    @property
    def pixel_size(self):
        """World width of one pixel on the canvas (camera.rs:29-60)."""
        return self._derived[2]


@dataclasses.dataclass
class CameraData:
    """Device-side camera parameters (0-d tensors of the render dtype)."""

    inv: Any          # [3,4] inverse view transform (affine)
    half_width: Any
    half_height: Any
    pixel_size: Any
    hsize: int
    vsize: int


def compile_camera(cam: Camera, dtype=torch.float32,
                   device="cuda") -> CameraData:
    """The camera's parameters on `device` (the card unless the caller
    passes "cpu"; config.checked_device)."""
    device = checked_device(device)
    t = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
    hw, hh, ps = cam._derived
    return CameraData(inv=t(mu.affine(mu.inverse(cam.transform))),
                      half_width=t(hw), half_height=t(hh), pixel_size=t(ps),
                      hsize=cam.hsize, vsize=cam.vsize)


def rays_for_pixels(cam: CameraData, px, py):
    """ray_for_pixel (camera.rs:75-93) for integer pixel tensors [R] ->
    (origins [R, 3], unit directions [R, 3]), rray_tpu's per-ray (AoS)
    form. The operations run in rays_for_pixels_soa's order, so both
    forms give the same rays."""
    dtype = cam.inv.dtype
    xoff = (px.to(dtype) + 0.5) * cam.pixel_size
    yoff = (py.to(dtype) + 0.5) * cam.pixel_size
    wx = cam.half_width - xoff
    wy = cam.half_height - yoff
    canvas = torch.stack([wx, wy, -torch.ones_like(wx)], -1)
    pixel = affine(cam.inv, canvas[:, None, :], True)[:, 0]
    origin = cam.inv[:, 3].expand(pixel.shape).contiguous()
    direction = pixel - origin
    d2 = (direction[:, 0] * direction[:, 0] + direction[:, 1] * direction[:, 1]
          + direction[:, 2] * direction[:, 2])
    floor = 1e-30 if dtype == torch.float64 else 1e-18
    return origin, direction * torch.rsqrt(torch.clamp_min(d2, floor))[:, None]


def all_rays(cam: CameraData):
    """[R, 3] rays for the full raster in row-major order
    (camera.rs:134-136)."""
    dev = cam.inv.device
    ys, xs = torch.meshgrid(torch.arange(cam.vsize, device=dev),
                            torch.arange(cam.hsize, device=dev),
                            indexing="ij")
    return rays_for_pixels(cam, xs.reshape(-1), ys.reshape(-1))


def rays_for_pixels_soa(cam: CameraData, px, py):
    """ray_for_pixel (camera.rs:75-93) for integer pixel tensors [R]."""
    dtype = cam.inv.dtype
    xoff = (px.to(dtype) + 0.5) * cam.pixel_size
    yoff = (py.to(dtype) + 0.5) * cam.pixel_size
    wx = cam.half_width - xoff
    wy = cam.half_height - yoff
    lin = cam.inv[:, :3]
    tr = cam.inv[:, 3]
    pixel = V3(lin[0, 0] * wx + lin[0, 1] * wy - lin[0, 2] + tr[0],
               lin[1, 0] * wx + lin[1, 1] * wy - lin[1, 2] + tr[1],
               lin[2, 0] * wx + lin[2, 1] * wy - lin[2, 2] + tr[2])
    origin = V3(*(tr[k].expand(wx.shape).contiguous() for k in range(3)))
    direction = (pixel - origin).normalize()
    return origin, direction


def rows_rays_soa(cam: CameraData, r0: int, r1: int):
    """SoA rays of raster rows [r0, r1) in row-major order."""
    dev = cam.inv.device
    ys, xs = torch.meshgrid(torch.arange(r0, r1, device=dev),
                            torch.arange(cam.hsize, device=dev),
                            indexing="ij")
    return rays_for_pixels_soa(cam, xs.reshape(-1), ys.reshape(-1))


def all_rays_soa(cam: CameraData):
    """SoA rays for the full raster in row-major order."""
    return rows_rays_soa(cam, 0, cam.vsize)
