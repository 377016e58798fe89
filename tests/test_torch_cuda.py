"""rray_tpu_torch's CUDA kernel on the card. Marked `cuda`: skipped where
torch.cuda.is_available() is False; on a GPU machine run with
`python -m pytest tests/test_torch_cuda.py -q -m cuda`."""
import os

import pytest
import torch

from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.kernels import whitted
from rray_tpu_torch.render.camera import Camera, all_rays_soa, compile_camera
from rray_tpu_torch.scene.data import compile_scene

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _args(name, device, cap=4, w=160, h=120):
    cam_spec, lights, shapes = load_scene_file(
        os.path.join(BASE, "examples", name))
    scene = compile_scene(shapes, lights, dtype=torch.float32, device=device)
    cam = Camera(w, h, cam_spec["fov"])
    cam.transform = cam_spec["transform"]
    ro, rd = all_rays_soa(compile_camera(cam, torch.float32, device))
    pat_tbl, descrs = whitted.pack_patterns(scene)
    depth, W = whitted.wavefront_shape(
        scene, RenderSettings(wavefront_capacity=cap))
    return ((ro.x, ro.y, ro.z), (rd.x, rd.y, rd.z), whitted.pack_prims(scene),
            pat_tbl, whitted.pack_lights(scene), scene.prim_kinds, descrs,
            scene.prim_pattern_static, depth, W, scene.has_reflective,
            scene.has_transparent)


@pytest.mark.parametrize("name,cap", [("example1.yaml", 4), ("glass.yaml", 1),
                                      ("glass.yaml", 4), ("glass.yaml", 32)])
def test_kernel_matches_plain_version(cuda, name, cap):
    args = _args(name, cuda, cap)
    before = whitted.launches
    kern = torch.stack(whitted.whitted_compact(*args))
    assert whitted.launches == before + 1
    plain = torch.stack(whitted.whitted_compact_reference(*args))
    torch.cuda.synchronize()
    # --fmad=false: the kernel rounds as the plain version does; only
    # rsqrtf/powf ulps may differ (measured: bit-identical at 800x600).
    diff = (kern - plain).abs().amax(0)
    assert bool(torch.isfinite(kern).all())
    assert float((diff <= 1e-6).double().mean()) >= 0.999


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    rays_o, rays_d, *rest = _args("glass.yaml", cuda, 4, 8, 6)
    f64 = tuple(c.double() for c in rays_o)
    with pytest.raises(TypeError, match="float32"):
        whitted.whitted_compact(f64, rays_d, *rest)
    with pytest.raises(ValueError, match="W=3"):
        whitted.whitted_compact(rays_o, rays_d, *rest[:7], 3, *rest[8:])
    strided = tuple(torch.zeros(12, device=cuda)[::2] for _ in range(3))
    with pytest.raises(ValueError, match="contiguous"):
        whitted.whitted_compact(strided, strided, *rest)
