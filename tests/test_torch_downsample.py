"""The box-filter AA downsample (rray_tpu_torch/kernels/downsample.py) on
the CPU: its plain version and its device body
(kernels/csrc/downsample_device.cuh, built here as host C++ with g++ and
-ffp-contract=off, the host analogue of the kernel's --fmad=false)
against render/canvas.py::downsample, numpy's mean of the host raster,
bit for bit; and api.render_scene's route to it. The kernel itself runs
in tests/test_torch_cuda.py, on the card."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rray_tpu_torch import api
from rray_tpu_torch.config import RenderSettings
from rray_tpu_torch.io.yaml_loader import load_scene_file
from rray_tpu_torch.kernels import downsample
from rray_tpu_torch.render import canvas
from rray_tpu_torch.render.integrator import render

BASE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(BASE, "rray_tpu_torch", "kernels", "csrc")
GLASS = os.path.join(BASE, "examples", "glass.yaml")

HARNESS = r"""
#define RRAY_DEVICE inline
#include "downsample_device.cuh"
template <typename T>
static void run(const void* r, void* i, int w, int oh, int ow, int aa) {
  const T* raster = static_cast<const T*>(r);
  T* image = static_cast<T*>(i);
  for (int oy = 0; oy < oh; ++oy)
    for (int ox = 0; ox < ow; ++ox)
      for (int c = 0; c < 3; ++c)
        image[(oy * ow + ox) * 3 + c] =
            rray::box_mean(raster, oy, ox, c, w, aa);
}
// The kernel's grid as loops: every (oy, ox, c) of the [oh, ow, 3] image.
extern "C" void downsample_all(const void* raster, void* image, int w,
                               int oh, int ow, int aa, int f64) {
  if (f64)
    run<double>(raster, image, w, oh, ow, aa);
  else
    run<float>(raster, image, w, oh, ow, aa);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the device code as host C++")
    d = tmp_path_factory.mktemp("downsample")
    (d / "harness.cpp").write_text(HARNESS)
    subprocess.run([cxx, "-O2", "-ffp-contract=off", "-std=c++17", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(d / "libharness.so"),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(d / "libharness.so"))
    lib.downsample_all.restype = None
    lib.downsample_all.argtypes = ([ctypes.c_void_p] * 2
                                   + [ctypes.c_int] * 5)
    return lib


def _raster(shape, dtype, seed):
    """Values spread over 20 decades of both signs, a few NaN and +-inf,
    and one block of -0.0 (numpy's sum of it is +0.0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 10.0 ** rng.integers(-10, 10, shape)
    x = x.astype(dtype)
    for value in (np.nan, np.inf, -np.inf):
        x.flat[rng.choice(x.size, 6, replace=False)] = value
    x[:5, :5] = -0.0
    return x


def _shaped(shape, aa, dtype):
    """(raster, oh, ow) for one of SHAPES at `aa`."""
    oh, ow, extra_h, extra_w = shape
    extra_w = aa - 1 if extra_w < 0 else extra_w
    return _raster((oh * aa + extra_h, ow * aa + extra_w, 3), dtype,
                   seed=aa), oh, ow


def _same_bits(got, want):
    """Equal shapes, dtypes, NaN places and the bits of every other value
    (so -0.0 is not +0.0)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.uint8), want[~nan].view(np.uint8))


# (height, width) in output pixels, plus the rows and columns past the
# last whole block that the crop drops (-1: aa - 1 of them).
SHAPES = [(7, 11, 0, 0), (9, 6, 1, -1), (1, 1, 0, 1)]


@pytest.mark.parametrize("shape", SHAPES, ids=["whole", "cropped", "one"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("aa", [2, 3, 4, 5])
def test_plain_version_matches_canvas_downsample(aa, dtype, shape):
    x, oh, ow = _shaped(shape, aa, dtype)
    want = canvas.downsample(x, aa)
    got = downsample.downsample(torch.from_numpy(x), aa).numpy()
    _same_bits(got, want)
    assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("shape", SHAPES, ids=["whole", "cropped", "one"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("aa", [2, 3, 4, 5])
def test_device_body_matches_canvas_downsample(host_lib, aa, dtype, shape):
    x, oh, ow = _shaped(shape, aa, dtype)
    got = np.empty((oh, ow, 3), dtype)
    host_lib.downsample_all(x.ctypes.data, got.ctypes.data, x.shape[1], oh,
                            ow, aa, int(dtype == np.float64))
    _same_bits(got, canvas.downsample(x, aa))


def test_wrapper_takes_aa_of_one_or_more():
    x = torch.from_numpy(_raster((6, 8, 3), np.float32, seed=0))
    assert torch.equal(downsample.downsample(x, 1).nan_to_num(),
                       x.nan_to_num())
    with pytest.raises(ValueError, match="aa >= 1"):
        downsample.downsample(x, 0)


@pytest.mark.parametrize("aa", [1, 2, 3])
def test_render_scene_returns_canvas_downsample_of_the_raster(aa):
    """The CPU route: the plain version on the raster before the copy,
    the same bits as the host mean of the copied raster; no launch."""
    spec, lights, shapes = load_scene_file(GLASS)
    before = downsample.launches
    image = api.render_scene(spec, lights, shapes, 16, 12, aa, device="cpu")
    scene, cam = api._build(spec, lights, shapes, 16, 12, aa,
                            torch.float32, "cpu")
    raster = render(scene, cam, RenderSettings(), 0).numpy()
    assert isinstance(image, np.ndarray)
    _same_bits(image, canvas.downsample(raster, aa))
    assert downsample.launches == before
