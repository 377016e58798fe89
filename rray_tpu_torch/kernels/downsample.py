"""Box-filter AA downsample of an aa-scaled raster: CUDA kernel, plain
PyTorch version, and the wrapper that picks between them.

It replaces no TPU kernel: rray_tpu copies the whole [H*aa, W*aa, 3]
raster to the host and averages its aa x aa blocks there with numpy
(rray_tpu/render/canvas.py:11-17; the port's render/canvas.py keeps that
function for host canvases). `api.render_scene` calls this one on the
raster the render leaves on the device, so a CLI frame at aa > 1 copies
the [H, W, 3] image instead and the host takes no mean: at config 5's
1920x1080 and aa = 5, 24.9 MB instead of 622 MB, and no strided numpy
pass over 51.84 M rays.

Bound: bytes. One pass reads the raster and writes the image once,
(aa^2 + 1) * H * W * 3 values: 647 MB at config 5's size, 0.19 ms at the
H100's 3.35 TB/s. The CUDA source is kernels/csrc/downsample.cu (one
thread per output value, the sum in a register; body `box_mean` in
csrc/downsample_device.cuh).

Both versions give canvas.downsample's numbers bit for bit: crop to whole
blocks, add each block's values in the raster's dtype to +0.0, rows outer
and columns inner (how numpy's mean(axis=(1, 3)) of the reshaped raster
sums), then divide once by aa * aa.
"""
from __future__ import annotations

import torch

from ..ops.vec import div

# Kernel launches made by `downsample` in this process (CPU calls, which
# run the plain version, do not count).
launches = 0


def downsample_reference(image, aa: int):
    """Plain PyTorch version of `downsample`: aa * aa adds to +0.0 in the
    kernel's order, then one division."""
    oh, ow = image.shape[0] // aa, image.shape[1] // aa
    blocks = image[: oh * aa, : ow * aa].reshape(oh, aa, ow, aa, 3)
    total = torch.zeros((oh, ow, 3), dtype=image.dtype, device=image.device)
    for dy in range(aa):
        for dx in range(aa):
            total = total + blocks[:, dy, :, dx]
    return div(total, aa * aa)


def _launch(image, aa: int):
    from . import build

    device = image.device
    if image.dim() != 3 or image.shape[2] != 3:
        raise ValueError(f"the raster has shape {tuple(image.shape)}, "
                         "expected [h, w, 3]")
    if image.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the raster is {image.dtype}; the CUDA kernel takes "
                        "float32 or float64")
    build.check_arg("raster", image, image.shape, device, image.dtype)
    h, w = image.shape[:2]
    oh, ow = h // aa, w // aa
    if 3 * w >= 2 ** 31:
        raise ValueError(f"a raster {w} pixels wide is past the kernel's "
                         "int32 row index")
    out = torch.empty((oh, ow, 3), dtype=image.dtype, device=device)
    ptr = build.ptr
    with build.device_guard(device):
        rc = build.load_library().downsample_launch(
            ptr(image), ptr(out), w, oh, ow, aa,
            int(image.dtype == torch.float64), build.stream(device))
    build.check_launch("downsample", rc)
    build.count(globals(), "launches")
    return out


def downsample(image, aa: int):
    """[h, w, 3] raster -> [h // aa, w // aa, 3]: the mean of each aa x aa
    block (rows and columns past the last whole block are dropped), in the
    raster's dtype, the same bits as canvas.downsample of its numpy copy.
    CPU tensors run the plain version; CUDA tensors launch the kernel
    (float32 or float64, contiguous)."""
    if aa < 1:
        raise ValueError(f"aa={aa}: the box filter takes aa >= 1")
    if image.device.type == "cpu":
        return downsample_reference(image, aa)
    return _launch(image, aa)
