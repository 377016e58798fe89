# read_image: a frozen copy of rray_tpu_torch/render/canvas.py::read_image at commit 6dfcb62.
"""Texture reading for the frozen loader, and its refusal of OBJ meshes
(the port's OBJ loader calls its native parser, which this reference
does not build)."""
from __future__ import annotations

import numpy as np


def read_image(path: str) -> np.ndarray:
    """Load an image as float RGB in [0,1] (texture.rs:16-20 + /255)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float64) / 255.0


def load_obj_file(path, material=None):
    raise NotImplementedError(f"{path}: the reference renders no OBJ mesh")
