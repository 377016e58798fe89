"""Canvas output: box-filter AA downsample + 8-bit PNG (canvas.rs:76-131).

Quantization matches the reference's `(c * 255.0) as u8` — truncation
toward zero with saturation, no clamp-to-1 and no gamma.
"""
from __future__ import annotations

import numpy as np

from ..utils import profiling


def downsample(image: np.ndarray, aa: int) -> np.ndarray:
    """Average aa x aa pixel blocks (canvas.rs:76-105)."""
    if aa <= 1:
        return image
    with profiling.span("downsample"):
        h, w = image.shape[:2]
        oh, ow = h // aa, w // aa
        return image[: oh * aa, : ow * aa].reshape(
            oh, aa, ow, aa, 3).mean(axis=(1, 3))


def to_u8(image: np.ndarray) -> np.ndarray:
    """Rust `as u8` saturating cast: truncate toward zero, clamp [0,255]."""
    scaled = np.nan_to_num(np.asarray(image, np.float64)) * 255.0
    return np.clip(np.trunc(scaled), 0, 255).astype(np.uint8)


def write_png(path: str, image: np.ndarray, aa: int = 1) -> None:
    image = downsample(np.asarray(image), aa)
    with profiling.span("png"):
        _write_png(path, image)


def _write_png(path: str, image: np.ndarray) -> None:
    # Native tier: C++ quantizer + zlib PNG encoder (native/rray_host.cpp).
    from ..io.native import encode_png_native, quantize_native

    rgba = quantize_native(np.nan_to_num(np.asarray(image, np.float32)))
    if rgba is not None:
        png = encode_png_native(rgba)
        if png is not None:
            with open(path, "wb") as f:
                f.write(png)
            return

    from PIL import Image

    data = to_u8(image)
    rgba = np.concatenate([data, np.full(data.shape[:2] + (1,), 255, np.uint8)],
                          axis=-1)
    Image.fromarray(rgba, "RGBA").save(path)


def read_image(path: str) -> np.ndarray:
    """Load an image as float RGB in [0,1] (texture.rs:16-20 + /255)."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    return np.asarray(img, np.float64) / 255.0
