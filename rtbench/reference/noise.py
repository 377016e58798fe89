# Frozen copy of rray_tpu_torch/ops/noise.py at commit 6dfcb62 (imports made local).
"""FastNoiseLite-compatible 3D Perlin noise on torch tensors (a copy of
rray_tpu ops/noise.py, the port's own).

The reference samples Perlin noise through the fastnoise-lite crate with
default settings: seed 1337, frequency 0.01, NoiseType::Perlin, no 3D
rotation (noise.rs:5-9,26-29), layered into fBm by octave_perlin
(noise.rs:50-63). The hash is int32 arithmetic with wrapping products
and an arithmetic `>> 15`, as rray_tpu computes it in JAX; here the
values ride in int64 tensors, each product is wrapped back to int32
range by hand (torch's int32 overflow is not something to lean on), and
out-of-range floors saturate as XLA's float -> int32 conversion does.
The CUDA kernel's copy is kernels/csrc/noise_device.cuh (uint32_t
products, the same closed-form gradient selects).
"""
from __future__ import annotations

import torch

_PRIME_X = 501125321
_PRIME_Y = 1136930381
_PRIME_Z = 1720413743
_HASH_MUL = 668265261  # 0x27d4eb2d
_PERLIN_SCALE = 0.964921414852142333984375

DEFAULT_SEED = 1337
DEFAULT_FREQUENCY = 0.01

_I32_MIN, _I32_MAX = -2 ** 31, 2 ** 31 - 1


def wrap_i32(v):
    """An int64 tensor reduced to int32 two's-complement range."""
    v = v & 0xFFFFFFFF
    return torch.where(v > _I32_MAX, v - 2 ** 32, v)


def to_i32(f):
    """float -> int32 value (in int64) as XLA converts: truncation toward
    zero, saturating at the int32 range, NaN to 0. torch's own conversion
    of an out-of-range float is undefined, so clamp first."""
    f = torch.nan_to_num(f.to(torch.float64), nan=0.0, posinf=_I32_MAX,
                         neginf=_I32_MIN)
    return f.clamp(_I32_MIN, _I32_MAX).to(torch.int64)


def _grad_coord(seed: int, xp, yp, zp, xd, yd, zd):
    h = (seed ^ xp) ^ (yp ^ zp)
    h = wrap_i32(h * _HASH_MUL)
    h = h ^ (h >> 15)  # arithmetic shift of the int32 value
    idx = (h & (63 << 2)) >> 2
    # The 64-entry gradient table in closed form: entries 0..59 are the
    # 12 cube-edge gradients (one zero component, the others +-1) tiled
    # 5x, 60..63 four fixed fillers (rray_tpu noise.py:39-63).
    j = idx % 12
    k = j % 4
    one = torch.ones_like(xd)
    s1 = torch.where((k & 1) == 0, one, -one)
    s2 = torch.where((k & 2) == 0, one, -one)
    g = j >> 2  # 0: x = 0, 1: y = 0, 2: z = 0
    dot = torch.where(g == 0, s1 * yd + s2 * zd,
                      torch.where(g == 1, s1 * xd + s2 * zd,
                                  s1 * xd + s2 * yd))
    fill = torch.where(idx == 60, xd + yd,
                       torch.where(idx == 61, zd - yd,
                                   torch.where(idx == 62, yd - xd, -yd - zd)))
    return torch.where(idx >= 60, fill, dot)


def _quintic(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _lerp(a, b, t):
    return a + t * (b - a)


def single_perlin3(x, y, z, seed: int = DEFAULT_SEED):
    """Raw Perlin at already frequency-scaled coordinates."""
    xf, yf, zf = torch.floor(x), torch.floor(y), torch.floor(z)
    xd0, yd0, zd0 = x - xf, y - yf, z - zf
    xd1, yd1, zd1 = xd0 - 1.0, yd0 - 1.0, zd0 - 1.0
    xs, ys, zs = _quintic(xd0), _quintic(yd0), _quintic(zd0)
    x0 = wrap_i32(to_i32(xf) * _PRIME_X)
    y0 = wrap_i32(to_i32(yf) * _PRIME_Y)
    z0 = wrap_i32(to_i32(zf) * _PRIME_Z)
    x1 = wrap_i32(x0 + _PRIME_X)
    y1 = wrap_i32(y0 + _PRIME_Y)
    z1 = wrap_i32(z0 + _PRIME_Z)

    def g(xp, yp, zp, xd, yd, zd):
        return _grad_coord(seed, xp, yp, zp, xd, yd, zd)

    xf00 = _lerp(g(x0, y0, z0, xd0, yd0, zd0), g(x1, y0, z0, xd1, yd0, zd0), xs)
    xf10 = _lerp(g(x0, y1, z0, xd0, yd1, zd0), g(x1, y1, z0, xd1, yd1, zd0), xs)
    xf01 = _lerp(g(x0, y0, z1, xd0, yd0, zd1), g(x1, y0, z1, xd1, yd0, zd1), xs)
    xf11 = _lerp(g(x0, y1, z1, xd0, yd1, zd1), g(x1, y1, z1, xd1, yd1, zd1), xs)
    yf0 = _lerp(xf00, xf10, ys)
    yf1 = _lerp(xf01, xf11, ys)
    return _lerp(yf0, yf1, zs) * _PERLIN_SCALE


def get_noise_3d(x, y, z, seed: int = DEFAULT_SEED,
                 frequency: float = DEFAULT_FREQUENCY):
    """FastNoiseLite get_noise_3d: the frequency transform, then Perlin
    (noise.rs:26-29)."""
    f = torch.tensor(frequency, dtype=x.dtype)
    return single_perlin3(x * f, y * f, z * f, seed=seed)


def octave_perlin(x, y, z, octaves: int, persistence):
    """fBm normalized by the total amplitude (noise.rs:50-63). `octaves`
    is a Python int, `persistence` a number or 0-d tensor."""
    dtype = x.dtype
    total = torch.zeros_like(x)
    frequency = 1.0
    amplitude = torch.tensor(1.0, dtype=dtype)
    max_value = torch.tensor(0.0, dtype=dtype)
    persistence = torch.as_tensor(persistence, dtype=dtype).cpu()
    for _ in range(max(int(octaves), 0)):
        total = total + get_noise_3d(x * frequency, y * frequency,
                                     z * frequency) * amplitude.to(x.device)
        max_value = max_value + amplitude
        amplitude = amplitude * persistence
        frequency *= 2.0
    if float(max_value.detach()) == 0.0:
        return total
    return total / max_value.to(x.device)
