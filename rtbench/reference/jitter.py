# Frozen copy of rray_tpu_torch/ops/jitter.py at commit 9ecb365.
"""Point-keyed stratified jitter for area-light sampling (rray_tpu
ops/jitter.py), on torch tensors.

A draw is a pure function of an int32 seed and the float32 bits of the
shadow origin:

    base = fmix32(bits(x) * C1 ^ fmix32(bits(y) * C2 ^ fmix32(bits(z)
           * C3 ^ seed)))
    draw(base, k) = (fmix32(base ^ k * 0x9E3779B9) >>> 8) * 2^-24

(murmur3's finalizer as the mixer, wrapping 32-bit arithmetic, logical
shifts). The plain versions of the area-shadow kernels draw through
these functions; the kernels recompute the same draws in registers
(kernels/csrc/jitter_device.cuh), and integer arithmetic is exact, so
both consume identical draws.

torch's `>>` on int32 is an arithmetic shift and its uint32 shifts raise
on the CPU, so the hash runs on int64 tensors holding values in
[0, 2^32): a shift of a non-negative value is logical, and a product
is formed from 16-bit halves so that it never leaves int64.

The seeds come from rray_tpu's key chain: `seed_table(seed, depth, L)`
holds seed_from_key(fold_in(fold_in(root, level), 1000 + li)) for every
level of the Whitted chain and every light, where the root is
PRNGKey(seed) for an int seed, or a key itself (a band of a progressive
frame renders under fold_in(PRNGKey(seed), row_start), as rray_tpu's
render_rows does).
"""
from __future__ import annotations

import numpy as np
import torch

from . import prng

MASK = 0xFFFFFFFF
C1, C2, C3 = 0xCC9E2D51, 0x1B873593, 0x85EBCA6B
F1, F2 = 0x85EBCA6B, 0xC2B2AE35
GOLD = 0x9E3779B9


def _mul(a, c: int):
    """a * c mod 2^32 for int64 a in [0, 2^32) and a constant c."""
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return ((a & 0xFFFF) * c + hi) & MASK


def fmix32(h):
    """murmur3 finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul(h, F1)
    h = h ^ (h >> 13)
    h = _mul(h, F2)
    return h ^ (h >> 16)


def seed_from_key(key) -> int:
    """One int32 seed from a uint32 key pair: k[0] ^ k[1] as int32."""
    k = np.asarray(key, np.uint32).reshape(-1)
    return int((k[0] ^ k[-1]).view(np.int32))


def _bits(v):
    return v.to(torch.float32).view(torch.int32).to(torch.int64) & MASK


def point_base(seed: int, x, y, z):
    """Per-point hash base from the float32 bits of (x, y, z) -> int64
    tensor of uint32 values."""
    h = fmix32(_mul(_bits(z), C3) ^ (int(seed) & MASK))
    h = fmix32(_mul(_bits(y), C2) ^ h)
    return fmix32(_mul(_bits(x), C1) ^ h)


def draw_unit(base, counter, dtype=torch.float32):
    """counter-th uniform in [0, 1) for each element of `base` (24 bits,
    exact in float32); `counter` is an int or an int64 tensor."""
    h = fmix32(base ^ ((counter * GOLD) & MASK))
    return (h >> 8).to(dtype) * 2.0 ** -24


def point_jitter(seed: int, x, y, z, n: int, dtype=torch.float32):
    """[2, n, R] stratified-jitter draws keyed by (seed, point bits):
    sample s reads (out[0, s], out[1, s])."""
    base = point_base(seed, x, y, z)
    return torch.stack([
        torch.stack([draw_unit(base, 2 * s + j, dtype) for s in range(n)])
        for j in range(2)])


def seed_table(seed, depth: int, n_lights: int):
    """[depth + 1, n_lights] int32 seeds of rray_tpu's key chain: level
    l, light li draws from seed_from_key(fold_in(fold_in(root, l), 1000 +
    li)). `seed` is an int (root PRNGKey(seed)) or a root key, a uint32
    pair (ops/prng.py)."""
    root = prng.root_key(seed)
    table = [[seed_from_key(prng.fold_in(prng.fold_in(root, lvl), 1000 + li))
              for li in range(n_lights)] for lvl in range(depth + 1)]
    return torch.tensor(table, dtype=torch.int32).reshape(depth + 1,
                                                          n_lights)
