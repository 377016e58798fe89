# Frozen copy of rray_tpu_torch/ops/prng.py at commit 9ecb365.
"""Threefry-2x32 keys on the host, in numpy: `prng_key` and `fold_in`.

rray_tpu keys every area-light jitter draw on a chain of
`jax.random.fold_in` calls from `jax.random.PRNGKey(seed)`
(rray_tpu/render/integrator.py `_fast_node_eval` and
`_whitted_kernel_call`). The port needs the same keys, bit for bit,
without JAX: they seed the point-keyed hash of ops/jitter.py, so a
different key gives every pixel different shadow samples.

A key is a uint32 pair. `prng_key(s)` is [0, s mod 2^32] (JAX's
`threefry_seed` for a 32-bit seed); `fold_in(k, d)` is the 20-round
Threefry-2x32 block of k applied to the counter pair (0, d), JAX's
`threefry_2x32(k, threefry_seed(d))`.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (key injection after every four,
    plus the injection's index) -> the output pair (y0, y1) as uint32."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.uint32(x0) + ks[0], np.uint32(x1) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return np.uint32(x[0]), np.uint32(x[1])


def prng_key(seed: int) -> np.ndarray:
    """The key of a 32-bit integer seed -> uint32 [2]: [0, seed mod
    2^32], jax.random.PRNGKey's key for a 32-bit seed (a negative seed
    included), which is what rray_tpu's render builds from its int seed
    in JAX's default 32-bit mode."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 32:
        raise ValueError(f"seed {seed} is outside the 32-bit range")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """A new key from `key` and a 32-bit integer (jax.random.fold_in)
    -> uint32 [2]."""
    with np.errstate(over="ignore"):
        return np.array(threefry2x32(key, 0, int(data) & 0xFFFFFFFF),
                        np.uint32)


def root_key(seed) -> np.ndarray:
    """The key that an int seed or a key stands for -> uint32 [2]: an int
    is `prng_key(seed)`, a uint32 pair is the key itself."""
    if isinstance(seed, (int, np.integer)):
        return prng_key(seed)
    key = np.asarray(seed)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise ValueError(f"a root key is a uint32 pair, not {key.dtype} "
                         f"{key.shape}")
    return key
