"""rray_tpu_torch/ops/prng.py and ops/jitter.py against jax.random and
rray_tpu/ops/jitter.py, bit for bit: the key chain that seeds the area
lights' jitter, and the point-keyed hash that draws from it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rray_tpu.ops import jitter as jax_jitter
from rray_tpu_torch.ops import jitter, prng

SEEDS = [0, 7, 123456, -1, -7, 2 ** 31 - 1, 2 ** 32 - 1]


def _key_data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


def _jax_key(seed):
    """jax.random.PRNGKey of a 32-bit seed: the key rray_tpu's render
    builds from an int seed in JAX's default 32-bit mode (these tests
    run with 64-bit mode on, where a negative Python int would become a
    64-bit seed)."""
    return jax.random.PRNGKey(np.int32(seed) if seed < 2 ** 31
                              else np.uint32(seed))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_chain_matches_jax_random(seed):
    """PRNGKey(s) and fold_in(fold_in(PRNGKey(s), level), 1000 + li) for
    the levels and lights of a depth-5 chain with three lights."""
    key = _jax_key(seed)
    root = prng.prng_key(seed)
    np.testing.assert_array_equal(root, _key_data(key))
    for lvl in range(6):
        for li in range(3):
            want = jax.random.fold_in(jax.random.fold_in(key, lvl), 1000 + li)
            got = prng.fold_in(prng.fold_in(root, lvl), 1000 + li)
            np.testing.assert_array_equal(got, _key_data(want))
            assert jitter.seed_from_key(got) == int(
                jax_jitter.seed_from_key(want))


def test_fold_in_of_large_data_and_out_of_range_seed():
    key = jax.random.PRNGKey(3)
    for data in (0, 1, 2 ** 31, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(prng.prng_key(3), data),
                                      _key_data(jax.random.fold_in(key, data)))
    with pytest.raises(ValueError, match="32-bit"):
        prng.prng_key(2 ** 32)


def test_seed_table_is_rray_tpu_kernel_table():
    """The [depth+1, L] table rray_tpu's _whitted_kernel_call builds
    (integrator.py:947-951)."""
    key = jax.random.PRNGKey(42)
    want = jnp.stack([
        jnp.stack([jax_jitter.seed_from_key(
            jax.random.fold_in(jax.random.fold_in(key, lvl), 1000 + li))
            for li in range(2)])
        for lvl in range(6)])
    table = jitter.seed_table(42, 5, 2)
    assert table.dtype == torch.int32 and tuple(table.shape) == (6, 2)
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))


def _points(dtype):
    """Seeded points with zeros, a negative zero, denormals and large and
    negative coordinates."""
    rng = np.random.default_rng(1)
    pts = rng.normal(0.0, 3.0, (3, 4096))
    pts[:, :6] = np.array([[0.0, -0.0, 1e-40, -1e-42, 1e-45, -3e38]] * 3)
    return pts.astype(dtype)


@pytest.mark.parametrize("seed", [0, -123456789, 2 ** 31 - 1])
def test_point_jitter_matches_rray_tpu(seed):
    pts = _points(np.float32)
    want = np.asarray(jax_jitter.point_jitter(
        jnp.int32(seed), *(jnp.asarray(c) for c in pts), 25))
    got = jitter.point_jitter(seed, *(torch.from_numpy(c) for c in pts), 25)
    assert got.dtype == torch.float32 and got.shape == (2, 25, 4096)
    np.testing.assert_array_equal(got.numpy(), want)
    base = np.asarray(jax_jitter.point_base(
        jnp.int32(seed), *(jnp.asarray(c) for c in pts)))
    np.testing.assert_array_equal(
        jitter.point_base(seed, *(torch.from_numpy(c) for c in pts)).numpy(),
        base.view(np.uint32))


def test_float64_points_hash_their_float32_bits():
    """rray_tpu hashes the float32 cast of a float64 point; draws come
    back in the asked dtype with the same values."""
    pts = _points(np.float64)
    want = np.asarray(jax_jitter.point_jitter(
        jnp.int32(5), *(jnp.asarray(c.astype(np.float32)) for c in pts), 4))
    got = jitter.point_jitter(5, *(torch.from_numpy(c) for c in pts), 4,
                              dtype=torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float64))
