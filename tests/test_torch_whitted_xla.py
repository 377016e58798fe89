"""rray_tpu_torch's plain whitted version in float64 against rray_tpu's
kernel-free XLA node (`_xla_reference_node`, pallas off): the compact
scan for glass, the fast path for example1 and for the reflection-only
chain, and at W=32 (every path kept) the exhaustive level scan. The two
packages evaluate the same formulas on the same tables; only summation
order differs (per-pixel path sums), so atol 1e-9."""
import numpy as np
import pytest

import torch_parity as tp

CASES = [("glass", tp.GLASS, False, {}),
         ("example1", tp.EXAMPLE1, False, {}),
         ("reflection_chain", tp.GLASS, True, {})]


@pytest.mark.parametrize("name,path,refl_only,settings", CASES,
                         ids=[c[0] for c in CASES])
def test_f64_matches_xla_node(name, path, refl_only, settings):
    jscene, tscene = tp.scenes(path, "float64", reflection_only=refl_only)
    o, d = tp.seeded_rays(np.float64)
    port, _ = tp.port_render_rays(tscene, o, d)
    ref = tp.jax_xla_rays(jscene, o, d, **settings)
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-9)


def test_full_capacity_equals_exhaustive_scan():
    """W = 2^5 = 32 keeps every path, so it equals the exhaustive scan.
    Float64 (not float32 as in test_wavefront.py): across two libraries
    float32 differs by the specular-highlight ulps that torch_parity's
    f32 budget describes, which would hide a dropped path."""
    jscene, tscene = tp.scenes(tp.GLASS, "float64")
    o, d = tp.seeded_rays(np.float64)
    port, shape = tp.port_render_rays(tscene, o, d, cap=32)
    assert shape == (5, 32)
    ref = tp.jax_xla_rays(jscene, o, d, wavefront="scan")
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-9)
