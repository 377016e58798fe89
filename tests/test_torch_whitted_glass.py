"""The compact wavefront (W=4 path rows per pixel, 2W children, stable
top-W) of rray_tpu_torch's plain version against rray_tpu's Pallas
kernel in interpret mode, on glass.yaml. Depth is cut from 5 to 2 to
keep this file's interpret-mode compile near 45 s on a CPU; at depth 2
the levels already hold 1, 2 and 4 live paths, so the 2W-row sort runs
on every level. Depth 5 with path drops is held against rray_tpu's XLA
compact scan in float64 (test_torch_whitted_xla.py) and against the
CUDA kernel on the card (chip_smoke.py)."""
import torch_parity as tp


def test_glass_compact_wavefront_matches_pallas_kernel():
    jscene, tscene = tp.scenes(tp.GLASS, "float32")
    o, d = tp.seeded_rays()
    port, shape = tp.port_render_rays(tscene, o, d, depth=2)
    assert shape == (2, 4)
    tp.assert_f32_budget(port, tp.jax_kernel_rays(jscene, o, d, *shape))
