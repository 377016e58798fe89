"""Stage d of the whitted kernel: the port's plain version with its
in-kernel mesh against rray_tpu's Pallas kernel (interpret mode) on a
36-triangle mesh over a checker floor, depth 0, in float32, under
tests/torch_parity.py's budget (>= 98% of rays within 2e-6 and >= 99.9%
within 1e-4: the specular-highlight ulps of XLA:CPU's compiled code;
measured 99.9% within 2e-6 and every ray within 1e-4). The depth-1
reflection chain is test_torch_mesh_whitted_chain.py (a file of its own
so that the two interpret-mode compiles run on two test workers)."""
from torch_mesh_parity import check_mesh_kernel_parity


def test_mesh_depth0_matches_pallas_kernel(tmp_path):
    check_mesh_kernel_parity(tmp_path, reflective=0.0, depth=0)
