"""Stage d along the width-1 reflection chain: the mesh fold replayed
per level over a reflective floor, depth 1, against rray_tpu's Pallas
kernel in interpret mode (see test_torch_mesh_whitted.py for the budget;
measured 99.9% of rays within 2e-6, every ray within 1e-4)."""
from torch_mesh_parity import check_mesh_kernel_parity


def test_mesh_reflection_chain_matches_pallas_kernel(tmp_path):
    check_mesh_kernel_parity(tmp_path, reflective=0.3, depth=1)
