"""rtbench: the benchmark of rray_tpu_torch (see README.md)."""
