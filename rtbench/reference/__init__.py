"""The plain reference of rtbench: frozen copies of the port's scene
loader, scene compiler, camera and per-ray (AoS) path (plain torch ops,
no kernel), and `whitted.py`, the level-synchronous Whitted tree over
them with the configurations' wavefront capacity. It imports nothing of
rray_tpu_torch, rray_tpu or JAX."""
