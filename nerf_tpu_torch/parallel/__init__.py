"""Several devices: the rank mesh, data parallelism and multi-scene
training (``nerf_tpu.parallel``'s counterparts)."""
