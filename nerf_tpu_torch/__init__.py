"""nerf_tpu_torch: the PyTorch/CUDA port of ``nerf_tpu``.

A package of its own beside the JAX package, which stays the reference and
which this package never imports. Module paths mirror ``nerf_tpu`` so each
counterpart is easy to find. Plain tensor code is PyTorch; each Pallas TPU
kernel on a ported path becomes a CUDA kernel written for Hopper (sm_90a),
built from ``csrc/`` at first use. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``, where every kernel's plain PyTorch version
runs instead.
"""

from nerf_tpu_torch.version import __version__

__all__ = ["__version__"]
