"""Quality metrics, as ``nerf_tpu.utils.metrics``: ``mse_to_psnr`` is the
reference formula ``20 * log10(1 / sqrt(mse))``, i.e. ``-10 * log10(mse)``,
on Python floats and NumPy arrays."""

from __future__ import annotations

import numpy as np


def mse_to_psnr(mse):
    return 20.0 * np.log10(1.0 / np.sqrt(mse))
