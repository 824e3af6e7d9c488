"""Quality metrics, as ``nerf_tpu.utils.metrics``: ``mse_to_psnr`` is the
reference formula ``20 * log10(1 / sqrt(mse))``, i.e. ``-10 * log10(mse)``,
on Python floats and NumPy arrays; ``ssim`` is the mean structural
similarity of Wang et al. 2004, host-side in NumPy."""

from __future__ import annotations

import numpy as np


def mse_to_psnr(mse):
    return 20.0 * np.log10(1.0 / np.sqrt(mse))


def _gauss(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def _filt(x: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The separable valid-mode convolution of ``x`` with ``k`` along its
    first two axes: one shifted, weighted add per tap (``np.convolve``'s
    values, whole slices at a time)."""
    n = k.size
    m = x.shape[0] - n + 1
    y = k[n - 1] * x[:m]
    for j in range(1, n):
        y += k[n - 1 - j] * x[j:j + m]
    m = x.shape[1] - n + 1
    z = k[n - 1] * y[:, :m]
    for j in range(1, n):
        z += k[n - 1 - j] * y[:, j:j + m]
    return z


def ssim(a, b, max_val: float = 1.0) -> float:
    """Mean structural similarity of two (H, W, C) or (H, W) images in
    [0, max_val]: 11x11 Gaussian window (sigma 1.5), k1 = 0.01, k2 = 0.03,
    valid-mode windows, in float64 (nerf_tpu's formulation)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = _gauss()
    mu_a, mu_b = _filt(a, k), _filt(b, k)
    var_a = _filt(a * a, k) - mu_a * mu_a
    var_b = _filt(b * b, k) - mu_b * mu_b
    cov = _filt(a * b, k) - mu_a * mu_b
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return float(s.mean())
