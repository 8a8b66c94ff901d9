"""SSIM with an 11x11 Gaussian window via depthwise convolution.

Same formulation as both reference paths: the fused Slang kernel
(slang/ssim_kernels.slang:22-155, C1=1e-4, C2=9e-4, zero-padded boundary) and
the MLX conv fallback (Trainer/SsimUtils.swift:17-50).  XLA lowers the
depthwise 11x11 conv and its conv-transpose gradient itself, so this stays
plain JAX and fully differentiable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=8)
def gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    """1D Gaussian taps, normalized (Trainer/LossUtil.swift:47-54)."""
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _depthwise_conv(img, window_size: int, sigma: float):
    """Zero-padded separable depthwise blur.  img: [H, W, C]."""
    c = img.shape[-1]
    g = gaussian_window(window_size, sigma)
    pad = window_size // 2
    x = img[None]  # NHWC
    kh = jnp.asarray(g).reshape(window_size, 1, 1, 1)
    kh = jnp.broadcast_to(kh, (window_size, 1, 1, c))
    kw = jnp.asarray(g).reshape(1, window_size, 1, 1)
    kw = jnp.broadcast_to(kw, (1, window_size, 1, c))
    dn = jax.lax.conv_dimension_numbers(x.shape, kh.shape, ("NHWC", "HWIO", "NHWC"))
    # Full-f32 convs: reduced-precision conv passes (bf16, TF32) make the
    # variance estimates noisy relative to C2=9e-4, which can push SSIM well
    # above 1 (observed ~1.15 -> negative training loss).
    x = jax.lax.conv_general_dilated(
        x, kh, (1, 1), [(pad, pad), (0, 0)], dimension_numbers=dn,
        feature_group_count=c, precision=jax.lax.Precision.HIGHEST,
    )
    x = jax.lax.conv_general_dilated(
        x, kw, (1, 1), [(0, 0), (pad, pad)], dimension_numbers=dn,
        feature_group_count=c, precision=jax.lax.Precision.HIGHEST,
    )
    return x[0]


def ssim_map(
    img1,
    img2,
    window_size: int = 11,
    sigma: float = 1.5,
    c1: float = 0.01**2,
    c2: float = 0.03**2,
):
    """Per-pixel SSIM map for [H, W, C] images in [0, 1]."""
    conv = lambda x: _depthwise_conv(x, window_size, sigma)
    mu1 = conv(img1)
    mu2 = conv(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2
    num = (2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)
    den = (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    return num / den


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """Mean SSIM (SsimUtils.swift:17-50)."""
    return jnp.mean(ssim_map(img1, img2, window_size, sigma))
