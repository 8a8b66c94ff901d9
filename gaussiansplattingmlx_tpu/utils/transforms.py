"""Small differentiable math utilities.

Counterparts of Trainer/GaussianSplattingMlxUtil.swift:55-144 plus the
quaternion/covariance builders from the projection kernel
(gaussian_projection_screen_shared.slang:118-168).  Quaternions are w-first
and unnormalized in parameter space.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def inverse_sigmoid(x):
    """GaussianSplattingMlxUtil.swift:55-57."""
    return jnp.log(x / (1.0 - x))


def homogeneous(points):
    """[..., 3] -> [..., 4] with trailing 1 (GaussianSplattingMlxUtil.swift:59-64)."""
    return jnp.concatenate([points, jnp.ones_like(points[..., :1])], axis=-1)


def normalize_quaternion(quat, eps: float = 1e-8):
    """Row-normalize w-first quaternions.

    The reference guards with max(norm, 1e-8) (shared.slang:130-135); we use
    the smooth sqrt(|q|^2 + eps^2) form, identical to float precision for any
    real quaternion but with a finite gradient at q = 0 (max(sqrt(0), eps)
    back-propagates 0/0 = NaN through the sqrt even when the cotangent is
    zero)."""
    norm = jnp.sqrt(jnp.sum(quat * quat, axis=-1, keepdims=True) + eps * eps)
    return quat / norm


def quat_to_rotmat(quat, eps: float = 1e-8):
    """Unnormalized w-first quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    q = normalize_quaternion(quat, eps)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return jnp.stack(
        [
            jnp.stack([r00, r01, r02], axis=-1),
            jnp.stack([r10, r11, r12], axis=-1),
            jnp.stack([r20, r21, r22], axis=-1),
        ],
        axis=-2,
    )


def build_scaling_rotation(scales, quat, eps: float = 1e-8):
    """L = R @ diag(s): [..., 3, 3] (GaussianSplattingMlxUtil.swift:97-106)."""
    R = quat_to_rotmat(quat, eps)
    return R * scales[..., None, :]


def build_cov3d(scales, quat, eps: float = 1e-8):
    """Sigma = L @ L^T from activated scales and raw quaternion.

    Matches buildCov3dFromScaleRotation (shared.slang:118-168).
    Returns the full symmetric [..., 3, 3].  Full float32 (a GPU runs
    default-precision f32 products in TF32, ~3 decimal digits)."""
    L = build_scaling_rotation(scales, quat, eps)
    return jnp.matmul(L, jnp.swapaxes(L, -1, -2),
                      precision=jax.lax.Precision.HIGHEST)


def strip_lowerdiag(cov):
    """Symmetric [..., 3, 3] -> 6-vector (xx, xy, xz, yy, yz, zz)
    (GaussianSplattingMlxUtil.swift:108-118)."""
    return jnp.stack(
        [
            cov[..., 0, 0],
            cov[..., 0, 1],
            cov[..., 0, 2],
            cov[..., 1, 1],
            cov[..., 1, 2],
            cov[..., 2, 2],
        ],
        axis=-1,
    )


def inv3x3(m):
    """Cofactor 3x3 inverse (PointCloudUtil.swift:13-48)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return inv / det[..., None, None]


def mask_to_indices(mask, fill_value: int = -1):
    """Boolean mask -> (indices padded with fill_value, count).

    Static-shape counterpart of the reference's atomic conditionToIndices
    Metal kernel (GaussianSplattingMlxUtil.swift:9-53): the output has the
    mask's length with valid indices compacted to the front, so it jits
    (dynamic-size nonzero cannot).
    """
    mask = mask.reshape(-1)
    n = mask.shape[0]
    count = jnp.sum(mask.astype(jnp.int32))
    order = jnp.argsort(~mask, stable=True)  # True entries first, stable
    idx = jnp.where(jnp.arange(n) < count, order, fill_value)
    return idx, count
