"""Fused Gaussian projection: world -> view -> NDC -> screen, EWA cov2d, SH color.

Counterpart of the reference's fused projection kernel
(slang/gaussian_projection_kernels.slang:36-173 and
slang/gaussian_projection_screen_shared.slang:53-383).  Written as plain
vectorized JAX: it is a chain of tiny per-Gaussian contractions and
elementwise math that XLA fuses into a handful of loops — a hand-written
Pallas kernel buys nothing here.  Differentiable end-to-end with `jax.grad`;
`radii`/rects are consumed under stop_gradient by the binning stage, matching
the reference (GaussianRenderer.swift:629-630,863-865).

Semantics replicated exactly, including reference-specific quirks:
  * the +1e-6 guard on clip-space w (shared.slang:102);
  * visibility cull at view z >= 0.2 (projection_kernels.slang:63);
  * the EWA `t` clamp written as clamp(t_z, +-1.3*tan_fov) (shared.slang:202-205)
    — this deviates from INRIA (which clamps t_x/t_z) but is what the
    reference computes, so we match it for parity;
  * +0.3 low-pass on the cov2d diagonal (shared.slang:237-240);
  * SH evaluated on the *unnormalized* view direction (shared.slang:265-267);
  * radius = 3*ceil(sqrt(lambda_max)), lambda_max = mid + sqrt(max(mid^2-det, 1e-5))
    (shared.slang:375-382);
  * rect min clamped at 0, rect max clamped at W-1/H-1 only from above
    (projection_kernels.slang:158-172).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import sh as sh_utils
from ..utils import transforms


class ProjectionOutputs(NamedTuple):
    means2d: jax.Array  # [N, 2] pixel coordinates
    depths: jax.Array  # [N] view-space z
    colors: jax.Array  # [N, 3] SH-evaluated RGB (clamped at 0)
    cov2d: jax.Array  # [N, 4] (c00, c01, c10, c11)
    conic: jax.Array  # [N, 4] inverse cov2d, same layout
    radii: jax.Array  # [N] screen-space radius (0 when culled)
    rect_min: jax.Array  # [N, 2]
    rect_max: jax.Array  # [N, 2]


def project_gaussians(
    means3d: jax.Array,
    scales: jax.Array,
    quats: jax.Array,
    shs: jax.Array,
    view: jax.Array,
    proj: jax.Array,
    camera_center: jax.Array,
    fov_x: jax.Array,
    fov_y: jax.Array,
    focal_x: jax.Array,
    focal_y: jax.Array,
    image_width: int,
    image_height: int,
    sh_degree: int,
    *,
    z_cull: float = 0.2,
    ndc_w_eps: float = 1e-6,
    tanfov_clip: float = 1.3,
    cov2d_dilation: float = 0.3,
    radius_eigen_eps: float = 1e-5,
    quat_norm_eps: float = 1e-8,
    active: jax.Array | None = None,
) -> ProjectionOutputs:
    """Project N Gaussians through one camera.

    Args:
      means3d: [N, 3] world positions.
      scales: [N, 3] *activated* (exp'd) scales.
      quats: [N, 4] raw w-first quaternions (normalized internally).
      shs: [N, K, 3] SH coefficients, K >= (sh_degree+1)^2.
      view: [4, 4] row-vector world-view transform (w2c^T).
      proj: [4, 4] row-vector projection (P^T).
      camera_center: [3].
      image_width/height: static ints.
      sh_degree: static int.
    """
    n = means3d.shape[0]
    w = jnp.float32(image_width)
    h = jnp.float32(image_height)

    # --- NDC projection (row-vector convention) -----------------------------
    p_hom = transforms.homogeneous(means3d)  # [N, 4]
    # Full-f32 matmuls: default precision may run reduced-precision passes
    # (TF32 on a GPU), which costs ~3 decimal digits on world/clip positions.
    hp = jax.lax.Precision.HIGHEST
    p_view = jnp.matmul(p_hom, view, precision=hp)  # [N, 4]
    p_clip = jnp.matmul(p_view, proj, precision=hp)  # [N, 4]
    depths = p_view[:, 2]
    visible = depths >= z_cull
    if active is not None:
        # Inactive capacity slots are culled exactly like behind-camera rows:
        # radius 0, so they never enter binning or consume the pair budget.
        # (Their composited contribution is already zero via the masked
        # opacity, so this changes no rendered pixel or gradient — it stops
        # padding slots with default exp(0)=1 scales from flooding the tile
        # expansion and triggering bogus overflow auto-growth.)
        visible = jnp.logical_and(visible, active > 0)
    # Culled gaussians never render (radii forced to 0 below), but their
    # inf/NaN intermediates would still poison THEIR OWN parameter gradients
    # through 0-cotangent * inf = NaN in the VJP.  Substituting a safe
    # denominator for culled rows changes nothing visible and keeps autodiff
    # finite everywhere.  (Latent hazard in the reference too: it divides by
    # w and t_z unconditionally, gaussian_projection_screen_shared.slang:102,
    # 208-211.)
    w_den = jnp.where(visible, p_clip[:, 3] + ndc_w_eps, 1.0)
    w_inv = 1.0 / w_den
    ndc = p_clip * w_inv[:, None]

    # NDC -> pixel: ((ndc + 1) * size - 1) / 2 (shared.slang:110-115)
    mean_x = ((ndc[:, 0] + 1.0) * w - 1.0) * 0.5
    mean_y = ((ndc[:, 1] + 1.0) * h - 1.0) * 0.5
    means2d = jnp.stack([mean_x, mean_y], axis=-1)

    # --- cov3d from scale/rotation ------------------------------------------
    cov3d = transforms.build_cov3d(scales, quats, quat_norm_eps)  # [N, 3, 3]

    # --- EWA cov2d ----------------------------------------------------------
    # `view` is w2c^T: rows 0..2 of its 3x3 block are a_ij in the kernel;
    # t = m @ a + view[3, :3] is the camera-space position.
    a = view[:3, :3]
    t = jnp.matmul(means3d, a, precision=hp) + view[3, :3]  # [N, 3]
    t0, t1 = t[:, 0], t[:, 1]
    # Same culled-row sanitization as above: t_z -> 1 keeps the EWA Jacobian
    # finite for gaussians that never render.
    t2 = jnp.where(visible, t[:, 2], 1.0)

    tan_fov_x = jnp.tan(fov_x * 0.5)
    tan_fov_y = jnp.tan(fov_y * 0.5)
    # Reference formulation (shared.slang:202-207): the clamp is applied to
    # t_z, then t_x' = t_x / clamp(t_z) * t_z.
    clip_x = jnp.clip(t2, -tan_fov_x * tanfov_clip, tan_fov_x * tanfov_clip)
    clip_y = jnp.clip(t2, -tan_fov_y * tanfov_clip, tan_fov_y * tanfov_clip)
    tx = t0 / clip_x * t2
    ty = t1 / clip_y * t2
    tz = t2

    j00 = focal_x / tz
    j02 = -tx * focal_x / (tz * tz)
    j11 = focal_y / tz
    j12 = -ty * focal_y / (tz * tz)

    # W = a^T (rotation part of w2c); B = J @ W, rows b0, b1.
    W = a.T
    b0 = j00[:, None] * W[0][None, :] + j02[:, None] * W[2][None, :]  # [N, 3]
    b1 = j11[:, None] * W[1][None, :] + j12[:, None] * W[2][None, :]

    # cov2d = B cov3d B^T + dilation * I
    c3b0 = jnp.einsum("nij,nj->ni", cov3d, b0, precision=hp)
    c3b1 = jnp.einsum("nij,nj->ni", cov3d, b1, precision=hp)
    c00 = jnp.sum(b0 * c3b0, axis=-1) + cov2d_dilation
    c01 = jnp.sum(b0 * c3b1, axis=-1)
    c10 = jnp.sum(b1 * c3b0, axis=-1)
    c11 = jnp.sum(b1 * c3b1, axis=-1) + cov2d_dilation
    cov2d = jnp.stack([c00, c01, c10, c11], axis=-1)

    det = c00 * c11 - c01 * c10
    # Visible gaussians have det >= dilation^2 > 0 (cov2d is PSD + 0.3 I);
    # the guard only protects culled rows' gradients from 0 * inf = NaN.
    det = jnp.where(jnp.logical_and(visible, det > 1e-12), det, 1.0)
    conic = jnp.stack([c11 / det, -c01 / det, -c10 / det, c00 / det], axis=-1)

    # --- SH color -----------------------------------------------------------
    dirs = means3d - camera_center[None, :]  # unnormalized, by design
    colors = sh_utils.sh_to_color(sh_degree, shs, dirs)

    # --- radius and screen rect (stop-grad consumers) -----------------------
    mid = 0.5 * (c00 + c11)
    lambda_max = mid + jnp.sqrt(jnp.maximum(mid * mid - det, radius_eigen_eps))
    radius = 3.0 * jnp.ceil(jnp.sqrt(lambda_max))
    radii = jnp.where(visible, radius, 0.0)

    min_x = jnp.maximum(mean_x - radii, 0.0)
    min_y = jnp.maximum(mean_y - radii, 0.0)
    max_x = jnp.minimum(mean_x + radii, w - 1.0)
    max_y = jnp.minimum(mean_y + radii, h - 1.0)
    rect_min = jnp.stack([min_x, min_y], axis=-1)
    rect_max = jnp.stack([max_x, max_y], axis=-1)

    return ProjectionOutputs(
        means2d=means2d,
        depths=depths,
        colors=colors,
        cov2d=cov2d,
        conic=conic,
        radii=jax.lax.stop_gradient(radii),
        rect_min=jax.lax.stop_gradient(rect_min),
        rect_max=jax.lax.stop_gradient(rect_max),
    )
