"""End-to-end differentiable render: projection -> binning -> rasterize.

Counterpart of GaussianRenderer.forward / forwardWithCameraParams
(Trainer/GaussianRenderer.swift:769-934), as one jit-friendly function.
Also serves as the inference renderer (the reference ships a separate
Metal viewer, Metal/MetalGaussianRenderer.swift; here the training
rasterizer jitted without gradients is the viewer backend).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import RasterizerConfig
from .ops import binning as binning_mod
from .ops import projection, rasterize_ref, tile_raster
from .ops.rasterize_ref import RenderOutputs


class RenderAux(NamedTuple):
    radii: jax.Array  # [N] screen radii (0 = culled)
    num_pairs: jax.Array  # [] pairs binned
    overflow_gaussians: jax.Array
    overflow_pairs: jax.Array
    means2d: jax.Array  # [N, 2] (for positional-gradient densification stats)
    tile_depth_mean: jax.Array  # [] mean pairs per tile (workload honesty)
    tile_depth_max: jax.Array  # [] max pairs in any tile


BACKENDS = ("triton", "triton_interpret", "reference")


def resolve_backend(backend: str, platform: str | None = None) -> str:
    """Rasterizer for a backend name.  "auto" is the compiled kernel on a
    GPU and an error anywhere else: the O(H*W*P) reference and the kernel's
    interpret mode run only where a caller names them."""
    if backend in BACKENDS:
        return backend
    if backend != "auto":
        raise ValueError(
            f"unknown rasterizer backend {backend!r}; expected 'auto' or one "
            f"of {BACKENDS}"
        )
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "triton"
    raise RuntimeError(
        f"rasterizer backend 'auto' needs a GPU, but JAX runs on "
        f"{platform!r}; name a backend ('reference' or 'triton_interpret') "
        "to render there"
    )


def render(
    means3d: jax.Array,
    shs: jax.Array,
    opacity: jax.Array,
    scales: jax.Array,
    rotations: jax.Array,
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
    raster_cfg: RasterizerConfig = RasterizerConfig(),
    white_background: bool = False,
    backend: str | None = None,
    pixel_y_offset=None,
    full_image_height: int | None = None,
    active: jax.Array | None = None,
):
    """Render one view.  All array args may be traced; shapes/ints static.

    For pixel-band sharding (parallel/sharding.py), `image_height` is the
    band height, `full_image_height` the camera's full image height, and
    `pixel_y_offset` the band's first row: the camera projection uses the
    full image while binning/rasterization run in band-local coordinates.

    Returns (RenderOutputs with background applied to color, RenderAux).
    """
    cfg = raster_cfg
    backend = resolve_backend(backend if backend is not None else cfg.backend)
    proj_height = full_image_height if full_image_height is not None else image_height

    p = projection.project_gaussians(
        means3d,
        scales,
        rotations,
        shs,
        view,
        proj,
        camera_center,
        fov_x,
        fov_y,
        focal_x,
        focal_y,
        image_width,
        proj_height,
        sh_degree,
        z_cull=cfg.z_cull,
        ndc_w_eps=cfg.ndc_w_eps,
        tanfov_clip=cfg.tanfov_clip,
        cov2d_dilation=cfg.cov2d_dilation,
        radius_eigen_eps=cfg.radius_eigen_eps,
        quat_norm_eps=cfg.quat_norm_eps,
        active=active,
    )

    means2d = p.means2d
    rect_min, rect_max = p.rect_min, p.rect_max
    if pixel_y_offset is not None:
        # Shift to band-local pixel coordinates and re-clip the y rects to
        # the band window (x rects keep the full-image clamps).
        offs = jnp.asarray(pixel_y_offset, means2d.dtype)
        means2d = means2d - jnp.stack([jnp.zeros_like(offs), offs])
        y_band = jax.lax.stop_gradient(means2d[:, 1])
        rect_min = jnp.stack(
            [rect_min[:, 0], jnp.maximum(y_band - p.radii, 0.0)], axis=-1
        )
        rect_max = jnp.stack(
            [rect_max[:, 0], jnp.minimum(y_band + p.radii, image_height - 1.0)],
            axis=-1,
        )

    packed = rasterize_ref.pack_gaussians(
        means2d, p.conic, p.colors, opacity, p.depths
    )
    b = binning_mod.bin_gaussians(
        rect_min,
        rect_max,
        p.radii,
        p.depths,
        image_width,
        image_height,
        cfg.tile_w,
        cfg.tile_h,
        cfg.max_pairs,
    )

    if backend == "reference":
        out = rasterize_ref.rasterize_reference(
            packed,
            b.sorted_gauss_idx,
            b.sorted_tile_id,
            image_width,
            image_height,
            cfg.tile_w,
            cfg.tile_h,
            alpha_clamp=cfg.alpha_clamp,
            transmittance_eps=cfg.transmittance_eps,
        )
    else:
        out = tile_raster.rasterize_tiles(
            packed,
            b.sorted_gauss_idx,
            b.pair_valid,
            b.tile_start,
            b.tile_count,
            image_width,
            image_height,
            cfg.tile_w,
            cfg.tile_h,
            chunk_size=cfg.chunk_size,
            alpha_clamp=cfg.alpha_clamp,
            transmittance_eps=cfg.transmittance_eps,
            undo_denom_floor=cfg.undo_denom_floor,
            interpret=backend == "triton_interpret",
        )

    color = rasterize_ref.apply_background(out.color, out.alpha, white_background)
    out = RenderOutputs(
        color=color, depth=out.depth, alpha=out.alpha, n_contrib=out.n_contrib
    )
    aux = RenderAux(
        radii=p.radii,
        num_pairs=b.num_pairs,
        overflow_gaussians=b.overflow_gaussians,
        overflow_pairs=b.overflow_pairs,
        means2d=p.means2d,
        tile_depth_mean=jnp.mean(b.tile_count.astype(jnp.float32)),
        tile_depth_max=jnp.max(b.tile_count),
    )
    return out, aux


def render_many(
    means3d: jax.Array,
    shs: jax.Array,
    opacity: jax.Array,
    scales: jax.Array,
    rotations: jax.Array,
    views: jax.Array,  # [B, 4, 4]
    projs: jax.Array,  # [B, 4, 4]
    camera_centers: jax.Array,  # [B, 3]
    fov_xs: jax.Array,  # [B]
    fov_ys: jax.Array,  # [B]
    focal_xs: jax.Array,  # [B]
    focal_ys: jax.Array,  # [B]
    image_width: int,
    image_height: int,
    sh_degree: int,
    raster_cfg: RasterizerConfig = RasterizerConfig(),
    white_background: bool = False,
    backend: str | None = None,
):
    """Render a BATCH of cameras of one model in a single traced graph.

    `lax.map` over the stacked camera tensors: the render body compiles once
    and runs sequentially on-device, so a frame sequence (orbit video,
    multi-view eval, a batch of poses) costs one dispatch instead of B.  The
    reference viewer's frame loop never leaves the GPU
    (Metal/MetalGaussianRenderer.swift:262-299); this is the jit-side
    counterpart.

    Returns (colors [B,H,W,3], depths [B,H,W], num_pairs [B],
    overflow_pairs [B]).
    """

    def body(cam):
        view, proj, center, fx, fy, fovx, fovy = cam
        out, aux = render(
            means3d, shs, opacity, scales, rotations,
            view, proj, center, fovx, fovy, fx, fy,
            image_width, image_height, sh_degree,
            raster_cfg=raster_cfg,
            white_background=white_background,
            backend=backend,
        )
        return out.color, out.depth, aux.num_pairs, aux.overflow_pairs

    return jax.lax.map(
        body,
        (views, projs, camera_centers, focal_xs, focal_ys, fov_xs, fov_ys),
    )
