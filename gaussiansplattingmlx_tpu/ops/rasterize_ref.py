"""Pure-JAX oracle rasterizer (differentiable, CPU-runnable).

Reference semantics: per-pixel front-to-back alpha compositing over the
pixel's tile list in depth order (slang/gaussian_tile_global_kernels.slang:
406-614).  This oracle is the ground truth for the tile kernel
(ops/tile_raster.py): identical math, identical early-exit rule,
differentiable with plain `jax.grad` (it is the "TinyTests synthetic scene"
harness SURVEY §4 calls for, which the reference never had).  Its one
product asks for full float32, so it stays exact where a GPU would run
default-precision f32 products in TF32.

Key identity used here and in the tile kernel: the serial march

    contrib_i = T_i * alpha_i ;  T_{i+1} = T_i * (1 - alpha_i) ;
    break when T_{i+1} < 1e-4

is equivalent to the vector form

    Tu_i = exclusive_cumprod(1 - alpha)_i          (transmittance before i)
    m_i  = Tu_i >= 1e-4                            (include mask, monotone)
    w_i  = Tu_i * alpha_i * m_i                    (per-sample weight)
    out  = sum_i w_i * attr_i ;  T_final = prod_i (1 - alpha_i * m_i)

because factors after the crossing can only shrink Tu, so the mask computed
from the *unmasked* cumulative product agrees with the serial break exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Packed per-Gaussian render record layout, mirroring buildPackedGaussians
# (GaussianRenderer.swift:45-51,85-99):
#   [0:2] mean2d, [2:6] conic (c00, c01, c10, c11), [6:9] color,
#   [9] opacity, [10] depth
PACKED_DIM = 11


def pack_gaussians(means2d, conic, colors, opacity, depths):
    """[N,2],[N,4],[N,3],[N,1],[N] -> [N,11]."""
    return jnp.concatenate(
        [means2d, conic, colors, opacity.reshape(-1, 1), depths.reshape(-1, 1)],
        axis=-1,
    )


def unpack_gradients(grad_packed):
    """[N,11] cotangent -> per-leaf cotangents (means2d, conic, colors,
    opacity[N,1], depths[N])."""
    return (
        grad_packed[:, 0:2],
        grad_packed[:, 2:6],
        grad_packed[:, 6:9],
        grad_packed[:, 9:10],
        grad_packed[:, 10],
    )


class RenderOutputs(NamedTuple):
    color: jax.Array  # [H, W, 3] accumulated color (background NOT applied)
    depth: jax.Array  # [H, W]
    alpha: jax.Array  # [H, W] = 1 - final transmittance
    n_contrib: jax.Array  # [H, W] int32 samples composited per pixel


def sample_alpha(px, py, mean_x, mean_y, c00, c01, c10, c11, opacity, alpha_clamp=0.99):
    """Gaussian falloff alpha, clamped like tileGlobalAlphaFromGaussian
    (tile_global_kernels.slang:438-456).  Clamp grad is zero above 0.99."""
    dx = px - mean_x
    dy = py - mean_y
    e = -0.5 * (dx * dx * c00 + dy * dy * c11 + dx * dy * (c01 + c10))
    raw = jnp.exp(e) * opacity
    return jnp.minimum(raw, alpha_clamp)


def rasterize_reference(
    packed: jax.Array,
    sorted_gauss_idx: jax.Array,
    sorted_tile_id: jax.Array,
    image_width: int,
    image_height: int,
    tile_w: int,
    tile_h: int,
    *,
    alpha_clamp: float = 0.99,
    transmittance_eps: float = 1e-4,
    row_chunk: int = 8,
) -> RenderOutputs:
    """Rasterize via the per-pixel vector identity over the full sorted pair
    list (each pixel masks pairs of its own tile).  O(H*W*max_pairs) — meant
    for oracle-scale scenes, not production."""
    grid_w = -(-image_width // tile_w)

    records = packed[sorted_gauss_idx]  # [P, 11]
    mean_x, mean_y = records[:, 0], records[:, 1]
    c00, c01, c10, c11 = records[:, 2], records[:, 3], records[:, 4], records[:, 5]
    col = records[:, 6:9]
    opa = records[:, 9]
    dep = records[:, 10]

    def pixel(py, px):
        tile = (py.astype(jnp.int32) // tile_h) * grid_w + (
            px.astype(jnp.int32) // tile_w
        )
        in_tile = sorted_tile_id == tile
        a = sample_alpha(
            px.astype(jnp.float32),
            py.astype(jnp.float32),
            mean_x,
            mean_y,
            c00,
            c01,
            c11=c11,
            c10=c10,
            opacity=opa,
            alpha_clamp=alpha_clamp,
        )
        a = jnp.where(in_tile, a, 0.0)
        one_minus = 1.0 - a
        tu = jnp.concatenate([jnp.ones((1,), a.dtype), jnp.cumprod(one_minus)[:-1]])
        m = (tu >= transmittance_eps) & in_tile
        w = tu * a * jnp.where(m, 1.0, 0.0)
        color = jnp.matmul(w, col, precision=jax.lax.Precision.HIGHEST)
        depth = jnp.sum(w * dep)
        t_final = jnp.prod(1.0 - a * jnp.where(m, 1.0, 0.0))
        n_contrib = jnp.sum(m.astype(jnp.int32))
        return color, depth, 1.0 - t_final, n_contrib

    xs = jnp.arange(image_width)
    row_fn = jax.vmap(jax.vmap(pixel, in_axes=(None, 0)), in_axes=(0, None))

    ys = jnp.arange(image_height)
    n_chunks = -(-image_height // row_chunk)
    pad_rows = n_chunks * row_chunk - image_height
    ys_p = jnp.pad(ys, (0, pad_rows)).reshape(n_chunks, row_chunk)
    # Rematerialised per row chunk: the backward keeps one chunk's
    # [row_chunk, W, max_pairs] intermediates alive at a time, not all rows'.
    color, depth, alpha, n_contrib = jax.lax.map(
        jax.checkpoint(lambda yy: row_fn(yy, xs)), ys_p
    )
    reshape = lambda v: v.reshape((n_chunks * row_chunk,) + v.shape[2:])[:image_height]
    return RenderOutputs(
        color=reshape(color),
        depth=reshape(depth),
        alpha=reshape(alpha),
        n_contrib=reshape(n_contrib),
    )


def apply_background(color, alpha, white_background: bool):
    """Background compositing, moved outside the kernel (differentiable XLA
    add).  Matches tile_global_kernels.slang:606-610: white adds the final
    transmittance to every channel."""
    if white_background:
        return color + (1.0 - alpha)[..., None]
    return color
