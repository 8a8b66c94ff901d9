"""Static-shape tile binning: exact (gaussian, tile) pair expansion + sort.

Replaces the reference's five-kernel dynamic pipeline
(count_tiles_per_gaussian / generate_keys / radix_sort / compute_tile_ranges /
build_packed_tile_indices, slang/gaussian_tile_global_kernels.slang:8-404)
whose two `.item()` host syncs (GaussianRenderer.swift:398-409,462) are
impossible under `jax.jit`.  The static-shape design:

  1. Per-Gaussian tile footprint from the screen rect — identical tile index
     math to count_tiles_per_gaussian (floor(min/tile) .. floor(max/tile)+1,
     clamped to the grid).  Footprints are EXACT — there is no per-gaussian
     cap; the reference never truncates a footprint and neither do we.
  2. Exact duplication onto a static pair axis: an inclusive cumsum of
     footprints gives each gaussian a contiguous block of pair slots (the
     same gaussian-major emission order as the reference's generate_keys);
     a vectorized `searchsorted` maps every pair slot back to its owning
     gaussian, and the slot's offset inside the block enumerates the rect
     row-major.  This is the reference's prefix-sum + per-gaussian key
     emission re-expressed over a fixed [max_pairs] axis (no dynamic
     allocation, no scatter).
  3. One stable lexicographic `lax.sort` on (tile_id, depth) with the
     gaussian index as payload — sorting replaces the reference's
     hand-written single-threadgroup radix sort.  The pipeline is
     sort/gather-only (no scatter compaction).
  4. Per-tile (start, count) ranges via searchsorted — the analogue of
     compute_tile_ranges.

Overflow (total pairs > max_pairs) is counted and reported instead of
reallocating; the trainer doubles `max_pairs` at the next recompile boundary
(train/trainer.py:_maybe_grow_raster).  Everything here is integer/stop-grad
— gradients never flow through binning, matching the reference's
stopGradient tile-slice builder (GaussianRenderer.swift:333-490).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Cumulative pair counts saturate at this value.  The clamp must be applied
# INSIDE the scan (a clamped-add associative_scan), not after a plain cumsum:
# at flagship pathology (1M gaussians x full-screen footprints) the true pair
# total exceeds 2^31 and a plain int32 cumsum wraps negative before any
# post-hoc clamp, breaking the monotonicity searchsorted needs.
# 2^30 - 1 keeps every partial sum a+b <= 2^31 - 2 inside int32; max_pairs is
# always far below the clamp, so ranks for real pair slots are exact.
_CUM_CLAMP = 2**30 - 1


def _saturating_cumsum(footprint: jax.Array) -> jax.Array:
    """Inclusive cumsum of nonneg int32 saturating at _CUM_CLAMP, wrap-free.

    min(a+b, C) over nonnegative ints is associative for sums that saturate
    (both associations yield exactly min(true_sum, C)), so the parallel scan
    computes the exact saturating prefix sum.
    """
    return jax.lax.associative_scan(
        lambda a, b: jnp.minimum(a + b, _CUM_CLAMP),
        jnp.minimum(footprint, _CUM_CLAMP),
    )


class TileBinning(NamedTuple):
    sorted_gauss_idx: jax.Array  # [max_pairs] gaussian id per pair (pad: 0)
    sorted_tile_id: jax.Array  # [max_pairs] tile id per pair (pad: num_tiles)
    tile_start: jax.Array  # [num_tiles] first pair index per tile
    tile_count: jax.Array  # [num_tiles] pairs per tile
    num_pairs: jax.Array  # [] total valid pairs (<= max_pairs)
    overflow_gaussians: jax.Array  # [] gaussians losing pairs to the budget
    overflow_pairs: jax.Array  # [] pairs dropped by the max_pairs budget
    pair_valid: jax.Array  # [max_pairs] bool


def _tile_bounds(rect_min, rect_max, tile_w, tile_h, grid_w, grid_h):
    """Tile index bounds, exactly as count_tiles_per_gaussian
    (tile_global_kernels.slang:44-55)."""
    tmin_x = jnp.floor(rect_min[:, 0] / tile_w).astype(jnp.int32)
    tmin_y = jnp.floor(rect_min[:, 1] / tile_h).astype(jnp.int32)
    tmax_x = jnp.floor(rect_max[:, 0] / tile_w).astype(jnp.int32) + 1
    tmax_y = jnp.floor(rect_max[:, 1] / tile_h).astype(jnp.int32) + 1
    tmin_x = jnp.clip(tmin_x, 0, grid_w)
    tmin_y = jnp.clip(tmin_y, 0, grid_h)
    tmax_x = jnp.clip(tmax_x, 0, grid_w)
    tmax_y = jnp.clip(tmax_y, 0, grid_h)
    return tmin_x, tmin_y, tmax_x, tmax_y


class PairExpansion(NamedTuple):
    """Pair-expansion state consumed by bin_gaussians."""

    rank: jax.Array  # [max_pairs] compacted rank per pair slot
    cum_keep: jax.Array  # [n] compacted inclusive cumsum (pad: clamp+1)
    keep_idx: jax.Array  # [n] compaction permutation (actives first)
    tmin_x: jax.Array  # [n]
    tmin_y: jax.Array  # [n]
    rw: jax.Array  # [n] rect width in tiles (>=1 where active)
    block_start: jax.Array  # [n] first pair slot of each gaussian's block
    num_pairs: jax.Array  # []
    overflow_gaussians: jax.Array  # []
    overflow_pairs: jax.Array  # []


def expand_pairs(
    rect_min: jax.Array,
    rect_max: jax.Array,
    radii: jax.Array,
    depths: jax.Array,
    image_width: int,
    image_height: int,
    tile_w: int,
    tile_h: int,
    max_pairs: int,
) -> PairExpansion:
    """Exact (gaussian, tile) pair expansion onto the static pair axis:
    footprints, saturating cumsum, compaction and the pair->gaussian merge.
    Integer/stop-grad only."""
    n = rect_min.shape[0]
    grid_w = -(-image_width // tile_w)
    grid_h = -(-image_height // tile_h)

    rect_min = jax.lax.stop_gradient(rect_min)
    rect_max = jax.lax.stop_gradient(rect_max)
    radii = jax.lax.stop_gradient(radii)

    tmin_x, tmin_y, tmax_x, tmax_y = _tile_bounds(
        rect_min, rect_max, float(tile_w), float(tile_h), grid_w, grid_h
    )
    active = radii > 0.0
    rw = jnp.where(active, tmax_x - tmin_x, 0)
    rh = jnp.where(active, tmax_y - tmin_y, 0)
    footprint = rw * rh  # exact tile count per gaussian

    # Inclusive cumsum = end offset of each gaussian's contiguous pair block,
    # in gaussian order (the reference's emission order).  Saturating scan:
    # wrap-free even when the true total exceeds int32 (see _CUM_CLAMP).
    cum = _saturating_cumsum(footprint)
    total = cum[-1] if n > 0 else jnp.int32(0)
    num_pairs = jnp.minimum(total, max_pairs)
    # Saturates at _CUM_CLAMP - max_pairs under the >2^31 pathology — still
    # correctly positive, so overflow detection/auto-grow always fires.
    overflow_pairs = jnp.maximum(total - max_pairs, 0)
    # Gaussians whose block extends past the budget lose pairs (row-major, so
    # later rect rows drop first for the boundary gaussian).
    overflow_gaussians = jnp.sum(
        jnp.logical_and(cum > max_pairs, footprint > 0).astype(jnp.int32)
    )

    # Pair slot -> owning gaussian: first index whose inclusive cumsum
    # exceeds the slot.  The positive-footprint gaussians are compacted first
    # (one [n] sort) so the cumsum is strictly increasing, then one
    # searchsorted over the compacted cumsum.
    slot_iota = jnp.arange(n, dtype=jnp.int32)
    active_key = jnp.where(footprint > 0, 0, 1).astype(jnp.int32)
    sort_key, keep_idx = jax.lax.sort(
        (active_key, slot_iota), num_keys=1, is_stable=True
    )
    cum_keep = jnp.where(sort_key == 0, cum[keep_idx], _CUM_CLAMP + 1)

    p = jnp.arange(max_pairs, dtype=jnp.int32)
    rank = jnp.searchsorted(cum_keep, p, side="right", method="sort")
    rank = jnp.minimum(rank.astype(jnp.int32), n - 1)
    return PairExpansion(
        rank=rank, cum_keep=cum_keep, keep_idx=keep_idx,
        tmin_x=tmin_x, tmin_y=tmin_y, rw=jnp.maximum(rw, 1),
        block_start=cum - footprint,
        num_pairs=num_pairs,
        overflow_gaussians=overflow_gaussians,
        overflow_pairs=overflow_pairs,
    )


def enumerate_tiles(g_block_start, g_rw, g_tmin_x, g_tmin_y, grid_w):
    """Per-pair tile coordinates from the gathered per-gaussian columns:
    the pair's offset inside its block enumerates the rect row-major.

    Exact float division stands in for integer div/mod: local = q*rw + r
    with 0 <= r < rw  =>  (local+0.5)/rw lies strictly inside (q, q+1), so the
    floor is exactly q for any rw <= 2^22."""
    p = jnp.arange(g_block_start.shape[0], dtype=jnp.int32)
    local = p - g_block_start
    q = jnp.floor(
        (local.astype(jnp.float32) + 0.5) / g_rw.astype(jnp.float32)
    ).astype(jnp.int32)
    ty = g_tmin_y + q
    tx = g_tmin_x + (local - q * g_rw)
    return ty * grid_w + tx


def bin_gaussians(
    rect_min: jax.Array,
    rect_max: jax.Array,
    radii: jax.Array,
    depths: jax.Array,
    image_width: int,
    image_height: int,
    tile_w: int,
    tile_h: int,
    max_pairs: int,
) -> TileBinning:
    n = rect_min.shape[0]
    grid_w = -(-image_width // tile_w)
    grid_h = -(-image_height // tile_h)
    num_tiles = grid_w * grid_h

    depths = jax.lax.stop_gradient(depths)
    e = expand_pairs(
        rect_min, rect_max, radii, depths,
        image_width, image_height, tile_w, tile_h, max_pairs,
    )
    rank, keep_idx = e.rank, e.keep_idx
    num_pairs = e.num_pairs
    p = jnp.arange(max_pairs, dtype=jnp.int32)
    valid = p < num_pairs
    # One 8-wide row gather for every per-pair per-gaussian quantity.  The
    # table is pre-gathered into compacted order ([n] rows, cheap) with the
    # ORIGINAL gaussian id in column 5.
    table = jnp.stack(
        [
            e.tmin_x[keep_idx],
            e.tmin_y[keep_idx],
            e.rw[keep_idx],
            e.block_start[keep_idx],
            jax.lax.bitcast_convert_type(
                depths.astype(jnp.float32), jnp.int32
            )[keep_idx],
            keep_idx,
            jnp.zeros_like(e.tmin_x),
            jnp.zeros_like(e.tmin_x),
        ],
        axis=1,
    )  # [n, 8] int32, compacted order
    g = table[rank]
    tiles = enumerate_tiles(g[:, 3], g[:, 2], g[:, 0], g[:, 1], grid_w)
    depth_g = jax.lax.bitcast_convert_type(g[:, 4], jnp.float32)
    tile_ids = jnp.where(valid, tiles, num_tiles)
    depth_keys = jnp.where(valid, depth_g, jnp.inf)
    gauss_ids = jnp.where(valid, g[:, 5], 0)

    # Stable lexicographic sort on (tile, depth); stability preserves gaussian
    # index order on depth ties like the reference's LSD radix sort (pairs
    # enter in gaussian-major order by construction above).
    sorted_tile, _, sorted_idx = jax.lax.sort(
        (tile_ids, depth_keys, gauss_ids),
        num_keys=2,
        is_stable=True,
    )

    tile_iota = jnp.arange(num_tiles, dtype=jnp.int32)
    tile_start = jnp.searchsorted(sorted_tile, tile_iota, side="left").astype(jnp.int32)
    tile_end = jnp.searchsorted(sorted_tile, tile_iota, side="right").astype(jnp.int32)
    tile_count = tile_end - tile_start

    pair_valid = sorted_tile < num_tiles

    return TileBinning(
        sorted_gauss_idx=sorted_idx,
        sorted_tile_id=sorted_tile,
        tile_start=tile_start,
        tile_count=tile_count,
        num_pairs=num_pairs,
        overflow_gaussians=e.overflow_gaussians,
        overflow_pairs=e.overflow_pairs,
        pair_valid=pair_valid,
    )
