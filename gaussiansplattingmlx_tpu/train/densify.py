"""Fixed-capacity densify (split/clone) and prune, fully jit-compatible.

Reference behaviour (GaussianTrainer.swift:766-908, classify/map kernels at
:344-427): every `interval` iterations within [from_iter, until_iter],

  prune  if sigmoid(opacity) < min_opacity                  -> 0 outputs
  split  if avg |grad_xyz| > grad_threshold and max(exp(scale)) > max_scale
                                                            -> 2 outputs
  clone  if avg |grad_xyz| > grad_threshold otherwise       -> 2 outputs
  keep   otherwise                                          -> 1 output

  split children: scales -= log(1.6); xyz +- mean(exp(src_scale)) * 0.1 * N(0,1)
  clone copy:     xyz += 0.01 * N(0,1)

Static-shape redesign: the reference reallocates arrays and re-creates the optimizer on
the host with several `.item()` syncs; here everything happens in fixed
[capacity]-shaped buffers via classify -> exclusive-cumsum offsets ->
scatter-built gather map -> single gather, so the whole operation jits and the
training step never changes shape.  If the densified total would exceed
capacity, densification is disabled for that round (prune/keep only) — the
host grows capacity between rounds (see trainer.maybe_grow).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.gaussians import INACTIVE_OPACITY, GaussianParams


class DensifyStats(NamedTuple):
    num_active: jax.Array  # [] int32 new live count
    n_keep: jax.Array
    n_split: jax.Array
    n_clone: jax.Array
    n_prune: jax.Array
    densify_enabled: jax.Array  # [] bool (False if capacity would overflow)


def split_and_prune(
    params: GaussianParams,
    num_active: jax.Array,
    grad_accum: jax.Array,  # [capacity] summed ||grad_xyz||
    grad_denom: jax.Array,  # [] float accumulation count
    rng_key: jax.Array,
    *,
    allow_densify: bool | jax.Array = True,
    grad_threshold: float = 2e-4,
    max_scale: float = 0.01,
    min_opacity: float = 5e-3,
    split_scale_div: float = 1.6,
    split_noise_factor: float = 0.1,
    clone_noise_std: float = 0.01,
    max_gaussians: int = 1_000_000,
    prune_world_scale: float = 0.0,
    prune_near_cameras: float = 0.0,
    camera_centers: jax.Array | None = None,  # [V,3], required if above > 0
    prune_needle_ratio: float = 0.0,
):
    cap = params.capacity
    slot = jnp.arange(cap, dtype=jnp.int32)
    active = slot < num_active

    avg_grad = jnp.where(grad_denom > 0, grad_accum / jnp.maximum(grad_denom, 1.0), 0.0)
    op_val = jax.nn.sigmoid(params.opacity[:, 0])
    max_scale_val = jnp.max(jnp.exp(params.scales), axis=1)

    allow = jnp.logical_and(
        jnp.asarray(allow_densify), num_active < max_gaussians
    )

    prune = jnp.logical_and(active, op_val < min_opacity)
    # Non-finite rows can never recover (their own VJP keeps them NaN, and
    # NaN comparisons are all-False so neither the opacity prune nor the
    # split/clone rules ever select them — they'd occupy capacity forever)
    # and a NaN opacity makes op_val NaN, evading the prune above.  Cull
    # them unconditionally; projection already z-culls them from rendering.
    finite = (
        jnp.isfinite(op_val)
        & jnp.all(jnp.isfinite(params.xyz), axis=1)
        & jnp.all(jnp.isfinite(params.scales), axis=1)
        & jnp.all(jnp.isfinite(params.rotation), axis=1)
        & jnp.all(jnp.isfinite(params.features_dc), axis=(1, 2))
        & jnp.all(jnp.isfinite(params.features_rest), axis=(1, 2))
    )
    prune = jnp.logical_or(prune, jnp.logical_and(active, ~finite))
    if prune_world_scale > 0:
        # INRIA-style big_points_ws prune (absent from the reference's
        # classify kernel): screen-filling gaussians blur the fit and
        # dominate the tile-pair budget.  See DensifyConfig.prune_world_scale.
        prune = jnp.logical_or(
            prune, jnp.logical_and(active, max_scale_val > prune_world_scale)
        )
    if prune_near_cameras > 0:
        # Floater kill: gaussians parked right in front of a training camera
        # memorize that single view (sky haze / veils) and are invisible or
        # wrong from every other pose — the dominant held-out failure mode of
        # the round-4 vendor campaign (holdout view 0: +4.2 dB from this cull
        # alone).  No reference counterpart (single-scene iOS app never
        # evaluates novel views).  camera_centers are centering-shifted.
        assert camera_centers is not None
        # |x - c|^2 = |x|^2 + |c|^2 - 2 x.c in matmul form: one [N, V]
        # product instead of a [N, V, 3] broadcast temporary (~400 MB at the
        # 1M-gaussian capacity if XLA declines to fuse the rank-3 form).
        # Only the SIGN of d2 - r^2 matters; the product runs in full
        # float32 (not TF32), so the cancellation error of the expanded form
        # stays far below the prune radius' own arbitrariness.
        xx = jnp.sum(params.xyz * params.xyz, axis=1, keepdims=True)  # [N,1]
        cc = jnp.sum(camera_centers * camera_centers, axis=1)  # [V]
        xc = jnp.matmul(params.xyz, camera_centers.T,
                        precision=jax.lax.Precision.HIGHEST)  # [N, V]
        d2 = xx + cc[None, :] - 2.0 * xc
        near = jnp.min(d2, axis=1) < prune_near_cameras ** 2
        prune = jnp.logical_or(prune, jnp.logical_and(active, near))
    if prune_needle_ratio > 0:
        # Needle kill: max/mid scale ratio.  Disks (flat surfaces: two large
        # axes, one tiny) keep a max/mid near 1 and survive; needles (one
        # long axis — the white streak artifacts on novel views) are pruned.
        s_sorted = jnp.sort(jnp.exp(params.scales), axis=1)  # ascending
        needle = s_sorted[:, 2] > prune_needle_ratio * jnp.maximum(
            s_sorted[:, 1], 1e-12
        )
        prune = jnp.logical_or(prune, jnp.logical_and(active, needle))
    grow = jnp.logical_and(
        jnp.logical_and(active, jnp.logical_not(prune)),
        jnp.logical_and(allow, avg_grad > grad_threshold),
    )
    split = jnp.logical_and(grow, max_scale_val > max_scale)
    clone = jnp.logical_and(grow, jnp.logical_not(split))
    keep = jnp.logical_and(active, jnp.logical_not(jnp.logical_or(prune, grow)))

    counts_densify = jnp.where(keep, 1, 0) + jnp.where(jnp.logical_or(split, clone), 2, 0)
    counts_plain = jnp.where(jnp.logical_and(active, jnp.logical_not(prune)), 1, 0)

    total_densify = jnp.sum(counts_densify)
    # Capacity guard: fall back to keep/prune-only when the result won't fit.
    densify_ok = total_densify <= cap
    counts = jnp.where(densify_ok, counts_densify, counts_plain)
    split = jnp.logical_and(split, densify_ok)
    clone = jnp.logical_and(clone, densify_ok)

    offsets = jnp.cumsum(counts) - counts
    total = jnp.sum(counts)

    # Scatter-build the gather map: slot -> (source index, noise mode).
    # noise modes (GaussianTrainer.swift:397-427): 0 keep/clone-original,
    # 1 split(+), 2 split(-), 3 clone-copy.
    gather_idx = jnp.zeros((cap,), jnp.int32)
    noise_mode = jnp.zeros((cap,), jnp.int32)
    has_first = counts >= 1
    pos1 = jnp.where(has_first, offsets, cap)
    mode1 = jnp.where(split, 1, 0)
    gather_idx = gather_idx.at[pos1].set(slot, mode="drop", unique_indices=True)
    noise_mode = noise_mode.at[pos1].set(mode1, mode="drop", unique_indices=True)
    has_second = counts >= 2
    pos2 = jnp.where(has_second, offsets + 1, cap)
    mode2 = jnp.where(split, 2, 3)
    gather_idx = gather_idx.at[pos2].set(slot, mode="drop", unique_indices=True)
    noise_mode = noise_mode.at[pos2].set(mode2, mode="drop", unique_indices=True)

    out_active = slot < total

    def gather(x):
        return x[gather_idx]

    new_xyz = gather(params.xyz)
    new_dc = gather(params.features_dc)
    new_rest = gather(params.features_rest)
    new_scales = gather(params.scales)
    new_rot = gather(params.rotation)
    new_op = gather(params.opacity)

    is_split_child = jnp.logical_or(noise_mode == 1, noise_mode == 2)
    # Scale reduction: /1.6 in linear space = -log(1.6) in log space.
    new_scales = new_scales - jnp.where(is_split_child, jnp.log(split_scale_div), 0.0)[
        :, None
    ]

    base_noise = jax.random.normal(rng_key, (cap, 3), dtype=new_xyz.dtype)
    src_scale_mean = jnp.mean(jnp.exp(gather(params.scales)), axis=1, keepdims=True)
    split_sign = jnp.where(noise_mode == 1, 1.0, 0.0) - jnp.where(noise_mode == 2, 1.0, 0.0)
    split_noise = split_sign[:, None] * src_scale_mean * split_noise_factor * base_noise
    clone_noise = jnp.where(noise_mode == 3, clone_noise_std, 0.0)[:, None] * base_noise
    new_xyz = new_xyz + split_noise + clone_noise

    # Deactivate dead slots so they can never render.
    new_op = jnp.where(out_active[:, None], new_op, INACTIVE_OPACITY)

    new_params = GaussianParams(
        xyz=new_xyz,
        features_dc=new_dc,
        features_rest=new_rest,
        scales=new_scales,
        rotation=new_rot,
        opacity=new_op,
    )
    stats = DensifyStats(
        num_active=total.astype(jnp.int32),
        n_keep=jnp.sum(keep.astype(jnp.int32)),
        n_split=jnp.sum(split.astype(jnp.int32)),
        n_clone=jnp.sum(clone.astype(jnp.int32)),
        n_prune=jnp.sum(prune.astype(jnp.int32)),
        densify_enabled=densify_ok,
    )
    return new_params, stats, gather_idx, noise_mode


def reset_opacity(params: GaussianParams, num_active: jax.Array,
                  reset_value: float = 0.01) -> GaussianParams:
    """INRIA-style periodic opacity reset (no reference counterpart).

    Clamps sigmoid(opacity) to <= reset_value for live gaussians, leaving
    already-more-transparent ones (and inactive slots) untouched:
        opacity_raw = min(opacity_raw, logit(reset_value))
    Saturated opacities block gradient flow to everything behind them; the
    periodic reset forces the model to re-earn its opacity and lets densify
    prune what never recovers.  See DensifyConfig.opacity_reset_interval."""
    import numpy as np

    logit = float(np.log(reset_value) - np.log1p(-reset_value))
    active = jnp.arange(params.capacity, dtype=jnp.int32) < num_active
    new_op = jnp.where(
        active[:, None], jnp.minimum(params.opacity, logit), params.opacity
    )
    return dataclasses.replace(params, opacity=new_op)


def remap_optimizer_moments(moments, gather_idx, noise_mode):
    """INRIA-style optional state carry-over: gather Adam moments along the
    densify map, zeroing the rows of newly created Gaussians.  Used when
    DensifyConfig.reset_optimizer_state=False (the reference always resets,
    GaussianTrainer.swift:1105-1110)."""
    fresh = noise_mode != 0

    def remap(x):
        g = x[gather_idx]
        mask_shape = (g.shape[0],) + (1,) * (g.ndim - 1)
        return jnp.where(fresh.reshape(mask_shape), 0.0, g)

    return jax.tree.map(remap, moments)
