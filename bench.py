"""Benchmark: one differentiable training-like step at the headline width.

    python bench.py

Workload: 800x800 image, 100k Gaussians, SH3 — projection, binning, the tile
rasterizer forward, L1+SSIM loss, and the backward through the custom VJPs.
Prints the card (`name, power.limit`) and then ONE JSON line with the step
time and the compositing load behind it.  Fails unless JAX runs on a GPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

W = H = 800
N = 100_000
SH_DEGREE = 3
ITERS = 10
METRIC = "fwd+bwd pixels/s (800x800, 100k gaussians, SH3)"


def make_scene(seed: int = 0, n: int = N, width: int = W, height: int = H):
    """Lego-like random scene: points in a unit-ish volume, a camera at r=4,
    Gaussian sizes of a converged 3DGS scene (~3 px screen sigma -> 1-4
    tiles), opacities spread like a trained model.  Returns (params,
    camera tensors, target image)."""
    import jax.numpy as jnp

    from gaussiansplattingmlx_tpu.models import gaussians
    from gaussiansplattingmlx_tpu.utils.camera import Camera

    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.6
    cols = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)
    params, _ = gaussians.create_from_points(
        pts, cols, sh_degree=SH_DEGREE, capacity=n
    )
    params = dataclasses.replace(
        params,
        scales=jnp.asarray(
            np.log(rng.uniform(0.004, 0.02, size=(n, 3))).astype(np.float32)
        ),
        opacity=jnp.asarray(
            rng.normal(0.0, 2.0, size=(n, 1)).astype(np.float32)
        ),
    )
    c2w = np.eye(4)
    c2w[2, 3] = -4.0
    cam = Camera.from_c2w(width, height, 1111.0, 1111.0, c2w).tensors()
    target = jnp.asarray(
        rng.uniform(size=(height, width, 3)).astype(np.float32)
    )
    return params, cam, target


def render_args(cam):
    import jax.numpy as jnp

    return (jnp.asarray(cam["view"]), jnp.asarray(cam["proj"]),
            jnp.asarray(cam["camera_center"]), cam["fov_x"], cam["fov_y"],
            cam["focal_x"], cam["focal_y"])


def tile_counts(params, cam, width: int, height: int, cfg):
    """Exact per-tile pair counts [grid_h, grid_w] of one view (projection
    + binning with a budget large enough for every footprint)."""
    import jax

    from gaussiansplattingmlx_tpu.models import gaussians
    from gaussiansplattingmlx_tpu.ops import binning, projection

    @jax.jit
    def counts(ptuple):
        means, shs, opacity, scales, rots = gaussians.activations(
            gaussians.GaussianParams.from_tuple(ptuple)
        )
        p = projection.project_gaussians(
            means, scales, rots, shs, *render_args(cam), width, height,
            SH_DEGREE,
        )
        gw, gh = -(-width // cfg.tile_w), -(-height // cfg.tile_h)
        tmin_x, tmin_y, tmax_x, tmax_y = binning._tile_bounds(
            p.rect_min, p.rect_max, cfg.tile_w, cfg.tile_h, gw, gh
        )
        jnp = jax.numpy
        fx, fy = jnp.arange(gw), jnp.arange(gh)
        in_x = (fx[None, :] >= tmin_x[:, None]) & (fx[None, :] < tmax_x[:, None])
        in_y = (fy[None, :] >= tmin_y[:, None]) & (fy[None, :] < tmax_y[:, None])
        in_y = in_y & (p.radii > 0)[:, None]
        # Counts stay below 2^24, so the f32 product is exact.
        return jnp.matmul(
            in_y.astype(jnp.float32).T, in_x.astype(jnp.float32),
            precision=jax.lax.Precision.HIGHEST,
        ).astype(jnp.int32)  # [gh, gw]

    return np.asarray(counts(params.as_tuple()))


def make_step(cfg, cam, target, backend: str, width: int = W, height: int = H):
    """Jitted (loss, stats, grads) of the training-like step."""
    import jax

    from gaussiansplattingmlx_tpu.models import gaussians
    from gaussiansplattingmlx_tpu.ops import losses as losses_mod
    from gaussiansplattingmlx_tpu.render import render

    zeros_hw = jax.numpy.zeros((height, width), jax.numpy.float32)

    @jax.jit
    def step(ptuple):
        def loss_fn(ptuple):
            pp = gaussians.GaussianParams.from_tuple(ptuple)
            means, shs, opacity, scales, rots = gaussians.activations(pp)
            out, aux = render(
                means, shs, opacity, scales, rots, *render_args(cam),
                width, height, SH_DEGREE, raster_cfg=cfg, backend=backend,
            )
            loss, _ = losses_mod.total_loss(
                out.color, target, out.depth, zeros_hw, zeros_hw
            )
            stats = (aux.num_pairs, aux.overflow_pairs, aux.tile_depth_mean,
                     aux.tile_depth_max)
            return loss, jax.lax.stop_gradient(stats)

        (loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            ptuple
        )
        return loss, stats, grads

    return step


def snug_budget(demand: int, quantum: int = 4096) -> int:
    """Pair budget for an exact demand: +3%, rounded up.  Every
    static-axis stage (sort, gather, the rasterizer's record buffer) pays for
    the whole budget, valid slots or not."""
    return max(quantum, -(-int(demand * 1.03) // quantum) * quantum)


def time_step(step, args, iters: int) -> float:
    """Mean seconds per call over `iters` calls after one warm call."""
    import jax

    jax.block_until_ready(step(args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main():
    from gaussiansplattingmlx_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    import jax

    from gaussiansplattingmlx_tpu.config import RasterizerConfig
    from gaussiansplattingmlx_tpu.utils.gpu import card_description, require_gpu

    dev = require_gpu()
    card = card_description()
    print(f"card: {card}", flush=True)

    params, cam, target = make_scene()
    cfg = RasterizerConfig()
    demand = int(tile_counts(params, cam, W, H, cfg).sum())
    cfg = dataclasses.replace(cfg, max_pairs=snug_budget(demand))
    step = make_step(cfg, cam, target, "auto")
    dt = time_step(step, params.as_tuple(), ITERS)
    _, stats, _ = step(params.as_tuple())
    num_pairs, ovfl_pairs, depth_mean, depth_max = (float(s) for s in stats)
    print(json.dumps({
        "metric": METRIC,
        "value": W * H / dt,
        "unit": "pixels/s",
        "step_ms": 1e3 * dt,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "num_pairs": round(num_pairs),
        "max_pairs": cfg.max_pairs,
        "tile": cfg.tile_w,
        "overflow_pairs": round(ovfl_pairs),
        "tile_depth_mean": depth_mean,
        "tile_depth_max": round(depth_max),
    }))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).parent))
    main()
