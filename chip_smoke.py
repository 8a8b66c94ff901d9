#!/usr/bin/env python
"""The main path on an NVIDIA GPU at the headline width, checked.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # four cards: the data-parallel phase only

Phases, in order; a failing phase ends the run with a non-zero exit and no
verdict line:

  tests    pytest -m gpu, in a subprocess that ends before this process
           opens the card (a JAX process reserves most of the card's memory)
  device   JAX must run on a GPU; prints the card's name and power limit
  parity   the compiled tile kernel against rasterize_reference at 800x800,
           100k Gaussians, SH3, float32 HIGHEST: forward (colour, depth,
           alpha, n_contrib) and the gradient of sum(r * colour) with respect
           to the five Gaussian leaves, band by band
  train    train.main: ~20 steps on a seeded 800x800 COLMAP scene with 100k
           initial points at SH3
  render   render_cli.main on the written snapshot: an 800x800 orbit and one
           1920x1080 frame

--four-cards runs one data-parallel step on a data=4 mesh and one on a
data=2 x tile=2 mesh, each against the same step computed on one card.

The last line of stdout is {"ok": true, "device": {...}} when every phase
passed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from xml.etree import ElementTree

import numpy as np

ROOT = Path(__file__).resolve().parent

# Parity limits (float32 HIGHEST on both sides).  The kernel sums each
# pixel's transmittance in log space, chunk by chunk, where the reference
# multiplies a linear cumulative product, and the per-Gaussian gradient sums
# run in another order (scatter-add); the differences are rounding over up
# to ~1.2k records per pixel.  On an H100 the worst band measured colour
# 1.3e-6, depth/max 6.3e-7, gradient 2.3e-6 and no n_contrib difference;
# the limits leave about 10x room.
COLOR_TOL = 1e-5  # max |diff| of colour, alpha (values in [0, 1])
DEPTH_REL_TOL = 1e-5  # max |diff| of depth over the max depth
NCONTRIB_SHARE_TOL = 1e-3  # pixels whose count differs (T crossing 1e-4)
GRAD_REL_TOL = 1e-4  # ||g_kernel - g_ref|| / ||g_ref|| per leaf
# Four-card steps against one card: the same sums compiled into another
# program and reduced over shards, so rounding again (4 x H100 measured at
# most 7.5e-7, in the scale and rotation gradients, which cancel most).
MESH_GRAD_REL_TOL = 1e-5
MESH_PARAM_ABS_TOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str):
    """Decorator: time a phase and label its output."""

    def wrap(fn):
        def run(*a, **kw):
            log(f"== phase {name}")
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")
            return out

        return run

    return wrap


@phase("tests")
def run_gpu_tests() -> None:
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tests_") as tmp:
        report = Path(tmp) / "junit.xml"
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
             "-p", "no:cacheprovider", f"--junitxml={report}"],
            cwd=ROOT, env=env,
        ).returncode
        if rc != 0:
            raise SystemExit(f"gpu-marked tests failed (pytest exit {rc})")
        suite = ElementTree.parse(report).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
    ran, skipped = int(suite.get("tests")), int(suite.get("skipped"))
    # A skip here means the subprocess found no card: that is a failure.
    if ran == 0 or skipped:
        raise SystemExit(f"gpu-marked tests: {ran} collected, {skipped} "
                         "skipped")


@phase("device")
def check_device():
    from gaussiansplattingmlx_tpu.utils.gpu import card_description, require_gpu

    import jax

    dev = require_gpu()
    devs = jax.devices()
    log(f"jax devices: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)}")
    card = card_description()
    log(f"card: {card}")
    return dev, card


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def parity_bands(counts: np.ndarray, n_bands: int) -> list:
    """Tile rows to compare: n_bands evenly spaced plus the row holding the
    deepest tile."""
    gh = counts.shape[0]
    rows = set(np.linspace(0, gh - 1, n_bands).round().astype(int).tolist())
    rows.add(int(np.unravel_index(np.argmax(counts), counts.shape)[0]))
    return sorted(rows)


@phase("parity")
def check_parity(width=800, height=800, n=100_000, backend="triton",
                 n_bands=8):
    """Kernel full frame vs the reference band by band (one band = one row
    of tiles, each with a pair budget sized to its own demand)."""
    import jax
    import jax.numpy as jnp

    import bench
    from gaussiansplattingmlx_tpu.config import RasterizerConfig
    from gaussiansplattingmlx_tpu.models import gaussians
    from gaussiansplattingmlx_tpu.render import render

    params, cam, _ = bench.make_scene(n=n, width=width, height=height)
    cfg = RasterizerConfig()
    counts = bench.tile_counts(params, cam, width, height, cfg)
    cfg = dataclasses.replace(cfg, max_pairs=bench.snug_budget(counts.sum()))
    leaves = gaussians.activations(params)
    cam_args = bench.render_args(cam)
    th = cfg.tile_h
    log(f"scene: {width}x{height}, {n} gaussians, SH{bench.SH_DEGREE}, "
        f"{int(counts.sum())} pairs, deepest tile {int(counts.max())}, "
        f"budget {cfg.max_pairs}")

    with jax.default_matmul_precision("highest"):

        @jax.jit
        def kernel_fwd(leaves):
            def f(leaves):
                out, aux = render(*leaves, *cam_args, width, height,
                                  bench.SH_DEGREE, raster_cfg=cfg,
                                  backend=backend)
                return out.color, (out, aux.overflow_pairs)

            color, vjp, (out, ovfl) = jax.vjp(f, leaves, has_aux=True)
            return out, ovfl, vjp

        out_k, ovfl, vjp_k = kernel_fwd(leaves)
        if int(ovfl) != 0:
            raise SystemExit(f"kernel frame overflowed by {int(ovfl)} pairs")
        kernel_grad = jax.jit(lambda vjp, r: vjp(r)[0])

        def ref_band(y0, budget):
            rcfg = dataclasses.replace(cfg, max_pairs=budget)

            @jax.jit
            def run(leaves, r):
                def f(leaves):
                    out, aux = render(
                        *leaves, *cam_args, width, th, bench.SH_DEGREE,
                        raster_cfg=rcfg, backend="reference",
                        pixel_y_offset=y0, full_image_height=height,
                    )
                    return out.color, (out, aux.overflow_pairs)

                _, vjp, (out, ovfl) = jax.vjp(f, leaves, has_aux=True)
                return out, ovfl, vjp(r)[0]

            return run

        rng = np.random.default_rng(1)
        depth_scale = float(np.max(np.asarray(out_k.depth)))
        worst = {"color": 0.0, "alpha": 0.0, "depth_rel": 0.0, "ncon": 0.0,
                 "grad": 0.0}
        ncon_diff = 0
        rows = parity_bands(counts, n_bands)
        for row in rows:
            y0 = row * th
            demand = int(counts[row].sum())
            budget = max(4096, 1 << (demand - 1).bit_length())
            r_band = rng.normal(size=(th, width, 3)).astype(np.float32)
            r_full = np.zeros((height, width, 3), np.float32)
            r_full[y0:y0 + th] = r_band
            out_r, ovfl_r, g_ref = ref_band(y0, budget)(
                leaves, jnp.asarray(r_band)
            )
            if int(ovfl_r) != 0:
                raise SystemExit(f"band {row}: reference overflowed")
            g_k = kernel_grad(vjp_k, jnp.asarray(r_full))
            sl = slice(y0, y0 + th)
            e_col = float(np.max(np.abs(
                np.asarray(out_k.color[sl]) - np.asarray(out_r.color))))
            e_alpha = float(np.max(np.abs(
                np.asarray(out_k.alpha[sl]) - np.asarray(out_r.alpha))))
            e_depth = float(np.max(np.abs(
                np.asarray(out_k.depth[sl]) - np.asarray(out_r.depth)))
            ) / depth_scale
            nd = int(np.sum(
                np.asarray(out_k.n_contrib[sl]) != np.asarray(out_r.n_contrib)))
            ncon_diff += nd
            e_grad = max(rel_err(a, b) for a, b in zip(g_k, g_ref))
            log(f"band row {row:3d} (y {y0}-{y0 + th - 1}, {demand} pairs, "
                f"budget {budget}): colour {e_col:.3g} alpha {e_alpha:.3g} "
                f"depth/max {e_depth:.3g} n_contrib diff {nd} px, "
                f"grad rel-norm {e_grad:.3g} ("
                + ", ".join(f"{rel_err(a, b):.2g}" for a, b in zip(g_k, g_ref))
                + ")")
            worst["color"] = max(worst["color"], e_col)
            worst["alpha"] = max(worst["alpha"], e_alpha)
            worst["depth_rel"] = max(worst["depth_rel"], e_depth)
            worst["grad"] = max(worst["grad"], e_grad)
        worst["ncon"] = ncon_diff / (len(rows) * th * width)
    log("parity worst: " + json.dumps(worst))
    limits = {"color": COLOR_TOL, "alpha": COLOR_TOL,
              "depth_rel": DEPTH_REL_TOL, "ncon": NCONTRIB_SHARE_TOL,
              "grad": GRAD_REL_TOL}
    bad = {k: v for k, v in worst.items() if not v <= limits[k]}
    if bad:
        raise SystemExit(f"parity outside limits {limits}: {bad}")


def make_scene_dir(out: Path, width: int, height: int, points: int,
                   views: int) -> None:
    subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "make_vendor_scene.py"),
         "--out", str(out), "--width", str(width), "--height", str(height),
         "--rich", "--points", str(points), "--views", str(views)],
        check=True, stdout=subprocess.DEVNULL,
    )


@phase("train")
def run_training(work: Path, card: str, width=800, height=800,
                 points=100_000, iterations=20, views=6, backend=None):
    import jax
    import jax.numpy as jnp

    import train

    scene = work / "scene"
    make_scene_dir(scene, width, height, points, views)
    out = work / "run"
    argv = ["--dataset", "colmap", "--root", str(scene), "--output", str(out),
            "--iterations", str(iterations), "--resize-factor", "1.0",
            "--init-points", str(points), "--sh-degree", "3"]
    if backend:
        argv += ["--backend", backend]
    trainer = train.main(argv)
    hist = trainer.history
    losses = [m["loss"] for m in hist]
    log(f"losses per log line: {losses}")
    final = hist[-1]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"non-finite training loss: {losses}")
    if final["overflow_pairs"] != 0:
        raise SystemExit(f"pair overflow at the end: {final['overflow_pairs']}")
    log(f"final: overflow_pairs {final['overflow_pairs']}, num_pairs "
        f"{final['num_pairs']}, psnr {final['psnr']:.3f}")
    compiled = trainer.train_step.lower(
        trainer.state, trainer.views, jnp.int32(0)
    ).compile()
    log(f"train step memory_analysis: {compiled.memory_analysis()}")
    log(f"informational: {final['iters_per_s']:.3f} it/s over the last log "
        f"window on {card}")
    ply = out / f"iteration_{int(trainer.state.step)}.ply"
    if not ply.exists():
        raise SystemExit(f"training wrote no snapshot {ply}")
    del trainer, compiled
    jax.clear_caches()
    return ply


@phase("render")
def run_render(ply: Path, work: Path, orbit=3, size=(800, 800),
               big=(1920, 1080), backend=None):
    import render_cli

    extra = ["--backend", backend] if backend else []
    for (w, h), frames in ((size, orbit), (big, 1)):
        summary = render_cli.main(
            ["--ply", str(ply), "--out", str(work / f"render_{w}x{h}"),
             "--orbit", str(frames), "--width", str(w), "--height", str(h)]
            + extra
        )
        log(f"render {w}x{h}: {summary}")
        if summary["frames"] != frames or not summary["finite"]:
            raise SystemExit(f"render {w}x{h} failed: {summary}")
        if summary["overflow_pairs"] != 0:
            raise SystemExit(f"render {w}x{h} overflowed: {summary}")


def make_view_grad(cfg, backend, width, height):
    """(params, views, i) -> loss gradient of view i on one device, as the
    train step takes it (activations -> render -> L1+SSIM)."""
    import jax
    import jax.numpy as jnp

    from gaussiansplattingmlx_tpu.models import gaussians
    from gaussiansplattingmlx_tpu.ops import losses
    from gaussiansplattingmlx_tpu.render import render

    @jax.jit
    def grad(ptuple, views, i):
        take = lambda k: views[k][i]

        def loss_fn(ptuple):
            leaves = gaussians.activations(
                gaussians.GaussianParams.from_tuple(ptuple)
            )
            out, _ = render(
                *leaves, take("view"), take("proj"), take("camera_center"),
                take("fov_x"), take("fov_y"), take("focal_x"), take("focal_y"),
                width, height, cfg.model.sh_degree, raster_cfg=cfg.raster,
                backend=backend,
            )
            return losses.total_loss(
                out.color, take("target_rgb"), out.depth,
                take("target_depth"), take("depth_mask"),
            )[0]

        return jax.grad(loss_fn)(ptuple)

    return lambda params, views, i: gaussians.GaussianParams.from_tuple(
        grad(params.as_tuple(), views, jnp.int32(i))
    )


def orbit_views(n_views, width, height, rng):
    """Stacked per-view tensors of n_views cameras around the scene, with
    random target images."""
    import jax.numpy as jnp

    import render_cli
    from gaussiansplattingmlx_tpu.train.trainer import VIEW_KEYS
    from gaussiansplattingmlx_tpu.utils.camera import Camera

    views = {k: [] for k in VIEW_KEYS}
    for i in range(n_views):
        c2w = render_cli.orbit_c2w(2 * np.pi * i / n_views, 4.0, 0.3)
        t = Camera.from_c2w(width, height, 1111.0, 1111.0, c2w).tensors()
        t["target_rgb"] = rng.uniform(size=(height, width, 3))
        t["target_depth"] = np.zeros((height, width))
        t["depth_mask"] = np.zeros((height, width))
        for k in VIEW_KEYS:
            views[k].append(np.asarray(t[k], np.float32))
    return {k: jnp.asarray(np.stack(v)) for k, v in views.items()}


@phase("four-cards")
def check_four_cards(backend="triton", width=800, height=800, n=100_000):
    """One data-parallel step on (data=4) and one on (data=2, tile=2), each
    against the same step on one card: the mean of the per-view gradients,
    then the Adam update."""
    import jax
    import jax.numpy as jnp

    import bench
    from gaussiansplattingmlx_tpu.config import (
        DensifyConfig, ModelConfig, RasterizerConfig, TrainConfig,
    )
    from gaussiansplattingmlx_tpu.models import gaussians
    from gaussiansplattingmlx_tpu.parallel import sharding
    from gaussiansplattingmlx_tpu.train import optimizer as adam
    from gaussiansplattingmlx_tpu.train.trainer import TrainState

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(devs)}")
    params, _, _ = bench.make_scene(n=n, width=width, height=height)
    views = orbit_views(4, width, height, np.random.default_rng(2))
    raster = RasterizerConfig()
    demand = max(
        int(bench.tile_counts(params, {k: v[i] for k, v in views.items()},
                              width, height, raster).sum())
        for i in range(4)
    )
    cfg = TrainConfig(
        iterations=100, init_points=n, output_dir="",
        model=ModelConfig(sh_degree=bench.SH_DEGREE, initial_capacity=n),
        raster=dataclasses.replace(raster,
                                   max_pairs=bench.snug_budget(demand)),
        densify=DensifyConfig(from_iter=10**9),
    )
    lrs = gaussians.GaussianParams(**gaussians.learning_rates(
        0, cfg.iterations, lr_xyz=cfg.optim.lr_xyz,
    ))
    view_grad = make_view_grad(cfg, backend, width, height)
    with jax.default_device(devs[0]):
        grads = [jax.device_get(view_grad(params, views, i))
                 for i in range(4)]

    def fresh_state():
        p = jax.tree.map(jnp.copy, params)
        return TrainState(
            params=p, opt=adam.init(p), num_active=jnp.int32(n),
            grad_accum=jnp.zeros((n,), jnp.float32),
            grad_denom=jnp.float32(0.0), step=jnp.int32(0),
        )

    for dp, tp in ((4, 1), (2, 2)):
        idx = list(range(dp))
        g_mean = jax.tree.map(lambda *g: sum(g) / dp, *[grads[i] for i in idx])
        want, _ = adam.update(params, g_mean, adam.init(params), lrs)
        mesh = sharding.make_mesh(dp, tp, devices=devs[:4])
        step = sharding.make_dp_train_step(
            cfg, width, height, bench.SH_DEGREE, cfg.iterations, mesh,
            backend,
        )
        new_state, metrics, _ = step(
            sharding.replicate_state(fresh_state(), mesh),
            sharding.replicate_views(views, mesh),
            sharding.shard_view_idx(idx, mesh),
        )
        # Adam's first moment after one step from zero is (1 - beta1) * g.
        got_g = jax.tree.map(lambda m: m / (1.0 - cfg.optim.beta1),
                             jax.device_get(new_state.opt.m))
        got_p = jax.device_get(new_state.params)
        want = jax.device_get(want)
        g_err = {k: rel_err(a, b) for k, a, b in zip(
            gaussians.PARAM_NAMES, got_g.as_tuple(), g_mean.as_tuple())}
        # Adam's first step is lr * sign(g) / sqrt(1 - beta2) here (no bias
        # correction), so a gradient within rounding of zero may flip its
        # step: compare parameters where |g| is not within 1e-4 of the
        # leaf's largest.
        p_err = {}
        for k, a, b, g in zip(gaussians.PARAM_NAMES, got_p.as_tuple(),
                              want.as_tuple(), g_mean.as_tuple()):
            g = np.abs(np.asarray(g))
            keep = g > 1e-4 * g.max()
            p_err[k] = float(np.max(np.abs(np.asarray(a) - np.asarray(b))[keep],
                                    initial=0.0))
        log(f"mesh data={dp} tile={tp}: loss {float(metrics['loss']):.6f} "
            f"overflow {int(metrics['overflow_pairs'])}")
        log(f"  gradient rel-norm vs one card: {g_err}")
        log(f"  max |param diff| vs one card: {p_err}")
        for d in devs[:4]:
            log(f"  {d}: bytes_in_use "
                f"{(d.memory_stats() or {}).get('bytes_in_use')}")
        if int(metrics["overflow_pairs"]) != 0:
            raise SystemExit("four-card step overflowed")
        if max(g_err.values()) > MESH_GRAD_REL_TOL:
            raise SystemExit(f"mesh data={dp} tile={tp} gradient: {g_err}")
        if max(p_err.values()) > MESH_PARAM_ABS_TOL:
            raise SystemExit(f"mesh data={dp} tile={tp} params: {p_err}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card data-parallel phase")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    if not args.four_cards:
        run_gpu_tests()

    from gaussiansplattingmlx_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    dev, card = check_device()
    import jax

    if args.four_cards:
        check_four_cards()
    else:
        check_parity()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            ply = run_training(Path(tmp), card)
            run_render(ply, Path(tmp))
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
