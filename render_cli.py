#!/usr/bin/env python
"""Inference renderer CLI — counterpart of the reference's Metal viewer
(Metal/MetalGaussianRenderer.swift + UI/RenderView.swift): loads a Gaussian
PLY snapshot and renders orbit cameras to PNGs.

    python render_cli.py --ply outputs/run/iteration_30000.ply \\
        --orbit 8 --width 800 --height 800 --out renders/
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ply", required=True)
    p.add_argument("--out", default="renders")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--focal", type=float, default=None,
                   help="focal length in pixels (default 1.2*width)")
    p.add_argument("--orbit", type=int, default=8,
                   help="number of orbit cameras around the scene")
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--elevation", type=float, default=0.2)
    p.add_argument("--white-background", action="store_true")
    p.add_argument("--backend", default=None)
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument("--tile", type=int, default=None)
    p.add_argument("--depth", action="store_true", help="also save depth maps")
    p.add_argument("--video", default=None,
                   help="write an animated turntable (GIF) to this path; "
                        "--orbit sets the frame count")
    p.add_argument("--video-fps", type=int, default=30)
    p.add_argument("--no-auto-pairs", action="store_true",
                   help="disable the probe-based pair-budget auto-shrink "
                        "(use the --max-pairs budget verbatim)")
    p.add_argument("--bench-frames", type=int, default=0,
                   help="after rendering, loop this many frames back-to-back "
                        "and report sustained rendered frames/s (the "
                        "reference viewer's interactive-rate metric, "
                        "Metal/MetalGaussianRenderer.swift:262-299)")
    p.add_argument("--bench-batch", type=int, default=8,
                   help="frames rendered per device dispatch in the bench "
                        "(lax.map over stacked cameras); 1 = one dispatch "
                        "per frame")
    return p.parse_args(argv)


def orbit_c2w(angle: float, radius: float, elevation: float) -> np.ndarray:
    pos = np.array(
        [radius * np.sin(angle), elevation, -radius * np.cos(angle)]
    )
    fwd = -pos / np.linalg.norm(pos)
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    true_up = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, fwd, pos
    return c2w


def main(argv=None):
    args = parse_args(argv)

    from gaussiansplattingmlx_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    from PIL import Image

    from gaussiansplattingmlx_tpu.config import RasterizerConfig
    from gaussiansplattingmlx_tpu.data import ply as ply_mod
    from gaussiansplattingmlx_tpu.models.gaussians import GaussianParams, activations
    from gaussiansplattingmlx_tpu.render import render
    from gaussiansplattingmlx_tpu.utils.camera import Camera

    g = ply_mod.read_gaussian_ply(args.ply)
    n = g.xyz.shape[0]
    print(f"loaded {n} gaussians, SH rest {g.features_rest.shape[1]}")
    sh_degree = int(np.sqrt(g.features_rest.shape[1] + 1)) - 1
    params = GaussianParams(
        xyz=jnp.asarray(g.xyz),
        features_dc=jnp.asarray(g.features_dc),
        features_rest=jnp.asarray(g.features_rest),
        scales=jnp.asarray(g.scales),
        rotation=jnp.asarray(g.rotation),
        opacity=jnp.asarray(g.opacity),
    )
    means, shs, opacity, scales, rots = activations(params)

    focal = args.focal if args.focal else 1.2 * args.width
    import dataclasses as _dc

    cfg = RasterizerConfig()
    if args.max_pairs:
        cfg = _dc.replace(cfg, max_pairs=args.max_pairs)
    if args.tile:
        cfg = _dc.replace(cfg, tile_h=args.tile, tile_w=args.tile)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    def make_render_view(rcfg):
        @jax.jit
        def render_view(view, proj, center, fx, fy, fovx, fovy):
            out, aux = render(
                means, shs, opacity, scales, rots,
                view, proj, center, fovx, fovy, fx, fy,
                args.width, args.height, sh_degree,
                raster_cfg=rcfg,
                white_background=args.white_background,
                backend=args.backend,
            )
            return out.color, out.depth, aux.overflow_pairs, aux.num_pairs

        return render_view

    render_view = make_render_view(cfg)

    def cam_tensors(i, n_frames):
        cam = Camera.from_c2w(
            args.width, args.height, focal, focal,
            orbit_c2w(2 * np.pi * i / n_frames, args.radius, args.elevation),
        )
        t = cam.tensors()
        return (
            jnp.asarray(t["view"]), jnp.asarray(t["proj"]),
            jnp.asarray(t["camera_center"]),
            t["focal_x"], t["focal_y"], t["fov_x"], t["fov_y"],
        )

    def render_checked(*cam):
        """Render with overflow handling: a clipped pair budget doubles
        max_pairs (one re-trace) and re-renders — never a truncated frame."""
        nonlocal cfg, render_view
        color, depth, ovfl, _ = render_view(*cam)
        while float(ovfl) > 0 and cfg.max_pairs < cfg.max_pairs_limit:
            cfg = _dc.replace(cfg, max_pairs=min(cfg.max_pairs * 2,
                                                 cfg.max_pairs_limit))
            print(f"pair-budget overflow: growing max_pairs to "
                  f"{cfg.max_pairs} (recompile)", flush=True)
            render_view = make_render_view(cfg)
            color, depth, ovfl, _ = render_view(*cam)
        return color, depth, int(ovfl)

    if not args.no_auto_pairs:
        # Viewer-grade budget sizing: every static-axis stage (sort, record
        # gather, the rasterizer's record buffer) pays for the full max_pairs
        # budget whether slots are valid or not, so an oversized budget taxes
        # every frame.  Probe a few orbit views, then shrink the budget to
        # the observed peak + headroom (chunk/merge-block aligned).  Never
        # grows past the CLI budget; per-frame overflow handling above stays
        # as the safety net for un-probed views.
        n_frames = max(args.orbit, args.bench_frames, 1)
        probe_idx = sorted({int(i) for i in
                            np.linspace(0, n_frames - 1, min(4, n_frames))})
        peak = 0
        for i in probe_idx:
            _, _, ovfl, npair = render_view(*cam_tensors(i, n_frames))
            peak = max(peak, int(float(npair)) + int(float(ovfl)))
        quantum = 512
        snug = max(quantum, -(-int(peak * 1.25) // quantum) * quantum)
        snug = min(snug, cfg.max_pairs_limit)
        if snug != cfg.max_pairs:
            # Shrink oversized budgets AND jump straight to a sufficient one
            # when the probe clipped (one recompile instead of doublings).
            print(f"auto pair budget: peak {peak} pairs over "
                  f"{len(probe_idx)} probe views -> max_pairs {snug} "
                  f"(was {cfg.max_pairs})", flush=True)
            cfg = _dc.replace(cfg, max_pairs=snug)
            render_view = make_render_view(cfg)

    frames = []
    summary = {"frames": 0, "finite": True, "overflow_pairs": 0}
    for i in range(args.orbit):
        color, depth, ovfl = render_checked(*cam_tensors(i, args.orbit))
        color = np.asarray(color)
        summary["frames"] += 1
        summary["finite"] &= bool(np.isfinite(color).all())
        summary["overflow_pairs"] += ovfl
        img = np.clip(color * 255.0, 0, 255).astype(np.uint8)
        frames.append(img)
        Image.fromarray(img).save(out_dir / f"render_{i:03d}.png")
        if args.depth:
            d = np.asarray(depth)
            d = (d / max(d.max(), 1e-6) * 255.0).astype(np.uint8)
            Image.fromarray(d, mode="L").save(out_dir / f"depth_{i:03d}.png")
        print(f"wrote render_{i:03d}.png")

    if args.video:
        # Turntable export — the offline counterpart of the reference's
        # interactive orbit viewer (UI/RenderView.swift:99-172).
        pils = [Image.fromarray(f) for f in frames]
        pils[0].save(
            args.video, save_all=True, append_images=pils[1:],
            duration=max(1, round(1000 / args.video_fps)), loop=0,
        )
        print(f"wrote {args.video} ({len(pils)} frames @ {args.video_fps} fps)")

    if args.bench_frames > 0:
        # Sustained inference throughput: pre-build the camera tensors, then
        # time device-bound rendering only (one host sync at the end).
        import time

        B = max(1, min(args.bench_batch, args.bench_frames))
        n_frames = -(-args.bench_frames // B) * B  # round up to full batches

        from gaussiansplattingmlx_tpu.render import render_many

        def make_render_batch(rcfg):
            @jax.jit
            def render_batch(view, proj, center, fx, fy, fovx, fovy):
                colors, _, npairs, ovfl = render_many(
                    means, shs, opacity, scales, rots,
                    view, proj, center, fovx, fovy, fx, fy,
                    args.width, args.height, sh_degree,
                    raster_cfg=rcfg,
                    white_background=args.white_background,
                    backend=args.backend,
                )
                return colors, ovfl, npairs

            return render_batch

        def stacked_batch(b):
            cams = [cam_tensors(i, n_frames)
                    for i in range(b * B, (b + 1) * B)]
            return tuple(
                jnp.stack([jnp.asarray(c[k]) for c in cams])
                for k in range(7)
            )

        batches = [stacked_batch(b) for b in range(n_frames // B)]
        for attempt in range(2):
            render_batch = make_render_batch(cfg)
            jax.block_until_ready(render_batch(*batches[0]))  # compile
            t0 = time.perf_counter()
            audits = []
            out = None
            for bt in batches:
                out = render_batch(*bt)
                audits.append(out[1:])  # [B] overflow / num_pairs, on device
            jax.block_until_ready(out)
            dt = time.perf_counter() - t0
            # Overflow audit OUTSIDE the timed region: a truncated frame must
            # never back an fps claim.  Grow once and re-run if any clipped.
            clipped = sum(float(jnp.sum(a[0])) for a in audits)
            if clipped == 0 or cfg.max_pairs >= cfg.max_pairs_limit:
                break
            cfg = _dc.replace(cfg, max_pairs=min(cfg.max_pairs * 2,
                                                 cfg.max_pairs_limit))
            print(f"bench overflow ({clipped:.0f} pairs clipped): growing "
                  f"max_pairs to {cfg.max_pairs}, re-running", flush=True)
        fps = n_frames / dt
        note = f" [OVERFLOW: {clipped:.0f} pairs clipped]" if clipped else ""
        print(f"rendered {n_frames} frames at "
              f"{args.width}x{args.height}: {fps:.1f} frames/s "
              f"({1e3 * dt / n_frames:.1f} ms/frame, "
              f"{B} frames/dispatch){note}")
        summary["bench_ms_per_frame"] = 1e3 * dt / n_frames
        if B > 1:
            # Per-dispatch reference point: the same frames, one dispatch
            # each.  Rebuilt from the FINAL cfg: the batched loop may have
            # grown max_pairs after an overflow, and both legs must use the
            # same budget for the overhead delta to mean anything.
            render_view = make_render_view(cfg)
            singles = [cam_tensors(i, n_frames) for i in range(n_frames)]
            jax.block_until_ready(render_view(*singles[0]))
            t0 = time.perf_counter()
            outs = [render_view(*c) for c in singles]
            jax.block_until_ready(outs)
            dt1 = time.perf_counter() - t0
            clipped1 = sum(float(o[2]) for o in outs)  # audit, untimed
            note = (f" [OVERFLOW: {clipped1:.0f} pairs clipped]"
                    if clipped1 else "")
            print(f"  per-dispatch: {n_frames / dt1:.1f} frames/s "
                  f"({1e3 * dt1 / n_frames:.1f} ms/frame) — "
                  f"dispatch overhead "
                  f"{1e3 * (dt1 - dt) / n_frames:+.1f} ms/frame{note}")
    return summary


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).parent))
    main()
