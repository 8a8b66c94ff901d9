#!/usr/bin/env python
"""Evaluation CLI: render every dataset view from a snapshot and report
PSNR / SSIM / L1 (the reference computes none of these in-loop; PSNR is this
project's parity criterion, BASELINE.md).

    python eval.py --dataset colmap --root /path/to/scene \\
        --ply outputs/run/iteration_30000.ply --resize-factor 0.5
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=["colmap", "blender", "nerfstudio"],
                   required=True)
    p.add_argument("--root", required=True)
    p.add_argument("--ply", required=True)
    p.add_argument("--resize-factor", type=float, default=0.5)
    p.add_argument("--white-background", action="store_true")
    p.add_argument("--backend", default=None)
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument("--tile", type=int, default=None)
    p.add_argument("--save-renders", default=None)
    p.add_argument("--no-center", action="store_true")
    p.add_argument("--views", default=None,
                   help="comma-separated view indices to evaluate (e.g. the "
                        "HELD-OUT views of a train/test split); default: all")
    return p.parse_args(argv)


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
    from gaussiansplattingmlx_tpu.data import blender, colmap, nerfstudio
    from gaussiansplattingmlx_tpu.data import ply as ply_mod
    from gaussiansplattingmlx_tpu.models.gaussians import GaussianParams, activations
    from gaussiansplattingmlx_tpu.ops import losses, ssim
    from gaussiansplattingmlx_tpu.render import render

    loaders = {
        "colmap": colmap.load_colmap,
        "blender": blender.load_blender,
        "nerfstudio": nerfstudio.load_nerfstudio,
    }
    data, pcd = loaders[args.dataset](
        args.root,
        resize_factor=args.resize_factor,
        white_background=args.white_background,
    )
    if not args.no_center:
        # Evaluation must see the same camera shift used at training time.
        pcd, centroid = pcd.centering()
        data = data.shift_cameras(centroid)

    g = ply_mod.read_gaussian_ply(args.ply)
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
    import dataclasses as _dc

    cfg = RasterizerConfig()
    if args.max_pairs:
        cfg = _dc.replace(cfg, max_pairs=args.max_pairs)
    if args.tile:
        cfg = _dc.replace(cfg, tile_h=args.tile, tile_w=args.tile)

    @jax.jit
    def render_view(view, proj, center, fx, fy, fovx, fovy):
        out, _ = render(
            means, shs, opacity, scales, rots,
            view, proj, center, fovx, fovy, fx, fy,
            data.width, data.height, sh_degree,
            raster_cfg=cfg,
            white_background=args.white_background,
            backend=args.backend,
        )
        return out.color

    out_dir = Path(args.save_renders) if args.save_renders else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)

    view_ids = (
        [int(v) for v in args.views.split(",")] if args.views
        else list(range(len(data.cameras)))
    )
    psnrs, ssims, l1s = [], [], []
    for i in view_ids:
        cam = data.cameras[i]
        t = cam.tensors()
        color = render_view(
            jnp.asarray(t["view"]), jnp.asarray(t["proj"]),
            jnp.asarray(t["camera_center"]),
            t["focal_x"], t["focal_y"], t["fov_x"], t["fov_y"],
        )
        target = jnp.asarray(data.images[i])
        psnrs.append(float(losses.psnr(color, target)))
        ssims.append(float(ssim.ssim(color, target)))
        l1s.append(float(losses.l1_loss(color, target)))
        if out_dir:
            img = np.clip(np.asarray(color) * 255.0, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(out_dir / f"eval_{i:03d}.png")
        print(f"view {i:3d}: psnr {psnrs[-1]:.2f} ssim {ssims[-1]:.4f}")

    result = {
        "psnr_mean": float(np.mean(psnrs)),
        "ssim_mean": float(np.mean(ssims)),
        "l1_mean": float(np.mean(l1s)),
        "views": len(psnrs),
        # Per-view spread: a high mean can hide barely-reconstructed
        # viewpoints (the round-4 held-out set spanned 13.6-25.5 dB).
        "per_view_psnr": [round(p, 2) for p in psnrs],
        "view_ids": view_ids,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).parent))
    main()
