"""Held-out quality forensics: render a held-out view under gaussian-subset
ablations to identify WHAT is hazing novel views (near-camera floaters vs SH
overfit vs translucent giants).

    python scripts/diagnose_holdout.py outputs/flagship_vendor/ckpt_30000.npz \
        --dataset-root outputs/vendor_scene_800 --view 0

Each ablation reports held-out PSNR; the mechanism is whichever cull recovers
the most dB.  CPU-safe at small sizes (name a backend); on a GPU it runs in
seconds.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ckpt")
    ap.add_argument("--dataset-root", required=True)
    ap.add_argument("--views", default="0,9,18,27")
    ap.add_argument("--resize-factor", type=float, default=1.0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--max-pairs", type=int, default=8388608)
    ap.add_argument("--backend", default=None,
                    help="rasterizer backend (default auto: the GPU kernel)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from gaussiansplattingmlx_tpu.config import RasterizerConfig
    from gaussiansplattingmlx_tpu.data import colmap
    from gaussiansplattingmlx_tpu.models.gaussians import GaussianParams, activations
    from gaussiansplattingmlx_tpu.ops import losses
    from gaussiansplattingmlx_tpu.render import render

    data, pcd = colmap.load_colmap(args.dataset_root,
                                   resize_factor=args.resize_factor)
    pcd, centroid = pcd.centering()
    data = data.shift_cameras(centroid)

    d = np.load(args.ckpt)
    n = int(d["num_active"])
    params = GaussianParams(
        xyz=jnp.asarray(d["param_xyz"][:n]),
        features_dc=jnp.asarray(d["param_features_dc"][:n]),
        features_rest=jnp.asarray(d["param_features_rest"][:n]),
        scales=jnp.asarray(d["param_scales"][:n]),
        rotation=jnp.asarray(d["param_rotation"][:n]),
        opacity=jnp.asarray(d["param_opacity"][:n]),
    )
    sh_degree = int(np.sqrt(params.features_rest.shape[1] + 1)) - 1
    means, shs, opacity, scales, rots = activations(params)
    means_np = np.asarray(means)
    r = np.linalg.norm(means_np, axis=1)
    smax = np.asarray(scales).max(axis=1)
    op_np = np.asarray(opacity)[:, 0]

    cam_pos = np.stack([np.asarray(c.tensors()["camera_center"]).reshape(3)
                        for c in data.cameras])
    # distance from each gaussian to the NEAREST camera (chunked)
    d_cam = np.full(n, np.inf, np.float32)
    for i in range(0, n, 65536):
        blk = means_np[i:i + 65536]
        dd = np.linalg.norm(blk[:, None, :] - cam_pos[None], axis=-1)
        d_cam[i:i + 65536] = dd.min(axis=1)

    import dataclasses as _dc

    cfg = _dc.replace(RasterizerConfig(), max_pairs=args.max_pairs)
    view_ids = [int(v) for v in args.views.split(",")]

    # One static-shape jitted renderer: ablations zero opacity instead of
    # dropping rows, and SH truncation zeroes rest coefficients — so every
    # ablation reuses the same compiled graph (the compile is the expensive
    # part, not the render).
    @jax.jit
    def render_one(o_masked, s_masked, view, proj, center,
                   fovx, fovy, fx, fy):
        out, _ = render(
            means, s_masked, o_masked, scales, rots,
            view, proj, center, fovx, fovy, fx, fy,
            data.width, data.height, sh_degree,
            raster_cfg=cfg, backend=args.backend,
        )
        return out.color

    def render_views(mask, sh_deg, tag):
        kept = int(mask.sum())
        o_m = jnp.where(jnp.asarray(mask)[:, None], opacity, 0.0)
        s_m = shs
        if sh_deg < sh_degree:
            keep_coef = (sh_deg + 1) ** 2
            coef_mask = (jnp.arange(shs.shape[1]) < keep_coef)[None, :, None]
            s_m = jnp.where(coef_mask, shs, 0.0)
        psnrs = []
        for vi in view_ids:
            t = data.cameras[vi].tensors()
            color = render_one(
                o_m, s_m,
                jnp.asarray(t["view"]), jnp.asarray(t["proj"]),
                jnp.asarray(t["camera_center"]),
                t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"],
            )
            p = float(losses.psnr(color, jnp.asarray(data.images[vi])))
            psnrs.append(p)
            if args.save:
                from PIL import Image
                Path(args.save).mkdir(parents=True, exist_ok=True)
                img = np.clip(np.asarray(color) * 255, 0, 255).astype(np.uint8)
                Image.fromarray(img).save(
                    Path(args.save) / f"{tag.replace(' ', '_').replace('<', 'lt').replace('>', 'gt')}_v{vi:03d}.png")
        print(f"{tag:28s} kept {kept:6d}/{n}  "
              f"psnr/view {' '.join(f'{p:5.2f}' for p in psnrs)}  "
              f"mean {np.mean(psnrs):5.2f}", flush=True)
        return np.mean(psnrs)

    all_mask = np.ones(n, bool)
    render_views(all_mask, sh_degree, "full")
    render_views(all_mask, 0, "sh_degree=0")
    render_views(all_mask, 1, "sh_degree=1")
    render_views(r < 5.0, sh_degree, "cull r>5 (sky dome)")
    render_views(~((r > 2.0) & (r < 5.0)), sh_degree, "cull r in 2..5")
    render_views(d_cam > 0.5, sh_degree, "cull d_cam<0.5")
    render_views(d_cam > 1.0, sh_degree, "cull d_cam<1.0")
    render_views(op_np > 0.05, sh_degree, "cull opacity<0.05")
    render_views(op_np > 0.2, sh_degree, "cull opacity<0.2")
    render_views(smax < 0.3, sh_degree, "cull smax>0.3")
    render_views((d_cam > 1.0) & (op_np > 0.05), sh_degree,
                 "cull d_cam<1 & op<0.05")


if __name__ == "__main__":
    main()
