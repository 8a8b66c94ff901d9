#!/usr/bin/env python
"""Training CLI — the counterpart of the reference's SwiftUI TrainView
(UI/TrainView.swift), as a command line:

    python train.py --dataset colmap --root /path/to/scene \\
        --iterations 30000 --resize-factor 0.5 --output outputs/lego

Dataset formats: colmap (sparse/0/*.bin + images/), blender (info.json),
nerfstudio (transforms.json).  Metrics stream to stdout and metrics.csv;
PLY snapshots and npz checkpoints land in --output.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import sys
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", choices=["colmap", "blender", "nerfstudio"],
                   required=True)
    p.add_argument("--root", required=True, help="dataset root directory")
    p.add_argument("--fetch-demo", choices=["lego", "chair"], default=None,
                   help="download this demo scene into --root first (same "
                        "sources the reference app bootstraps from; needs "
                        "network access)")
    p.add_argument("--output", default="outputs/run", help="output directory")
    p.add_argument("--iterations", type=int, default=30000)
    p.add_argument("--resize-factor", type=float, default=0.5)
    p.add_argument("--init-points", type=int, default=16384)
    p.add_argument("--sh-degree", type=int, default=4)
    p.add_argument("--sh-warmup", type=int, default=0,
                   help="INRIA-style SH warmup: rest band d trains from iter "
                        "d*N (0 = reference behaviour, all bands from iter 0)")
    p.add_argument("--white-background", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default=None,
                   help="rasterizer backend: auto (the compiled tile kernel "
                        "on a GPU) | reference | triton_interpret")
    p.add_argument("--config", default=None, help="TrainConfig JSON file")
    p.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    p.add_argument("--max-gaussians", type=int, default=1_000_000)
    p.add_argument("--lambda-depth", type=float, default=None)
    p.add_argument("--no-center", action="store_true",
                   help="skip point-cloud centering")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="mesh 'data' axis size: one camera view per device "
                        "per step, gradients all-reduced (0 = all "
                        "remaining devices)")
    p.add_argument("--tile-parallel", type=int, default=None,
                   help="mesh 'tile' axis size: split each camera's pixel "
                        "rows into this many bands (exact seam handling)")
    p.add_argument("--opacity-reset-interval", type=int, default=None,
                   help="INRIA-style periodic opacity reset every N iters "
                        "(0 = off, the reference behaviour); recommended "
                        "3000 on large-extent / sky scenes")
    p.add_argument("--prune-world-scale", type=float, default=None,
                   help="prune gaussians larger than this many world units "
                        "at densify time (0 = off; INRIA uses 0.1 x extent)")
    p.add_argument("--spatial-lr-scale", default=None,
                   help="position-LR scene scaling: a float, or 'auto' for "
                        "1.1 x camera bounding-sphere radius (INRIA); "
                        "default 1.0 = reference behaviour")
    p.add_argument("--multihost", action="store_true",
                   help="join a jax.distributed cluster (reads "
                        "JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / "
                        "JAX_PROCESS_ID); each process keeps a host-local "
                        "view store and only gradients cross hosts")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from gaussiansplattingmlx_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()

    if args.multihost:
        from gaussiansplattingmlx_tpu.parallel import multihost

        multihost.initialize()

    from gaussiansplattingmlx_tpu.config import (
        LossConfig, ModelConfig, TrainConfig,
    )
    from gaussiansplattingmlx_tpu.data import blender, colmap, nerfstudio
    from gaussiansplattingmlx_tpu.train.trainer import Trainer

    if args.config:
        cfg = TrainConfig.from_json(Path(args.config).read_text())
    else:
        cfg = TrainConfig()
    loss_cfg = cfg.loss
    if args.lambda_depth is not None:
        loss_cfg = dataclasses.replace(loss_cfg, lambda_depth=args.lambda_depth)
    par_cfg = cfg.parallel
    if args.data_parallel is not None:
        par_cfg = dataclasses.replace(par_cfg, data_parallel=args.data_parallel)
    if args.tile_parallel is not None:
        par_cfg = dataclasses.replace(par_cfg, tile_parallel=args.tile_parallel)
    densify_cfg = cfg.densify
    if args.opacity_reset_interval is not None:
        densify_cfg = dataclasses.replace(
            densify_cfg, opacity_reset_interval=args.opacity_reset_interval
        )
    if args.prune_world_scale is not None:
        densify_cfg = dataclasses.replace(
            densify_cfg, prune_world_scale=args.prune_world_scale
        )
    cfg = dataclasses.replace(
        cfg,
        iterations=args.iterations,
        resize_factor=args.resize_factor,
        init_points=args.init_points,
        white_background=args.white_background,
        seed=args.seed,
        output_dir=args.output,
        loss=loss_cfg,
        parallel=par_cfg,
        densify=densify_cfg,
        model=dataclasses.replace(
            cfg.model, sh_degree=args.sh_degree, max_gaussians=args.max_gaussians,
            sh_warmup_interval=args.sh_warmup,
        ),
    )

    loaders = {
        "colmap": colmap.load_colmap,
        "blender": blender.load_blender,
        "nerfstudio": nerfstudio.load_nerfstudio,
    }
    if args.fetch_demo:
        from gaussiansplattingmlx_tpu.data import fetch

        fmt, fetcher = fetch.DEMOS[args.fetch_demo]
        if fmt != args.dataset:
            sys.exit(f"--fetch-demo {args.fetch_demo} is a {fmt} scene; "
                     f"pass --dataset {fmt}")
        print(f"fetching demo scene {args.fetch_demo!r} into {args.root} ...",
              flush=True)
        fetcher(args.root)
    print(f"loading {args.dataset} dataset from {args.root} ...", flush=True)
    data, pcd = loaders[args.dataset](
        args.root,
        resize_factor=cfg.resize_factor,
        white_background=cfg.white_background,
    )
    if not args.no_center:
        pcd, centroid = pcd.centering()
        data = data.shift_cameras(centroid)
        print(f"centered point cloud (centroid {centroid.round(3).tolist()})")

    if args.spatial_lr_scale is not None:
        if args.spatial_lr_scale == "auto":
            from gaussiansplattingmlx_tpu.utils.camera import (
                spatial_lr_scale_auto,
            )

            scale = spatial_lr_scale_auto(data.cameras)
            print(f"spatial_lr_scale auto: {scale:.3f}", flush=True)
        else:
            scale = float(args.spatial_lr_scale)
        cfg = dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, spatial_lr_scale=scale)
        )

    print(
        f"{data.num_views} views {data.width}x{data.height}, "
        f"{pcd.size} init points -> sampling {cfg.init_points}",
        flush=True,
    )

    import jax

    is_writer = jax.process_index() == 0
    out_dir = Path(args.output)
    if is_writer:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "config.json").write_text(cfg.to_json())

    trainer = Trainer(cfg, data, pcd, backend=args.backend)
    if args.resume:
        trainer.restore_checkpoint(args.resume)
        print(f"resumed from {args.resume} at step {int(trainer.state.step)}")

    csv_path = out_dir / "metrics.csv"
    csv_file = open(csv_path, "a", newline="") if is_writer else None
    writer = None

    def on_metrics(m):
        nonlocal writer
        if not is_writer:
            return
        if writer is None:
            writer = csv.DictWriter(csv_file, fieldnames=sorted(m.keys()))
            if csv_file.tell() == 0:
                writer.writeheader()
        writer.writerow(m)
        csv_file.flush()
        # One JSON line per log line: the heartbeat that
        # scripts/supervise_train.py watches.
        with open(out_dir / "metrics.jsonl", "a") as f:
            f.write(json.dumps(m) + "\n")
        print(
            f"iter {m['iteration']:6d}  loss {m['loss']:.5f}  "
            f"psnr {m['psnr']:.2f}  n {m['num_active']}  "
            f"{m['iters_per_s']:.2f} it/s",
            flush=True,
        )

    final = trainer.run(on_metrics=on_metrics)
    trainer.save_loss_curve()
    trainer.save_snapshot(int(trainer.state.step))
    trainer.save_checkpoint(int(trainer.state.step))
    if is_writer:
        print("final:", json.dumps(final))
        csv_file.close()
    return trainer


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).parent))
    main()
