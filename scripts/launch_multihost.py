"""Multi-host training launcher + worker.

Two modes:

  launcher (default): spawns ``--num-processes`` local worker processes that
    form a real JAX distributed cluster over loopback (the same
    ``jax.distributed.initialize`` + ``make_array_from_process_local_data``
    code path a multi-host cluster uses; only the transport differs).  Each
    worker gets ``--devices-per-process`` virtual CPU devices (or, with
    ``--gpu``, that many cards of its own through CUDA_VISIBLE_DEVICES, so
    no two processes open one card), loads ONLY its slice of the camera
    views, and runs batched data-parallel train steps.

        python scripts/launch_multihost.py --num-processes 2 \
            --devices-per-process 2 --iters 6

  worker (--worker): one process of the cluster.  On a real cluster, run
    this directly on every host with JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID exported.

The reference has no distribution layer (SURVEY §2.4); this is new design.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def worker(args) -> None:
    # Platform/device config must precede first jax import effects.
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from gaussiansplattingmlx_tpu.parallel import multihost

    multihost.initialize()
    import jax.numpy as jnp
    import numpy as np

    from gaussiansplattingmlx_tpu.config import (
        DensifyConfig, ModelConfig, RasterizerConfig, TrainConfig,
    )
    from gaussiansplattingmlx_tpu.models import gaussians
    from gaussiansplattingmlx_tpu.parallel import sharding
    from gaussiansplattingmlx_tpu.train import optimizer as adam
    from gaussiansplattingmlx_tpu.train.trainer import TrainState
    from gaussiansplattingmlx_tpu.utils.camera import Camera

    pi, pc = jax.process_index(), jax.process_count()
    n_dev = len(jax.devices())
    print(f"[proc {pi}/{pc}] up: {n_dev} global devices, "
          f"{len(jax.local_devices())} local", flush=True)

    W = H = args.size
    mesh = sharding.make_mesh(0, 1)
    ndata = mesh.shape["data"]

    # --- synthetic scene, deterministic across processes -------------------
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(args.points, 3)).astype(np.float32) * 0.5
    cols = rng.uniform(0.1, 0.9, size=(args.points, 3)).astype(np.float32)
    params, num = gaussians.create_from_points(
        pts, cols, sh_degree=1, capacity=args.points
    )

    num_views = args.views
    cams = []
    for i in range(num_views):
        ang = 2 * np.pi * i / num_views
        c2w = np.eye(4)
        c2w[0, 3], c2w[2, 3] = 3.0 * np.sin(ang), -3.0 * np.cos(ang)
        cams.append(Camera.from_c2w(W, H, 1.2 * W, 1.2 * W, c2w))

    # Host-local view store: THIS process loads only its cameras' targets.
    local_ids = multihost.local_view_range(num_views)
    targets = {
        int(g): rng.uniform(size=(H, W, 3)).astype(np.float32)
        for g in np.arange(num_views)
    }  # deterministic rng: all procs agree on the target of view g
    local_store = {}
    keys = ["view", "proj", "camera_center", "fov_x", "fov_y",
            "focal_x", "focal_y"]
    for g in local_ids:
        t = cams[int(g)].tensors()
        row = {k: np.asarray(t[k], np.float32) for k in keys}
        row["target_rgb"] = targets[int(g)]
        row["target_depth"] = np.zeros((H, W), np.float32)
        row["depth_mask"] = np.zeros((H, W), np.float32)
        local_store[int(g)] = row
    stacked = {
        k: np.stack([local_store[int(g)][k] for g in local_ids])
        for k in local_store[int(local_ids[0])]
    }

    raster = RasterizerConfig(
        tile_h=16, tile_w=16, max_pairs=4096,
        chunk_size=32, backend="reference",
    )
    cfg = TrainConfig(
        iterations=args.iters, init_points=args.points, log_interval=1,
        output_dir="", model=ModelConfig(sh_degree=1,
                                         initial_capacity=args.points),
        raster=raster, densify=DensifyConfig(from_iter=10**9),
    )
    step = sharding.make_dp_train_step(
        cfg, W, H, 1, cfg.iterations, mesh, backend="reference",
        batched_views=True,
    )
    state = TrainState(
        params=params, opt=adam.init(params), num_active=jnp.int32(num),
        grad_accum=jnp.zeros((params.capacity,), jnp.float32),
        grad_denom=jnp.float32(0.0), step=jnp.int32(0),
    )
    state = sharding.replicate_state(state, mesh)

    shard_pos, n_local = multihost.local_data_shards(mesh)
    step_rng = np.random.default_rng(12345 + pi)  # per-host camera schedule
    t0 = time.time()
    losses = []
    for it in range(args.iters):
        chosen = multihost.sample_local_view_ids(step_rng, local_ids, n_local)
        local_batch = multihost.select_local_batch(stacked, local_ids, chosen)
        batch = multihost.make_global_view_batch(local_batch, mesh)
        state, metrics, _ = step(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if pi == 0:
            print(f"[proc 0] iter {it + 1} loss {loss:.5f}", flush=True)
    if pi == 0:
        wall = time.time() - t0
        out = {
            "processes": pc, "devices": n_dev, "data_parallel": ndata,
            "iters": args.iters, "losses": losses,
            "it_per_s": args.iters / wall,
            "pixels_per_s": args.iters * ndata * W * H / wall,
        }
        print("RESULT " + json.dumps(out), flush=True)


def worker_trainer(args) -> None:
    """Full Trainer in multi-process batched-views mode on a real dataset
    (the vendored COLMAP scene): densification, capacity growth, raster
    auto-grow and checkpoint/resume all run under jax.process_count() > 1.

    Deterministic across process COUNTS: the same seed trains bit-identical
    params whether the (data=N) mesh spans 1 process or N — the equivalence
    test in tests/test_multihost.py compares the saved final params."""
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from gaussiansplattingmlx_tpu.parallel import multihost

    multihost.initialize()
    import numpy as np

    from gaussiansplattingmlx_tpu.config import (
        DensifyConfig, ModelConfig, ParallelConfig, RasterizerConfig,
        TrainConfig,
    )
    from gaussiansplattingmlx_tpu.data import colmap
    from gaussiansplattingmlx_tpu.train.trainer import Trainer

    pi, pc = jax.process_index(), jax.process_count()
    print(f"[proc {pi}/{pc}] trainer mode: {len(jax.devices())} global devices",
          flush=True)
    data, pcd = colmap.load_colmap(args.root, resize_factor=args.resize_factor)
    pcd, centroid = pcd.centering()
    data = data.shift_cameras(centroid)
    cfg = TrainConfig(
        iterations=args.iters, init_points=args.points,
        log_interval=max(args.iters // 3, 1), snapshot_interval=10**9,
        preview_interval=10**9, checkpoint_interval=args.ckpt_interval,
        output_dir=args.out, seed=0,
        model=ModelConfig(sh_degree=1, initial_capacity=256,
                          max_gaussians=4096),
        raster=RasterizerConfig(max_pairs=8192, chunk_size=32,
                                backend="reference"),
        densify=DensifyConfig(interval=4, from_iter=4, until_iter=10**9,
                              grad_threshold=1e-9, max_scale=1e9),
        parallel=ParallelConfig(data_parallel=0, tile_parallel=1),
    )
    # batched_views explicitly ON even single-process so the view-sampling
    # stream is identical across process counts (the equivalence contract).
    trainer = Trainer(cfg, data, pcd, backend="reference", batched_views=True)
    if args.resume:
        trainer.restore_checkpoint(args.resume)
        print(f"[proc {pi}] resumed from {args.resume} "
              f"at step {int(trainer.state.step)}", flush=True)
    trainer.run()
    if trainer.is_writer:
        p = jax.device_get(trainer.state.params)
        Path(args.out).mkdir(parents=True, exist_ok=True)
        np.savez(
            Path(args.out) / "final_params.npz",
            xyz=np.asarray(p.xyz), scales=np.asarray(p.scales),
            opacity=np.asarray(p.opacity),
            features_dc=np.asarray(p.features_dc),
            num_active=int(trainer.state.num_active),
        )
        print("TRAINER_DONE", flush=True)


def worker_env(args, pid: int) -> dict:
    """Environment of worker `pid`: the cluster coordinates, plus its own
    devices — virtual CPU devices, or with --gpu a disjoint range of cards
    (a JAX process reserves most of a card's memory, so processes must never
    share one)."""
    env = dict(
        os.environ,
        JAX_COORDINATOR_ADDRESS=f"localhost:{args.port}",
        JAX_NUM_PROCESSES=str(args.num_processes),
        JAX_PROCESS_ID=str(pid),
    )
    if args.gpu:
        first = pid * args.devices_per_process
        env["CUDA_VISIBLE_DEVICES"] = ",".join(
            str(d) for d in range(first, first + args.devices_per_process)
        )
    else:
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={args.devices_per_process}"
        )
    return env


def launcher(args) -> None:
    procs = []
    for pid in range(args.num_processes):
        env = worker_env(args, pid)
        cmd = [sys.executable, __file__, "--worker",
               "--iters", str(args.iters), "--size", str(args.size),
               "--views", str(args.views), "--points", str(args.points)]
        if not args.gpu:
            cmd.append("--cpu")
        if args.trainer:
            cmd += ["--trainer", "--root", args.root, "--out", args.out,
                    "--resize-factor", str(args.resize_factor),
                    "--ckpt-interval", str(args.ckpt_interval)]
            if args.resume:
                cmd += ["--resume", args.resume]
        procs.append(subprocess.Popen(cmd, env=env, cwd=str(REPO)))
    rc = [p.wait(timeout=args.timeout) for p in procs]
    if any(rc):
        raise SystemExit(f"worker exit codes {rc}")
    print(f"all {args.num_processes} workers exited cleanly")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="worker: force the CPU platform (local clusters)")
    ap.add_argument("--gpu", action="store_true",
                    help="launcher: give each worker its own GPUs instead "
                         "of virtual CPU devices")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=2)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--views", type=int, default=8)
    ap.add_argument("--points", type=int, default=64)
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--port", type=int, default=29701)
    # --trainer mode: full Trainer (densify/growth/ckpt) on a COLMAP scene.
    ap.add_argument("--trainer", action="store_true")
    ap.add_argument("--root", default="tests/fixtures/vendor_scene")
    ap.add_argument("--out", default="outputs/multihost_trainer")
    ap.add_argument("--resize-factor", type=float, default=0.25)
    ap.add_argument("--ckpt-interval", type=int, default=0)
    ap.add_argument("--resume", default=None)
    args = ap.parse_args()
    if args.worker and args.trainer:
        worker_trainer(args)
    elif args.worker:
        worker(args)
    else:
        launcher(args)


if __name__ == "__main__":
    main()
