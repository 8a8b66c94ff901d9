"""Multi-host layer tests (single-process pieces on the 8-virtual-device CPU
mesh, plus a real 2-process distributed smoke run via the launcher).

The reference has no distribution layer (SURVEY §2.4); correctness target is
equivalence with the single-process sharded step."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussiansplattingmlx_tpu.data.dataset import TrainData
from gaussiansplattingmlx_tpu.parallel import multihost, sharding
from gaussiansplattingmlx_tpu.train.trainer import stack_views

from test_sharding import build_state, make_cfg, scene  # noqa: F401
from test_train_smoke import W, H

REPO = Path(__file__).resolve().parents[1]


def test_local_view_range_partition():
    # 4 processes x 10 views: every view covered, equal per-process counts.
    parts = [multihost.local_view_range(10, pi, 4) for pi in range(4)]
    sizes = {len(p) for p in parts}
    assert sizes == {3}  # ceil(10/4), wrap-padded
    covered = set()
    for p in parts:
        covered |= set(int(v) for v in p)
    assert covered == set(range(10))


def test_local_view_range_single_process():
    ids = multihost.local_view_range(7, 0, 1)
    assert list(ids) == list(range(7))


def test_make_global_view_batch_sharding():
    mesh = sharding.make_mesh(data_parallel=8, tile_parallel=1)
    local = {
        "a": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
        "b": np.arange(8, dtype=np.float32),
    }
    out = multihost.make_global_view_batch(local, mesh)
    for k, v in out.items():
        assert v.shape == local[k].shape
        np.testing.assert_array_equal(np.asarray(v), local[k])
        spec = v.sharding.spec
        assert spec[0] == "data"


@pytest.mark.heavy
def test_batched_step_matches_idx_step(scene):  # noqa: F811
    """The multi-host batched step == the replicated-views + idx step."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    cfg = make_cfg()
    views = stack_views(data)
    mesh = sharding.make_mesh(data_parallel=8, tile_parallel=1)

    idx_step = sharding.make_dp_train_step(cfg, W, H, 0, cfg.iterations, mesh)
    bat_step = sharding.make_dp_train_step(
        cfg, W, H, 0, cfg.iterations, mesh, batched_views=True
    )

    chosen = np.array([3, 1, 4, 1, 5, 2, 6, 0])
    s1 = sharding.replicate_state(build_state(pts, cols), mesh)
    out1, m1, _ = idx_step(
        s1, sharding.replicate_views(views, mesh),
        sharding.shard_view_idx(chosen, mesh),
    )

    # Assemble the same per-step batch the multi-host path would build from
    # host-local stores (single process: the full store is local).
    local_ids = multihost.local_view_range(len(cams), 0, 1)
    views_np = {k: np.asarray(v) for k, v in views.items()}
    local_batch = multihost.select_local_batch(views_np, local_ids, chosen)
    batch = multihost.make_global_view_batch(local_batch, mesh)
    s2 = sharding.replicate_state(build_state(pts, cols), mesh)
    out2, m2, _ = bat_step(s2, batch)

    np.testing.assert_allclose(
        float(m1["loss"]), float(m2["loss"]), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(out1.params.xyz), np.asarray(out2.params.xyz),
        rtol=1e-6, atol=1e-8,
    )
    np.testing.assert_allclose(
        np.asarray(out1.grad_accum), np.asarray(out2.grad_accum),
        rtol=1e-5, atol=1e-10,
    )


def test_sample_local_view_ids_stay_local():
    rng = np.random.default_rng(0)
    local = np.array([2, 5, 7])
    draws = multihost.sample_local_view_ids(rng, local, 64)
    assert set(int(d) for d in draws) <= {2, 5, 7}


@pytest.mark.parametrize("gpu", [False, True], ids=["cpu", "gpu"])
def test_launcher_gives_each_worker_its_own_devices(gpu, monkeypatch):
    """Worker environments: virtual CPU devices, or with --gpu disjoint card
    ranges, so no two JAX processes open one card."""
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.syspath_prepend(str(REPO / "scripts"))
    import launch_multihost

    args = launch_multihost.argparse.Namespace(
        port=29999, num_processes=3, devices_per_process=2, gpu=gpu
    )
    envs = [launch_multihost.worker_env(args, pid) for pid in range(3)]
    assert [e["JAX_PROCESS_ID"] for e in envs] == ["0", "1", "2"]
    assert all(e["JAX_COORDINATOR_ADDRESS"] == "localhost:29999" for e in envs)
    if gpu:
        cards = [e["CUDA_VISIBLE_DEVICES"].split(",") for e in envs]
        assert cards == [["0", "1"], ["2", "3"], ["4", "5"]]
        assert all("JAX_PLATFORMS" not in e for e in envs)
    else:
        assert all(e["JAX_PLATFORMS"] == "cpu" for e in envs)
        assert all("device_count=2" in e["XLA_FLAGS"] for e in envs)


@pytest.mark.slow
def test_launch_multihost_smoke():
    """Real 2-process x 2-device distributed cluster over loopback: the
    jax.distributed + make_array_from_process_local_data path a multi-host
    cluster uses."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    proc = subprocess.run(
        [sys.executable, "scripts/launch_multihost.py",
         "--num-processes", "2", "--devices-per-process", "2",
         "--iters", "3", "--size", "32", "--views", "4", "--points", "32"],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    result_lines = [
        line for line in proc.stdout.splitlines() if line.startswith("RESULT ")
    ]
    assert result_lines, proc.stdout + proc.stderr
    out = json.loads(result_lines[0][len("RESULT "):])
    assert out["processes"] == 2
    assert out["devices"] == 4
    assert all(np.isfinite(v) for v in out["losses"])


def _run_trainer_cluster(nproc, dpp, out, port, iters=8, extra=()):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    proc = subprocess.run(
        [sys.executable, "scripts/launch_multihost.py", "--trainer",
         "--num-processes", str(nproc), "--devices-per-process", str(dpp),
         "--iters", str(iters), "--out", str(out), "--port", str(port),
         *extra],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return np.load(Path(out) / "final_params.npz")


@pytest.mark.slow
def test_multihost_trainer_densify_equivalence(tmp_path):
    """The FULL Trainer (densify + capacity growth) on the vendored COLMAP
    scene trains BIT-identical params whether the 2-device data mesh spans
    one process or two — the real multi-host integration contract
    (VERDICT round 2, missing #5)."""
    a = _run_trainer_cluster(1, 2, tmp_path / "p1", 29751)
    b = _run_trainer_cluster(2, 1, tmp_path / "p2", 29752)
    assert int(a["num_active"]) == int(b["num_active"])
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.slow
def test_multihost_trainer_checkpoint_resume(tmp_path):
    """2-process checkpoint at step 4 + resume == uninterrupted 8 steps,
    bit-exact, with densification on."""
    a = _run_trainer_cluster(2, 1, tmp_path / "full", 29753,
                             extra=("--ckpt-interval", "4"))
    ck = tmp_path / "full" / "ckpt_4.npz"
    assert ck.exists()
    b = _run_trainer_cluster(2, 1, tmp_path / "resumed", 29754,
                             extra=("--resume", str(ck)))
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.heavy
def test_trainer_batched_views_single_process(scene):  # noqa: F811
    """Trainer batched-views mode on the virtual mesh (single process):
    host-local store, per-shard sampling, densify + replication all wired."""
    from gaussiansplattingmlx_tpu.config import (
        DensifyConfig, ModelConfig, TrainConfig,
    )
    from gaussiansplattingmlx_tpu.train.trainer import Trainer
    from gaussiansplattingmlx_tpu.utils.point_cloud import PointCloud
    from test_train_smoke import RASTER

    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)
    cfg = TrainConfig(
        iterations=6, init_points=len(pts), log_interval=3,
        snapshot_interval=10**9, checkpoint_interval=0, output_dir="",
        model=ModelConfig(sh_degree=0, initial_capacity=128),
        raster=RASTER,
        densify=DensifyConfig(interval=3, from_iter=3, until_iter=1000,
                              grad_threshold=1e-9, max_scale=1e9),
    )
    mesh = sharding.make_mesh(2, 1, devices=jax.devices()[:2])
    trainer = Trainer(cfg, data, pc, backend="reference", mesh=mesh,
                      batched_views=True)
    assert trainer.batched_views
    n0 = int(trainer.state.num_active)
    log = []
    trainer.run(on_metrics=log.append)
    assert np.isfinite(log[-1]["loss"])
    assert int(trainer.state.num_active) > n0  # densify ran under the mesh


@pytest.mark.heavy
def test_trainer_batched_views_with_tile_axis(scene):  # noqa: F811
    """Batched-views Trainer on a (data=2, tile=2) mesh: host-local store +
    band-sharded rendering compose (the full multi-host pod shape)."""
    from gaussiansplattingmlx_tpu.config import (
        DensifyConfig, ModelConfig, TrainConfig,
    )
    from gaussiansplattingmlx_tpu.train.trainer import Trainer
    from gaussiansplattingmlx_tpu.utils.point_cloud import PointCloud
    from test_sharding import RASTER8

    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)
    cfg = TrainConfig(
        iterations=4, init_points=len(pts), log_interval=2,
        snapshot_interval=10**9, checkpoint_interval=0, output_dir="",
        model=ModelConfig(sh_degree=0, initial_capacity=64),
        raster=RASTER8,
        densify=DensifyConfig(from_iter=10**9),
    )
    mesh = sharding.make_mesh(2, 2, devices=jax.devices()[:4])
    trainer = Trainer(cfg, data, pc, backend="reference", mesh=mesh,
                      batched_views=True)
    log = []
    trainer.run(on_metrics=log.append)
    assert np.isfinite(log[-1]["loss"])
    assert log[-1]["psnr"] > 5.0


@pytest.mark.slow
def test_train_cli_multihost_two_processes(tmp_path):
    """The real train.py CLI under a 2-process loopback cluster: --multihost
    --data-parallel 0 trains, only process 0 writes outputs."""
    import sys

    sys.path.insert(0, str(REPO / "tests"))
    from test_data_loaders import write_blender_fixture

    scene_dir = tmp_path / "scene"
    write_blender_fixture(scene_dir, np.random.default_rng(0),
                          n_images=4, w=32, h=24)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({
        "raster": {"backend": "reference", "max_pairs": 4096,
                   "chunk_size": 32},
        "log_interval": 2, "snapshot_interval": 4, "checkpoint_interval": 4,
        "preview_interval": 100,
        "model": {"initial_capacity": 512},
        "densify": {"from_iter": 10**9},
    }))
    out = tmp_path / "out"
    procs = []
    for pid in range(2):
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env.update(
            JAX_COORDINATOR_ADDRESS="localhost:29961",
            JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=1",
        )
        procs.append(subprocess.Popen(
            [sys.executable, "train.py", "--dataset", "blender",
             "--root", str(scene_dir), "--output", str(out),
             "--config", str(cfg_path), "--iterations", "4",
             "--sh-degree", "0", "--resize-factor", "1.0",
             "--init-points", "400", "--multihost", "--data-parallel", "0"],
            cwd=str(REPO), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs[0][-2000:] + outs[1][-2000:]
    assert (out / "metrics.csv").exists()
    assert (out / "ckpt_4.npz").exists()
    assert list(out.glob("iteration_*.ply"))
