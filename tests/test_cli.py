"""End-to-end CLI integration: train.py on a tiny Blender fixture, then
render_cli.py and eval.py on its outputs (all CPU, oracle-scale)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

REPO = Path(__file__).resolve().parents[1]

CONFIG = {
    "iterations": 6,
    "log_interval": 2,
    "snapshot_interval": 5,
    "preview_interval": 3,
    "checkpoint_interval": 5,
    "model": {"sh_degree": 1, "initial_capacity": 256},
    "raster": {
        "tile_h": 16, "tile_w": 16, 
        "max_pairs": 2048, "chunk_size": 32, "backend": "reference",
    },
    "densify": {"from_iter": 10**9},
}


def write_scene(root, rng, n_images=3, w=32, h=24):
    from test_data_loaders import write_blender_fixture

    write_blender_fixture(root, rng, n_images=n_images, w=w, h=h)


def run_cli(script, *args, env_extra=None):
    import os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, str(REPO / script), *args],
        capture_output=True, text=True, env=env, timeout=600,
    )


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    rng = np.random.default_rng(0)
    scene = tmp_path_factory.mktemp("scene")
    out = tmp_path_factory.mktemp("out")
    write_scene(scene, rng)
    cfg_path = scene / "cfg.json"
    cfg_path.write_text(json.dumps(CONFIG))
    r = run_cli(
        "train.py", "--dataset", "blender", "--root", str(scene),
        "--output", str(out), "--config", str(cfg_path),
        "--iterations", "6", "--sh-degree", "1", "--resize-factor", "1.0",
    )
    assert r.returncode == 0, r.stderr[-3000:]
    return scene, out, r


def test_train_cli(trained):
    scene, out, r = trained
    assert "final:" in r.stdout
    assert (out / "metrics.csv").exists()
    assert (out / "config.json").exists()
    plys = list(out.glob("iteration_*.ply"))
    assert plys, "no PLY snapshots written"
    assert list(out.glob("ckpt_*.npz")), "no checkpoint written"
    assert (out / "loss_curve.png").exists()
    assert list((out / "previews").glob("*.png")), "no previews written"


def test_render_cli(trained, tmp_path):
    scene, out, _ = trained
    ply = sorted(out.glob("iteration_*.ply"))[-1]
    r = run_cli(
        "render_cli.py", "--ply", str(ply), "--out", str(tmp_path),
        "--width", "32", "--height", "32", "--orbit", "2", "--depth",
        "--backend", "reference", "--max-pairs", "4096",
    )
    assert r.returncode == 0, r.stderr[-3000:]
    imgs = sorted(tmp_path.glob("render_*.png"))
    assert len(imgs) == 2
    arr = np.asarray(Image.open(imgs[0]))
    assert arr.shape == (32, 32, 3)
    assert len(list(tmp_path.glob("depth_*.png"))) == 2


def test_eval_cli(trained):
    scene, out, _ = trained
    ply = sorted(out.glob("iteration_*.ply"))[-1]
    r = run_cli(
        "eval.py", "--dataset", "blender", "--root", str(scene),
        "--ply", str(ply), "--resize-factor", "1.0",
        "--backend", "reference", "--max-pairs", "4096",
    )
    assert r.returncode == 0, r.stderr[-3000:]
    last = r.stdout.strip().splitlines()[-1]
    metrics = json.loads(last)
    assert metrics["views"] == 3
    assert np.isfinite(metrics["psnr_mean"])


def test_train_resume(trained, tmp_path):
    scene, out, _ = trained
    ckpt = sorted(out.glob("ckpt_*.npz"))[-1]
    cfg_path = scene / "cfg.json"
    r = run_cli(
        "train.py", "--dataset", "blender", "--root", str(scene),
        "--output", str(tmp_path), "--config", str(cfg_path),
        "--iterations", "3", "--sh-degree", "1", "--resize-factor", "1.0",
        "--resume", str(ckpt),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed from" in r.stdout


def test_render_cli_overflow_autogrow(trained, tmp_path):
    """A render budget that clips grows (recompile) instead of producing a
    truncated frame — via the probe auto-sizer (one jump) or the per-frame
    doubling safety net."""
    scene, out, _ = trained
    ply = sorted(out.glob("iteration_*.ply"))[-1]
    r = run_cli(
        "render_cli.py", "--ply", str(ply), "--out", str(tmp_path),
        "--width", "32", "--height", "32", "--orbit", "1",
        "--backend", "reference", "--max-pairs", "16",
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert ("auto pair budget" in r.stdout) or ("growing max_pairs" in r.stdout)
    assert (tmp_path / "render_000.png").exists()


def test_render_cli_auto_pairs_shrink(trained, tmp_path):
    """An oversized viewer budget shrinks to the probed peak (+headroom)."""
    scene, out, _ = trained
    ply = sorted(out.glob("iteration_*.ply"))[-1]
    r = run_cli(
        "render_cli.py", "--ply", str(ply), "--out", str(tmp_path),
        "--width", "32", "--height", "32", "--orbit", "1",
        "--backend", "reference", "--max-pairs", "65536",
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "auto pair budget" in r.stdout, r.stdout
    assert (tmp_path / "render_000.png").exists()
