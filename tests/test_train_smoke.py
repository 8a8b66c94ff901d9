"""End-to-end training smoke test on a synthetic scene (CPU, oracle backend).

A small cloud of colored Gaussians is rendered from several cameras with the
oracle to produce ground-truth images; training from a perturbed point cloud
must substantially reduce loss / increase PSNR.  This is the integration test
the reference lacks (SURVEY §4)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussiansplattingmlx_tpu.config import (
    DensifyConfig, LossConfig, ModelConfig, OptimizerConfig, RasterizerConfig,
    TrainConfig,
)
from gaussiansplattingmlx_tpu.data.dataset import TrainData
from gaussiansplattingmlx_tpu.models import gaussians
from gaussiansplattingmlx_tpu.render import render
from gaussiansplattingmlx_tpu.train.trainer import Trainer
from gaussiansplattingmlx_tpu.utils.camera import Camera
from gaussiansplattingmlx_tpu.utils.point_cloud import PointCloud

W, H = 48, 48
RASTER = RasterizerConfig(
    tile_h=16, tile_w=16, max_pairs=4096,
    chunk_size=32, backend="reference",
)


def orbit_cameras(n_views, radius=4.0, focal=50.0):
    cams = []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        pos = np.array([radius * np.sin(ang), 0.3, -radius * np.cos(ang)])
        fwd = -pos / np.linalg.norm(pos)  # look at origin
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        true_up = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, true_up, fwd, pos
        cams.append(Camera.from_c2w(W, H, focal, focal, c2w))
    return cams


def synth_scene(rng, n=60):
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 0.5
    cols = rng.uniform(0.1, 0.9, size=(n, 3)).astype(np.float32)
    params, _ = gaussians.create_from_points(pts, cols, sh_degree=0, capacity=n)
    # Enlarge/solidify so views are well covered.
    params = dataclasses.replace(
        params,
        scales=jnp.full((n, 3), np.log(0.15), jnp.float32),
        opacity=jnp.full((n, 1), 2.0, jnp.float32),
    )
    return pts, cols, params


def render_view(params, cam, sh_degree=0):
    means, shs, opacity, scales, rots = gaussians.activations(params)
    t = cam.tensors()
    out, _ = render(
        means, shs, opacity, scales, rots,
        jnp.asarray(t["view"]), jnp.asarray(t["proj"]),
        jnp.asarray(t["camera_center"]),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"],
        W, H, sh_degree, raster_cfg=RASTER, backend="reference",
    )
    return out


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(42)
    pts, cols, params = synth_scene(rng)
    cams = orbit_cameras(6)
    images = np.stack(
        [np.asarray(render_view(params, c).color) for c in cams]
    ).astype(np.float32)
    return pts, cols, cams, images


def test_synthetic_views_nontrivial(scene):
    _, _, _, images = scene
    assert images.max() > 0.2
    assert images.std() > 0.02


def test_training_improves_psnr(scene):
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    noisy = pts + np.random.default_rng(1).normal(size=pts.shape).astype(np.float32) * 0.05
    pc = PointCloud(coords=noisy, colors=cols * 255.0)
    cfg = TrainConfig(
        iterations=80,
        init_points=len(pts),
        log_interval=20,
        snapshot_interval=10**9,
        checkpoint_interval=0,
        output_dir="",
        early_stop_loss=1e-7,
        model=ModelConfig(sh_degree=0, initial_capacity=64),
        raster=RASTER,
        densify=DensifyConfig(from_iter=10**9),  # off for the smoke test
    )
    trainer = Trainer(cfg, data, pc, backend="reference")
    first = None
    metrics_log = []
    final = trainer.run(on_metrics=metrics_log.append)
    first = metrics_log[0]
    assert np.isfinite(final["loss"])
    assert final["loss"] < first["loss"] * 0.8
    assert final["psnr"] > first["psnr"] + 1.0


def test_densify_in_loop(scene):
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)
    cfg = TrainConfig(
        iterations=40,
        init_points=len(pts),
        log_interval=20,
        snapshot_interval=10**9,
        checkpoint_interval=0,
        output_dir="",
        model=ModelConfig(sh_degree=0, initial_capacity=128),
        raster=RASTER,
        densify=DensifyConfig(interval=10, from_iter=10, until_iter=1000,
                              grad_threshold=1e-9, max_scale=1e9),
    )
    trainer = Trainer(cfg, data, pc, backend="reference")
    n0 = int(trainer.state.num_active)
    trainer.run()
    # grad_threshold ~ 0 forces clones every 10 iters.
    assert int(trainer.state.num_active) > n0


def test_overflow_auto_grow(scene, capsys):
    """A truncating pair budget is a HANDLED condition: the render error it
    causes is real (quantified vs the untruncated oracle), the trainer warns
    and doubles capacity at the next log boundary, and after growth the
    overflow counters drop to zero and the render is exact."""
    pts, cols, cams, images = scene
    _, _, params = synth_scene(np.random.default_rng(42))

    # Quantify the truncation error at a budget that actually bites.
    tight = dataclasses.replace(RASTER, max_pairs=128, auto_grow=False)
    full_out = render_view(params, cams[0])
    t = cams[0].tensors()
    means, shs, opacity, scales, rots = gaussians.activations(params)
    out_tight, aux_tight = render(
        means, shs, opacity, scales, rots,
        jnp.asarray(t["view"]), jnp.asarray(t["proj"]),
        jnp.asarray(t["camera_center"]),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"],
        W, H, 0, raster_cfg=tight, backend="reference",
    )
    assert int(aux_tight.overflow_pairs) > 0
    err = float(jnp.abs(out_tight.color - full_out.color).max())
    assert err > 1e-3  # truncation visibly corrupts the image ...

    # ... and the trainer responds: capacity doubles until overflow is gone.
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)
    cfg = TrainConfig(
        iterations=8, init_points=len(pts), log_interval=2,
        snapshot_interval=10**9, checkpoint_interval=0, output_dir="",
        model=ModelConfig(sh_degree=0, initial_capacity=64),
        raster=dataclasses.replace(RASTER, max_pairs=128, max_pairs_limit=4096),
        densify=DensifyConfig(from_iter=10**9),
    )
    trainer = Trainer(cfg, data, pc, backend="reference")
    log = []
    trainer.run(on_metrics=log.append)
    assert trainer.cfg.raster.max_pairs > 128  # grew
    assert log[-1]["overflow_pairs"] == 0  # and resolved
    err = capsys.readouterr().err
    assert "WARNING: pair-budget overflow" in err


def test_checkpoint_roundtrip(scene, tmp_path):
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)
    cfg = TrainConfig(
        iterations=5, init_points=len(pts), log_interval=5,
        snapshot_interval=10**9, checkpoint_interval=0, output_dir=str(tmp_path),
        model=ModelConfig(sh_degree=0, initial_capacity=64),
        raster=RASTER, densify=DensifyConfig(from_iter=10**9),
    )
    trainer = Trainer(cfg, data, pc, backend="reference")
    trainer.run()
    trainer.save_checkpoint(5)
    from gaussiansplattingmlx_tpu.train import checkpoint

    state2, host_rng, jax_key = checkpoint.load(tmp_path / "ckpt_5.npz")
    assert int(state2.step) == int(trainer.state.step)
    np.testing.assert_array_equal(
        np.asarray(state2.params.xyz), np.asarray(trainer.state.params.xyz)
    )
    # RNG round-trips: next draws match the live trainer's.
    assert host_rng is not None and jax_key is not None
    assert host_rng.integers(0, 1 << 30) == trainer.rng.integers(0, 1 << 30)
    np.testing.assert_array_equal(np.asarray(jax_key), np.asarray(trainer.key))
    cfg2 = checkpoint.load_config(tmp_path / "ckpt_5.npz")
    assert cfg2.iterations == 5


def test_resume_bit_equivalence(scene, tmp_path):
    """ckpt at step 3 + 4 more steps == 7 uninterrupted steps, bit-exact
    (params, Adam moments, and the replayed camera/noise sequence)."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)

    def make_cfg(iters):
        return TrainConfig(
            iterations=iters, init_points=len(pts), log_interval=100,
            snapshot_interval=10**9, checkpoint_interval=0, output_dir=str(tmp_path),
            model=ModelConfig(sh_degree=0, initial_capacity=64),
            raster=RASTER,
            densify=DensifyConfig(interval=2, from_iter=2, until_iter=1000,
                                  grad_threshold=1e-9, max_scale=1e9),
        )

    t_full = Trainer(make_cfg(7), data, pc, backend="reference")
    t_full.run()

    # Same config (the LR schedule depends on total iterations); stop early.
    t_a = Trainer(make_cfg(7), data, pc, backend="reference")
    t_a.run(iterations=3)
    t_a.save_checkpoint(3)

    t_b = Trainer(make_cfg(7), data, pc, backend="reference")
    t_b.restore_checkpoint(tmp_path / "ckpt_3.npz")
    assert int(t_b.state.step) == 3
    t_b.run()

    assert int(t_b.state.step) == int(t_full.state.step) == 7
    assert int(t_b.state.num_active) == int(t_full.state.num_active)
    for name in ("xyz", "scales", "opacity"):
        np.testing.assert_array_equal(
            np.asarray(getattr(t_b.state.params, name)),
            np.asarray(getattr(t_full.state.params, name)),
        )
        np.testing.assert_array_equal(
            np.asarray(getattr(t_b.state.opt.m, name)),
            np.asarray(getattr(t_full.state.opt.m, name)),
        )


def test_overflow_on_unlogged_step_triggers_growth(scene, capsys):
    """Overflow on a NON-logged step must still trigger auto-grow: the
    in-graph overflow accumulator (TrainState.overflow_acc) carries it to the
    next log boundary even when the logged step itself does not overflow."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)
    cfg = TrainConfig(
        iterations=4, init_points=len(pts), log_interval=4,
        snapshot_interval=10**9, checkpoint_interval=0, output_dir="",
        model=ModelConfig(sh_degree=0, initial_capacity=64),
        raster=dataclasses.replace(RASTER, max_pairs=128, max_pairs_limit=4096),
        densify=DensifyConfig(from_iter=10**9),
    )
    # Add one camera pointed AWAY from the scene (zero pairs, no overflow)
    # and force the sampler to pick overflowing views on steps 1-3 but the
    # empty view on the logged step 4.
    # A camera far away looking outward so nothing projects (zero pairs).
    c2w = np.eye(4)
    c2w[:3, 3] = [0.0, 0.0, -50.0]
    c2w[:3, 2] = [0.0, 0.0, -1.0]  # looking away from the cloud at origin
    away = Camera.from_c2w(W, H, 50.0, 50.0, c2w)
    images2 = np.concatenate([images, np.zeros((1, H, W, 3), np.float32)])
    data = TrainData(cameras=list(cams) + [away], images=images2)

    class ScriptedRng:
        """Deterministic view sampler: overflowing view, then the empty one."""

        def __init__(self, seq):
            self.seq = list(seq)

        def integers(self, lo, hi, size=None):
            v = self.seq.pop(0)
            return np.array([v] * size) if size is not None else v

    trainer = Trainer(cfg, data, pc, backend="reference")
    trainer.rng = ScriptedRng([0, 0, 0, len(cams)])  # last = empty view
    log = []
    trainer.run(on_metrics=log.append)
    # The logged step itself had no overflow ...
    assert log[-1]["overflow_pairs"] == 0
    # ... but the accumulator carried the earlier steps' overflow:
    assert log[-1]["overflow_pairs_acc"] > 0
    assert trainer.cfg.raster.max_pairs > 128
    assert "WARNING: pair-budget overflow" in capsys.readouterr().err


def test_overflow_growth_is_demand_based(scene, capsys):
    """When the LOGGED step overflows, num_pairs + overflow_pairs is the true
    pair demand, so growth lands at a snug ~1.3x margin over demand instead of
    blindly doubling (a 0.1% overflow must not buy a 2x budget that taxes
    every later binning pass).  The 1.25x minimum keeps recompiles geometric."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)
    # Probe the true demand with a one-step trainer at a huge budget (the
    # trainer's init from the point cloud is deterministic, so the tight run
    # below sees the same first-step demand), then set the budget ~10% under.
    probe_cfg = TrainConfig(
        iterations=1, init_points=len(pts), log_interval=1,
        snapshot_interval=10**9, checkpoint_interval=0, output_dir="",
        model=ModelConfig(sh_degree=0, initial_capacity=64),
        raster=dataclasses.replace(RASTER, max_pairs=1 << 16),
        densify=DensifyConfig(from_iter=10**9),
    )
    probe_log = []
    Trainer(probe_cfg, data, pc, backend="reference").run(
        on_metrics=probe_log.append
    )
    demand_probe = int(probe_log[0]["num_pairs"])
    budget = max(128, (demand_probe * 9 // 10) // 128 * 128)  # ~10% overflow
    cfg = TrainConfig(
        iterations=2, init_points=len(pts), log_interval=1,
        snapshot_interval=10**9, checkpoint_interval=0, output_dir="",
        model=ModelConfig(sh_degree=0, initial_capacity=64),
        raster=dataclasses.replace(
            RASTER, max_pairs=budget, max_pairs_limit=1 << 22
        ),
        densify=DensifyConfig(from_iter=10**9),
    )
    trainer = Trainer(cfg, data, pc, backend="reference")
    log = []
    trainer.run(on_metrics=log.append)
    overflowed = [m for m in log if m["overflow_pairs"] > 0]
    if not overflowed:  # trainer params differ from the probe; skip quietly
        import pytest

        pytest.skip("scene did not overflow at the probed budget")
    demand = overflowed[0]["num_pairs"] + overflowed[0]["overflow_pairs"]
    grown = trainer.cfg.raster.max_pairs
    assert grown > budget
    # Snug: within alignment slack of max(demand*1.3, budget*1.25) — and in
    # particular strictly below the blind 2x whenever demand*1.3 is.
    expected = max(int(demand * 1.3), int(budget * 1.25))
    expected = (expected + 511) // 512 * 512
    assert grown == min(expected, trainer.cfg.raster.max_pairs_limit)
    if expected < 2 * budget:
        assert grown < 2 * budget
    assert "WARNING: pair-budget overflow" in capsys.readouterr().err


def test_checkpoint_rewraps_typed_prng_key(tmp_path):
    """A TYPED key (jax.random.key) must restore as the same typed key — the
    raw uint32 data alone would change the noise stream under non-default
    key impls (bit-exact-resume contract)."""
    from gaussiansplattingmlx_tpu.train import checkpoint
    from gaussiansplattingmlx_tpu.train.trainer import TrainState
    from gaussiansplattingmlx_tpu.train import optimizer as adam

    params, _ = gaussians.create_from_points(
        np.zeros((4, 3), np.float32), np.full((4, 3), 0.5, np.float32),
        sh_degree=0, capacity=4,
    )
    state = TrainState(
        params=params, opt=adam.init(params), num_active=jnp.int32(4),
        grad_accum=jnp.zeros((4,), jnp.float32),
        grad_denom=jnp.float32(0.0), step=jnp.int32(0),
    )
    typed = jax.random.key(7)
    checkpoint.save(tmp_path / "c.npz", state, jax_key=typed)
    _, _, restored = checkpoint.load(tmp_path / "c.npz")
    assert jnp.issubdtype(restored.dtype, jax.dtypes.prng_key)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(restored)),
        np.asarray(jax.random.uniform(typed)),
    )


@pytest.mark.heavy
def test_budget_auto_shrink_is_trajectory_neutral(scene, capsys):
    """An oversized pair budget (auto-grow overshoot) shrinks back toward the
    observed peak at a log boundary, and the trajectory is BIT-IDENTICAL to a
    run that kept the oversized budget throughout: rendering is
    budget-independent while overflow is zero."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)

    def make_cfg():
        return TrainConfig(
            iterations=24, init_points=len(pts), log_interval=2,
            snapshot_interval=10**9, checkpoint_interval=0, output_dir="",
            model=ModelConfig(sh_degree=0, initial_capacity=64),
            raster=RASTER,
            densify=DensifyConfig(from_iter=10**9),
        )

    def simulate_growth(trainer, budget):
        # What auto-grow does mid-run: bump the budget + rebuild the step.
        trainer.cfg = dataclasses.replace(
            trainer.cfg,
            raster=dataclasses.replace(trainer.cfg.raster, max_pairs=budget),
        )
        trainer._build_train_step()

    t_shrink = Trainer(make_cfg(), data, pc, backend="reference")
    simulate_growth(t_shrink, 16384)
    t_shrink.run()
    err = capsys.readouterr().err
    assert "shrinking max_pairs" in err, err
    assert t_shrink.cfg.raster.max_pairs < 16384
    # Floor: never below the user-configured budget.
    assert t_shrink.cfg.raster.max_pairs >= RASTER.max_pairs

    t_fixed = Trainer(make_cfg(), data, pc, backend="reference")
    simulate_growth(t_fixed, 16384)
    t_fixed.cfg = dataclasses.replace(
        t_fixed.cfg,
        raster=dataclasses.replace(t_fixed.cfg.raster, auto_shrink=False),
    )
    t_fixed.run()

    a = jax.tree.map(np.asarray, t_shrink.state.params)
    b = jax.tree.map(np.asarray, t_fixed.state.params)
    for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(la, lb)


def test_opacity_reset_in_loop(scene):
    """DensifyConfig.opacity_reset_interval clamps live opacities in the
    training loop at the configured cadence (INRIA reset_opacity; no
    reference counterpart — defaults off)."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)
    cfg = TrainConfig(
        iterations=10,
        init_points=len(pts),
        log_interval=10,
        snapshot_interval=10**9,
        checkpoint_interval=0,
        output_dir="",
        model=ModelConfig(sh_degree=0, initial_capacity=64,
                          init_opacity=0.9),  # start nearly saturated
        raster=RASTER,
        densify=DensifyConfig(from_iter=10**9, until_iter=10**9,
                              opacity_reset_interval=10,
                              opacity_reset_value=0.01),
    )
    trainer = Trainer(cfg, data, pc, backend="reference")
    n0 = int(trainer.state.num_active)
    before = jax.nn.sigmoid(np.asarray(trainer.state.params.opacity[:n0, 0]))
    assert before.max() > 0.5
    trainer.run()
    n = int(trainer.state.num_active)
    after = jax.nn.sigmoid(np.asarray(trainer.state.params.opacity[:n, 0]))
    # reset fires at iteration 10 (the final step): everything clamped
    assert after.max() <= 0.011
    m = np.asarray(trainer.state.opt.m.opacity)
    assert np.all(m[:n] == 0.0)


def test_spatial_lr_scale_scales_position_updates(scene):
    """OptimizerConfig.spatial_lr_scale multiplies ONLY the position LR
    (INRIA-style scene scaling; 1.0 = reference behaviour).  With scale 0
    positions are frozen while every other parameter still moves."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)

    def run_one(scale):
        cfg = TrainConfig(
            iterations=2, init_points=len(pts), log_interval=2,
            snapshot_interval=10**9, checkpoint_interval=0, output_dir="",
            model=ModelConfig(sh_degree=0, initial_capacity=64),
            raster=RASTER,
            optim=OptimizerConfig(spatial_lr_scale=scale),
            densify=DensifyConfig(from_iter=10**9),
        )
        trainer = Trainer(cfg, data, pc, backend="reference")
        init_xyz = np.asarray(trainer.state.params.xyz).copy()
        init_dc = np.asarray(trainer.state.params.features_dc).copy()
        trainer.run()
        return (np.asarray(trainer.state.params.xyz) - init_xyz,
                np.asarray(trainer.state.params.features_dc) - init_dc)

    dxyz0, ddc0 = run_one(0.0)
    assert np.all(dxyz0 == 0.0)  # positions frozen
    assert np.abs(ddc0).max() > 0  # colors still train
    dxyz2, _ = run_one(2.0)
    assert np.abs(dxyz2).max() > 0


def test_heartbeat_touched_before_recompile(scene, tmp_path):
    """Budget growth rebuilds (recompiles) the train step; the trainer must
    refresh the supervisor heartbeat first or a 5+ minute compile reads as a
    stall and supervise_train.py kills it into a restart loop."""
    import os
    import time

    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)
    cfg = TrainConfig(
        iterations=2, init_points=len(pts), log_interval=2,
        snapshot_interval=10**9, checkpoint_interval=0,
        output_dir=str(tmp_path),
        model=ModelConfig(sh_degree=0, initial_capacity=64),
        raster=dataclasses.replace(RASTER, max_pairs=512, auto_grow=True),
        densify=DensifyConfig(from_iter=10**9),
    )
    trainer = Trainer(cfg, data, pc, backend="reference")
    hb = tmp_path / "metrics.jsonl"
    hb.touch()
    old = time.time() - 1000
    os.utime(hb, (old, old))
    trainer._maybe_grow_raster(
        {"overflow_pairs_acc": 100.0, "overflow_pairs": 100.0,
         "num_pairs": 512.0}
    )
    assert trainer.cfg.raster.max_pairs > 512  # growth happened
    assert hb.stat().st_mtime > old + 500  # heartbeat refreshed first


def test_prune_only_maintenance_window(scene):
    """DensifyConfig.prune_until_iter: after densify ends, prune-only rounds
    keep running (near-camera + world-scale + opacity prunes) without ever
    growing the model, and Adam moments survive the remap."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)
    cfg = TrainConfig(
        iterations=30,
        init_points=len(pts),
        log_interval=10,
        snapshot_interval=10**9,
        checkpoint_interval=0,
        output_dir="",
        model=ModelConfig(sh_degree=0, initial_capacity=128),
        raster=RASTER,
        densify=DensifyConfig(
            interval=5, from_iter=1, until_iter=4,   # densify never fires
            prune_until_iter=30,
            # cameras orbit at radius 4; half the gaussians sit within 0.5
            # world units of... none, so use a radius that catches the cloud
            # edge nearest a camera only if floaters exist: prune nothing,
            # then check the needle prune below does fire.
            prune_near_cameras=0.25,
            prune_needle_ratio=5.0,
        ),
    )
    trainer = Trainer(cfg, data, pc, backend="reference")
    assert trainer.prune_step is not None
    # Inject a needle gaussian (one axis 100x) and a camera-hugging floater.
    import dataclasses as dc
    st = trainer.state
    scales = np.asarray(st.params.scales).copy()
    scales[0] = [np.log(1.0), np.log(0.01), np.log(0.01)]  # needle
    xyz = np.asarray(st.params.xyz).copy()
    cam_c = np.asarray(cams[0].tensors()["camera_center"]).reshape(3)
    xyz[1] = cam_c + 0.1  # floater hugging camera 0
    trainer.state = dc.replace(
        st, params=dc.replace(st.params, scales=jnp.asarray(scales),
                              xyz=jnp.asarray(xyz)))
    n0 = int(trainer.state.num_active)
    trainer.run()
    n1 = int(trainer.state.num_active)
    # Both injected pathologies are pruned by the maintenance rounds; the
    # model never grows (densify window closed before the first interval).
    assert n1 <= n0 - 2


def test_sh_warmup_gates_rest_bands(scene):
    """ModelConfig.sh_warmup_interval: rest band d is frozen (zero forward
    contribution AND zero gradient) until iteration d*interval, ramps in
    without recompiling, and past the full ramp the step is bit-identical to
    a warmup-free step."""
    from gaussiansplattingmlx_tpu.train.trainer import stack_views

    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(coords=pts, colors=cols * 255.0)

    def make_trainer(warmup):
        cfg = TrainConfig(
            iterations=100,
            init_points=len(pts),
            log_interval=10**9,
            snapshot_interval=10**9,
            checkpoint_interval=0,
            output_dir="",
            model=ModelConfig(sh_degree=2, initial_capacity=64,
                              sh_warmup_interval=warmup),
            raster=RASTER,
            densify=DensifyConfig(from_iter=10**9),
        )
        return Trainer(cfg, data, pc, backend="reference")

    tr = make_trainer(warmup=5)
    views = stack_views(data)
    copy_state = lambda st: jax.tree.map(jnp.copy, st)

    def step_at(trainer, step):
        st = dataclasses.replace(copy_state(trainer.state),
                                 step=jnp.int32(step))
        new_state, _, _ = trainer.train_step(st, views, jnp.int32(0))
        return new_state

    # SH(2) rest rows: 0-2 are degree 1, 3-7 are degree 2.
    rest0 = np.asarray(tr.state.params.features_rest)

    s0 = step_at(tr, 0)  # active degree 0: ALL rest rows frozen
    assert np.array_equal(np.asarray(s0.params.features_rest), rest0)
    assert not np.array_equal(np.asarray(s0.params.features_dc),
                              np.asarray(tr.state.params.features_dc))

    s5 = step_at(tr, 5)  # active degree 1: rows 0-2 move, 3-7 frozen
    r5 = np.asarray(s5.params.features_rest)
    assert not np.array_equal(r5[:, :3], rest0[:, :3])
    assert np.array_equal(r5[:, 3:], rest0[:, 3:])

    s10 = step_at(tr, 10)  # active degree 2 == full model
    r10 = np.asarray(s10.params.features_rest)
    assert not np.array_equal(r10[:, 3:], rest0[:, 3:])

    # Past the ramp the warmup step is bit-identical to the plain step.
    tr_plain = make_trainer(warmup=0)
    s10_plain = step_at(tr_plain, 10)
    for a, b in zip(s10.params.as_tuple(), s10_plain.params.as_tuple()):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_render_many_matches_per_view(scene):
    """render_many (one lax.map graph over stacked cameras) reproduces the
    per-view render() loop exactly — the batched serving/viewer path."""
    from gaussiansplattingmlx_tpu.render import render_many

    pts, cols, cams, images = scene
    params, _ = gaussians.create_from_points(pts, cols, sh_degree=0,
                                             capacity=len(pts))
    params = dataclasses.replace(
        params,
        scales=jnp.full((len(pts), 3), np.log(0.15), jnp.float32),
        opacity=jnp.full((len(pts), 1), 2.0, jnp.float32),
    )
    means, shs, opacity, scales, rots = gaussians.activations(params)
    ts = [c.tensors() for c in cams[:3]]
    stack = lambda k: jnp.stack([jnp.asarray(t[k]) for t in ts])
    colors, depths, npairs, ovfl = render_many(
        means, shs, opacity, scales, rots,
        stack("view"), stack("proj"), stack("camera_center"),
        stack("fov_x"), stack("fov_y"), stack("focal_x"), stack("focal_y"),
        W, H, 0, raster_cfg=RASTER, backend="reference",
    )
    assert float(jnp.sum(ovfl)) == 0
    # XLA compiles the lax.map body separately from the eager per-view
    # oracle, so fp regrouping at ~1e-5 relative is expected; the discrete
    # outputs (pair counts) must be exact.
    for i in range(3):
        out = render_view(params, cams[i])
        np.testing.assert_allclose(np.asarray(colors[i]),
                                   np.asarray(out.color),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(depths[i]),
                                   np.asarray(out.depth),
                                   rtol=1e-4, atol=1e-4)
