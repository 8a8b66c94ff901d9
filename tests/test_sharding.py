"""Multi-device tests on the 8-virtual-CPU mesh: DP gradient equivalence,
band-render parity, tile-parallel exactness vs the single-device step, and
the combined data x tile mesh."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussiansplattingmlx_tpu.config import (
    DensifyConfig, ModelConfig, RasterizerConfig, TrainConfig,
)
from gaussiansplattingmlx_tpu.data.dataset import TrainData
from gaussiansplattingmlx_tpu.models import gaussians
from gaussiansplattingmlx_tpu.parallel import sharding
from gaussiansplattingmlx_tpu.render import render
from gaussiansplattingmlx_tpu.train import optimizer as adam
from gaussiansplattingmlx_tpu.train.trainer import (
    TrainState, make_train_step, stack_views,
)
from gaussiansplattingmlx_tpu.utils.point_cloud import PointCloud

from test_train_smoke import RASTER, W, H, orbit_cameras, synth_scene

# 8px tiles so a 2-band split of the 48px image keeps band_h (24) a multiple
# of tile_h — the exactness precondition of the tile-parallel design.  The
# footprint cap is raised so NO gaussian is truncated: R-truncation keeps a
# row-major tile prefix, which differs between band-local and full-image
# binning and would break the band==full equivalence being tested.
RASTER8 = dataclasses.replace(
    RASTER, tile_h=8, tile_w=8, max_pairs=16384
)


def build_state(pts, cols, capacity=64):
    params, n = gaussians.create_from_points(
        pts, cols, sh_degree=0, capacity=capacity
    )
    return TrainState(
        params=params,
        opt=adam.init(params),
        num_active=jnp.int32(n),
        grad_accum=jnp.zeros((capacity,), jnp.float32),
        grad_denom=jnp.float32(0.0),
        step=jnp.int32(0),
    )


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(42)
    pts, cols, params = synth_scene(rng)
    cams = orbit_cameras(8)
    images = []
    for c in cams:
        means, shs, opacity, scales, rots = gaussians.activations(params)
        t = c.tensors()
        out, _ = render(
            means, shs, opacity, scales, rots,
            jnp.asarray(t["view"]), jnp.asarray(t["proj"]),
            jnp.asarray(t["camera_center"]),
            t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"],
            W, H, 0, raster_cfg=RASTER, backend="reference",
        )
        images.append(np.asarray(out.color))
    return pts, cols, cams, np.stack(images).astype(np.float32)


def make_cfg(raster=RASTER):
    return TrainConfig(
        iterations=10, init_points=60, log_interval=1,
        snapshot_interval=10**9, checkpoint_interval=0, output_dir="",
        model=ModelConfig(sh_degree=0, initial_capacity=64),
        raster=raster, densify=DensifyConfig(from_iter=10**9),
    )


def test_band_render_matches_full(scene):
    """A 2-band split of one view must reproduce the full image rows."""
    pts, cols, cams, images = scene
    state = build_state(pts, cols)
    means, shs, opacity, scales, rots = gaussians.activations(
        state.params, gaussians.active_mask(state.params, state.num_active)
    )
    t = cams[0].tensors()
    args = (
        means, shs, opacity, scales, rots,
        jnp.asarray(t["view"]), jnp.asarray(t["proj"]),
        jnp.asarray(t["camera_center"]),
        t["fov_x"], t["fov_y"], t["focal_x"], t["focal_y"],
    )
    full, _ = render(*args, W, H, 0, raster_cfg=RASTER, backend="reference")
    band_h = 16  # multiple of tile_h -> band tiling == full tiling, exact
    for b in range(H // band_h):
        band, _ = render(
            *args, W, band_h, 0, raster_cfg=RASTER, backend="reference",
            pixel_y_offset=jnp.float32(b * band_h), full_image_height=H,
        )
        np.testing.assert_allclose(
            np.asarray(band.color),
            np.asarray(full.color[b * band_h : (b + 1) * band_h]),
            rtol=1e-4, atol=1e-5,
        )
        np.testing.assert_allclose(
            np.asarray(band.alpha),
            np.asarray(full.alpha[b * band_h : (b + 1) * band_h]),
            rtol=1e-4, atol=1e-5,
        )


def single_view_loss_and_grad(views, state, i, raster=RASTER):
    active = gaussians.active_mask(state.params, state.num_active)

    @jax.jit
    def go(ptuple, i):
        def loss_fn(ptuple):
            params = gaussians.GaussianParams.from_tuple(ptuple)
            means, shs, opacity, scales, rots = gaussians.activations(params, active)
            out, _ = render(
                means, shs, opacity, scales, rots,
                views["view"][i], views["proj"][i], views["camera_center"][i],
                views["fov_x"][i], views["fov_y"][i],
                views["focal_x"][i], views["focal_y"][i],
                W, H, 0, raster_cfg=raster, backend="reference",
            )
            from gaussiansplattingmlx_tpu.ops import losses as L

            loss, _ = L.total_loss(
                out.color, views["target_rgb"][i], out.depth,
                views["target_depth"][i], views["depth_mask"][i],
            )
            return loss

        return jax.value_and_grad(loss_fn)(ptuple)

    return go(state.params.as_tuple(), jnp.int32(i))


@pytest.mark.heavy
def test_dp_matches_mean_of_single_steps(scene):
    """8-way DP step == single-device step on the averaged gradient, and the
    densify statistic is the MEAN OF per-view grad NORMS."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    cfg = make_cfg()
    views = stack_views(data)

    mesh = sharding.make_mesh(data_parallel=8, tile_parallel=1)
    dp_step = sharding.make_dp_train_step(cfg, W, H, 0, cfg.iterations, mesh)
    state = sharding.replicate_state(build_state(pts, cols), mesh)
    batch = sharding.replicate_views(views, mesh)
    idx = sharding.shard_view_idx(np.arange(8), mesh)
    new_state, metrics, imgs = dp_step(state, batch, idx)
    assert np.isfinite(float(metrics["loss"]))
    assert imgs.shape == (8, H, W, 3)

    # Manual average of 8 single-view grads -> same params after one Adam step.
    single = build_state(pts, cols)
    grads_sum = None
    losses = []
    norm_sum = np.zeros((single.params.capacity,), np.float64)
    for i in range(8):
        l, g = single_view_loss_and_grad(views, single, i)
        losses.append(float(l))
        gp = gaussians.GaussianParams.from_tuple(g)
        norm_sum += np.sqrt(np.sum(np.asarray(gp.xyz) ** 2, axis=1))
        g = jax.tree.map(lambda x: x / 8.0, g)
        grads_sum = g if grads_sum is None else jax.tree.map(jnp.add, grads_sum, g)

    np.testing.assert_allclose(float(metrics["loss"]), np.mean(losses), rtol=1e-5)
    # Densify statistic: mean over views of per-view gradient norms
    # (GaussianTrainer.swift:321-339 accumulates per-step ||grad_xyz||).
    np.testing.assert_allclose(
        np.asarray(new_state.grad_accum), norm_sum / 8.0, rtol=1e-4, atol=1e-9
    )
    grads = gaussians.GaussianParams.from_tuple(grads_sum)
    lrs = gaussians.learning_rates(0, cfg.iterations)
    lr_tree = gaussians.GaussianParams(
        xyz=lrs["xyz"], features_dc=lrs["features_dc"],
        features_rest=lrs["features_rest"], scales=lrs["scales"],
        rotation=lrs["rotation"], opacity=lrs["opacity"],
    )
    expect_params, _ = adam.update(single.params, grads, single.opt, lr_tree)
    np.testing.assert_allclose(
        np.asarray(new_state.params.xyz), np.asarray(expect_params.xyz),
        rtol=1e-4, atol=1e-6,
    )


@pytest.mark.heavy
def test_tile_parallel_matches_single_device(scene):
    """(data=1, tile=2) step == the plain single-device train step: loss,
    gradients (via params), and densify statistic all allclose — the SSIM
    band-seam exactness guarantee."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams[:1], images=images[:1])
    cfg = make_cfg(RASTER8)
    views = stack_views(data)

    mesh = sharding.make_mesh(
        data_parallel=1, tile_parallel=2, devices=jax.devices()[:2]
    )
    dp_step = sharding.make_dp_train_step(cfg, W, H, 0, cfg.iterations, mesh)
    state0 = build_state(pts, cols)
    state = sharding.replicate_state(state0, mesh)
    batch = sharding.replicate_views(views, mesh)
    idx = sharding.shard_view_idx([0], mesh)
    tiled_state, tiled_metrics, _ = dp_step(state, batch, idx)

    ref_step = make_train_step(cfg, W, H, 0, cfg.iterations, backend="reference")
    ref_state, ref_metrics, _ = ref_step(
        build_state(pts, cols), views, jnp.int32(0)
    )

    np.testing.assert_allclose(
        float(tiled_metrics["loss"]), float(ref_metrics["loss"]), rtol=1e-6
    )
    np.testing.assert_allclose(
        float(tiled_metrics["ssim"]), float(ref_metrics["ssim"]), rtol=1e-6
    )
    for name in ("xyz", "scales", "opacity", "features_dc"):
        np.testing.assert_allclose(
            np.asarray(getattr(tiled_state.params, name)),
            np.asarray(getattr(ref_state.params, name)),
            rtol=1e-5, atol=1e-7, err_msg=name,
        )
    np.testing.assert_allclose(
        np.asarray(tiled_state.grad_accum), np.asarray(ref_state.grad_accum),
        rtol=1e-4, atol=1e-9,
    )


@pytest.mark.heavy
def test_mesh_trainer_converges_with_densify(scene):
    """Full Trainer loop on a (data=4, tile=2) mesh: multi-step training
    improves the loss and densification grows the model under the mesh
    (capacity growth re-replicates) — multi-chip TRAINING, not just a step."""
    from gaussiansplattingmlx_tpu.train.trainer import Trainer

    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    pc = PointCloud(
        coords=pts + np.random.default_rng(3).normal(
            size=pts.shape
        ).astype(np.float32) * 0.05,
        colors=cols * 255.0,
    )
    cfg = dataclasses.replace(
        make_cfg(RASTER8),
        iterations=24, log_interval=4,
        model=ModelConfig(sh_degree=0, initial_capacity=64, max_gaussians=512),
        densify=DensifyConfig(interval=8, from_iter=8, until_iter=1000,
                              grad_threshold=1e-9, max_scale=1e9),
    )
    mesh = sharding.make_mesh(data_parallel=4, tile_parallel=2)
    trainer = Trainer(cfg, data, pc, backend="reference", mesh=mesh)
    n0 = int(trainer.state.num_active)
    log = []
    final = trainer.run(on_metrics=log.append)
    assert np.isfinite(final["loss"])
    assert final["loss"] < log[0]["loss"]
    # grad_threshold ~ 0 forces clones at every densify interval.
    assert int(trainer.state.num_active) > n0
    # State stayed replicated through densify + growth.
    assert int(trainer.state.step) == 24


def test_data_x_tile_mesh(scene):
    """(data=4, tile=2) == (data=4, tile=1): the tile split changes nothing."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams[:4], images=images[:4])
    cfg = make_cfg(RASTER8)
    views = stack_views(data)

    def run(dp, tp, ndev):
        mesh = sharding.make_mesh(dp, tp, devices=jax.devices()[:ndev])
        step = sharding.make_dp_train_step(cfg, W, H, 0, cfg.iterations, mesh)
        state = sharding.replicate_state(build_state(pts, cols), mesh)
        batch = sharding.replicate_views(views, mesh)
        idx = sharding.shard_view_idx(np.arange(4), mesh)
        return step(state, batch, idx)

    s_a, m_a, _ = run(4, 2, 8)
    s_b, m_b, _ = run(4, 1, 4)
    np.testing.assert_allclose(float(m_a["loss"]), float(m_b["loss"]), rtol=1e-6)
    for name in ("xyz", "scales", "opacity"):
        np.testing.assert_allclose(
            np.asarray(getattr(s_a.params, name)),
            np.asarray(getattr(s_b.params, name)),
            rtol=1e-5, atol=1e-7, err_msg=name,
        )
    np.testing.assert_allclose(
        np.asarray(s_a.grad_accum), np.asarray(s_b.grad_accum),
        rtol=1e-4, atol=1e-9,
    )


def test_dp_step_tile_kernel_interpret(scene):
    """The tile rasterizer kernel (Pallas interpret mode) UNDER shard_map,
    the combination mesh-mode GPU training runs: one DP step on a (2, 1)
    mesh matches the reference-backend step's loss and gradients."""
    pts, cols, cams, images = scene
    data = TrainData(cameras=cams, images=images)
    views = stack_views(data)
    mesh = sharding.make_mesh(2, 1, devices=jax.devices()[:2])

    def run(backend, raster):
        cfg = make_cfg(raster)
        step = sharding.make_dp_train_step(
            cfg, W, H, 0, cfg.iterations, mesh, backend=backend
        )
        s = sharding.replicate_state(build_state(pts, cols), mesh)
        out, m, _ = step(
            s, sharding.replicate_views(views, mesh),
            sharding.shard_view_idx(np.array([1, 4]), mesh),
        )
        return float(m["loss"]), np.asarray(out.params.xyz)

    l_k, x_k = run("triton_interpret", RASTER)
    l_ref, x_ref = run("reference", RASTER)
    np.testing.assert_allclose(l_k, l_ref, rtol=1e-5)
    np.testing.assert_allclose(x_k, x_ref, rtol=1e-4, atol=1e-7)
