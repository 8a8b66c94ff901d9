"""Multi-chip distribution: camera data-parallelism + pixel-band sharding.

The reference is strictly single-device (SURVEY §2.4: no DP/TP/PP, no
collectives of any kind) — this layer is new design.  The mesh is a plain
(data, tile) reshape of `jax.devices()`; every card of a host reaches every
other at the same rate (NVLink), so the layout follows the algorithm alone:

  * mesh axis "data": each device trains on a DIFFERENT camera view per step.
    Gaussian parameters are replicated; per-view gradients are `pmean`'d
    across the mesh — the 3DGS analogue of data parallelism.  With the reference's random
    camera sampling this is exact gradient accumulation over a batch of views
    (the single-view reference is the batch=1 special case).
  * mesh axis "tile": for very large renders, ONE camera's pixel-tile grid is
    split into horizontal bands, one band per device.  Each device rasterizes
    only its band; the bands are then `all_gather`'d and the loss is
    computed on the FULL image on every tile device, so SSIM windows crossing
    band seams see real neighbour rows, not conv zero-padding — the sharded
    loss and gradients match the single-device step exactly (see
    tests/test_sharding.py).  The all_gather transpose (psum_scatter) returns
    each band's cotangent scaled by n_tile; the `pmean` over "tile" therefore
    reconstructs the exact full-image parameter gradient.  Structurally the
    same pattern as sequence-sharded attention with KV all-gather (SURVEY §5).

Densification statistics under DP follow the reference semantics
(GaussianTrainer.swift:321-339,996-998): the accumulated quantity is the
PER-VIEW gradient norm — mean over the view batch of ||∂L_view/∂xyz|| — not
the norm of the averaged gradient (norm-of-mean < mean-of-norms would
under-densify at the reference's grad_threshold).

Built on `shard_map` so the Pallas rasterizer runs rank-identical per shard
(no vmap over pallas_call), with XLA collectives between the devices.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import TrainConfig
from ..models import gaussians
from ..models.gaussians import GaussianParams
from ..ops import losses as losses_mod
from ..render import render as render_fn
from ..train import optimizer as adam
from ..train.trainer import TrainState


def make_mesh(
    data_parallel: int = 0,
    tile_parallel: int = 1,
    devices=None,
) -> Mesh:
    """Mesh over (data, tile).  data_parallel=0 uses all remaining devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if data_parallel <= 0:
        data_parallel = n // tile_parallel
    need = data_parallel * tile_parallel
    assert need <= n, f"{data_parallel} x {tile_parallel} > {n} devices"
    # Fewer devices than available: use the first `need` (jax.devices() is
    # process-contiguous, so multi-host shards stay host-local).
    return Mesh(
        devices.reshape(-1)[:need].reshape(data_parallel, tile_parallel),
        ("data", "tile"),
    )


def make_dp_train_step(
    cfg: TrainConfig,
    image_width: int,
    image_height: int,
    sh_degree: int,
    total_iterations: int,
    mesh: Mesh,
    backend: Optional[str] = None,
    batched_views: bool = False,
) -> Callable:
    """Data-parallel train step over (state, views, view_idx).

    `views` is the full stacked view dict (replicated — every device holds all
    camera tensors and targets); `view_idx` is an int32 [data_parallel] array
    sharded over "data" selecting each device's camera for this step.  Params
    are replicated, per-view gradients pmean'd, and the Adam update
    is replicated (identical on all devices after the collective).

    With `batched_views=True` the step instead takes (state, view_batch) where
    `view_batch` is a per-step dict of [data_parallel, ...] arrays sharded
    over "data" — each device holds ONLY its own camera's tensors.  This is
    the multi-host form (parallel/multihost.py): each process materializes
    just its addressable shard of the batch, so camera targets never cross
    hosts (only gradients do).  Semantics are identical to the replicated
    form.

    Returns (new_state, metrics, images) where images is the [data_parallel,
    H, W, 3] batch of rendered full views (for previews).
    """

    tile_devices = mesh.shape["tile"]
    band_h = image_height // tile_devices
    if tile_devices > 1:
        # (A single full-height "band" has no seam; any image height works.)
        assert image_height % tile_devices == 0, (
            "tile-parallel requires image_height divisible by the tile axis"
        )
        assert band_h % cfg.raster.tile_h == 0, (
            "tile-parallel requires the band height to be a multiple of "
            "tile_h so the band tiling coincides with the full-image tiling "
            "(exactness)"
        )

    # SH-degree warmup — the same traced band mask as the single-device step
    # (gaussians.apply_sh_warmup); replicated math, no collectives.
    warmup = int(getattr(cfg.model, "sh_warmup_interval", 0))

    def per_device(state: TrainState, views: Dict, view_idx):
        if batched_views:
            # views is this device's [1, ...] slice of the per-step batch.
            take = lambda k: views[k][0]
        else:
            take = lambda k: views[k][view_idx[0]]
        active = gaussians.active_mask(state.params, state.num_active)
        band = jax.lax.axis_index("tile") * band_h

        def loss_fn(ptuple):
            params = gaussians.apply_sh_warmup(
                GaussianParams.from_tuple(ptuple), state.step, warmup,
                sh_degree,
            )
            means3d, shs, opacity, scales, rotations = gaussians.activations(
                params, active
            )
            out, aux = render_fn(
                means3d, shs, opacity, scales, rotations,
                take("view"), take("proj"), take("camera_center"),
                take("fov_x"), take("fov_y"), take("focal_x"), take("focal_y"),
                image_width, band_h, sh_degree,
                raster_cfg=cfg.raster,
                white_background=cfg.white_background,
                backend=backend,
                active=active,
                pixel_y_offset=band,
                full_image_height=image_height,
            )
            # Reassemble the full image across the tile axis and compute the
            # loss on it (identically on every tile device): exact
            # single-device loss semantics including SSIM at band seams.
            color_full = jax.lax.all_gather(out.color, "tile", axis=0, tiled=True)
            depth_full = jax.lax.all_gather(out.depth, "tile", axis=0, tiled=True)
            loss, parts = losses_mod.total_loss(
                color_full, take("target_rgb"), depth_full,
                take("target_depth"), take("depth_mask"),
                lambda_dssim=cfg.loss.lambda_dssim,
                lambda_depth=cfg.loss.lambda_depth,
                ssim_window=cfg.loss.ssim_window,
                ssim_sigma=cfg.loss.ssim_sigma,
            )
            psnr = losses_mod.psnr(color_full, take("target_rgb"))
            aux_out = {
                "psnr": psnr, "num_pairs": aux.num_pairs,
                "overflow_pairs": aux.overflow_pairs,
                "overflow_gaussians": aux.overflow_gaussians,
                "image": color_full,
            }
            return loss, (parts, aux_out)

        (loss, (parts, aux_out)), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(state.params.as_tuple())
        grads = GaussianParams.from_tuple(grads)
        # The all_gather transpose hands each device its band cotangent summed
        # over the tile group (= n_tile * the true band cotangent, since every
        # device computed the identical loss); averaging over "tile" therefore
        # yields exactly the full-image per-view gradient.
        grads_view = jax.lax.pmean(grads, "tile")
        # Reference densify statistic: per-view ||grad_xyz|| accumulated, then
        # averaged over the view batch (mean of norms, not norm of mean).
        grad_norm = jax.lax.pmean(
            jnp.sqrt(jnp.sum(grads_view.xyz * grads_view.xyz, axis=1)), "data"
        )
        # Per-LEAF all-reduces (six independent collectives, not one fused
        # tuple): SH/opacity cotangents are ready after the rasterizer
        # backward, BEFORE the projection backward that produces
        # xyz/scale/rotation grads — separate collectives give XLA's
        # latency-hiding scheduler the freedom to overlap the early ones
        # with the remaining backward compute.  At 3DGS scale the gradients
        # are tens of MB per step, so correctness of the schedule, not
        # bandwidth, is what matters here.
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, "data"), grads_view)
        loss = jax.lax.pmean(loss, "data")
        parts = jax.lax.pmean(parts, "data")

        lrs = gaussians.learning_rates(
            state.step, total_iterations,
            lr_xyz=cfg.optim.lr_xyz * cfg.optim.spatial_lr_scale,
            lr_features_dc=cfg.optim.lr_features_dc,
            lr_features_rest=cfg.optim.lr_features_rest,
            lr_scales=cfg.optim.lr_scales,
            lr_rotation=cfg.optim.lr_rotation,
            lr_opacity=cfg.optim.lr_opacity,
            xyz_lr_floor=cfg.optim.xyz_lr_floor,
        )
        lr_tree = GaussianParams(
            xyz=lrs["xyz"], features_dc=lrs["features_dc"],
            features_rest=lrs["features_rest"], scales=lrs["scales"],
            rotation=lrs["rotation"], opacity=lrs["opacity"],
        )
        new_params, new_opt = adam.update(
            state.params, grads, state.opt, lr_tree,
            beta1=cfg.optim.beta1, beta2=cfg.optim.beta2, eps=cfg.optim.eps,
            bias_correction=cfg.optim.bias_correction,
        )
        # Overflow/pair counts differ across BOTH mesh axes (each band bins
        # independently); reduce over both so the reported values are the
        # replicated globals, not an arbitrary shard's.
        overflow_pairs = jax.lax.psum(
            jax.lax.psum(aux_out["overflow_pairs"], "data"), "tile"
        )
        overflow_gaussians = jax.lax.psum(
            jax.lax.psum(aux_out["overflow_gaussians"], "data"), "tile"
        )
        overflow_acc = state.overflow_acc + jnp.stack(
            [overflow_pairs, overflow_gaussians]
        ).astype(jnp.float32)
        new_state = TrainState(
            params=new_params, opt=new_opt, num_active=state.num_active,
            grad_accum=state.grad_accum + grad_norm,
            grad_denom=state.grad_denom + 1.0,
            step=state.step + 1,
            overflow_acc=overflow_acc,
        )
        metrics = {
            "loss": loss, **parts,
            "psnr": jax.lax.pmean(aux_out["psnr"], "data"),
            # Mean pairs per VIEW: sum the per-band pair counts over "tile"
            # (one view's bands bin independently; their sum is the view's
            # full-image pair count), then average over the view batch.
            "num_pairs": jax.lax.pmean(
                jax.lax.psum(aux_out["num_pairs"], "tile"), "data"
            ),
            "overflow_pairs": overflow_pairs,
            "overflow_gaussians": overflow_gaussians,
            "overflow_pairs_acc": overflow_acc[0],
            "overflow_gaussians_acc": overflow_acc[1],
            # Gradient-attribution health (see the single-device step): the
            # accumulated grad norms are already psum'd across the mesh.
            "grad_coverage": jnp.sum(
                jnp.where(
                    jnp.arange(state.params.capacity) < state.num_active,
                    ((state.grad_accum + grad_norm) > 0).astype(jnp.float32),
                    0.0,
                )
            ) / jnp.maximum(state.num_active.astype(jnp.float32), 1.0),
        }
        # [1, H, W, 3] per data shard -> [data_parallel, H, W, 3] global.
        images = aux_out["image"][None]
        return new_state, metrics, images

    shard_fn = jax.shard_map(
        per_device,
        mesh=mesh,
        in_specs=(P(), P("data") if batched_views else P(), P("data")),
        out_specs=(P(), P(), P("data")),
        check_vma=False,
    )
    if batched_views:
        # view_idx is vestigial in batched mode; present (zeros) so the two
        # forms share one signature, but each device reads views[k][0].
        def batched(state, view_batch):
            ndata = mesh.shape["data"]
            idx = jnp.zeros((ndata,), jnp.int32)
            return shard_fn(state, view_batch, idx)

        return jax.jit(batched, donate_argnums=(0,))
    return jax.jit(shard_fn, donate_argnums=(0,))


def replicate_state(state, mesh: Mesh):
    sharding = jax.sharding.NamedSharding(mesh, P())
    return jax.device_put(state, sharding)


def replicate_views(views: Dict, mesh: Mesh) -> Dict:
    sharding = jax.sharding.NamedSharding(mesh, P())
    return {k: jax.device_put(v, sharding) for k, v in views.items()}


def shard_view_idx(view_idx, mesh: Mesh):
    """int32 [data_parallel] view selector, sharded over the data axis."""
    sharding = jax.sharding.NamedSharding(mesh, P("data"))
    return jax.device_put(jnp.asarray(view_idx, jnp.int32), sharding)
