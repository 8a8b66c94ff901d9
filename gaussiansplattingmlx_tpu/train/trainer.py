"""Training orchestration: jitted train step + host-side loop.

Counterpart of GaussianTrainer.startTrain (Trainer/GaussianTrainer.swift:
934-1129), redesigned for XLA: ONE jit-compiled function per capacity bucket
executes activation -> render -> loss -> backward -> Adam entirely on device
(the reference's per-iteration `.item()` syncs and manual `eval` batching
disappear; the host only syncs when it logs).  Densification is a second
jitted function over the same fixed-capacity buffers; capacity grows by
doubling on the host, so recompiles are O(log N) per run.
"""

from __future__ import annotations

import dataclasses
import json
import time
from functools import partial
from pathlib import Path
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import TrainConfig
from ..data.dataset import TrainData
from ..models import gaussians
from ..models.gaussians import GaussianParams, INACTIVE_OPACITY
from ..ops import losses as losses_mod
from ..render import render as render_fn
from ..utils.point_cloud import PointCloud
from . import densify as densify_mod
from . import optimizer as adam


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    opt: adam.AdamState
    num_active: jax.Array  # [] int32
    grad_accum: jax.Array  # [capacity]
    grad_denom: jax.Array  # [] float32
    step: jax.Array  # [] int32
    # Running (pairs, gaussians) overflow totals since run start, accumulated
    # IN-GRAPH every step so overflow between log boundaries cannot be missed
    # (the trainer only fetches metrics at log intervals; a per-step host
    # check would serialize dispatch).  float32: pair counts can exceed int32
    # when accumulated across steps.
    overflow_acc: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((2,), jnp.float32)
    )


VIEW_KEYS = ("view", "proj", "camera_center", "fov_x", "fov_y", "focal_x",
             "focal_y", "target_rgb", "target_depth", "depth_mask")


def stack_views(data: TrainData) -> Dict[str, jnp.ndarray]:
    """Stack all per-view tensors to device arrays indexed by view id."""
    stacked = stack_views_host(data, range(data.num_views))
    return {k: jnp.asarray(v) for k, v in stacked.items()}


def stack_views_host(data: TrainData, view_ids) -> Dict[str, np.ndarray]:
    """Stack the given views' tensors on the HOST (numpy), in view_ids order.

    The multi-host batched path keeps only this process's views in its store —
    camera targets for other hosts never materialize here."""
    stacked = {k: [] for k in VIEW_KEYS}
    for i in view_ids:
        t = data.view_tensors(int(i))
        for k in VIEW_KEYS:
            stacked[k].append(np.asarray(t[k], np.float32))
    return {k: np.stack(v) for k, v in stacked.items()}


def make_train_step(
    cfg: TrainConfig,
    image_width: int,
    image_height: int,
    sh_degree: int,
    total_iterations: int,
    backend: Optional[str] = None,
) -> Callable:
    """Build the jitted train step.  Retraces per parameter capacity."""

    warmup = int(getattr(cfg.model, "sh_warmup_interval", 0))

    @partial(jax.jit, donate_argnums=(0,))
    def train_step(state: TrainState, views: Dict, view_idx):
        take = lambda k: views[k][view_idx]
        active = gaussians.active_mask(state.params, state.num_active)

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
                image_width, image_height, sh_degree,
                raster_cfg=cfg.raster,
                white_background=cfg.white_background,
                backend=backend,
                active=active,
            )
            loss, parts = losses_mod.total_loss(
                out.color, take("target_rgb"), out.depth, take("target_depth"),
                take("depth_mask"),
                lambda_dssim=cfg.loss.lambda_dssim,
                lambda_depth=cfg.loss.lambda_depth,
                ssim_window=cfg.loss.ssim_window,
                ssim_sigma=cfg.loss.ssim_sigma,
            )
            return loss, (parts, out, aux)

        (loss, (parts, out, aux)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params.as_tuple()
        )
        grads = GaussianParams.from_tuple(grads)

        # Densification statistic: accumulate ||d xyz|| per point
        # (accum_grad_norm kernel, GaussianTrainer.swift:321-339,724-742).
        grad_norm = jnp.sqrt(jnp.sum(grads.xyz * grads.xyz, axis=1))
        grad_accum = state.grad_accum + grad_norm
        grad_denom = state.grad_denom + 1.0

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
        overflow_acc = state.overflow_acc + jnp.stack(
            [aux.overflow_pairs, aux.overflow_gaussians]
        ).astype(jnp.float32)
        new_state = TrainState(
            params=new_params, opt=new_opt, num_active=state.num_active,
            grad_accum=grad_accum, grad_denom=grad_denom, step=state.step + 1,
            overflow_acc=overflow_acc,
        )
        metrics = {
            "loss": loss, "l1": parts["l1"], "ssim": parts["ssim"],
            "depth": parts["depth"],
            "psnr": losses_mod.psnr(out.color, take("target_rgb")),
            "num_pairs": aux.num_pairs,
            "overflow_pairs": aux.overflow_pairs,
            "overflow_gaussians": aux.overflow_gaussians,
            # Inclusive run totals — what _maybe_grow_raster watches, so an
            # overflow on any non-logged step still triggers auto-grow.
            "overflow_pairs_acc": overflow_acc[0],
            "overflow_gaussians_acc": overflow_acc[1],
            # Gradient-attribution health: fraction of ACTIVE gaussians with
            # any accumulated position gradient since the last densify.  The
            # round-4 denormal-flush bug routed every gradient to gaussian 0
            # (coverage ~0) while the forward stayed perfect — this metric
            # makes that failure class visible at the next log line instead
            # of after thousands of wasted iterations.
            "grad_coverage": jnp.sum(
                jnp.where(active, (grad_accum > 0).astype(jnp.float32), 0.0)
            ) / jnp.maximum(state.num_active.astype(jnp.float32), 1.0),
        }
        # The rendered image rides along (already computed on device); the
        # host fetches it only at preview intervals — the counterpart of the
        # reference's pushImageData every 20 iters (GaussianTrainer.swift:
        # 1003-1044).
        return new_state, metrics, out.color

    return train_step


def make_densify_step(
    cfg: TrainConfig,
    camera_centers=None,
    allow_densify: bool = True,
) -> Callable:
    """allow_densify=False builds the PRUNE-ONLY maintenance variant
    (DensifyConfig.prune_until_iter): no split/clone, and Adam moments are
    always carried by exact gather remap (no new rows exist, so the remap is
    lossless) regardless of reset_optimizer_state."""

    @partial(jax.jit, donate_argnums=(0,))
    def densify_step(state: TrainState, rng_key):
        new_params, stats, gather_idx, noise_mode = densify_mod.split_and_prune(
            state.params, state.num_active, state.grad_accum, state.grad_denom,
            rng_key,
            allow_densify=allow_densify,
            grad_threshold=cfg.densify.grad_threshold,
            max_scale=cfg.densify.max_scale,
            min_opacity=cfg.densify.min_opacity,
            split_scale_div=cfg.densify.split_scale_div,
            split_noise_factor=cfg.densify.split_noise_factor,
            clone_noise_std=cfg.densify.clone_noise_std,
            max_gaussians=cfg.model.max_gaussians,
            prune_world_scale=cfg.densify.prune_world_scale,
            prune_near_cameras=cfg.densify.prune_near_cameras,
            camera_centers=camera_centers,
            prune_needle_ratio=cfg.densify.prune_needle_ratio,
        )
        if cfg.densify.reset_optimizer_state and allow_densify:
            # Reference behaviour: fresh Adam after densify
            # (GaussianTrainer.swift:1105-1110).
            new_opt = adam.init(new_params)
        else:
            new_opt = adam.AdamState(
                m=densify_mod.remap_optimizer_moments(state.opt.m, gather_idx, noise_mode),
                v=densify_mod.remap_optimizer_moments(state.opt.v, gather_idx, noise_mode),
                count=state.opt.count,
            )
        new_state = TrainState(
            params=new_params, opt=new_opt, num_active=stats.num_active,
            grad_accum=jnp.zeros_like(state.grad_accum),
            grad_denom=jnp.zeros_like(state.grad_denom),
            step=state.step,
            overflow_acc=state.overflow_acc,
        )
        return new_state, stats

    return densify_step


def make_opacity_reset_step(cfg: TrainConfig) -> Callable:
    """Jitted INRIA-style opacity reset (DensifyConfig.opacity_reset_interval):
    clamp live opacities to <= opacity_reset_value and zero the opacity Adam
    moments so the optimizer does not immediately re-saturate them."""

    @partial(jax.jit, donate_argnums=(0,))
    def opacity_reset_step(state: TrainState):
        new_params = densify_mod.reset_opacity(
            state.params, state.num_active, cfg.densify.opacity_reset_value
        )
        zero_op = lambda t: dataclasses.replace(
            t, opacity=jnp.zeros_like(t.opacity)
        )
        new_opt = adam.AdamState(
            m=zero_op(state.opt.m), v=zero_op(state.opt.v),
            count=state.opt.count,
        )
        return dataclasses.replace(state, params=new_params, opt=new_opt)

    return opacity_reset_step


def grow_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """Host-side buffer growth (pads with inactive slots); triggers one
    recompile of the jitted steps at the new bucket."""
    old = state.params.capacity
    if new_capacity <= old:
        return state
    pad_n = new_capacity - old

    def pad(x, fill=0.0):
        widths = [(0, pad_n)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths, constant_values=fill)

    quat_pad = jnp.tile(jnp.asarray([[1.0, 0, 0, 0]], jnp.float32), (pad_n, 1))
    params = GaussianParams(
        xyz=pad(state.params.xyz),
        features_dc=pad(state.params.features_dc),
        features_rest=pad(state.params.features_rest),
        scales=pad(state.params.scales),
        # identity quats: zero quats NaN the normalize VJP
        rotation=jnp.concatenate([state.params.rotation, quat_pad], axis=0),
        opacity=pad(state.params.opacity, INACTIVE_OPACITY),
    )
    opt = adam.AdamState(
        m=jax.tree.map(pad, state.opt.m),
        v=jax.tree.map(pad, state.opt.v),
        count=state.opt.count,
    )
    return TrainState(
        params=params, opt=opt, num_active=state.num_active,
        grad_accum=pad(state.grad_accum), grad_denom=state.grad_denom,
        step=state.step, overflow_acc=state.overflow_acc,
    )


class Trainer:
    """Host-side loop: camera sampling, densify cadence, snapshots, metrics,
    checkpoints, early stopping (TrainView/GaussianTrainer orchestration)."""

    def __init__(
        self,
        config: TrainConfig,
        data: TrainData,
        point_cloud: PointCloud,
        backend: Optional[str] = None,
        mesh=None,
        batched_views: Optional[bool] = None,
    ):
        """mesh: optional jax.sharding.Mesh with ("data", "tile") axes — when
        given, training runs the data+tile-sharded step (parallel/sharding.py)
        with params replicated and `mesh.shape["data"]` camera views consumed
        per iteration.  When mesh is None but config.parallel requests
        parallelism (or this is a multi-process run), the Trainer builds the
        mesh itself.  The reference has no counterpart (SURVEY §2.4).

        batched_views: use the multi-host-safe batched step form — each data
        shard's camera tensors are assembled per step from a HOST-LOCAL view
        store (parallel/multihost.py) instead of a replicated all-views stack,
        so camera pixels never cross hosts.  Defaults to on under
        jax.process_count() > 1, off otherwise; the two forms are exactly
        equivalent (tests/test_multihost.py densify-equivalence)."""
        self.cfg = config
        self.data = data
        self.backend = backend
        if mesh is None:
            par = config.parallel
            multiproc = jax.process_count() > 1
            if par.data_parallel != 1 or par.tile_parallel != 1 or multiproc:
                from ..parallel import sharding as _sharding

                dp = par.data_parallel
                if multiproc and dp == 1 and par.tile_parallel == 1:
                    # Multi-process with the default (single-device) config:
                    # span ALL devices — a 1-device mesh would leave every
                    # other process without addressable shards.
                    dp = 0
                mesh = _sharding.make_mesh(dp, par.tile_parallel)
        self.mesh = mesh
        self.rng = np.random.default_rng(config.seed)
        self.key = jax.random.PRNGKey(config.seed)

        pc = point_cloud.random_sample(config.init_points, seed=config.seed)
        capacity = max(config.model.initial_capacity, _next_pow2(pc.size))
        params, n = gaussians.create_from_points(
            pc.coords, pc.colors / 255.0,
            sh_degree=config.model.sh_degree,
            capacity=capacity,
            init_opacity=config.model.init_opacity,
            dist2_floor=config.model.dist2_floor,
            knn_k=config.model.knn_k,
        )
        self.state = TrainState(
            params=params,
            opt=adam.init(params),
            num_active=jnp.int32(n),
            grad_accum=jnp.zeros((capacity,), jnp.float32),
            grad_denom=jnp.float32(0.0),
            step=jnp.int32(0),
        )
        self.batched_views = False
        if mesh is not None:
            # Late import: parallel.sharding imports TrainState from here.
            from ..parallel import multihost as _multihost
            from ..parallel import sharding as _sharding

            self._sharding = _sharding
            self._multihost = _multihost
            self.data_parallel = mesh.shape["data"]
            self.batched_views = (
                jax.process_count() > 1
                if batched_views is None else bool(batched_views)
            )
            self.state = _sharding.replicate_state(self.state, mesh)
            if self.batched_views:
                self._build_local_store()
                self.views = None
            else:
                self.views = _sharding.replicate_views(stack_views(data), mesh)
        else:
            self.views = stack_views(data)
        self.out_dir = Path(config.output_dir)
        self._build_train_step()
        cam_centers = None
        if config.densify.prune_near_cameras > 0:
            if jax.process_count() > 1:
                # Per-process camera subsets would give each process a
                # different prune mask and break the replicated-state
                # bit-identity invariant (tests/test_multihost.py).
                raise NotImplementedError(
                    "prune_near_cameras requires the full camera set on "
                    "every process; unsupported under multihost data loading"
                )
            cam_centers = jnp.stack([
                jnp.asarray(c.tensors()["camera_center"]).reshape(3)
                for c in data.cameras
            ])
        self.densify_step = make_densify_step(config, cam_centers)
        self.prune_step = (
            make_densify_step(config, cam_centers, allow_densify=False)
            if config.densify.prune_until_iter > config.densify.until_iter
            else None
        )
        self.opacity_reset_step = make_opacity_reset_step(config)
        if (
            config.densify.opacity_reset_interval > 0
            and config.densify.reset_optimizer_state
        ):
            import sys

            # Precaution (docs/DESIGN.md round-4 postscript): the
            # reference's per-densify Adam re-init (no bias correction)
            # amplifies the first post-densify step ~3.16x lr; right after
            # an opacity reset the gradients are small and noisy, so the
            # amplified steps act on a fragile state.  INRIA pairs resets
            # with moment carry-over instead.
            print(
                "NOTE: opacity_reset_interval with "
                "reset_optimizer_state=True (reference Adam semantics) "
                "amplifies post-densify steps on a freshly-reset model — "
                "INRIA pairs resets with moment carry-over "
                "(reset_optimizer_state=False, implemented)",
                file=sys.stderr, flush=True,
            )
        self.history: list = []
        # Accumulated overflow already warned about / grown for (host mirror
        # of TrainState.overflow_acc[0] at the last handling point).
        self._overflow_handled = 0.0
        # Auto-shrink window state: the configured budget is the shrink floor
        # (auto-shrink only undoes auto-GROW overshoot), peak/obs track logged
        # num_pairs since the last budget change.
        self._initial_max_pairs = config.raster.max_pairs
        self._pairs_peak = 0.0
        self._pairs_obs = 0

    def _build_train_step(self):
        # Rebuilding the step means the next call recompiles (minutes at
        # flagship scale): refresh the supervisor heartbeat first so the
        # compile window cannot read as a stall, regardless of caller.
        self._touch_heartbeat()
        cfg, data = self.cfg, self.data
        if self.mesh is not None:
            self.train_step = self._sharding.make_dp_train_step(
                cfg, data.width, data.height,
                cfg.model.sh_degree, cfg.iterations, self.mesh, self.backend,
                batched_views=self.batched_views,
            )
        else:
            self.train_step = make_train_step(
                cfg, data.width, data.height,
                cfg.model.sh_degree, cfg.iterations, self.backend,
            )

    def _build_local_store(self):
        """Batched-views mode: contiguous per-shard view ranges + a host-local
        tensor store covering only THIS process's shards' views.

        Every process draws the full per-shard `chosen` id vector from the
        SAME host RNG stream (deterministic across processes and across
        process counts — the basis of the densify-equivalence test) but
        materializes tensors only for its own shards."""
        ndata = self.data_parallel
        nv = self.data.num_views
        per = -(-nv // ndata)  # ceil; wrap-padded so shards sample uniformly
        self.shard_views = [
            (np.arange(s * per, (s + 1) * per) % nv).astype(np.int64)
            for s in range(ndata)
        ]
        self.local_shards, _ = self._multihost.local_data_shards(self.mesh)
        if len(self.local_shards) == 0:
            raise ValueError(
                f"process {jax.process_index()} owns no mesh devices "
                f"(mesh={dict(self.mesh.shape)}, "
                f"{jax.process_count()} processes) — size the mesh so every "
                "process holds at least one 'data' shard (data_parallel=0 "
                "spans all devices)"
            )
        local_ids = np.unique(
            np.concatenate([self.shard_views[s] for s in self.local_shards])
        )
        self.local_ids = local_ids
        self._local_row = {int(g): i for i, g in enumerate(local_ids)}
        self.local_store = stack_views_host(self.data, local_ids)

    def _batched_step(self):
        """One batched-views step: sample per-shard global view ids, assemble
        this process's rows, run the sharded step.  Returns (chosen, metrics,
        images)."""
        ndata = self.data_parallel
        chosen = np.asarray(
            [
                self.shard_views[s][
                    int(self.rng.integers(0, len(self.shard_views[s])))
                ]
                for s in range(ndata)
            ],
            np.int64,
        )
        rows = np.asarray(
            [self._local_row[int(chosen[s])] for s in self.local_shards],
            np.int64,
        )
        local_batch = {k: v[rows] for k, v in self.local_store.items()}
        batch = self._multihost.make_global_view_batch(local_batch, self.mesh)
        self.state, metrics, images = self.train_step(self.state, batch)
        return chosen, metrics, images

    @property
    def is_writer(self) -> bool:
        """Only process 0 writes previews/snapshots/checkpoints/curves."""
        return jax.process_index() == 0

    def _maybe_grow_raster(self, metrics: Dict) -> None:
        """Overflow is a handled condition: warn + double the truncating
        capacity (recompile at the new static shape), up to config limits.

        Watches the IN-GRAPH accumulated overflow total (TrainState.
        overflow_acc, surfaced as overflow_pairs_acc) rather than the logged
        step's instantaneous count, so overflow that occurs and clears between
        log boundaries still triggers growth."""
        import sys

        r = self.cfg.raster
        if not r.auto_grow:
            return
        # Binning duplicates footprints exactly (ops/binning.py); the only
        # truncating capacity left is the global pair budget.
        acc = metrics.get("overflow_pairs_acc", metrics.get("overflow_pairs", 0))
        new_overflow = acc - self._overflow_handled
        if new_overflow <= 0:
            self._maybe_shrink_raster(metrics)
            return
        if r.max_pairs < r.max_pairs_limit:
            # Demand-based growth: num_pairs + overflow_pairs is the TRUE pair
            # demand of the logged step (ops/binning.py:161-164), so when the
            # logged step itself overflowed, grow to a snug 1.3x margin over
            # demand instead of blindly doubling (a 0.1% overflow should not
            # buy a 2x budget that taxes every later binning pass).  A 1.25x
            # minimum growth factor keeps the recompile count geometric, and
            # when the overflow happened only on a NON-logged step (logged
            # overflow_pairs == 0, demand unknown) fall back to doubling.
            step_overflow = float(metrics.get("overflow_pairs", 0.0))
            if step_overflow > 0:
                demand = float(metrics.get("num_pairs", 0.0)) + step_overflow
                target = max(int(demand * 1.3), int(r.max_pairs * 1.25))
            else:
                target = r.max_pairs * 2
            target = ((target + 511) // 512) * 512
            new = dataclasses.replace(
                r, max_pairs=min(max(target, r.max_pairs + 512),
                                 r.max_pairs_limit)
            )
            print(
                f"WARNING: pair-budget overflow by step {int(self.state.step)} "
                f"(pairs dropped since last growth {int(new_overflow)}, "
                f"gaussians affected this step "
                f"{int(metrics.get('overflow_gaussians', 0))}); "
                f"growing max_pairs {r.max_pairs}->{new.max_pairs} (recompile)",
                file=sys.stderr, flush=True,
            )
            self.cfg = dataclasses.replace(self.cfg, raster=new)
            self._build_train_step()
        else:
            print(
                f"WARNING: pair-budget overflow by step {int(self.state.step)} "
                f"but max_pairs_limit reached (max_pairs={r.max_pairs}); "
                f"output is truncated — raise raster limits",
                file=sys.stderr, flush=True,
            )
        self._overflow_handled = acc
        self._pairs_peak = 0.0
        self._pairs_obs = 0

    def _maybe_shrink_raster(self, metrics: Dict) -> None:
        """Shrink the pair budget back toward the observed peak once it is
        clearly oversized (auto-grow overshoot past a densify peak).

        Trajectory-neutral: with overflow at zero the rendered outputs are
        bit-identical across budgets (binning is exact and the stable sort
        keeps real rows in the same order regardless of padding), so only
        step cost changes.  Hysteresis: >= 8 logged observations since the
        last budget change, a 2.2x peak margin before shrinking, landing at
        peak*1.4, never below the user-configured budget."""
        import sys

        r = self.cfg.raster
        if not r.auto_shrink:
            return
        self._pairs_peak = max(
            self._pairs_peak, float(metrics.get("num_pairs", 0.0))
        )
        self._pairs_obs += 1
        floor = min(self._initial_max_pairs, r.max_pairs)
        if (
            self._pairs_obs < 8
            or r.max_pairs <= floor
            or self._pairs_peak * 2.2 >= r.max_pairs
        ):
            return
        snug = max(
            ((int(self._pairs_peak * 1.4) + 511) // 512) * 512, floor
        )
        if snug >= r.max_pairs:
            return
        print(
            f"pair budget underused by step {int(self.state.step)} "
            f"(window peak {int(self._pairs_peak)} vs budget {r.max_pairs}); "
            f"shrinking max_pairs {r.max_pairs}->{snug} (recompile)",
            file=sys.stderr, flush=True,
        )
        self.cfg = dataclasses.replace(
            self.cfg, raster=dataclasses.replace(r, max_pairs=snug)
        )
        self._build_train_step()
        self._pairs_peak = 0.0
        self._pairs_obs = 0

    def _touch_heartbeat(self):
        """Refresh the supervisor heartbeat (metrics.jsonl mtime) before a
        long XLA recompile: budget/capacity growth rebuilds the train step,
        and a 5+ minute compile with a stale heartbeat reads as a stall to
        scripts/supervise_train.py — which would kill and restart into the
        SAME compile, looping until max_restarts."""
        if self.cfg.output_dir and self.is_writer:
            try:
                (self.out_dir / "metrics.jsonl").touch()
            except OSError:
                pass

    def next_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def run(
        self,
        iterations: Optional[int] = None,
        on_metrics: Optional[Callable] = None,
    ) -> Dict:
        cfg = self.cfg
        iterations = iterations if iterations is not None else cfg.iterations
        last_log = time.time()
        start = int(self.state.step)  # nonzero when resumed from a checkpoint
        last_step = start
        final = {}
        for it in range(start + 1, iterations + 1):
            if self.mesh is not None and self.batched_views:
                chosen, metrics, images = self._batched_step()
                view_idx = int(chosen[0])
                image = None
            elif self.mesh is not None:
                idxs = self.rng.integers(
                    0, self.data.num_views, size=self.data_parallel
                )
                view_idx = int(idxs[0])
                self.state, metrics, images = self.train_step(
                    self.state, self.views,
                    self._sharding.shard_view_idx(idxs, self.mesh),
                )
                # Indexing the sharded [data, H, W, 3] output directly would
                # dispatch an eager gather over the mesh; fetch to host only
                # when a preview is actually written.
                image = None
            else:
                view_idx = int(self.rng.integers(0, self.data.num_views))
                self.state, metrics, image = self.train_step(
                    self.state, self.views, jnp.int32(view_idx)
                )

            if it % cfg.preview_interval == 0 and cfg.output_dir and self.is_writer:
                if image is None:
                    image = self._fetch_preview_image(images)
                self.save_preview(it, image, view_idx)
            if it % cfg.snapshot_interval == 0 and cfg.output_dir:
                self.save_snapshot(it)

            in_densify = cfg.densify.from_iter <= it <= cfg.densify.until_iter
            in_prune_only = (
                self.prune_step is not None
                and cfg.densify.until_iter < it <= cfg.densify.prune_until_iter
            )
            if it % cfg.densify.interval == 0 and (in_densify or in_prune_only):
                step_fn = self.densify_step if in_densify else self.prune_step
                self.state, stats = step_fn(self.state, self.next_key())
                if self.mesh is not None:
                    # Keep the state replicated across the mesh after the
                    # (unsharded) densify gather/scatter.
                    self.state = self._sharding.replicate_state(self.state, self.mesh)
                self.maybe_grow()

            if (
                cfg.densify.opacity_reset_interval > 0
                and it % cfg.densify.opacity_reset_interval == 0
                and it <= cfg.densify.until_iter
            ):
                self.state = self.opacity_reset_step(self.state)
                if self.mesh is not None:
                    self.state = self._sharding.replicate_state(self.state, self.mesh)

            if it % cfg.log_interval == 0 or it == iterations:
                m = {k: float(v) for k, v in metrics.items()}
                self._maybe_grow_raster(m)
                if (
                    m.get("grad_coverage", 1.0) < 0.01
                    and int(self.state.num_active) > 1000
                ):
                    import sys

                    print(
                        f"WARNING: grad_coverage "
                        f"{m['grad_coverage']:.4f} at step {it} — almost no "
                        "gaussians receive gradients; training is likely "
                        "broken (see docs/DESIGN.md round-4 postscript)",
                        file=sys.stderr, flush=True,
                    )
                now = time.time()
                m["iters_per_s"] = (it - last_step) / max(now - last_log, 1e-9)
                m["num_active"] = int(self.state.num_active)
                m["iteration"] = it
                last_log, last_step = now, it
                self.history.append(m)
                final = m
                if on_metrics:
                    on_metrics(m)
                if m["loss"] < cfg.early_stop_loss:
                    break
            if cfg.checkpoint_interval and it % cfg.checkpoint_interval == 0 and cfg.output_dir:
                self.save_checkpoint(it)
        return final

    def maybe_grow(self):
        cap = self.state.params.capacity
        n = int(self.state.num_active)
        if n > 0.85 * cap and cap < self.cfg.model.max_gaussians:
            new_cap = min(cap * 2, _next_pow2(self.cfg.model.max_gaussians))
            self._touch_heartbeat()
            self.state = grow_capacity(self.state, new_cap)
            if self.mesh is not None:
                self.state = self._sharding.replicate_state(self.state, self.mesh)

    def _fetch_preview_image(self, images):
        """First data shard's rendered view.  Multi-process: read only an
        ADDRESSABLE shard (device_get on the global sharded array would need
        non-addressable transfers); on the host-contiguous mesh process 0's
        first shard is data index 0, matching view_idx."""
        if jax.process_count() == 1:
            return jax.device_get(images)[0]
        return np.asarray(images.addressable_shards[0].data)[0]

    def save_preview(self, iteration: int, image, view_idx: int):
        """Rendered/GT preview pair (TrainStatusView counterpart)."""
        from PIL import Image as PILImage

        d = self.out_dir / "previews"
        d.mkdir(parents=True, exist_ok=True)
        rendered = np.clip(np.asarray(image) * 255.0, 0, 255).astype(np.uint8)
        gt = np.clip(self.data.images[view_idx] * 255.0, 0, 255).astype(np.uint8)
        pair = np.concatenate([rendered, gt], axis=1)
        PILImage.fromarray(pair).save(d / f"iter_{iteration:06d}_v{view_idx}.png")

    def save_loss_curve(self, path=None):
        """Loss/PSNR chart (LossChartView counterpart).  Skipped, with a
        note, where matplotlib is not installed."""
        import sys

        try:
            import matplotlib
        except ImportError:
            print("NOTE: matplotlib not installed; no loss_curve.png",
                  file=sys.stderr, flush=True)
            return

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if not self.history or not self.is_writer:
            return
        its = [m["iteration"] for m in self.history]
        fig, ax1 = plt.subplots(figsize=(8, 4))
        ax1.plot(its, [m["loss"] for m in self.history], label="loss", color="tab:red")
        ax1.set_xlabel("iteration")
        ax1.set_ylabel("loss")
        ax2 = ax1.twinx()
        ax2.plot(its, [m["psnr"] for m in self.history], label="psnr", color="tab:blue")
        ax2.set_ylabel("psnr (dB)")
        fig.tight_layout()
        out = path if path else self.out_dir / "loss_curve.png"
        fig.savefig(out, dpi=100)
        plt.close(fig)

    def save_snapshot(self, iteration: int):
        from ..data import ply

        if not self.is_writer:
            return
        n = int(self.state.num_active)
        p = jax.device_get(self.state.params)
        ply.write_gaussian_ply(
            self.out_dir / f"iteration_{iteration}.ply",
            p.xyz[:n], p.features_dc[:n], p.features_rest[:n],
            p.opacity[:n], p.scales[:n], p.rotation[:n],
        )

    def save_checkpoint(self, iteration: int):
        from . import checkpoint

        if not self.is_writer:
            return
        checkpoint.save(
            self.out_dir / f"ckpt_{iteration}.npz", self.state, self.cfg,
            host_rng=self.rng, jax_key=self.key,
        )

    def restore_checkpoint(self, path):
        from . import checkpoint

        self.state, host_rng, jax_key = checkpoint.load(path)
        if host_rng is not None:
            self.rng = host_rng
        if jax_key is not None:
            self.key = jax_key
        # Overflow already accumulated before the checkpoint was handled then
        # (the saved config reflects any growth); don't re-warn/re-grow for it.
        self._overflow_handled = float(np.asarray(self.state.overflow_acc)[0])
        # Auto-grown raster capacities (max_pairs / R) are runtime state: the
        # checkpoint's config records them at save time.  Adopt any that are
        # larger than the current config so a resumed run does not re-truncate
        # (and re-grow) its way through the same overflows — without this,
        # resume is not equivalent to the uninterrupted run.
        ckpt_cfg = checkpoint.load_config(path)
        if ckpt_cfg is not None:
            r, cr = self.cfg.raster, ckpt_cfg.raster
            if cr.max_pairs > r.max_pairs:
                self.cfg = dataclasses.replace(
                    self.cfg,
                    raster=dataclasses.replace(r, max_pairs=cr.max_pairs),
                )
                self._build_train_step()
        if self.mesh is not None:
            self.state = self._sharding.replicate_state(self.state, self.mesh)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p
