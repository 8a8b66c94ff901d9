"""Single source of truth for every hyperparameter and constant of the framework.

The reference scatters its configuration between SwiftUI state and hard-coded
Swift defaults (see /root/reference GaussianSplattingMlx/UI/TrainView.swift:206-215,
Trainer/GaussianTrainer.swift:277-300, Trainer/GaussianModel.swift:56-65,
Trainer/CameraUtil.swift:21-22).  Here everything lives in explicit dataclasses
so a training run is fully described by one `TrainConfig`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RasterizerConfig:
    """Static-shape rasterizer / tile-binning configuration.

    The reference computes `totalPairs` and `maxTilePairs` with host syncs
    (GaussianRenderer.swift:398-409,462) which is impossible under `jax.jit`;
    instead we use static capacities with overflow reporting.
    """

    # Pixel tile size.  The reference trains with a 4x4 grid of giant tiles
    # (ColmapDataLoader.swift:494-499) and renders with 64x64.  16x16 is the
    # original 3DGS CUDA rasterizer's block: one kernel program per tile
    # holds a (256, chunk_size) working set in registers.  The kernel needs
    # tile_h * tile_w and chunk_size to be powers of two.
    tile_h: int = 16
    tile_w: int = 16
    # Global (gaussian, tile) pair budget for the depth sort — the ONE
    # truncating capacity.  Binning reports overflow_pairs when the exact
    # pair total exceeds it.
    max_pairs: int = 2 ** 20  # 1M pairs
    # Overflow is a handled condition, not just a counter: when the Trainer
    # observes overflow_pairs > 0 it warns loudly and doubles max_pairs (one
    # recompile), up to the limit.  The reference never truncates — its pair
    # list is exact at dynamic cost (GaussianRenderer.swift:398-409); static
    # shapes + exact duplication + auto-growth is the jit-compatible
    # equivalent.
    auto_grow: bool = True
    max_pairs_limit: int = 2 ** 23
    # Undo auto-grow overshoot: campaigns that doubled through a densify peak
    # keep paying peak-sized binning forever (every stage pays for the full
    # static budget).  Rendering is budget-independent while overflow is zero
    # (exact binning; stable sort keeps real rows in order), so the Trainer
    # shrinks back toward the observed peak at a log boundary — never below
    # the configured max_pairs, with a 2.2x hysteresis margin against
    # re-growth thrash.
    auto_shrink: bool = True
    # Gaussian records each tile program composites per step of its march
    # (ops/tile_raster.py).
    chunk_size: int = 32
    # Compositing constants (tile_global_kernels.slang:453-455,599).
    alpha_clamp: float = 0.99
    transmittance_eps: float = 1e-4
    undo_denom_floor: float = 1e-6
    # Projection constants (gaussian_projection_screen_shared.slang).
    ndc_w_eps: float = 1e-6
    z_cull: float = 0.2  # gaussian_projection_kernels.slang:63
    cov2d_dilation: float = 0.3  # low-pass filter added to cov2d diagonal
    tanfov_clip: float = 1.3
    radius_eigen_eps: float = 1e-5
    quat_norm_eps: float = 1e-8
    # Rasterizer (render.resolve_backend): "auto" is the compiled tile
    # kernel on a GPU and an error elsewhere; "reference" (the pure-JAX
    # oracle) and "triton_interpret" (the kernel in Pallas interpret mode)
    # run anywhere, but only when named.
    backend: str = "auto"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 4  # TrainView.swift:171
    init_opacity: float = 0.1  # GaussianModel.swift:114
    knn_k: int = 3  # GaussianModel.swift:106
    dist2_floor: float = 1e-7  # GaussianModel.swift:105-108
    # Fixed parameter capacity (number of Gaussian slots).  Buffers are padded
    # to the next capacity bucket; growth doubles capacity so XLA recompiles
    # only O(log) times over a run.
    initial_capacity: int = 2 ** 14
    max_gaussians: int = 1_000_000  # GaussianTrainer.swift:300
    # INRIA-style SH-degree warmup (no reference counterpart: the reference
    # trains all SH bands from iteration 0).  When > 0, band d of
    # features_rest only receives signal from iteration d * sh_warmup_interval
    # onward (oneupSHdegree every N iters).  With the reference's UNNORMALIZED
    # SH view directions (GaussianTrainer.swift sh evaluation), degree-4 basis
    # terms scale like |dir|^4 — letting them move from iteration 0 makes
    # early color steps violently view-dependent and destabilizes SH4 runs.
    # Implemented as a traced mask on features_rest inside the jitted step
    # (zero forward contribution AND zero gradient for inactive bands), so
    # warmup causes no recompiles.  0 disables (reference behaviour).
    sh_warmup_interval: int = 0


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Adam exactly as the reference wires MLXOptimizers.Adam
    (GaussianTrainer.swift:941-945): no bias correction, eps inside the
    denominator, per-parameter learning rates."""

    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-15
    bias_correction: bool = False
    # Per-parameter LR table (GaussianModel.swift:56-65); xyz decays linearly
    # from lr_xyz to lr_xyz*0.01 over the run.
    lr_xyz: float = 1.6e-4
    lr_features_dc: float = 2.5e-3
    lr_features_rest: float = 2.5e-3 / 20.0
    lr_scales: float = 5e-3
    lr_rotation: float = 1e-3
    lr_opacity: float = 2.5e-2
    xyz_lr_floor: float = 0.01  # max(1 - t, 0.01)
    # INRIA-style position-LR scene scaling (no reference counterpart: the
    # reference uses the raw table on every scene).  The effective position
    # LR is lr_xyz * spatial_lr_scale; INRIA sets it to ~1.1x the camera
    # bounding-sphere radius so position steps are proportional to scene
    # size.  1.0 keeps reference behaviour.
    spatial_lr_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """Split/clone/prune rules (GaussianTrainer.swift:293-300,766-908)."""

    interval: int = 100
    from_iter: int = 500
    until_iter: int = 15000
    grad_threshold: float = 2e-4
    max_scale: float = 0.01  # world units; split if max(exp(scale)) above
    min_opacity: float = 5e-3
    split_scale_div: float = 1.6  # scales -= log(1.6) on split
    split_noise_factor: float = 0.1
    clone_noise_std: float = 0.01
    # The reference re-creates fresh Adam state after every densify
    # (GaussianTrainer.swift:1105-1110), deviating from INRIA.  Keep as a
    # switch for behavioural parity.
    reset_optimizer_state: bool = True
    # --- training-health options beyond the reference (INRIA-style) ---------
    # The reference never resets opacity or prunes oversized gaussians
    # (GaussianTrainer.swift:344-427 classify kernel has neither input); on
    # scenes with large extent / sky this lets opacity saturate at 1.0 and
    # world-screen-filling gaussians survive, which blurs the fit and blows up
    # the tile-pair budget.  Both knobs default OFF for reference parity.
    # opacity_reset_interval > 0: every N iterations (while densification is
    # active) clamp sigmoid(opacity) to <= opacity_reset_value and zero the
    # opacity Adam moments — INRIA gaussian-splatting train.py reset_opacity().
    opacity_reset_interval: int = 0
    opacity_reset_value: float = 0.01
    # prune_world_scale > 0: at densify time also prune gaussians whose
    # max(exp(scale)) exceeds this many world units — INRIA's big_points_ws
    # prune (0.1 * scene extent).
    prune_world_scale: float = 0.0
    # prune_near_cameras > 0: prune gaussians within this many world units of
    # any training camera center.  Near-camera floaters memorize one view's
    # appearance and haze every novel view (round-4 vendor campaign: holdout
    # view 0 at 13.6 dB vs 35 dB train, +4.2 dB from this cull post-hoc).
    prune_near_cameras: float = 0.0
    # prune_needle_ratio > 0: prune gaussians whose max/mid scale ratio
    # exceeds this (degenerate "needles" — white streak artifacts on novel
    # views).  Flat disks (max/mid ~ 1) are unaffected.
    prune_needle_ratio: float = 0.0
    # prune_until_iter > 0: keep running PRUNE-ONLY maintenance rounds (every
    # `interval` iterations) after densification ends at until_iter, up to
    # this iteration.  Round 4 stopped all pruning at densify end and a
    # 4.5-world-unit gaussian grew unchecked across the last 9k iterations,
    # veiling an entire held-out view.  Prune-only rounds preserve Adam
    # moments (exact gather remap — no new gaussians are created), so late
    # convergence is unaffected.  0 = pruning stops with densification.
    prune_until_iter: int = 0


@dataclasses.dataclass(frozen=True)
class LossConfig:
    lambda_dssim: float = 0.2  # GaussianTrainer.swift:277
    lambda_depth: float = 0.0  # GaussianTrainer.swift:280
    ssim_window: int = 11
    ssim_sigma: float = 1.5
    ssim_c1: float = 0.01 ** 2
    ssim_c2: float = 0.03 ** 2


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    znear: float = 0.1  # CameraUtil.swift:21
    zfar: float = 100.0


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Distribution layer — new design, no reference counterpart (SURVEY §2.4).

    Data parallelism shards the camera batch across `data` mesh devices with
    Gaussian parameters replicated and gradients all-reduced.  `tile`
    sharding splits the pixel-tile grid of a single camera for very large
    renders."""

    data_axis: str = "data"
    tile_axis: str = "tile"
    data_parallel: int = 1
    tile_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    iterations: int = 30000  # TrainView.swift:206-215
    resize_factor: float = 0.5
    init_points: int = 16384
    white_background: bool = False
    snapshot_interval: int = 100
    log_interval: int = 10
    preview_interval: int = 20
    early_stop_loss: float = 1e-4  # GaussianTrainer.swift:934,1045
    seed: int = 0
    output_dir: str = "outputs"
    checkpoint_interval: int = 1000

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    raster: RasterizerConfig = dataclasses.field(default_factory=RasterizerConfig)
    optim: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    densify: DensifyConfig = dataclasses.field(default_factory=DensifyConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "TrainConfig":
        raw = json.loads(text)

        def build(cls, data):
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kwargs = {}
            for key, value in data.items():
                if key not in fields:
                    continue
                ftype = fields[key].type
                sub = _NESTED.get(key)
                kwargs[key] = build(sub, value) if sub and isinstance(value, dict) else value
            return cls(**kwargs)

        return build(TrainConfig, raw)


_NESTED = {
    "model": ModelConfig,
    "raster": RasterizerConfig,
    "optim": OptimizerConfig,
    "densify": DensifyConfig,
    "loss": LossConfig,
    "camera": CameraConfig,
    "parallel": ParallelConfig,
}
