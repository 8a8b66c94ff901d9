"""gaussiansplattingmlx_tpu — 3D Gaussian Splatting framework for NVIDIA GPUs.

A from-scratch JAX/Pallas re-design of the capabilities of
tatsuya-ogawa/GaussianSplattingMlx (Apple-Silicon MLX/Metal): end-to-end 3DGS
training (Kerbl et al. 2023), COLMAP/Blender/NerfStudio data loading, Gaussian
PLY checkpoints, densification, and an inference renderer: a jit-compiled
static-shape training step, a Pallas tile rasterizer on the Triton route,
sort-based binning, and a `jax.sharding` mesh for multi-device scaling (which
the reference does not have).
"""

__version__ = "0.1.0"

from .config import TrainConfig  # noqa: F401
