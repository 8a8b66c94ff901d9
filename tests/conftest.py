"""Test environment: deterministic 8-virtual-device CPU mesh.

Tests run on the CPU unless JAX_PLATFORMS says otherwise; the tile
rasterizer kernel runs there in Pallas interpret mode.  Tests marked `gpu`
need a card and skip without one; `python chip_smoke.py` runs them on the
GPU (it sets JAX_PLATFORMS=cuda for its pytest subprocess).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first JAX device, for tests marked `gpu`; skips without a card.
    Decided here, never at import: every xdist worker must collect the same
    tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev
