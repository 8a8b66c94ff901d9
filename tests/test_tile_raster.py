"""Tile rasterizer kernel (ops/tile_raster.py) against the reference.

The kernel runs in Pallas interpret mode here; the tests marked `gpu`
compile it for the card (`python chip_smoke.py` runs them there).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussiansplattingmlx_tpu.ops import binning, rasterize_ref, tile_raster


def make_scene(rng, n=24, W=48, H=40, tw=16, th=8, opacity_range=(0.2, 0.9),
               max_pairs=512, corner=False):
    means2d = rng.uniform(2, max(W, H) - 2, size=(n, 2)).astype(np.float32)
    means2d[:, 0] *= W / max(W, H)
    means2d[:, 1] *= H / max(W, H)
    if corner:  # everything in the top-left tile: most tiles stay empty
        means2d = rng.uniform(2, 6, size=(n, 2)).astype(np.float32)
    sigma = rng.uniform(1.0, 4.0, size=n).astype(np.float32)
    if corner:
        sigma = np.full(n, 1.0, np.float32)
    conic = np.zeros((n, 4), np.float32)
    conic[:, 0] = 1.0 / sigma**2
    conic[:, 3] = 1.0 / sigma**2
    # small off-diagonal to exercise the c01+c10 path
    off = rng.uniform(-0.02, 0.02, size=n).astype(np.float32)
    conic[:, 1] = off
    conic[:, 2] = off
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(*opacity_range, size=(n, 1)).astype(np.float32)
    depths = rng.uniform(1.0, 10.0, size=n).astype(np.float32)
    radii = (3 * sigma).astype(np.float32)
    rect_min = np.maximum(means2d - radii[:, None], 0.0)
    rect_max = np.minimum(
        means2d + radii[:, None], np.array([W - 1, H - 1], np.float32)
    )
    packed = rasterize_ref.pack_gaussians(
        jnp.asarray(means2d), jnp.asarray(conic), jnp.asarray(colors),
        jnp.asarray(opacity), jnp.asarray(depths),
    )
    b = binning.bin_gaussians(
        jnp.asarray(rect_min), jnp.asarray(rect_max), jnp.asarray(radii),
        jnp.asarray(depths), W, H, tw, th, max_pairs=max_pairs,
    )
    return packed, b, (W, H, tw, th)


def run_kernel(packed, b, W, H, tw, th, chunk=8, interpret=True):
    return tile_raster.rasterize_tiles(
        packed, b.sorted_gauss_idx, b.pair_valid, b.tile_start, b.tile_count,
        W, H, tw, th, chunk_size=chunk, interpret=interpret,
    )


def run_reference(packed, b, W, H, tw, th):
    return rasterize_ref.rasterize_reference(
        packed, b.sorted_gauss_idx, b.sorted_tile_id, W, H, tw, th
    )


def assert_outputs_close(got, want, img_tol=1e-5, ncon_slack=0.003):
    np.testing.assert_allclose(
        np.asarray(got.color), np.asarray(want.color), rtol=1e-4, atol=img_tol
    )
    np.testing.assert_allclose(
        np.asarray(got.depth), np.asarray(want.depth), rtol=1e-4,
        atol=img_tol * 10,
    )
    np.testing.assert_allclose(
        np.asarray(got.alpha), np.asarray(want.alpha), rtol=1e-4, atol=img_tol
    )
    # log-space vs linear transmittance: the include mask can flip on pixels
    # sitting exactly at the 1e-4 threshold; allow a tiny fraction.
    mismatch = np.mean(np.asarray(got.n_contrib) != np.asarray(want.n_contrib))
    assert mismatch <= ncon_slack, f"n_contrib mismatch fraction {mismatch}"


def loss_of(runner, b, dims, target):
    W, H, tw, th = dims

    def loss(p):
        out = runner(p, b, W, H, tw, th)
        return (jnp.sum((out.color - target) ** 2)
                + 0.3 * jnp.sum(out.depth ** 2) + 0.7 * jnp.sum(out.alpha))

    return loss


def assert_grads_close(rng, packed, b, dims, chunk=8, rtol=2e-3, atol=2e-4):
    W, H = dims[:2]
    target = jnp.asarray(rng.uniform(size=(H, W, 3)).astype(np.float32))
    kernel = lambda *a: run_kernel(*a, chunk=chunk)
    g_k = np.asarray(jax.grad(loss_of(kernel, b, dims, target))(packed))
    g_r = np.asarray(jax.grad(loss_of(run_reference, b, dims, target))(packed))
    assert np.isfinite(g_k).all()
    np.testing.assert_allclose(g_k, g_r, rtol=rtol, atol=atol)


TILES = [(16, 8), (16, 16), (32, 32)]


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_forward_matches_reference(rng, tile):
    tw, th = tile
    packed, b, dims = make_scene(rng, n=32, W=64, H=40, tw=tw, th=th)
    assert_outputs_close(run_kernel(packed, b, *dims),
                         run_reference(packed, b, *dims))


@pytest.mark.parametrize("chunk", [4, 8, 16, 32])
def test_forward_chunk_boundaries(rng, chunk):
    # Chunk sizes that do and do not divide the per-tile counts.
    packed, b, dims = make_scene(rng, n=30)
    assert_outputs_close(run_kernel(packed, b, *dims, chunk=chunk),
                         run_reference(packed, b, *dims))


def test_forward_empty_tiles(rng):
    packed, b, dims = make_scene(rng, n=6, corner=True)
    assert int(np.sum(np.asarray(b.tile_count) == 0)) > 10
    got = run_kernel(packed, b, *dims)
    assert_outputs_close(got, run_reference(packed, b, *dims))
    assert float(np.max(np.asarray(got.alpha)[20:, 20:])) == 0.0


def test_forward_early_exit_heavy_occlusion(rng):
    packed, b, dims = make_scene(rng, n=40, opacity_range=(0.95, 0.99))
    want = run_reference(packed, b, *dims)
    # Saturated pixels stop before their tile's list ends.
    per_pixel_list = np.asarray(b.tile_count).max()
    assert (np.asarray(want.n_contrib) < per_pixel_list).any()
    assert_outputs_close(run_kernel(packed, b, *dims), want)


def test_forward_budget_overflow_matches_reference(rng):
    """A pair budget below demand truncates the list: the kernel composites
    exactly the truncated list the reference sees."""
    packed, b, dims = make_scene(rng, n=30, max_pairs=40)
    assert int(b.overflow_pairs) > 0
    assert_outputs_close(run_kernel(packed, b, *dims),
                         run_reference(packed, b, *dims))


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
def test_backward_matches_reference(rng, tile):
    tw, th = tile
    packed, b, dims = make_scene(rng, n=16, W=32, H=32, tw=tw, th=th)
    assert_grads_close(rng, packed, b, dims)


@pytest.mark.parametrize("chunk", [4, 16])
def test_backward_chunk_boundaries(rng, chunk):
    packed, b, dims = make_scene(rng, n=20, W=32, H=24)
    assert_grads_close(rng, packed, b, dims, chunk=chunk)


def test_backward_early_exit(rng):
    packed, b, dims = make_scene(rng, n=30, W=32, H=24,
                                 opacity_range=(0.9, 0.99))
    assert_grads_close(rng, packed, b, dims, rtol=5e-3, atol=5e-4)


def test_backward_empty_frame_is_zero(rng):
    """No pairs at all: zero image, zero (finite) gradient."""
    packed, b, dims = make_scene(rng, n=8, max_pairs=64)
    b = b._replace(tile_count=jnp.zeros_like(b.tile_count),
                   pair_valid=jnp.zeros_like(b.pair_valid))
    W, H = dims[:2]
    out = run_kernel(packed, b, *dims)
    assert float(jnp.max(out.alpha)) == 0.0
    g = jax.grad(lambda p: jnp.sum(run_kernel(p, b, *dims).color))(packed)
    assert np.all(np.asarray(g) == 0.0)


def test_final_transmittance_channel(rng):
    """The forward keeps T apart from alpha (the backward divides by it)."""
    packed, b, dims = make_scene(rng, n=40, opacity_range=(0.95, 0.99))
    W, H, tw, th = dims
    st = tile_raster.RasterStatic(
        chunk=8, tile_h=th, tile_w=tw, grid_h=-(-H // th),
        grid_w=-(-W // tw), num_pairs=b.sorted_gauss_idx.shape[0],
        alpha_clamp=0.99, transmittance_eps=1e-4, undo_denom_floor=1e-6,
        interpret=True,
    )
    records = tile_raster.record_table(packed)[b.sorted_gauss_idx].T
    out = np.asarray(tile_raster._triton_forward(st, records, b.tile_start,
                                                 b.tile_count))
    np.testing.assert_allclose(out[:, 4], 1.0 - out[:, 6], atol=1e-6)
    assert out[:, 6].min() > 0.0


def test_record_table_layout(rng):
    packed, _, _ = make_scene(rng, n=5)
    p = np.asarray(packed)
    t = np.asarray(tile_raster.record_table(packed))
    assert t.shape == (5, tile_raster.REC_ROWS)
    np.testing.assert_array_equal(t[:, 0:3], p[:, 0:3])
    np.testing.assert_array_equal(t[:, 3], p[:, 3] + p[:, 4])
    np.testing.assert_array_equal(t[:, 4], p[:, 5])
    np.testing.assert_array_equal(t[:, 5], p[:, 9])
    np.testing.assert_array_equal(t[:, 6:9], p[:, 6:9])
    np.testing.assert_array_equal(t[:, 9], p[:, 10])


@pytest.mark.gpu
@pytest.mark.parametrize("tile", [(16, 16), (32, 32)],
                         ids=lambda t: f"{t[0]}x{t[1]}")
def test_compiled_kernel_matches_reference(gpu, rng, tile):
    """The kernel as the Triton route compiles it, forward and gradient."""
    tw, th = tile
    packed, b, dims = make_scene(rng, n=40, W=64, H=64, tw=tw, th=th,
                                 max_pairs=1024)
    with jax.default_matmul_precision("highest"):
        got = run_kernel(packed, b, *dims, chunk=32, interpret=False)
        assert_outputs_close(got, run_reference(packed, b, *dims))
        W, H = dims[:2]
        target = jnp.asarray(rng.uniform(size=(H, W, 3)).astype(np.float32))
        compiled = lambda *a: run_kernel(*a, chunk=32, interpret=False)
        g_k = jax.grad(loss_of(compiled, b, dims, target))(packed)
        g_r = jax.grad(loss_of(run_reference, b, dims, target))(packed)
    np.testing.assert_allclose(np.asarray(g_k), np.asarray(g_r), rtol=2e-3,
                               atol=2e-4)
