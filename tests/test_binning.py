"""Tile binning vs a brute-force numpy implementation of the reference's
tile-index math (slang/gaussian_tile_global_kernels.slang:8-126)."""

import numpy as np
import jax.numpy as jnp

from gaussiansplattingmlx_tpu.ops import binning


def brute_force_pairs(rect_min, rect_max, radii, depths, W, H, tw, th):
    gw, gh = -(-W // tw), -(-H // th)
    pairs = []
    for i in range(len(radii)):
        if radii[i] <= 0:
            continue
        tmin_x = int(np.clip(np.floor(rect_min[i, 0] / tw), 0, gw))
        tmin_y = int(np.clip(np.floor(rect_min[i, 1] / th), 0, gh))
        tmax_x = int(np.clip(np.floor(rect_max[i, 0] / tw) + 1, 0, gw))
        tmax_y = int(np.clip(np.floor(rect_max[i, 1] / th) + 1, 0, gh))
        for ty in range(tmin_y, tmax_y):
            for tx in range(tmin_x, tmax_x):
                pairs.append((ty * gw + tx, depths[i], i))
    pairs.sort(key=lambda p: (p[0], p[1], p[2]))
    return pairs, gw * gh


def run_binning(rect_min, rect_max, radii, depths, W, H, tw, th, max_pairs=256):
    return binning.bin_gaussians(
        jnp.asarray(rect_min),
        jnp.asarray(rect_max),
        jnp.asarray(radii),
        jnp.asarray(depths),
        W,
        H,
        tw,
        th,
        max_pairs,
    )


def test_binning_matches_brute_force(rng):
    W = H = 64
    tw = th = 16
    n = 40
    means = rng.uniform(0, 64, size=(n, 2)).astype(np.float32)
    radius = rng.uniform(1, 20, size=n).astype(np.float32)
    radius[::7] = 0.0  # some culled
    depths = rng.uniform(0.5, 10, size=n).astype(np.float32)
    rect_min = np.maximum(means - radius[:, None], 0.0)
    rect_max = np.minimum(means + radius[:, None], np.array([W - 1, H - 1], np.float32))

    out = run_binning(rect_min, rect_max, radius, depths, W, H, tw, th)
    expected, num_tiles = brute_force_pairs(
        rect_min, rect_max, radius, depths, W, H, tw, th
    )

    assert int(out.num_pairs) == len(expected)
    assert int(out.overflow_pairs) == 0
    got_tiles = np.asarray(out.sorted_tile_id)[: len(expected)]
    got_idx = np.asarray(out.sorted_gauss_idx)[: len(expected)]
    np.testing.assert_array_equal(got_tiles, [p[0] for p in expected])
    np.testing.assert_array_equal(got_idx, [p[2] for p in expected])

    # tile_start / tile_count cover exactly the sorted pair ranges.
    start = np.asarray(out.tile_start)
    count = np.asarray(out.tile_count)
    for t in range(num_tiles):
        members = [p[2] for p in expected if p[0] == t]
        assert count[t] == len(members)
        np.testing.assert_array_equal(got_idx[start[t] : start[t] + count[t]], members)


def test_depth_ordering_within_tile(rng):
    # Three gaussians covering the same single tile, shuffled depths.
    W = H = 32
    rect_min = np.zeros((3, 2), np.float32)
    rect_max = np.full((3, 2), 10.0, np.float32)
    radii = np.ones(3, np.float32)
    depths = np.array([5.0, 1.0, 3.0], np.float32)
    out = run_binning(rect_min, rect_max, radii, depths, W, H, 32, 32)
    idx = np.asarray(out.sorted_gauss_idx)[:3]
    np.testing.assert_array_equal(idx, [1, 2, 0])


def test_huge_footprint_is_exact(rng):
    # One gaussian covering the whole 4x4 tile grid: binning is exact —
    # no per-gaussian footprint truncation of any kind.
    W = H = 64
    rect_min = np.zeros((1, 2), np.float32)
    rect_max = np.full((1, 2), 63.0, np.float32)
    radii = np.ones(1, np.float32)
    depths = np.ones(1, np.float32)
    out = run_binning(rect_min, rect_max, radii, depths, W, H, 16, 16)
    assert int(out.overflow_gaussians) == 0
    assert int(out.num_pairs) == 16
    kept = np.asarray(out.sorted_tile_id)[np.asarray(out.pair_valid)]
    np.testing.assert_array_equal(np.sort(kept), np.arange(16))


def test_pair_budget_overflow(rng):
    # 10 gaussians x 4 tiles each = 40 pairs but budget 16.
    W = H = 32
    n = 10
    rect_min = np.tile(np.array([[10.0, 10.0]], np.float32), (n, 1))
    rect_max = np.tile(np.array([[20.0, 20.0]], np.float32), (n, 1))
    radii = np.ones(n, np.float32)
    depths = np.arange(1, n + 1, dtype=np.float32)
    out = run_binning(rect_min, rect_max, radii, depths, W, H, 16, 16, max_pairs=16)
    assert int(out.num_pairs) == 16
    assert int(out.overflow_pairs) == 40 - 16
    # 6 gaussians' blocks extend past the 16-pair budget (gaussian-major
    # emission: 4 pairs each -> gaussians 4..9 lose pairs).
    assert int(out.overflow_gaussians) == 6


def test_budget_keeps_gaussian_major_prefix(rng):
    """Pairs beyond max_pairs drop in gaussian-major emission order: the kept
    set is exactly the first `max_pairs` (gaussian, row-major-tile) pairs."""
    W = H = 128
    # One gaussian covering the full 8x8 tile grid (64 tiles), budget 8:
    # the first 8 row-major tiles (top row) survive.
    rect_min = np.array([[0.0, 0.0]], np.float32)
    rect_max = np.array([[127.0, 127.0]], np.float32)
    out = run_binning(
        rect_min, rect_max, np.ones(1, np.float32), np.ones(1, np.float32),
        W, H, 16, 16, max_pairs=8,
    )
    assert int(out.overflow_gaussians) == 1
    assert int(out.num_pairs) == 8
    kept = np.asarray(out.sorted_tile_id)[np.asarray(out.pair_valid)]
    np.testing.assert_array_equal(np.sort(kept), np.arange(8))


def test_exactness_at_scale_random(rng):
    """Randomized exactness: mixed footprint sizes (including several much
    larger than the old per-gaussian cap) reproduce brute force bit-exactly."""
    W = H = 256
    tw = th = 16
    n = 300
    means = rng.uniform(0, 256, size=(n, 2)).astype(np.float32)
    radius = rng.uniform(1, 120, size=n).astype(np.float32)  # up to whole grid
    radius[::5] = 0.0
    depths = rng.uniform(0.5, 10, size=n).astype(np.float32)
    rect_min = np.maximum(means - radius[:, None], 0.0)
    rect_max = np.minimum(means + radius[:, None], np.array([W - 1, H - 1], np.float32))
    out = run_binning(
        rect_min, rect_max, radius, depths, W, H, tw, th, max_pairs=2**15
    )
    expected, _ = brute_force_pairs(rect_min, rect_max, radius, depths, W, H, tw, th)
    assert int(out.num_pairs) == len(expected)
    assert int(out.overflow_pairs) == 0
    assert int(out.overflow_gaussians) == 0
    got_tiles = np.asarray(out.sorted_tile_id)[: len(expected)]
    got_idx = np.asarray(out.sorted_gauss_idx)[: len(expected)]
    np.testing.assert_array_equal(got_tiles, [p[0] for p in expected])
    np.testing.assert_array_equal(got_idx, [p[2] for p in expected])


def test_all_culled_scene(rng):
    """Every gaussian culled (radius 0): zero pairs, all-sentinel tiles."""
    n = 10
    rect_min = np.zeros((n, 2), np.float32)
    rect_max = np.ones((n, 2), np.float32)
    out = run_binning(
        rect_min, rect_max, np.zeros(n, np.float32),
        np.ones(n, np.float32), 64, 64, 16, 16,
    )
    assert int(out.num_pairs) == 0
    assert int(out.overflow_pairs) == 0
    assert not bool(np.asarray(out.pair_valid).any())
    assert (np.asarray(out.tile_count) == 0).all()


def test_single_gaussian_single_tile(rng):
    out = run_binning(
        np.array([[5.0, 5.0]], np.float32), np.array([[6.0, 6.0]], np.float32),
        np.ones(1, np.float32), np.array([2.5], np.float32), 32, 32, 16, 16,
    )
    assert int(out.num_pairs) == 1
    assert np.asarray(out.sorted_tile_id)[0] == 0
    assert np.asarray(out.sorted_gauss_idx)[0] == 0


def test_saturating_cumsum_no_int32_wrap():
    """At flagship pathology (1M gaussians x full-screen 2500-tile footprints)
    the true pair total is 2.5e9 > 2^31: the clamped-add scan must stay
    monotone and positive where a plain int32 cumsum would wrap negative."""
    n = 1_000_000
    footprint = np.full(n, 2500, np.int32)
    cum = np.asarray(binning._saturating_cumsum(jnp.asarray(footprint)))
    want = np.minimum(np.cumsum(footprint.astype(np.int64)), binning._CUM_CLAMP)
    np.testing.assert_array_equal(cum, want.astype(np.int32))
    assert (cum > 0).all()
    assert (np.diff(cum) >= 0).all()


def test_binning_survives_pathological_pair_total():
    """Full bin_gaussians at the >2^31-pair pathology: overflow detection
    fires, valid pairs are the exact gaussian-major prefix, tile ranges stay
    monotone (nothing downstream sees wrapped offsets)."""
    n = 1_000_000
    W = H = 800
    tw = th = 16  # 50x50 = 2500-tile grid; every gaussian covers it all
    rect_min = np.zeros((n, 2), np.float32)
    rect_max = np.full((n, 2), 799.0, np.float32)
    radii = np.ones(n, np.float32)
    depths = np.linspace(1.0, 2.0, n).astype(np.float32)
    max_pairs = 4096
    out = run_binning(rect_min, rect_max, radii, depths, W, H, tw, th,
                      max_pairs=max_pairs)
    assert int(out.num_pairs) == max_pairs
    assert int(out.overflow_pairs) > 0
    assert int(out.overflow_gaussians) > 0
    # Budgeted prefix = gaussian 0's full 2500-tile rect + the start of
    # gaussian 1's (gaussian-major emission order).
    gauss = np.asarray(out.sorted_gauss_idx)[np.asarray(out.pair_valid)]
    counts = np.bincount(gauss, minlength=2)
    assert counts[0] == 2500 and counts[1] == max_pairs - 2500
    assert set(np.unique(gauss)) == {0, 1}
    starts = np.asarray(out.tile_start)
    assert (np.diff(starts) >= 0).all()
    assert int(np.asarray(out.tile_count).sum()) == max_pairs
