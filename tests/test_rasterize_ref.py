"""Oracle rasterizer: analytic cases, serial-reference equivalence, and
finite-difference gradient checks."""

import numpy as np
import jax
import jax.numpy as jnp

from gaussiansplattingmlx_tpu.ops import binning, rasterize_ref


def make_scene(rng, n=20, W=32, H=32, tw=16, th=16, opacity_range=(0.2, 0.9)):
    means2d = rng.uniform(4, W - 4, size=(n, 2)).astype(np.float32)
    sigma = rng.uniform(1.0, 4.0, size=n).astype(np.float32)
    conic = np.zeros((n, 4), np.float32)
    conic[:, 0] = 1.0 / sigma**2
    conic[:, 3] = 1.0 / sigma**2
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(*opacity_range, size=(n, 1)).astype(np.float32)
    depths = rng.uniform(1.0, 10.0, size=n).astype(np.float32)
    radii = (3 * sigma).astype(np.float32)
    rect_min = np.maximum(means2d - radii[:, None], 0.0)
    rect_max = np.minimum(
        means2d + radii[:, None], np.array([W - 1, H - 1], np.float32)
    )
    packed = rasterize_ref.pack_gaussians(
        jnp.asarray(means2d),
        jnp.asarray(conic),
        jnp.asarray(colors),
        jnp.asarray(opacity),
        jnp.asarray(depths),
    )
    b = binning.bin_gaussians(
        jnp.asarray(rect_min),
        jnp.asarray(rect_max),
        jnp.asarray(radii),
        jnp.asarray(depths),
        W,
        H,
        tw,
        th,
        max_pairs=1024,
    )
    return packed, b, (W, H, tw, th)


def serial_rasterize(packed, b, W, H, tw, th):
    """Literal serial re-implementation of the forward march
    (tile_global_kernels.slang:523-614), in numpy."""
    packed = np.asarray(packed)
    tile_id = np.asarray(b.sorted_tile_id)
    gauss = np.asarray(b.sorted_gauss_idx)
    start = np.asarray(b.tile_start)
    count = np.asarray(b.tile_count)
    gw = -(-W // tw)
    color = np.zeros((H, W, 3))
    depth = np.zeros((H, W))
    alpha = np.zeros((H, W))
    ncon = np.zeros((H, W), np.int32)
    for y in range(H):
        for x in range(W):
            t = (y // th) * gw + (x // tw)
            T = 1.0
            n = count[t]
            for i in range(count[t]):
                g = gauss[start[t] + i]
                mx, my, c00, c01, c10, c11, r, gcol, bcol, op, d = packed[g]
                dx, dy = x - mx, y - my
                e = -0.5 * (dx * dx * c00 + dy * dy * c11 + dx * dy * (c01 + c10))
                a = min(np.exp(e) * op, 0.99)
                contrib = T * a
                color[y, x] += contrib * packed[g, 6:9]
                depth[y, x] += contrib * d
                T *= 1.0 - a
                if T < 1e-4:
                    n = i + 1
                    break
            alpha[y, x] = 1.0 - T
            ncon[y, x] = n
    return color, depth, alpha, ncon


def test_matches_serial_reference(rng):
    packed, b, (W, H, tw, th) = make_scene(rng)
    out = rasterize_ref.rasterize_reference(
        packed, b.sorted_gauss_idx, b.sorted_tile_id, W, H, tw, th
    )
    color, depth, alpha, ncon = serial_rasterize(packed, b, W, H, tw, th)
    np.testing.assert_allclose(np.asarray(out.color), color, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.depth), depth, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.alpha), alpha, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(out.n_contrib), ncon)


def test_early_exit_matches_serial(rng):
    # Opaque gaussians stacked on one tile force the T < 1e-4 early exit.
    packed, b, (W, H, tw, th) = make_scene(rng, n=30, opacity_range=(0.95, 0.99))
    out = rasterize_ref.rasterize_reference(
        packed, b.sorted_gauss_idx, b.sorted_tile_id, W, H, tw, th
    )
    color, depth, alpha, ncon = serial_rasterize(packed, b, W, H, tw, th)
    np.testing.assert_array_equal(np.asarray(out.n_contrib), ncon)
    np.testing.assert_allclose(np.asarray(out.color), color, rtol=1e-4, atol=1e-5)
    assert (np.asarray(out.n_contrib) < 30).any()  # exit actually triggered


def test_single_gaussian_analytic():
    # One isotropic gaussian centered on a pixel: alpha at center = opacity.
    W = H = 16
    packed = rasterize_ref.pack_gaussians(
        jnp.asarray([[8.0, 8.0]]),
        jnp.asarray([[0.25, 0.0, 0.0, 0.25]]),
        jnp.asarray([[1.0, 0.5, 0.25]]),
        jnp.asarray([[0.8]]),
        jnp.asarray([2.0]),
    )
    b = binning.bin_gaussians(
        jnp.asarray([[0.0, 0.0]]),
        jnp.asarray([[15.0, 15.0]]),
        jnp.asarray([6.0]),
        jnp.asarray([2.0]),
        W, H, 16, 16, 16,
    )
    out = rasterize_ref.rasterize_reference(
        packed, b.sorted_gauss_idx, b.sorted_tile_id, W, H, 16, 16
    )
    assert abs(float(out.alpha[8, 8]) - 0.8) < 1e-6
    np.testing.assert_allclose(
        np.asarray(out.color[8, 8]), [0.8, 0.4, 0.2], rtol=1e-5
    )
    assert abs(float(out.depth[8, 8]) - 1.6) < 1e-5
    # Off-center pixel: alpha = op * exp(-0.5 * r^2 / sigma^2), sigma^2 = 4.
    expected = 0.8 * np.exp(-0.5 * (4.0**2) * 0.25)
    assert abs(float(out.alpha[8, 12]) - expected) < 1e-5


def test_gradient_finite_differences(rng):
    packed, b, (W, H, tw, th) = make_scene(rng, n=8, W=16, H=16)
    target = jnp.asarray(rng.uniform(size=(H, W, 3)).astype(np.float32))

    def loss(p):
        out = rasterize_ref.rasterize_reference(
            p, b.sorted_gauss_idx, b.sorted_tile_id, W, H, tw, th
        )
        return (
            jnp.mean((out.color - target) ** 2)
            + 0.1 * jnp.mean(out.depth)
            + 0.1 * jnp.mean(out.alpha)
        )

    g = np.asarray(jax.grad(loss)(packed))
    assert np.isfinite(g).all()
    p0 = np.asarray(packed, np.float64)
    f0 = float(loss(packed))
    rng2 = np.random.default_rng(7)
    for _ in range(12):
        i = rng2.integers(0, p0.shape[0])
        j = rng2.integers(0, p0.shape[1])
        eps = 1e-3 if j in (0, 1, 10) else 1e-4
        pp = p0.copy()
        pp[i, j] += eps
        f1 = float(loss(jnp.asarray(pp, jnp.float32)))
        fd = (f1 - f0) / eps
        if abs(fd) < 1e-6 and abs(g[i, j]) < 1e-6:
            continue
        np.testing.assert_allclose(g[i, j], fd, rtol=0.08, atol=2e-3)


def test_white_background():
    color = jnp.zeros((4, 4, 3))
    alpha = jnp.full((4, 4), 0.25)
    out = rasterize_ref.apply_background(color, alpha, True)
    np.testing.assert_allclose(np.asarray(out), 0.75, atol=1e-7)
    out2 = rasterize_ref.apply_background(color, alpha, False)
    np.testing.assert_allclose(np.asarray(out2), 0.0)


def test_reference_ignores_default_matmul_precision(rng):
    """The oracle asks for full float32 itself: a lower default precision
    (TF32 on a GPU) must not change its output."""
    packed, b, dims = make_scene(rng)
    W, H, tw, th = dims

    def run():
        return rasterize_ref.rasterize_reference(
            packed, b.sorted_gauss_idx, b.sorted_tile_id, W, H, tw, th
        )

    want = run()
    with jax.default_matmul_precision("float32"):
        got = run()
    with jax.default_matmul_precision("bfloat16"):
        low = run()
    for a, c, d in zip(got, want, low):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
        np.testing.assert_array_equal(np.asarray(d), np.asarray(c))
