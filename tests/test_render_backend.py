"""Rasterizer choice, the render wrapper around the tile kernel, the
per-Gaussian gradient reduction, and the compile-cache helper."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from gaussiansplattingmlx_tpu.config import RasterizerConfig
from gaussiansplattingmlx_tpu.models import gaussians
from gaussiansplattingmlx_tpu.ops import tile_raster
from gaussiansplattingmlx_tpu.render import BACKENDS, render, resolve_backend
from gaussiansplattingmlx_tpu.utils import compile_cache
from gaussiansplattingmlx_tpu.utils.camera import Camera

W, H = 32, 48
RASTER = RasterizerConfig(tile_h=16, tile_w=16, max_pairs=4096, chunk_size=8)


def test_resolve_auto_is_kernel_on_gpu():
    assert resolve_backend("auto", platform="gpu") == "triton"


def test_resolve_auto_raises_off_gpu():
    assert jax.default_backend() == "cpu"
    with pytest.raises(RuntimeError, match="needs a GPU"):
        resolve_backend("auto")


@pytest.mark.parametrize("name", BACKENDS)
def test_resolve_named_backend(name):
    assert resolve_backend(name) == name
    assert resolve_backend(name, platform="gpu") == name


def test_resolve_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown rasterizer backend"):
        resolve_backend("pallas")


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(60, 3)).astype(np.float32) * 0.5
    cols = rng.uniform(0.1, 0.9, size=(60, 3)).astype(np.float32)
    params, _ = gaussians.create_from_points(pts, cols, sh_degree=1,
                                             capacity=60)
    leaves = gaussians.activations(params)
    c2w = np.eye(4)
    c2w[2, 3] = -3.0
    t = Camera.from_c2w(W, H, 40.0, 40.0, c2w).tensors()
    cam = (jnp.asarray(t["view"]), jnp.asarray(t["proj"]),
           jnp.asarray(t["camera_center"]), t["fov_x"], t["fov_y"],
           t["focal_x"], t["focal_y"])
    return leaves, cam


def render_with(scene, backend, **kw):
    leaves, cam = scene
    height = kw.pop("height", H)
    cfg = kw.pop("cfg", RASTER)
    return render(*leaves, *cam, W, height, 1, raster_cfg=cfg,
                  backend=backend, **kw)


def test_render_auto_raises_on_cpu(scene):
    with pytest.raises(RuntimeError, match="needs a GPU"):
        render_with(scene, None)


@pytest.mark.parametrize("white", [False, True], ids=["black", "white"])
def test_render_kernel_matches_reference(scene, white):
    got, aux = render_with(scene, "triton_interpret", white_background=white)
    want, aux_r = render_with(scene, "reference", white_background=white)
    assert int(aux.num_pairs) == int(aux_r.num_pairs) > 0
    np.testing.assert_allclose(np.asarray(got.color), np.asarray(want.color),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.alpha), np.asarray(want.alpha),
                               rtol=1e-4, atol=1e-5)
    if white:
        assert float(jnp.min(got.color)) > 0.0


@pytest.mark.parametrize("band", [0, 1, 2])
def test_band_path_matches_full_frame(scene, band):
    """A 16-row band rendered with pixel_y_offset reproduces those rows of
    the full frame (the tile-parallel path of parallel/sharding.py)."""
    full, _ = render_with(scene, "triton_interpret")
    y0 = 16 * band
    part, _ = render_with(scene, "triton_interpret", height=16,
                          pixel_y_offset=jnp.float32(y0), full_image_height=H)
    np.testing.assert_allclose(np.asarray(part.color),
                               np.asarray(full.color[y0:y0 + 16]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(part.n_contrib),
                                  np.asarray(full.n_contrib[y0:y0 + 16]))


def test_render_gradient_matches_reference(scene):
    leaves, cam = scene
    r = jnp.asarray(np.random.default_rng(0).normal(size=(H, W, 3)),
                    jnp.float32)

    def grads(backend):
        def f(lv):
            out, _ = render(*lv, *cam, W, H, 1, raster_cfg=RASTER,
                            backend=backend)
            return jnp.sum(r * out.color)

        return jax.grad(f)(leaves)

    for a, b in zip(grads("triton_interpret"), grads("reference")):
        a, b = np.asarray(a), np.asarray(b)
        assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b) + 1e-7


def test_segment_sum_pairs_matches_dense(rng):
    n, p = 7, 50
    rows = rng.normal(size=(tile_raster.REC_ROWS, p)).astype(np.float32)
    gid = rng.integers(0, n, size=p).astype(np.int32)
    valid = rng.uniform(size=p) < 0.8
    got = np.asarray(tile_raster.segment_sum_pairs(
        jnp.asarray(rows), jnp.asarray(gid), jnp.asarray(valid), n))
    onehot = (gid[None, :] == np.arange(n)[:, None]) & valid[None, :]
    want = onehot.astype(np.float64) @ rows.T.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_record_gather_gradient_is_segment_sum(rng):
    """The VJP of the pair-record gather sums each Gaussian's rows and
    drops invalid slots."""
    n, p = 6, 40
    table = jnp.asarray(rng.normal(size=(n, tile_raster.REC_ROWS)),
                        jnp.float32)
    gid = jnp.asarray(rng.integers(0, n, size=p), jnp.int32)
    valid = jnp.asarray(np.arange(p) < 30)
    cot = jnp.asarray(rng.normal(size=(tile_raster.REC_ROWS, p)), jnp.float32)
    rec, vjp = jax.vjp(
        lambda t: tile_raster._gather_records(n, t, gid, valid), table
    )
    np.testing.assert_array_equal(np.asarray(rec), np.asarray(table[gid].T))
    np.testing.assert_allclose(
        np.asarray(vjp(cot)[0]),
        np.asarray(tile_raster.segment_sum_pairs(cot, gid, valid, n)),
    )


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_respects_env(monkeypatch, cache_config, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = __import__("pathlib").Path(__file__).resolve().parents[1]
    assert path == str(repo / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # Fixed: a second call (another process) lands on the same directory.
    assert compile_cache.enable_compile_cache() == path


@pytest.mark.gpu
def test_auto_backend_is_kernel_on_card(gpu, scene):
    got, _ = render_with(scene, "auto")
    want, _ = render_with(scene, "reference")
    np.testing.assert_allclose(np.asarray(got.color), np.asarray(want.color),
                               rtol=1e-4, atol=1e-4)
