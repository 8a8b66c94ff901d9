"""Tile rasterizer for the GPU: forward and custom-VJP backward.

The per-pixel front-to-back march of the reference's compositing kernels
(slang/gaussian_tile_global_kernels.slang:406-881) in the shape the original
3DGS CUDA rasterizer gives it (Kerbl et al. 2023): one program per screen
tile, which walks the tile's depth-sorted pair range in chunks of C records,
keeps every pixel's transmittance and accumulators in registers, and stops
once every pixel of the tile has saturated (T < transmittance_eps).  The
backward walks the same range back to front, undoing T from the saved final
transmittance, and writes each pair's gradient row into that pair's own
slot; the slots are disjoint, so the kernel needs no atomics.  The rows are
summed per Gaussian in XLA (`segment_sum_pairs`).

Within a chunk the serial march is the vector identity of
ops/rasterize_ref.py: transmittance before record j is T_in times the
exclusive prefix product of (1 - alpha), evaluated as exp of an exclusive
cumsum of log1p(-alpha); the include mask is `Tu >= eps` on the unmasked
product, so it is a per-pixel prefix and agrees with the serial break.

The kernel is a Pallas kernel on the Triton route; `interpret=True` runs the
same kernel on the CPU for tests.  A kernel, not plain XLA: the same chunk
math for all tiles at once writes a [tiles, TT, C] intermediate to device
memory per chunk and makes every tile pay for the deepest one
(docs/DESIGN.md has the measured comparison).

Record layout [REC_ROWS, P] (component-major, one column per sorted pair):
  0 mean_x, 1 mean_y, 2 c00, 3 c01 + c10, 4 c11, 5 opacity, 6-8 rgb, 9 depth
Forward output [num_tiles, OUT_CHANNELS, TT] with TT = tile_h * tile_w:
  0-2 rgb, 3 depth, 4 alpha (= 1 - T), 5 n_contrib, 6 final T.
The final T is kept apart from alpha because 1 - alpha loses its digits once
the pixel is nearly opaque, and the backward divides by it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .rasterize_ref import RenderOutputs

REC_ROWS = 10
OUT_CHANNELS = 7
# Warps per tile program: 128 threads, two pixels each for a 16x16 tile.
NUM_WARPS = 4


class RasterStatic(NamedTuple):
    """Hashable static configuration threaded through the custom_vjp."""

    chunk: int
    tile_h: int
    tile_w: int
    grid_h: int
    grid_w: int
    num_pairs: int  # columns of the record buffer (the pair budget)
    alpha_clamp: float
    transmittance_eps: float
    undo_denom_floor: float
    interpret: bool

    @property
    def num_tiles(self) -> int:
        return self.grid_h * self.grid_w

    @property
    def tile_pixels(self) -> int:
        return self.tile_h * self.tile_w


# --- chunk math ----------------------------------------------------------------
#
# Pixel quantities are [TT, 1] blocks, record rows [1, C]: lanes (records)
# are the last axis, pixels the one before.


def _alpha(px, py, rec, alpha_clamp):
    """Gaussian falloff, the elementwise form of rasterize_ref.sample_alpha
    in fp32.  Returns (alpha, raw = g * opacity, g, dx, dy)."""
    mx, my, c00, cs, c11, op = rec[:6]
    dx = px - mx
    dy = py - my
    g = jnp.exp(-0.5 * (dx * dx * c00 + dy * dy * c11 + dx * dy * cs))
    raw = g * op
    return jnp.minimum(raw, alpha_clamp), raw, g, dx, dy


def _fwd_chunk(px, py, rec, valid, t_in, acc, ncon, st: RasterStatic):
    """Composite one chunk.  t_in/ncon [TT], acc 4 x [TT]."""
    a, _, _, _, _ = _alpha(px, py, rec, st.alpha_clamp)
    a = jnp.where(valid, a, 0.0)
    la = jnp.log1p(-a)
    excl = jnp.cumsum(la, axis=-1) - la
    tu = t_in[..., None] * jnp.exp(excl)
    m = jnp.logical_and(tu >= st.transmittance_eps, valid)
    w = jnp.where(m, tu * a, 0.0)
    acc = tuple(acc[k] + jnp.sum(w * rec[6 + k], axis=-1) for k in range(4))
    ncon = ncon + jnp.sum(m.astype(jnp.float32), axis=-1)
    # m is a prefix of the lanes, so T after the chunk is T_in times the
    # product over the included lanes.
    t_out = t_in * jnp.exp(jnp.sum(jnp.where(m, la, 0.0), axis=-1))
    return t_out, acc, ncon


def _bwd_chunk(px, py, rec, rank, ncon, t_end, acc_wu, cot, tfin_term,
               st: RasterStatic):
    """Reverse step over one chunk.

    rank [1, C] within-tile record index; ncon/t_end/acc_wu [TT];
    cot 4 x [TT, 1] (rgb, depth cotangents); tfin_term [TT, 1].
    Returns (per-record gradient rows, 10 x [C], T at chunk start,
    acc_wu including this chunk)."""
    a, raw, g, dx, dy = _alpha(px, py, rec, st.alpha_clamp)
    m = rank < ncon[..., None]  # the forward's include set, replayed
    la = jnp.where(m, jnp.log1p(-a), 0.0)
    total = jnp.sum(la, axis=-1)
    excl = jnp.cumsum(la, axis=-1) - la
    # Undo T back from the chunk end: T before record j is
    # T_end / prod_{i >= j}(1 - a_i), here as a log-space subtraction.  It is
    # bounded below by T_final >= eps * (1 - alpha_clamp), so it cannot
    # underflow into denormals.
    tu = t_end[..., None] * jnp.exp(excl - total[..., None])
    w = jnp.where(m, tu * a, 0.0)
    u = (cot[0] * rec[6] + cot[1] * rec[7] + cot[2] * rec[8]
         + cot[3] * rec[9])
    wu = w * u
    sum_wu = jnp.sum(wu, axis=-1)
    later = acc_wu[..., None] + (sum_wu[..., None] - jnp.cumsum(wu, axis=-1))
    # 1 - a >= 1 - alpha_clamp; the floor mirrors the reference's
    # undoTileGlobalPixelState guard (slang :506-510).
    one_minus = jnp.maximum(1.0 - a, st.undo_denom_floor)
    dl_da = jnp.where(m, u * tu - (later + tfin_term) / one_minus, 0.0)
    # The alpha clamp has zero gradient above it (slang :455).
    draw = jnp.where(raw <= st.alpha_clamp, dl_da, 0.0)
    de = draw * raw  # d/d(exponent): raw = exp(e) * opacity
    c00, cs, c11 = rec[2], rec[3], rec[4]
    psum = lambda x: jnp.sum(x, axis=-2)
    grads = (
        psum(de * (dx * c00 + 0.5 * dy * cs)),
        psum(de * (dy * c11 + 0.5 * dx * cs)),
        psum(-0.5 * de * dx * dx),
        psum(-0.5 * de * dx * dy),
        psum(-0.5 * de * dy * dy),
        psum(draw * g),
        psum(w * cot[0]),
        psum(w * cot[1]),
        psum(w * cot[2]),
        psum(w * cot[3]),
    )
    t_start = t_end * jnp.exp(-total)
    return grads, t_start, acc_wu + sum_wu


def _tile_pixels(t, st: RasterStatic):
    """Float pixel coordinates [TT, 1] of tile t."""
    pix = jnp.arange(st.tile_pixels, dtype=jnp.int32)
    px = (t % st.grid_w) * st.tile_w + pix % st.tile_w
    py = (t // st.grid_w) * st.tile_h + pix // st.tile_w
    return (px.astype(jnp.float32)[..., None],
            py.astype(jnp.float32)[..., None])


# --- Pallas kernel on the Triton route ----------------------------------------


def _load_chunk(rec_ref, start, count, ci, st: RasterStatic):
    """Masked loads of chunk ci of a tile's range at any offset: no
    alignment padding.  Returns (rows 10 x [1, C], valid [C], within-tile
    rank [C] int32, pair index [C])."""
    rank = ci * st.chunk + jnp.arange(st.chunk, dtype=jnp.int32)
    valid = rank < count
    idx = jnp.minimum(start + rank, st.num_pairs - 1)
    rows = tuple(
        plgpu.load(rec_ref.at[k * st.num_pairs + idx], mask=valid,
                   other=0.0)[None, :]
        for k in range(REC_ROWS)
    )
    return rows, valid, rank, idx


def _fwd_kernel(start_ref, count_ref, rec_ref, out_ref, *, st: RasterStatic):
    t = pl.program_id(0)
    tt = st.tile_pixels
    start = start_ref[t]
    count = count_ref[t]
    px, py = _tile_pixels(t, st)
    nchunks = (count + st.chunk - 1) // st.chunk

    def cond(carry):
        ci, _, _, _, alive = carry
        return jnp.logical_and(ci < nchunks, alive)

    def body(carry):
        ci, t_in, acc, ncon, _ = carry
        rec, valid, _, _ = _load_chunk(rec_ref, start, count, ci, st)
        t_in, acc, ncon = _fwd_chunk(px, py, rec, valid[None, :], t_in, acc,
                                     ncon, st)
        return ci + 1, t_in, acc, ncon, jnp.max(t_in) >= st.transmittance_eps

    zeros = jnp.zeros((tt,), jnp.float32)
    _, t_fin, acc, ncon, _ = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), jnp.ones((tt,), jnp.float32), (zeros,) * 4, zeros,
         jnp.bool_(True)),
    )
    pix = jnp.arange(tt, dtype=jnp.int32)
    base = t * (OUT_CHANNELS * tt)
    for k, v in enumerate((*acc, 1.0 - t_fin, ncon, t_fin)):
        plgpu.store(out_ref.at[base + k * tt + pix], v)


def _bwd_kernel(start_ref, count_ref, rec_ref, out_ref, cot_ref, zeros_ref,
                grad_ref, *, st: RasterStatic):
    """grad_ref aliases zeros_ref: slots this tile never reaches (records
    past its last contributor, padding) keep their zeros."""
    del zeros_ref
    t = pl.program_id(0)
    tt = st.tile_pixels
    start = start_ref[t]
    count = count_ref[t]
    px, py = _tile_pixels(t, st)
    pix = jnp.arange(tt, dtype=jnp.int32)
    base = t * (OUT_CHANNELS * tt)
    load_px = lambda ref, k: plgpu.load(ref.at[base + k * tt + pix])
    cot = tuple(load_px(cot_ref, k)[:, None] for k in range(4))
    ncon = load_px(out_ref, 5)
    t_fin = load_px(out_ref, 6)
    # alpha = 1 - T_final, so dL/dT_final = -dL/dalpha.
    tfin_term = (-load_px(cot_ref, 4) * t_fin)[:, None]
    # Records past the deepest contributor have no gradient for any pixel.
    live = (jnp.max(ncon).astype(jnp.int32) + st.chunk - 1) // st.chunk

    def body(k, carry):
        t_end, acc_wu = carry
        ci = live - 1 - k
        rec, valid, rank, idx = _load_chunk(rec_ref, start, count, ci, st)
        grads, t_end, acc_wu = _bwd_chunk(
            px, py, rec, rank.astype(jnp.float32)[None, :], ncon, t_end,
            acc_wu, cot, tfin_term, st,
        )
        for j, gj in enumerate(grads):
            plgpu.store(grad_ref.at[j * st.num_pairs + idx], gj, mask=valid)
        return t_end, acc_wu

    jax.lax.fori_loop(0, live, body, (t_fin, jnp.zeros((tt,), jnp.float32)))


def _triton_forward(st: RasterStatic, records, tile_start, tile_count):
    out = pl.pallas_call(
        functools.partial(_fwd_kernel, st=st),
        out_shape=jax.ShapeDtypeStruct(
            (st.num_tiles * OUT_CHANNELS * st.tile_pixels,), jnp.float32
        ),
        grid=(st.num_tiles,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=st.interpret,
        name="tile_raster_fwd",
    )(tile_start, tile_count, records.reshape(-1))
    return out.reshape(st.num_tiles, OUT_CHANNELS, st.tile_pixels)


def _triton_backward(st: RasterStatic, records, tile_start, tile_count, out,
                     cot_out):
    zeros = jnp.zeros((REC_ROWS * st.num_pairs,), jnp.float32)
    grad = pl.pallas_call(
        functools.partial(_bwd_kernel, st=st),
        out_shape=jax.ShapeDtypeStruct(zeros.shape, jnp.float32),
        grid=(st.num_tiles,),
        input_output_aliases={5: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=st.interpret,
        name="tile_raster_bwd",
    )(tile_start, tile_count, records.reshape(-1), out.reshape(-1),
      cot_out.reshape(-1), zeros)
    return grad.reshape(REC_ROWS, st.num_pairs)


# --- custom VJPs and the public entry -----------------------------------------


def _zero_cot(x):
    return jnp.zeros(x.shape, dtype=jax.dtypes.float0)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _raster_core(st: RasterStatic, records, tile_start, tile_count):
    return _raster_fwd(st, records, tile_start, tile_count)[0]


def _raster_fwd(st, records, tile_start, tile_count):
    out = _triton_forward(st, records, tile_start, tile_count)
    return out, (records, tile_start, tile_count, out)


def _raster_bwd(st, residuals, cot_out):
    records, tile_start, tile_count, out = residuals
    grad = _triton_backward(st, records, tile_start, tile_count, out, cot_out)
    return grad, _zero_cot(tile_start), _zero_cot(tile_count)


_raster_core.defvjp(_raster_fwd, _raster_bwd)


def segment_sum_pairs(rows, gid, valid, num_gaussians: int):
    """Per-pair gradient rows [R, P] -> per-Gaussian sums [N, R].

    An XLA scatter-add; invalid pairs go to an out-of-range segment and are
    dropped, so padding slots add nothing to (and do not contend on) any
    Gaussian."""
    seg = jnp.where(valid, gid, num_gaussians)
    return jax.ops.segment_sum(rows.T, seg, num_segments=num_gaussians)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _gather_records(num_gaussians: int, table, gid, valid):
    """table [N, R] -> records [R, P]; the VJP is segment_sum_pairs."""
    return table[gid].T


def _gather_records_fwd(num_gaussians, table, gid, valid):
    return table[gid].T, (gid, valid)


def _gather_records_bwd(num_gaussians, residuals, g):
    gid, valid = residuals
    return (segment_sum_pairs(g, gid, valid, num_gaussians), _zero_cot(gid),
            _zero_cot(valid))


_gather_records.defvjp(_gather_records_fwd, _gather_records_bwd)


def record_table(packed):
    """Reference packing [N, 11] (mean2d, conic c00 c01 c10 c11, rgb,
    opacity, depth) -> kernel rows [N, REC_ROWS].  The two off-diagonal
    conic entries enter the exponent only as their sum."""
    return jnp.concatenate(
        [packed[:, 0:3], packed[:, 3:4] + packed[:, 4:5], packed[:, 5:6],
         packed[:, 9:10], packed[:, 6:9], packed[:, 10:11]],
        axis=1,
    )


def rasterize_tiles(
    packed: jax.Array,
    sorted_gauss_idx: jax.Array,
    pair_valid: jax.Array,
    tile_start: jax.Array,
    tile_count: jax.Array,
    image_width: int,
    image_height: int,
    tile_w: int,
    tile_h: int,
    *,
    chunk_size: int = 32,
    alpha_clamp: float = 0.99,
    transmittance_eps: float = 1e-4,
    undo_denom_floor: float = 1e-6,
    interpret: bool = False,
) -> RenderOutputs:
    """Rasterize the binned pairs: packed [N, 11] (reference layout) and the
    sorted pair list of ops/binning.py -> image outputs (background not
    applied).  Differentiable with respect to `packed`."""
    grid_w = -(-image_width // tile_w)
    grid_h = -(-image_height // tile_h)
    st = RasterStatic(
        chunk=chunk_size,
        tile_h=tile_h,
        tile_w=tile_w,
        grid_h=grid_h,
        grid_w=grid_w,
        num_pairs=sorted_gauss_idx.shape[0],
        alpha_clamp=alpha_clamp,
        transmittance_eps=transmittance_eps,
        undo_denom_floor=undo_denom_floor,
        interpret=interpret,
    )
    records = _gather_records(packed.shape[0], record_table(packed),
                              sorted_gauss_idx, pair_valid)
    out = _raster_core(st, records, tile_start, tile_count)
    return _untile(out, st, image_width, image_height)


def _untile(out, st: RasterStatic, image_width: int, image_height: int):
    x = out[:, :6].reshape(st.grid_h, st.grid_w, 6, st.tile_h, st.tile_w)
    x = x.transpose(2, 0, 3, 1, 4).reshape(
        6, st.grid_h * st.tile_h, st.grid_w * st.tile_w
    )
    x = x[:, :image_height, :image_width]
    return RenderOutputs(
        color=x[0:3].transpose(1, 2, 0),
        depth=x[3],
        alpha=x[4],
        n_contrib=x[5].astype(jnp.int32),
    )
