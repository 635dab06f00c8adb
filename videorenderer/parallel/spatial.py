"""Spatially-sharded frame processing: one frame split across chips by rows.

For frames too large for one chip's real-time budget (8K+, or very deep
batches), the frame's rows are sharded over the mesh.  Every pipeline stage
is row-local except the vertical (H-axis) contractions — chroma upsample,
blend-deinterlace and resize — which need ``halo`` input rows from the
neighbor shards; those are exchanged with ``jax.lax.ppermute``
inside ``shard_map`` (see :func:`videorenderer.parallel.mesh.halo_exchange`),
which XLA lowers to device-to-device copies over the interconnect.

This is the framework's "sequence parallelism" analogue (SURVEY.md §5): the
support radius of each separable filter is static, so the halo is exact and
the collective volume is a few rows per shard per stage.

Parity with the single-chip fused path (pipeline._make_fused_fn):

 * the same axis maps — per-shard row-map blocks are stacked host-side
   and selected with ``jax.lax.axis_index`` inside shard_map, so one
   compiled program serves every shard;
 * the ordered-dither pattern keeps its unsharded phase (each shard passes
   its global row offset into ops.dither.ordered_dither), so sharded output
   is bit-identical to the single-chip fused output — tests/test_spatial.py
   asserts exact equality;
 * ``src_rect`` crops fold into the axis maps (W locally, H by zero-embedding
   the cropped rows into the full plane height), and ``dst.video_rect``
   placement folds into the H output embedding + a post-dither row mask + a
   W pad — the FillBlack semantics of ps_final_pass without gathering rows
   across shards (the two-pass ResizeShaderPass placement,
   Source/DX11VideoProcessor.cpp:3115-3199, under row sharding).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats import ColorSystem
from ..ops import chroma as chroma_ops
from ..ops import dither as dither_ops
from ..ops import scale as scale_ops
from ..pipeline import (PipelinePlan, _can_fuse, _compose, _corrections,
                        _local_tonemap)
from .mesh import halo_exchange


def required_halo(mat: np.ndarray, n_shards: int) -> int:
    """Exact halo rows needed so each output shard's rows only reference its
    input shard ± halo."""
    h_in, h_out = mat.shape
    assert h_in % n_shards == 0 and h_out % n_shards == 0
    hs_in, hs_out = h_in // n_shards, h_out // n_shards
    halo = 0
    nz_r, nz_c = np.nonzero(mat)
    for r, m in zip(nz_r, nz_c):
        i = m // hs_out
        halo = max(halo, i * hs_in - r, (r + 1) - (i + 1) * hs_in)
    return int(halo)


def _embed(mat: np.ndarray, in_total: int | None = None, in_off: int = 0,
           out_total: int | None = None, out_off: int = 0) -> np.ndarray:
    """Zero-embed an (in, out) axis map into a larger (in_total, out_total):
    input rows land at ``in_off``, output columns at ``out_off``.  Zero
    columns make the corresponding output rows exact 0.0 (black fill) and
    zero rows ignore the pixels cropped away by src_rect."""
    h, w = mat.shape
    it = in_total if in_total is not None else h
    ot = out_total if out_total is not None else w
    if (it, ot) == (h, w) and in_off == 0 and out_off == 0:
        return np.asarray(mat)
    out = np.zeros((it, ot), np.asarray(mat).dtype)
    out[in_off:in_off + h, out_off:out_off + w] = mat
    return out


def _shard_row_mats(mat: np.ndarray, n: int, halo: int) -> list[np.ndarray]:
    """Per-shard (hs_in + 2*halo, hs_out) blocks of a global (h_in, h_out)
    row map: shard i's output rows against its halo-extended input rows
    (out-of-range halo rows get zero weight — halo_exchange's edge-replicated
    rows must not be double counted)."""
    h_in, h_out = mat.shape
    hs_in, hs_out = h_in // n, h_out // n
    mats = []
    for i in range(n):
        lo = i * hs_in - halo
        m = np.zeros((hs_in + 2 * halo, hs_out), mat.dtype)
        g0, g1 = max(lo, 0), min(lo + hs_in + 2 * halo, h_in)
        m[g0 - lo:g1 - lo] = mat[g0:g1, i * hs_out:(i + 1) * hs_out]
        mats.append(m)
    return mats


class _RowResize:
    """One H-axis contraction under row sharding: halo exchange + per-shard
    matmul, with the weight blocks selected by ``jax.lax.axis_index`` so a
    single compiled program serves every shard."""

    def __init__(self, mat: np.ndarray | None, n: int, axis: str,
                 pre_scale: float | None = None):
        self.axis = axis
        self.mat = mat
        self.n = n
        self.pre_scale = pre_scale
        if mat is None:
            return
        self.halo = required_halo(mat, n)
        hs_in = mat.shape[0] // n
        if self.halo > hs_in:
            raise ValueError(
                f"spatial sharding needs {self.halo} halo rows but each "
                f"shard only holds {hs_in}; use fewer shards for this scale")
        self.hs_out = mat.shape[1] // n
        # (n, hs_in+2h, hs_out)
        self._mats = np.stack(_shard_row_mats(mat, n, self.halo))

    def __call__(self, x: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
        """x: this shard's (..., hs_in, W) block (raw integer when
        ``pre_scale`` normalizes it; float otherwise)."""
        if self.mat is None:
            if self.pre_scale is not None:
                return x.astype(dtype) * jnp.asarray(self.pre_scale, dtype)
            return x
        if self.n == 1:
            # single-shard fast path: no collective, no block select — the
            # one stacked block IS the global map (halo is 0 by definition)
            ext = x
            idx = None
        else:
            idx = jax.lax.axis_index(self.axis)
            ext = halo_exchange(x, self.halo, self.axis)
        if idx is None:
            m = jnp.asarray(self._mats[0], dtype)
        else:
            m = jax.lax.dynamic_index_in_dim(
                jnp.asarray(self._mats, dtype), idx, axis=0, keepdims=False)
        if self.pre_scale is not None:
            ext = ext.astype(dtype) * jnp.asarray(self.pre_scale, dtype)
        moved = jnp.moveaxis(ext, -2, -1)
        out = jnp.matmul(moved, m, preferred_element_type=jnp.float32,
                         precision=scale_ops.RESIZE_PRECISION)
        return jnp.moveaxis(out, -1, -2)


def spatial_padded_heights(plan: PipelinePlan, n: int,
                           surf_unit: int = 1) -> tuple[int, int]:
    """(padded source height, padded surface height) for an ``n``-shard row
    mesh: the smallest heights divisible by n for every plane (luma AND
    chroma) and for the surface.  1080p NV12 on 8 shards pads 1080 -> 1088
    (chroma 540 -> 544); already-divisible geometry pads by zero.
    ``surf_unit`` additionally forces each SHARD's surface rows to a
    multiple of it (the learned-model class needs s2d-aligned shards)."""
    info = plan.info
    dh = info.chroma_div[1] if info.cs_type == ColorSystem.YUV else 1
    unit = n * dh
    src_h_pad = -(-plan.src.height // unit) * unit
    sunit = n * surf_unit
    surf_h_pad = -(-plan.dst.height // sunit) * sunit
    return src_h_pad, surf_h_pad


def _jinc2_spatial_ok(plan: PipelinePlan) -> bool:
    """True when the plan's resize is the one-pass 2D Jinc2 upscale (both
    axes "up" or one a no-op) — the case :func:`_make_spatial_jinc2` shards.
    Mixed Jinc2-up/convolution-down axes run two passes and stay
    single-chip."""
    from ..config import Upscaling
    s = plan.settings
    if (s.upscaling != Upscaling.JINC2 or not s.vp_scaling
            or plan.dovi is not None):
        return False
    src, dst = plan.src, plan.dst
    w, h = src.width, src.height
    if plan.src_rect is not None:
        l, t, r, b = plan.src_rect
        w, h = r - l, b - t
    vid_w, vid_h = dst.video_size
    rx, ry = scale_ops.jinc2_passes(h, w, vid_h, vid_w,
                                    s.interpolate_at_50pct)
    return (rx == "up" and ry in ("up", None)
            and (h, w) != (vid_h, vid_w))


def make_spatial_frame_fn(plan: PipelinePlan, mesh: Mesh,
                          axis: str = "spatial", dtype=jnp.float32,
                          pack_surface: bool = False,
                          pad_to_mesh: bool = True,
                          surf_row_unit: int = 1):
    """Row-sharded version of the frame pipeline.

    Input planes are (..., H, W) sharded on H over ``mesh[axis]``; output is
    (..., 3, dst.height, dst.width) sharded the same way, bit-identical to
    the single-chip path — or, with ``pack_surface``, an
    (..., dst.height, dst.width) int32 packed-dword surface (each shard
    packs its own rows).

    Three plan classes shard (SURVEY §5's oversized-frame mandate):

     * fusable linear-prefix plans (pipeline._can_fuse) — the fused
       pipeline per shard;
     * DoVi split-fused plans (pipeline._can_split_fuse) — the reshape/RPU
       matrix/LMS chain is pointwise (row-local); only the chroma-upsample
       and resize H contractions exchange halos;
     * one-pass 2D Jinc2 upscales — the low-rank separable expansion
       (ops.scale._jinc2_lowrank) makes the 2D kernel a sum of ~5 separable
       resizes, so each rank's H pass (and the anti-ringing row selections)
       shard with halos like any separable filter.

    Heights not divisible by the mesh size are handled by ``pad_to_mesh``
    (default): plane heights zero-pad to :func:`spatial_padded_heights`
    (use :func:`pad_shard_planes_rows` to prepare inputs; the pad rows get
    zero weight in the embedded H maps, so they never touch the output) and
    the returned surface has ``surf_h_pad`` rows whose trailing pad rows
    are black — crop with ``out[..., :dst.height, :]``.  With
    ``pad_to_mesh=False`` non-divisible heights raise."""
    from ..pipeline import _can_split_fuse
    if _can_fuse(plan):
        return _make_spatial_fused(plan, mesh, axis, dtype, pack_surface,
                                   pad_to_mesh, surf_row_unit)
    if surf_row_unit != 1:
        raise ValueError("surf_row_unit is only supported for fusable "
                         "(linear-prefix) plans — the learned-model class "
                         "composes on those")
    if _can_split_fuse(plan):
        return _make_spatial_dovi(plan, mesh, axis, dtype, pack_surface,
                                  pad_to_mesh)
    if _jinc2_spatial_ok(plan):
        return _make_spatial_jinc2(plan, mesh, axis, dtype, pack_surface,
                                   pad_to_mesh)
    raise ValueError(
        "spatial sharding requires a fusable (linear-prefix) plan, a DoVi "
        "split-fused plan, or a one-pass 2D Jinc2 upscale; this plan is "
        "none of those (mixed Jinc2 up/down axes, shader-order "
        "corrections, or a non-YUV DoVi source)")


def _check_divisible(plan: PipelinePlan, n: int, pad_to_mesh: bool,
                     surf_h: int, surf_unit: int = 1) -> tuple[int, int, bool]:
    """(src_h_pad, surf_h_pad, pad_rows) plus the non-divisible guard."""
    info = plan.info
    dh = info.chroma_div[1] if info.cs_type == ColorSystem.YUV else 1
    src_h_pad, surf_h_pad = spatial_padded_heights(plan, n, surf_unit)
    if not pad_to_mesh and (src_h_pad != plan.src.height
                            or surf_h_pad != surf_h):
        raise ValueError(
            f"a height (src {plan.src.height}, chroma "
            f"{plan.src.height // dh if info.cs_type == ColorSystem.YUV else '-'},"
            f" surface {surf_h}) is not divisible by the {n}-shard "
            "spatial mesh; enable pad_to_mesh for the pad-and-crop fallback")
    return src_h_pad, surf_h_pad, surf_h_pad != surf_h


def _shard_final(plan: PipelinePlan, rgb: jnp.ndarray, row0, hs_surf: int,
                 rect: tuple[int, int, int, int], surf_w: int,
                 has_vrect: bool, pad_rows: bool, fmt: str | None):
    """Final pass per shard, ps_final_pass.hlsl semantics under sharding:
    dither in video-local pattern coordinates (global surface row minus the
    rect top; columns are video-local until the W pad below), then FillBlack
    rows outside the rect and pad the columns."""
    l1, t1, r1, b1 = rect
    db = plan.dither_bits
    if db is not None and db != 0:
        rgb = jnp.clip(rgb, 0.0, 1.0)
        if db < 0:
            rgb = dither_ops.quantize(rgb, -db)
        else:
            rgb = dither_ops.ordered_dither(rgb, db, row_offset=row0 - t1)
    if has_vrect or pad_rows:
        gr = row0 + jnp.arange(hs_surf)
        mask = ((gr >= t1) & (gr < b1)).astype(rgb.dtype)
        rgb = rgb * mask[:, None]
        rgb = jnp.pad(rgb, [(0, 0)] * (rgb.ndim - 1)
                      + [(l1, surf_w - r1)])
    if fmt is not None:
        from ..pipeline import _pack_surface_xla
        rgb = _pack_surface_xla(rgb, fmt)
    return rgb


def _wrap_shard_map(shard_fn, mesh: Mesh, axis: str, n: int,
                    fmt: str | None):
    """The shard_map wrapper (or the 1-shard fast path) shared by every
    spatial builder; planes are (..., H, W) sharded on H."""
    from jax import shard_map

    def spec_for(ndim):
        parts = [None] * ndim
        parts[-2] = axis
        return P(*parts)

    def fn(planes):
        if n == 1:
            # single-shard fast path: shard_map over a trivial mesh is pure
            # dispatch overhead (SPMD wrapping, axis bookkeeping) — the
            # shard function IS the whole-frame function when halo is empty
            # and every band stack has one entry
            return shard_fn(*planes)
        specs = tuple(spec_for(p.ndim) for p in planes)
        out_spec = spec_for(planes[0].ndim + (0 if fmt is not None else 1))
        smfn = shard_map(shard_fn, mesh=mesh, in_specs=specs,
                         out_specs=out_spec)
        return smfn(*planes)

    return fn


def _make_spatial_fused(plan: PipelinePlan, mesh: Mesh, axis: str, dtype,
                        pack_surface: bool, pad_to_mesh: bool,
                        surf_row_unit: int = 1):
    """Row-sharded fused (linear-prefix) pipeline — see
    :func:`make_spatial_frame_fn`."""
    s = plan.settings
    src, dst = plan.src, plan.dst
    info = plan.info
    n = mesh.shape[axis]

    # --- geometry: src_rect crop and video_rect placement ------------------
    l0, t0, r0, b0 = plan.src_rect or (0, 0, src.width, src.height)
    crop_w, crop_h = r0 - l0, b0 - t0
    vid_w, vid_h = dst.video_size
    l1, t1, r1, b1 = dst.video_rect or (0, 0, dst.width, dst.height)
    surf_w, surf_h = dst.width, dst.height

    dw, dh = info.chroma_div
    src_h_pad, surf_h_pad, pad_rows = _check_divisible(plan, n, pad_to_mesh,
                                                       surf_h, surf_row_unit)

    # --- axis maps, exactly as _make_fused_fn builds them ------------------
    cx = scale_ops.select_scaler(crop_w, vid_w, s.upscaling,
                                 s.downscaling, s.interpolate_at_50pct)
    cy = scale_ops.select_scaler(crop_h, vid_h, s.upscaling,
                                 s.downscaling, s.interpolate_at_50pct)
    wx = scale_ops.build_axis_matrix(cx, crop_w, vid_w)
    wy = scale_ops.build_axis_matrix(cy, crop_h, vid_h)

    blend = (s.deint_blend and src.interlaced and info.subsampling == 420
             and info.cs_type == ColorSystem.YUV)
    wy_luma = wy
    if blend:
        wy_luma = _compose(chroma_ops.blend_deinterlace_matrix(crop_h), wy)

    if info.cs_type == ColorSystem.YUV:
        ux, uy = chroma_ops.chroma_upsample_matrices(
            crop_w // dw, crop_h // dh, info.subsampling,
            s.chroma_scaling, src.chroma_location)
        cwx = _compose(ux, wx)
        cwy = _compose(uy, wy)
    else:
        cwx = cwy = None

    # H maps gain the src_rect input embedding (cropped rows sit at t0 in the
    # full sharded plane) and the video_rect output embedding (video rows sit
    # at t1 in the surface; zero columns produce the black fill).  An
    # identity map materializes whenever embedding or sharding itself makes
    # the H contraction non-trivial.
    embed_h = (plan.src_rect is not None or dst.video_rect is not None
               or src_h_pad != src.height or pad_rows)
    def h_map(m, in_full, in_off, in_vid):
        if m is None and not embed_h:
            return None
        if m is None:
            m = np.eye(in_vid)
        return _embed(np.asarray(m), in_total=in_full, in_off=in_off,
                      out_total=surf_h_pad, out_off=t1)

    my_luma = h_map(wy_luma, src_h_pad, t0, crop_h)
    my_chroma = h_map(cwy, src_h_pad // dh, t0 // dh, crop_h // dh) \
        if info.cs_type == ColorSystem.YUV else None

    norm = 1.0 / (2.0 ** info.plane_bits - 1.0)

    # the UNORM normalization rides the W pass when there is one, else the
    # per-shard H pass
    ry_luma = _RowResize(my_luma, n, axis,
                         pre_scale=norm if wx is None else None)
    ry_chroma = (_RowResize(my_chroma, n, axis,
                            pre_scale=norm if cwx is None else None)
                 if info.cs_type == ColorSystem.YUV else None)

    hs_surf = surf_h_pad // n
    has_vrect = dst.video_rect is not None
    from ..pipeline import _pack_surface_xla, surface_pack_format
    fmt = surface_pack_format(dst) if pack_surface else None

    def apply_w(p, mx, x_lo, x_hi):
        """W-axis pass on this shard's raw rows: crop columns locally, then
        normalize and resize."""
        p = p[..., x_lo:x_hi]
        if mx is None:
            return p  # normalization folds into the H pass
        x = p.astype(dtype) * jnp.asarray(norm, dtype)
        return scale_ops.resize_axis(x, mx, -1)

    def shard_fn(*planes):
        # on a 1-shard mesh there is no axis to index (the fast path below
        # runs shard_fn outside shard_map entirely)
        idx = jax.lax.axis_index(axis) if n > 1 else 0
        if info.cs_type == ColorSystem.GRAY:
            y = ry_luma(apply_w(planes[0], wx, l0, r0), dtype)
            m, c = plan.cmat_m, plan.cmat_c
            rgb = jnp.stack([y * m[i, 0] + c[i] for i in range(3)], axis=-3)
        else:
            if info.cs_type == ColorSystem.YUV:
                comps = (ry_luma(apply_w(planes[0], wx, l0, r0), dtype),
                         ry_chroma(apply_w(planes[1], cwx, l0 // dw,
                                           r0 // dw), dtype),
                         ry_chroma(apply_w(planes[2], cwx, l0 // dw,
                                           r0 // dw), dtype))
            else:
                comps = tuple(ry_luma(apply_w(p, wx, l0, r0), dtype)
                              for p in planes)
            if plan.apply_matrix:
                m = jnp.asarray(plan.cmat_m, dtype)
                c = jnp.asarray(plan.cmat_c, dtype)
                rgb = jnp.stack(
                    [m[i, 0] * comps[0] + m[i, 1] * comps[1]
                     + m[i, 2] * comps[2] + c[i] for i in range(3)], axis=-3)
            else:
                rgb = jnp.stack(comps, axis=-3)
        rgb = _corrections(plan, rgb)
        if plan.local_tonemap:
            rgb = _local_tonemap(plan, rgb)

        return _shard_final(plan, rgb, idx * hs_surf, hs_surf,
                            (l1, t1, r1, b1), surf_w, has_vrect, pad_rows,
                            fmt)

    return _wrap_shard_map(shard_fn, mesh, axis, n, fmt)


def _stage_a_height(plan: PipelinePlan, n: int) -> int:
    """Height of the row-sharded source-resolution intermediate (the cropped
    source rows at offset 0, padded to the mesh)."""
    t0 = plan.src_rect[1] if plan.src_rect is not None else 0
    b0 = plan.src_rect[3] if plan.src_rect is not None else plan.src.height
    return -(-(b0 - t0) // n) * n


def _make_spatial_dovi(plan: PipelinePlan, mesh: Mesh, axis: str, dtype,
                       pack_surface: bool, pad_to_mesh: bool):
    """Row-sharded DoVi split-fused pipeline (pipeline._make_dovi_fused_fn
    under sharding): stage A upsamples chroma to source resolution (the uy
    H contraction exchanges halos) and runs the reshape + RPU ycc matrix +
    LMS PQ round trip — all pointwise, so row-local; stage B resizes the
    PQ RGB to the surface (the wy H contraction exchanges halos) and runs
    corrections/tone map/dither per shard.  Bit-identical to the
    single-chip split-fused path (reference chain:
    Source/Shaders.cpp:531-859)."""
    from ..ops import dovi as dovi_ops
    s = plan.settings
    src, dst = plan.src, plan.dst
    info = plan.info
    n = mesh.shape[axis]

    l0, t0, r0, b0 = plan.src_rect or (0, 0, src.width, src.height)
    crop_w, crop_h = r0 - l0, b0 - t0
    vid_w, vid_h = dst.video_size
    l1, t1, r1, b1 = dst.video_rect or (0, 0, dst.width, dst.height)
    surf_w, surf_h = dst.width, dst.height

    dw, dh = info.chroma_div
    src_h_pad, surf_h_pad, pad_rows = _check_divisible(plan, n, pad_to_mesh,
                                                       surf_h)
    ah_pad = _stage_a_height(plan, n)   # stage-A intermediate rows
    if not pad_to_mesh and ah_pad != crop_h:
        raise ValueError(
            f"the cropped source height {crop_h} is not divisible by the "
            f"{n}-shard spatial mesh; enable pad_to_mesh")

    ux, uy = chroma_ops.chroma_upsample_matrices(
        crop_w // dw, crop_h // dh, info.subsampling,
        s.chroma_scaling, src.chroma_location)
    blend = s.deint_blend and src.interlaced and info.subsampling == 420
    by = chroma_ops.blend_deinterlace_matrix(crop_h) if blend else None

    cx = scale_ops.select_scaler(crop_w, vid_w, s.upscaling,
                                 s.downscaling, s.interpolate_at_50pct)
    cy = scale_ops.select_scaler(crop_h, vid_h, s.upscaling,
                                 s.downscaling, s.interpolate_at_50pct)
    wx = scale_ops.build_axis_matrix(cx, crop_w, vid_w)
    wy = scale_ops.build_axis_matrix(cy, crop_h, vid_h)

    norm = 1.0 / (2.0 ** info.plane_bits - 1.0)

    # stage-A H maps: source-res rows embedded into the ah_pad intermediate
    # (crop rows land at offset 0; zero rows ignore the crop, zero columns
    # keep the pad rows exact 0)
    def a_map(m, in_vid, in_full, in_off):
        if m is None and in_full == ah_pad and in_off == 0 \
                and in_vid == ah_pad:
            return None
        if m is None:
            m = np.eye(in_vid)
        return _embed(np.asarray(m), in_total=in_full, in_off=in_off,
                      out_total=ah_pad, out_off=0)

    ma_luma = a_map(by, crop_h, src_h_pad, t0)
    ma_chroma = a_map(uy, crop_h // dh, src_h_pad // dh, t0 // dh)
    # luma has no W pass in stage A: the normalization rides its H bands
    # (or a plain scale when the map is trivial)
    ra_luma = _RowResize(ma_luma, n, axis, pre_scale=norm)
    ra_chroma = _RowResize(ma_chroma, n, axis,
                           pre_scale=None if ux is not None else norm)

    # stage-B H map: video rows embedded into the surface at the rect top
    mb = wy
    if mb is None and not (ah_pad == surf_h_pad and t1 == 0):
        mb = np.eye(vid_h)
    if mb is not None:
        mb = _embed(np.asarray(mb), in_total=ah_pad, in_off=0,
                    out_total=surf_h_pad, out_off=t1)
    rb = _RowResize(mb, n, axis)

    hs_surf = surf_h_pad // n
    has_vrect = dst.video_rect is not None
    from ..pipeline import surface_pack_format
    fmt = surface_pack_format(dst) if pack_surface else None

    def apply_w_int(p, mx, x_lo, x_hi):
        """Stage-A chroma W upsample on raw integer rows."""
        p = p[..., x_lo:x_hi]
        if mx is None:
            return p
        x = p.astype(dtype) * jnp.asarray(norm, dtype)
        return scale_ops.resize_axis(x, mx, -1)

    def apply_w_f(x, mx):
        """Stage-B W resize on float rows."""
        if mx is None:
            return x
        return scale_ops.resize_axis(x, mx, -1)

    am = np.asarray(plan.cmat_m, np.float32)
    ac = np.asarray(plan.cmat_c, np.float32)

    def shard_fn(y, u, v):
        idx = jax.lax.axis_index(axis) if n > 1 else 0
        # stage A: raw integer planes -> source-res ycc (crop W locally,
        # halo-exchanged H contractions)
        ya = ra_luma(y[..., l0:r0], dtype)
        ua = ra_chroma(apply_w_int(u, ux, l0 // dw, r0 // dw), dtype)
        va = ra_chroma(apply_w_int(v, ux, l0 // dw, r0 // dw), dtype)
        comps = jnp.stack([ya, ua, va], axis=-3)
        # reshape + ycc matrix + LMS PQ round trip: pointwise, row-local
        # (ShaderDoviReshape + the convert pass, Source/Shaders.cpp:809-859)
        comps = dovi_ops.reshape(comps, plan.dovi, axis=-3)
        if plan.apply_matrix:
            yc = comps[..., 0, :, :]
            uc = comps[..., 1, :, :]
            vc = comps[..., 2, :, :]
            rgb = jnp.stack(
                [am[i, 0] * yc + am[i, 1] * uc + am[i, 2] * vc + ac[i]
                 for i in range(3)], axis=-3)
        else:
            rgb = comps
        rgb = dovi_ops.apply_lms_matrix(rgb, plan.dovi, axis=-3)
        # stage B: resize the PQ RGB to the surface
        rgb = rb(apply_w_f(rgb, wx), dtype)
        rgb = _corrections(plan, rgb)
        if plan.local_tonemap:
            rgb = _local_tonemap(plan, rgb)
        return _shard_final(plan, rgb, idx * hs_surf, hs_surf,
                            (l1, t1, r1, b1), surf_w, has_vrect, pad_rows,
                            fmt)

    return _wrap_shard_map(shard_fn, mesh, axis, n, fmt)


def _make_spatial_jinc2(plan: PipelinePlan, mesh: Mesh, axis: str, dtype,
                        pack_surface: bool, pad_to_mesh: bool):
    """Row-sharded one-pass 2D Jinc2 upscale: the low-rank separable
    expansion (ops/scale.py module note) turns the non-separable 2D kernel
    into ~5 separable resizes, so each rank's H pass shards with halo
    exchange like any separable filter; the per-output-pixel weight
    normalization is an outer product (each shard matmuls its own ay rows
    against bx), and the anti-ringing center min/max row selections are
    exact one-hot H maps.  Matches the single-chip low-rank path
    (scale._jinc2_lowrank — the matmul form of
    Shaders/examples/resizer_onepass_jinc2.hlsl) to f32 rounding."""
    from ..ops.scale import (_JINC2_AR_STRENGTH, _jinc2_tap_data,
                             jinc2_lr_matrices)
    s = plan.settings
    src, dst = plan.src, plan.dst
    info = plan.info
    n = mesh.shape[axis]

    l0, t0, r0, b0 = plan.src_rect or (0, 0, src.width, src.height)
    crop_w, crop_h = r0 - l0, b0 - t0
    vid_w, vid_h = dst.video_size
    l1, t1, r1, b1 = dst.video_rect or (0, 0, dst.width, dst.height)
    surf_w, surf_h = dst.width, dst.height

    dw, dh = info.chroma_div
    src_h_pad, surf_h_pad, pad_rows = _check_divisible(plan, n, pad_to_mesh,
                                                       surf_h)
    ah_pad = _stage_a_height(plan, n)
    if not pad_to_mesh and ah_pad != crop_h:
        raise ValueError(
            f"the cropped source height {crop_h} is not divisible by the "
            f"{n}-shard spatial mesh; enable pad_to_mesh")

    # convert stage maps (chroma upsample to source res + optional blend),
    # exactly as the fused builders compose them
    if info.cs_type == ColorSystem.YUV:
        ux, uy = chroma_ops.chroma_upsample_matrices(
            crop_w // dw, crop_h // dh, info.subsampling,
            s.chroma_scaling, src.chroma_location)
    else:
        ux = uy = None
    blend = (s.deint_blend and src.interlaced and info.subsampling == 420
             and info.cs_type == ColorSystem.YUV)
    by = chroma_ops.blend_deinterlace_matrix(crop_h) if blend else None

    norm = 1.0 / (2.0 ** info.plane_bits - 1.0)

    def a_map(m, in_vid, in_full, in_off):
        if m is None and in_full == ah_pad and in_off == 0 \
                and in_vid == ah_pad:
            return None
        if m is None:
            m = np.eye(in_vid)
        return _embed(np.asarray(m), in_total=in_full, in_off=in_off,
                      out_total=ah_pad, out_off=0)

    ra_luma = _RowResize(a_map(by, crop_h, src_h_pad, t0), n, axis,
                         pre_scale=norm)
    ra_chroma = (_RowResize(
        a_map(uy, crop_h // dh, src_h_pad // dh, t0 // dh), n, axis,
        pre_scale=None if ux is not None else norm)
        if info.cs_type == ColorSystem.YUV else None)

    # the low-rank Jinc2 factors: K rank pairs + normalization vectors
    ay_mats, bx_mats, ay, bx = jinc2_lr_matrices(crop_h, vid_h,
                                                 crop_w, vid_w)
    emb_b = lambda m: _embed(np.asarray(m, np.float32), in_total=ah_pad,
                             in_off=0, out_total=surf_h_pad, out_off=t1)
    rank_rows = [_RowResize(emb_b(ak), n, axis)
                 for ak in ay_mats]
    # per-shard weight-sum rows: ay embedded into the surface (rows outside
    # the video rect get 1.0 so the 0-row division stays finite), sharded
    # statically and selected by axis index
    ay_emb = np.ones((surf_h_pad, ay.shape[1]), np.float32)
    ay_emb[t1:t1 + vid_h] = ay
    hs_surf = surf_h_pad // n
    ay_shards = np.stack([ay_emb[i * hs_surf:(i + 1) * hs_surf]
                          for i in range(n)])              # (n, hs, K)
    bx_t = np.asarray(bx.T, np.float32)                    # (K, vid_w)

    # anti-ringing center rows: one-hot selection maps (exact copies)
    by_taps, _ = _jinc2_tap_data(crop_h, vid_h)
    r0_rows = np.clip(by_taps, 0, crop_h - 1)
    r1_rows = np.clip(by_taps + 1, 0, crop_h - 1)

    def sel_map(rows):
        m = np.zeros((crop_h, vid_h), np.float32)
        m[rows, np.arange(vid_h)] = 1.0
        return _RowResize(emb_b(m), n, axis)

    rsel0, rsel1 = sel_map(r0_rows), sel_map(r1_rows)
    bx_taps, _ = _jinc2_tap_data(crop_w, vid_w)
    c0_cols = jnp.asarray(np.clip(bx_taps, 0, crop_w - 1))
    c1_cols = jnp.asarray(np.clip(bx_taps + 1, 0, crop_w - 1))

    has_vrect = dst.video_rect is not None
    from ..pipeline import surface_pack_format
    fmt = surface_pack_format(dst) if pack_surface else None

    def apply_w_int(p, mx, x_lo, x_hi):
        p = p[..., x_lo:x_hi]
        if mx is None:
            return p
        x = p.astype(dtype) * jnp.asarray(norm, dtype)
        return scale_ops.resize_axis(x, mx, -1)

    def apply_w_f(x, mx):
        return scale_ops.resize_axis(x, mx, -1)

    def shard_fn(*planes):
        idx = jax.lax.axis_index(axis) if n > 1 else 0
        # convert: normalize + chroma upsample + color matrix at source res
        if info.cs_type == ColorSystem.GRAY:
            yc = ra_luma(planes[0][..., l0:r0], dtype)
            m, c = plan.cmat_m, plan.cmat_c
            rgb = jnp.stack([yc * m[i, 0] + c[i] for i in range(3)],
                            axis=-3)
        else:
            if info.cs_type == ColorSystem.YUV:
                comps = (ra_luma(planes[0][..., l0:r0], dtype),
                         ra_chroma(apply_w_int(planes[1], ux, l0 // dw,
                                               r0 // dw), dtype),
                         ra_chroma(apply_w_int(planes[2], ux, l0 // dw,
                                               r0 // dw), dtype))
            else:
                comps = tuple(ra_luma(p[..., l0:r0], dtype) for p in planes)
            if plan.apply_matrix:
                m = jnp.asarray(plan.cmat_m, dtype)
                c = jnp.asarray(plan.cmat_c, dtype)
                rgb = jnp.stack(
                    [m[i, 0] * comps[0] + m[i, 1] * comps[1]
                     + m[i, 2] * comps[2] + c[i] for i in range(3)],
                    axis=-3)
            else:
                rgb = jnp.stack(comps, axis=-3)

        # 2D Jinc2 via the low-rank expansion, per shard (same accumulation
        # order as scale._jinc2_lowrank: W then H per rank, running sum)
        un = None
        for rk, bk in zip(rank_rows, bx_mats):
            t = rk(apply_w_f(rgb, bk), dtype)
            un = t if un is None else un + t
        ay_sh = jax.lax.dynamic_index_in_dim(
            jnp.asarray(ay_shards), idx, axis=0, keepdims=False)
        wsum = jnp.matmul(ay_sh, jnp.asarray(bx_t),
                          precision=jax.lax.Precision.HIGHEST)
        out = un / wsum
        # anti-ringing clamp against the center 2x2 input taps
        x0 = rsel0(rgb, dtype)
        x1 = rsel1(rgb, dtype)
        mn_r = jnp.minimum(x0, x1)
        mx_r = jnp.maximum(x0, x1)
        mn = jnp.minimum(jnp.take(mn_r, c0_cols, axis=-1),
                         jnp.take(mn_r, c1_cols, axis=-1))
        mx = jnp.maximum(jnp.take(mx_r, c0_cols, axis=-1),
                         jnp.take(mx_r, c1_cols, axis=-1))
        clamped = jnp.clip(out, mn, mx)
        rgb = out + (clamped - out) * _JINC2_AR_STRENGTH

        if s.vp_scaling:
            rgb = _corrections(plan, rgb)
        if plan.local_tonemap:
            rgb = _local_tonemap(plan, rgb)
        return _shard_final(plan, rgb, idx * hs_surf, hs_surf,
                            (l1, t1, r1, b1), surf_w, has_vrect, pad_rows,
                            fmt)

    return _wrap_shard_map(shard_fn, mesh, axis, n, fmt)


def model_receptive_radius_s2d(params) -> int:
    """Total receptive-field row radius (in s2d-domain pixels) of a conv
    trunk: the sum of each 4-D conv kernel's row radius.  Every conv sits
    on the deepest path through the residual trunks of models/superres.py
    and models/videohdr.py, so the radii add."""
    total = 0
    for leaf in jax.tree_util.tree_leaves(params):
        if getattr(leaf, "ndim", 0) == 4:
            total += (int(leaf.shape[0]) - 1) // 2
    return total


def make_spatial_learned_fn(plan: PipelinePlan, mesh: Mesh, params, cfg,
                            kind: str, axis: str = "spatial",
                            dtype=jnp.float32, pack_surface: bool = False,
                            pad_to_mesh: bool = True):
    """Row-sharded learned-model composition (the fourth spatial plan
    class): the 1:1 convert pipeline runs in its sharded fused class, then
    the conv net runs per shard on halo-extended rows.

    ``kind`` is ``"superres"`` (models/superres.enhance_plane_chw — the
    vendor-SR slot, Source/D3D11VP.cpp:712-844) or ``"videohdr"``
    (models/videohdr.enhance_plane_chw — the RTX Video HDR slot,
    Source/D3D11VP.cpp:846-891).  ``params``/``cfg`` as the api setters
    take them.

    Why it is exact: every conv is SAME-padded, so an output row at
    distance >= R (the summed conv radius, :func:`model_receptive_radius_s2d`)
    from a block edge equals the whole-frame result.  Each shard extends
    its rows by ``halo = R * cfg.s2d`` source pixels via
    :func:`..parallel.mesh.halo_exchange`, ZEROES the halo rows that fall
    outside the global frame (conv SAME zero-padding semantics — the
    exchange itself edge-replicates, which would NOT match), applies the
    net with ``row_valid`` frame bounds (each conv's out-of-frame output
    rows are re-zeroed — without this, fake halo rows accumulate
    relu(bias) activations that whole-frame SAME padding never produces,
    and global-edge shards drift), and crops the halo back off.  The s2d
    space-to-depth transform stays shard-local because shard heights are
    padded to a multiple of ``cfg.s2d`` (``surf_row_unit`` on the base
    builder).

    Output: (..., 3, H*scale, W*scale) float (scale = cfg.scale for
    superres, 1 for videohdr) sharded on rows, matching
    ``enhance_plane_chw(params, make_frame_fn(plan)(planes), cfg)`` — or
    the packed int32 surface with ``pack_surface``.  Heights padded by
    the mesh come back as black rows; crop with ``[..., :H*scale, :]``.

    Equality caveat: the halo/mask algebra is exact (f32 halo-math test),
    but XLA's bf16 conv lowering is not bit-stable across input heights,
    so bf16 trunks can differ from single-chip by ~1 conv ulp (~66 dB;
    the shipped SR configuration happens to lower shape-stably and IS
    bit-identical — both pinned in tests/test_spatial.py)."""
    if kind == "superres":
        from ..models.superres import enhance_plane_chw as net_apply
        scale = cfg.scale
    elif kind == "videohdr":
        from ..models.videohdr import enhance_plane_chw as net_apply
        scale = 1
    else:
        raise ValueError(f"unknown learned-model kind {kind!r}")
    s2d = int(getattr(cfg, "s2d", 1))
    n = mesh.shape[axis]
    surf_h = plan.dst.height
    if surf_h % s2d != 0:
        raise ValueError(
            f"spatial learned-model sharding needs the model input height "
            f"({surf_h}) divisible by cfg.s2d={s2d}: the single-chip model "
            "edge-pads the s2d grid, which zero halos cannot reproduce")

    base = make_spatial_frame_fn(plan, mesh, axis, dtype,
                                 pack_surface=False, pad_to_mesh=pad_to_mesh,
                                 surf_row_unit=s2d)
    _, surf_h_pad = spatial_padded_heights(plan, n, surf_unit=s2d)
    hs = surf_h_pad // n
    radius = model_receptive_radius_s2d(params)
    halo = radius * s2d
    if halo > hs:
        raise ValueError(
            f"learned-model sharding needs {halo} halo rows but each shard "
            f"only holds {hs}; use fewer shards for this size")

    from ..pipeline import _pack_surface_xla, surface_pack_format
    fmt = surface_pack_format(plan.dst) if pack_surface else None
    pad_rows = surf_h_pad != surf_h

    def model_shard(rgb):
        if n == 1:
            y = net_apply(params, rgb, cfg)
        else:
            idx = jax.lax.axis_index(axis)
            ext = halo_exchange(rgb, halo, axis)
            start = idx * hs - halo          # block's global source row 0
            gr = start + jnp.arange(hs + 2 * halo)
            mask = ((gr >= 0) & (gr < surf_h)).astype(ext.dtype)
            ext = ext * mask[:, None]
            # frame bounds in the block's local s2d rows: the net re-zeroes
            # each conv's out-of-frame rows (SAME zero-pad parity)
            row_valid = (-start // s2d, (surf_h - start) // s2d)
            y = net_apply(params, ext, cfg, row_valid=row_valid)
            y = y[..., halo * scale:(halo + hs) * scale, :]
            if pad_rows:
                # keep the mesh-pad rows black (the net's bias terms would
                # otherwise leak nonzero values into them)
                gro = idx * hs * scale + jnp.arange(hs * scale)
                y = y * (gro < surf_h * scale).astype(y.dtype)[:, None]
        if fmt is not None:
            y = _pack_surface_xla(y, fmt)
        return y

    def spec_for(ndim):
        parts = [None] * ndim
        parts[-2] = axis
        return P(*parts)

    def fn(planes):
        rgb = base(planes)
        if n == 1:
            return model_shard(rgb)
        from jax import shard_map
        smfn = shard_map(
            model_shard, mesh=mesh, in_specs=spec_for(rgb.ndim),
            out_specs=spec_for(rgb.ndim - (1 if fmt is not None else 0)))
        return smfn(rgb)

    return fn


def shard_planes_rows(mesh: Mesh, planes, axis: str = "spatial"):
    """Place (..., H, W) plane arrays with H sharded over the mesh."""
    def put(x):
        parts = [None] * x.ndim
        parts[-2] = axis
        return jax.device_put(x, NamedSharding(mesh, P(*parts)))
    return tuple(put(p) for p in planes)


def pad_shard_planes_rows(plan: PipelinePlan, mesh: Mesh, planes,
                          axis: str = "spatial"):
    """Zero-pad plane heights to :func:`spatial_padded_heights` and shard —
    the input half of the pad-and-crop fallback (the pad rows carry zero
    weight in the embedded H maps, so their values never reach the
    output)."""
    n = mesh.shape[axis]
    src_h_pad, _ = spatial_padded_heights(plan, n)
    info = plan.info
    dh = info.chroma_div[1]
    out = []
    for i, p in enumerate(planes):
        target = (src_h_pad // dh
                  if i > 0 and info.cs_type == ColorSystem.YUV else src_h_pad)
        ph = p.shape[-2]
        if ph < target:
            pads = [(0, 0)] * (p.ndim - 2) + [(0, target - ph), (0, 0)]
            p = jnp.pad(jnp.asarray(p), pads)
        out.append(p)
    return shard_planes_rows(mesh, tuple(out), axis)
