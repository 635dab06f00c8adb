"""Spatially-sharded pipeline vs the single-device fused pipeline."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.csputils import CSP
from videorenderer.config import Upscaling
from videorenderer.parallel.spatial import (make_spatial_frame_fn,
                                                required_halo,
                                                shard_planes_rows)
from videorenderer.pipeline import make_frame_fn, plan_pipeline
from videorenderer.ops import scale


def test_required_halo():
    mat = scale.upscale_matrix(Upscaling.LANCZOS3, 64, 128)
    h = required_halo(np.asarray(mat), 4)
    assert 1 <= h <= 8
    mat2 = scale.upscale_matrix(Upscaling.LANCZOS3, 128, 64)
    h2 = required_halo(np.asarray(mat2), 4)
    assert h2 >= 1


@pytest.mark.parametrize("out_size", [(64, 128), (32, 32), (128, 256)])
def test_spatial_matches_single(out_size):
    oh, ow = out_size
    w, h = 64, 64
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=ow, height=oh, bits=8)
    plan = plan_pipeline(Settings(use_dither=False), src, dst)

    rng = np.random.default_rng(0)
    planes = (rng.integers(0, 256, (h, w), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8))

    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    sharded = shard_planes_rows(mesh, tuple(jnp.asarray(p) for p in planes))
    fn = jax.jit(make_spatial_frame_fn(plan, mesh))
    got = np.asarray(fn(sharded))
    np.testing.assert_allclose(got, ref, atol=3e-6)


def test_spatial_src_rect_exact():
    """src_rect folds into the axis maps (H crop zero-embedded into the
    sharded plane height): bit-identical to the single-chip fused crop."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    w, h = 64, 64
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709, src_rect=(8, 4, 56, 52))
    dst = OutputDescriptor(width=96, height=96, bits=8)
    plan = plan_pipeline(Settings(), src, dst)
    rng = np.random.default_rng(2)
    planes = (rng.integers(0, 256, (h, w), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8))
    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    got = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh))(
        shard_planes_rows(mesh, tuple(jnp.asarray(p) for p in planes))))
    np.testing.assert_array_equal(got, ref)


def test_spatial_video_rect_exact():
    """video_rect placement: H output embedding + row mask + W pad give the
    FillBlack surface bit-identically, including the dither phase (the rect
    top is NOT a multiple of the 32-row Bayer period)."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    w, h = 64, 64
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=128, height=96, bits=8,
                           video_rect=(24, 20, 104, 84))
    plan = plan_pipeline(Settings(), src, dst)
    rng = np.random.default_rng(3)
    planes = (rng.integers(0, 256, (h, w), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8))
    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    got = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh))(
        shard_planes_rows(mesh, tuple(jnp.asarray(p) for p in planes))))
    assert got.shape == (3, 96, 128)
    np.testing.assert_array_equal(got, ref)


def test_spatial_guards():
    """Clear errors for unshardable configs instead of trace-time shape
    failures (VERDICT r1: _final_pass video_rect was unguarded)."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    src = SourceDescriptor(format=ColorFormat.NV12, width=64, height=60,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=64, height=64, bits=8)
    plan = plan_pipeline(Settings(), src, dst)
    with pytest.raises(ValueError, match="not divisible"):
        make_spatial_frame_fn(plan, mesh, pad_to_mesh=False)
    src2 = SourceDescriptor(format=ColorFormat.NV12, width=64, height=64,
                            matrix=CSP.BT_709)
    dst2 = OutputDescriptor(width=64, height=66, bits=8)
    with pytest.raises(ValueError, match="not divisible"):
        make_spatial_frame_fn(plan_pipeline(Settings(), src2, dst2), mesh,
                              pad_to_mesh=False)
    # non-fusable plan (DoVi-free check: shader-order corrections)
    plan3 = plan_pipeline(Settings(vp_scaling=False), src2,
                          OutputDescriptor(width=64, height=64))
    with pytest.raises(ValueError, match="fusable"):
        make_spatial_frame_fn(plan3, mesh)


def test_spatial_dither_and_hdr():
    from videorenderer.csputils import Levels, Primaries, TRC
    mesh = Mesh(np.array(jax.devices()[:2]), ("spatial",))
    w, h = 64, 32
    src = SourceDescriptor(format=ColorFormat.P010, width=w, height=h,
                           matrix=CSP.BT_2020_NC, levels=Levels.TV,
                           primaries=Primaries.BT_2020, transfer=TRC.PQ)
    dst = OutputDescriptor(width=32, height=16, bits=10)
    plan = plan_pipeline(Settings(upscaling=Upscaling.LANCZOS3), src, dst)
    rng = np.random.default_rng(1)
    planes = (rng.integers(64, 941, (h, w), np.uint16) << 6,
              rng.integers(64, 961, (h // 2, w // 2), np.uint16) << 6,
              rng.integers(64, 961, (h // 2, w // 2), np.uint16) << 6)
    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    got = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh))(
        shard_planes_rows(mesh, tuple(jnp.asarray(p) for p in planes))))
    # sharded dither keeps the unsharded pattern phase: bit-identical output
    np.testing.assert_array_equal(got, ref)


def test_spatial_pack_surface():
    """Per-shard packed-surface output equals packing the unpacked sharded
    result."""
    from videorenderer.parallel.spatial import (make_spatial_frame_fn,
                                                    shard_planes_rows)
    from videorenderer.pipeline import _pack_surface_xla
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    rng = np.random.default_rng(61)
    H, W = 32, 64
    planes = (jnp.asarray(rng.integers(0, 256, (H, W), np.uint8)),
              jnp.asarray(rng.integers(0, 256, (H // 2, W // 2), np.uint8)),
              jnp.asarray(rng.integers(0, 256, (H // 2, W // 2), np.uint8)))
    src = SourceDescriptor(format=ColorFormat.NV12, width=W, height=H,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=W * 2, height=H * 2, bits=8)
    plan = plan_pipeline(Settings(use_dither=True), src, dst)
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    sp = shard_planes_rows(mesh, planes)
    plain = jax.jit(make_spatial_frame_fn(plan, mesh))(sp)
    packed = np.asarray(jax.jit(make_spatial_frame_fn(
        plan, mesh, pack_surface=True))(sp))
    ref = np.asarray(_pack_surface_xla(plain, "rgba8"))
    assert packed.shape == (H * 2, W * 2)
    np.testing.assert_array_equal(packed, ref)


def test_spatial_pad_and_crop_1080p():
    """Pad-and-crop fallback (VERDICT r2): 1080p NV12 on an 8-shard mesh —
    1080/540 rows are not divisible by 8, so planes pad to 1088/544 with
    zero-weight rows and the surface pads to the next mesh multiple; the
    cropped output is bit-identical to the single-chip fused path."""
    from videorenderer.parallel.spatial import (pad_shard_planes_rows,
                                                    spatial_padded_heights)
    mesh = Mesh(np.array(jax.devices()[:8]), ("spatial",))
    w, h = 128, 108            # 1080p geometry /10: same divisibility shape
    ow, oh = 64, 54
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=ow, height=oh, bits=8)
    plan = plan_pipeline(Settings(upscaling=Upscaling.LANCZOS3), src, dst)
    src_h_pad, surf_h_pad = spatial_padded_heights(plan, 8)
    assert src_h_pad == 112 and surf_h_pad == 56

    rng = np.random.default_rng(7)
    planes = (rng.integers(0, 256, (h, w), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8))
    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    sp = pad_shard_planes_rows(plan, mesh, planes)
    got = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh))(sp))
    assert got.shape[-2] == surf_h_pad
    np.testing.assert_array_equal(got[..., :oh, :], ref)
    # pad rows are black fill
    assert np.all(got[..., oh:, :] == 0)


def test_spatial_pad_batched_and_packed():
    """Pad-and-crop with a batch dim and packed-surface output."""
    from videorenderer.parallel.spatial import pad_shard_planes_rows
    from videorenderer.pipeline import _pack_surface_xla
    mesh = Mesh(np.array(jax.devices()[:8]), ("spatial",))
    w, h, ow, oh = 64, 52, 64, 52
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=ow, height=oh, bits=8)
    plan = plan_pipeline(Settings(), src, dst)
    rng = np.random.default_rng(8)
    planes = (rng.integers(0, 256, (2, h, w), np.uint8),
              rng.integers(0, 256, (2, h // 2, w // 2), np.uint8),
              rng.integers(0, 256, (2, h // 2, w // 2), np.uint8))
    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    sp = pad_shard_planes_rows(plan, mesh, planes)
    got = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh))(sp))
    np.testing.assert_array_equal(got[..., :oh, :], ref)
    packed = np.asarray(jax.jit(make_spatial_frame_fn(
        plan, mesh, pack_surface=True))(sp))
    ref_p = np.asarray(_pack_surface_xla(jnp.asarray(got), "rgba8"))
    np.testing.assert_array_equal(packed, ref_p)


def test_spatial_single_shard_fast_path():
    """A 1-device mesh takes the no-shard_map fast path (no collectives,
    static band selection); output stays bit-identical to the fused
    single-chip function AND to the multi-shard result, dither included."""
    w, h = 64, 64
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=128, height=96, bits=8)
    plan = plan_pipeline(Settings(use_dither=True), src, dst)
    rng = np.random.default_rng(7)
    planes = tuple(jnp.asarray(p) for p in (
        rng.integers(0, 256, (h, w), np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), np.uint8)))

    ref = np.asarray(jax.jit(make_frame_fn(plan, fused=True))(planes))

    mesh1 = Mesh(np.array(jax.devices()[:1]), ("spatial",))
    fn1 = jax.jit(make_spatial_frame_fn(plan, mesh1))
    got1 = np.asarray(fn1(shard_planes_rows(mesh1, planes)))
    np.testing.assert_array_equal(got1, ref)

    # the fast path must not drift from the real sharded program
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    fn4 = jax.jit(make_spatial_frame_fn(plan, mesh4))
    got4 = np.asarray(fn4(shard_planes_rows(mesh4, planes)))
    np.testing.assert_array_equal(got4, got1)

    # packed-surface variant rides the same fast path
    fn1p = jax.jit(make_spatial_frame_fn(plan, mesh1, pack_surface=True))
    got1p = np.asarray(fn1p(shard_planes_rows(mesh1, planes)))
    from videorenderer.pipeline import _pack_surface_xla
    np.testing.assert_array_equal(
        got1p, np.asarray(_pack_surface_xla(jnp.asarray(ref), "rgba8")))


# ---------------------------------------------------------------------------
# DoVi split-fused and one-pass Jinc2 plans under row sharding (VERDICT r3 #5)
# ---------------------------------------------------------------------------


def _dovi_poly_meta():
    from videorenderer.ops import dovi as dovi_ops
    from videorenderer.ops.dovi import ReshapeCurve
    curve = ReshapeCurve(pivots=(0.5,), method=(0, 0),
                         poly=np.array([[0.02, 0.9, 0.1],
                                        [0.0, 1.05, -0.05]]))
    return dovi_ops.DoviMetadata(
        curves=(curve, dovi_ops.identity_curve(), dovi_ops.identity_curve()),
        ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                    [1, -0.164553, -0.571353],
                                    [1, 1.8814, 0]]),
        ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
        rgb_to_lms_matrix=np.linalg.inv(dovi_ops.DOVI_LMS2RGB))


def _dovi_src(w, h, **over):
    from videorenderer.csputils import Primaries, TRC
    return SourceDescriptor(format=ColorFormat.P010, width=w, height=h,
                            transfer=TRC.PQ, primaries=Primaries.BT_2020,
                            matrix=CSP.BT_2020_NC, dovi=_dovi_poly_meta(),
                            **over)


def _p010_planes(w, h, seed=0, batch=None):
    rng = np.random.default_rng(seed)
    shape = lambda *s: ((batch,) + s) if batch else s
    return (rng.integers(64, 941, shape(h, w), np.uint16) << 6,
            rng.integers(64, 961, shape(h // 2, w // 2), np.uint16) << 6,
            rng.integers(64, 961, shape(h // 2, w // 2), np.uint16) << 6)


@pytest.mark.parametrize("out_size", [(64, 64), (32, 32), (16, 16)])
def test_spatial_dovi_matches_single(out_size):
    """Row-sharded DoVi split-fused pipeline is bit-identical to the
    single-chip split-fused path: reshape/matrix/LMS are row-local, only
    the chroma-upsample and resize H contractions exchange halos."""
    from videorenderer.pipeline import _can_split_fuse
    ow, oh = out_size
    w, h = 32, 32
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    src = _dovi_src(w, h)
    dst = OutputDescriptor(width=ow, height=oh, bits=8)
    plan = plan_pipeline(Settings(use_dither=False), src, dst)
    assert _can_split_fuse(plan)
    planes = _p010_planes(w, h, seed=11)
    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    got = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh))(
        shard_planes_rows(mesh, tuple(jnp.asarray(p) for p in planes))))
    np.testing.assert_array_equal(got, ref)


def test_spatial_dovi_vrect_dither_and_pack():
    """DoVi spatial with video_rect placement, ordered dither and packed
    surface output — full final-pass semantics under sharding.  The PQ->SDR
    chain amplifies the per-shard matmul's reduction-order ULPs (~x80
    luminance scale through the EOTF), so quantized codes may flip by 1 LSB
    at dither thresholds — the same bar as test_fused."""
    from videorenderer.pipeline import _pack_surface_xla
    w, h = 32, 32
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    src = _dovi_src(w, h)
    dst = OutputDescriptor(width=96, height=64, bits=8,
                           video_rect=(16, 12, 80, 60))
    plan = plan_pipeline(Settings(use_dither=True), src, dst)
    planes = _p010_planes(w, h, seed=12)
    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    sp = shard_planes_rows(mesh, tuple(jnp.asarray(p) for p in planes))
    got = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh))(sp))
    assert got.shape == ref.shape
    diff = np.abs(got - ref)
    assert (diff > 0.5 / 255).mean() < 1e-3
    assert diff.max() <= 1.5 / 255
    # black fill outside the rect is exact
    np.testing.assert_array_equal(got[..., :12, :], 0.0)
    np.testing.assert_array_equal(got[..., 60:, :], 0.0)
    np.testing.assert_array_equal(got[..., :16], 0.0)
    # the packed surface is exactly the packed planar shard output
    packed = np.asarray(jax.jit(make_spatial_frame_fn(
        plan, mesh, pack_surface=True))(sp))
    np.testing.assert_array_equal(
        packed, np.asarray(_pack_surface_xla(jnp.asarray(got), "rgba8")))


def test_spatial_dovi_pad_and_crop():
    """Non-divisible DoVi heights take the pad-and-crop fallback (the 8K
    oversized-frame story for split-fused chains)."""
    from videorenderer.parallel.spatial import pad_shard_planes_rows
    w, h = 32, 28           # chroma 14 rows: not divisible by 4 shards
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    src = _dovi_src(w, h)
    dst = OutputDescriptor(width=64, height=56, bits=8)
    plan = plan_pipeline(Settings(use_dither=False), src, dst)
    planes = _p010_planes(w, h, seed=13)
    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    sp = pad_shard_planes_rows(plan, mesh, planes)
    got = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh))(sp))
    np.testing.assert_array_equal(got[..., :56, :], ref)
    assert np.all(got[..., 56:, :] == 0)


def test_spatial_jinc2_matches_single():
    """Row-sharded one-pass 2D Jinc2 upscale: bit-identical across shard
    counts, and matches the single-chip low-rank path up to the staged
    path's function-form chroma upsample (rare 1-LSB flips, same bar as
    test_fused)."""
    w, h, ow, oh = 64, 64, 128, 128
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=ow, height=oh, bits=8)
    plan = plan_pipeline(Settings(upscaling=Upscaling.JINC2,
                                  use_dither=False), src, dst)
    rng = np.random.default_rng(21)
    planes = tuple(jnp.asarray(p) for p in (
        rng.integers(0, 256, (h, w), np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), np.uint8),
        rng.integers(0, 256, (h // 2, w // 2), np.uint8)))
    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))

    mesh1 = Mesh(np.array(jax.devices()[:1]), ("spatial",))
    got1 = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh1))(
        shard_planes_rows(mesh1, planes)))
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    got4 = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh4))(
        shard_planes_rows(mesh4, planes)))
    # sharding must not change a single bit relative to the 1-shard program
    np.testing.assert_array_equal(got4, got1)
    diff = np.abs(got1 - ref)
    assert (diff > 0.5 / 255).mean() < 1e-3
    assert diff.max() <= 1.5 / 255


def test_spatial_jinc2_vrect_and_batch():
    """Jinc2 spatial with video_rect placement and a batch dim (the
    single-chip reference takes the staged resize_plane path here)."""
    w, h = 64, 64
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=128, height=96, bits=8,
                           video_rect=(24, 4, 112, 92))
    plan = plan_pipeline(Settings(upscaling=Upscaling.JINC2), src, dst)
    rng = np.random.default_rng(22)
    planes = tuple(jnp.asarray(p) for p in (
        rng.integers(0, 256, (2, h, w), np.uint8),
        rng.integers(0, 256, (2, h // 2, w // 2), np.uint8),
        rng.integers(0, 256, (2, h // 2, w // 2), np.uint8)))
    ref = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    got = np.asarray(jax.jit(make_spatial_frame_fn(plan, mesh))(
        shard_planes_rows(mesh, planes)))
    assert got.shape == ref.shape == (2, 3, 96, 128)
    diff = np.abs(got - ref)
    assert (diff > 0.5 / 255).mean() < 1e-3
    assert diff.max() <= 1.5 / 255


def test_spatial_jinc2_mixed_axes_raise():
    """Mixed Jinc2-up / convolution-down axes stay single-chip: clear
    error, not a wrong result."""
    src = SourceDescriptor(format=ColorFormat.NV12, width=64, height=64,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=128, height=16, bits=8)  # W up, H down 4x
    plan = plan_pipeline(Settings(upscaling=Upscaling.JINC2), src, dst)
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    with pytest.raises(ValueError, match="fusable"):
        make_spatial_frame_fn(plan, mesh)


def _nv12_planes(rng, w, h):
    return (rng.integers(0, 256, (h, w), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8))


def test_spatial_learned_superres_exact():
    """Learned-model plan class, SR: halo-extended per-shard conv trunk is
    bit-identical to enhance_plane_chw over the single-chip frame (conv
    SAME zero-padding reproduced by zeroed out-of-frame halo rows)."""
    from videorenderer.models.superres import (SuperResConfig,
                                                   enhance_plane_chw,
                                                   init_params)
    from videorenderer.parallel.spatial import make_spatial_learned_fn

    cfg = SuperResConfig(channels=8, num_blocks=1, scale=2, s2d=2)
    params = init_params(jax.random.PRNGKey(7), cfg)
    # randomize biases too (init zeroes them): nonzero biases are what the
    # row_valid frame bounds exist for — zero biases would pass trivially
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(21), len(leaves))
    params = jax.tree_util.tree_unflatten(tree, [
        p if p.ndim == 4 else
        (jax.random.normal(k, p.shape, jnp.float32) * 0.1).astype(p.dtype)
        for k, p in zip(keys, leaves)])
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    w, h = 64, 48
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=w, height=h, bits=8)   # 1:1 convert base
    plan = plan_pipeline(Settings(), src, dst)
    rng = np.random.default_rng(11)
    planes = tuple(jnp.asarray(p) for p in _nv12_planes(rng, w, h))

    ref = np.asarray(enhance_plane_chw(
        params, jax.jit(make_frame_fn(plan))(planes), cfg))
    fn = jax.jit(make_spatial_learned_fn(plan, mesh, params, cfg,
                                         "superres"))
    got = np.asarray(fn(shard_planes_rows(mesh, planes)))
    assert got.shape == (3, h * 2, w * 2)
    np.testing.assert_array_equal(got, ref)


def test_spatial_learned_videohdr_halo_math_exact():
    """The halo/mask math of the learned class is EXACT for VideoHDR:
    running the net eagerly on a halo-extended block with out-of-frame
    rows zeroed AND row_valid frame bounds (what each shard does)
    reproduces the whole-frame result bit-for-bit on the kept rows —
    including the global-edge shards, where row_valid re-zeroes each
    conv's out-of-frame rows so fake halo rows never accumulate
    relu(bias) activations that whole-frame SAME padding lacks."""
    from videorenderer.models.videohdr import (VideoHDRConfig,
                                                   enhance_plane_chw,
                                                   init_params)
    from videorenderer.parallel.spatial import model_receptive_radius_s2d

    # f32 compute isolates the halo MATH from bf16 conv rounding (XLA's
    # conv lowering is not bit-stable across input heights in bf16)
    cfg = VideoHDRConfig(channels=8, s2d=2, dtype=jnp.float32)
    params = init_params(jax.random.PRNGKey(3), cfg)
    # randomize ALL weights AND biases: nonzero biases are exactly what
    # makes naive zero-halo blocks drift at global edges
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(9), len(leaves))
    params = jax.tree_util.tree_unflatten(tree, [
        (jax.random.normal(k, p.shape, jnp.float32) * 0.05).astype(p.dtype)
        for k, p in zip(keys, leaves)])
    rng = np.random.default_rng(13)
    h, w = 48, 64
    x = jnp.asarray(rng.random((3, h, w)), jnp.float32)
    full = np.asarray(enhance_plane_chw(params, x, cfg))
    halo = model_receptive_radius_s2d(params) * cfg.s2d
    assert halo == 6
    n, hs = 4, h // 4
    for i in range(n):
        lo, hi = i * hs - halo, (i + 1) * hs + halo
        ext = jnp.zeros((3, hs + 2 * halo, w), jnp.float32)
        g0, g1 = max(lo, 0), min(hi, h)
        ext = ext.at[:, g0 - lo:g1 - lo].set(x[:, g0:g1])
        rv = (-lo // cfg.s2d, (h - lo) // cfg.s2d)
        y = np.asarray(enhance_plane_chw(params, ext, cfg, row_valid=rv))
        np.testing.assert_array_equal(y[:, halo:halo + hs],
                                      full[:, i * hs:(i + 1) * hs])


def test_spatial_learned_videohdr_packed_band():
    """End-to-end sharded VideoHDR with in-class surface packing, on a
    height the mesh must pad: pad rows come back black and the real rows
    match the single-chip composition within a tight band.  (Not
    bit-equal: XLA's SPMD partitioner lowers the bf16 convs differently
    inside shard_map, flipping conv outputs by 1 bf16 ulp — the halo/mask
    math itself is proven exact by
    test_spatial_learned_videohdr_halo_math_exact; the SR class, whose
    convs lower identically, IS asserted bit-equal.)"""
    from videorenderer.models.videohdr import (VideoHDRConfig,
                                                   enhance_plane_chw,
                                                   init_params)
    from videorenderer.parallel.spatial import (make_spatial_learned_fn,
                                                    pad_shard_planes_rows,
                                                    spatial_padded_heights)
    from videorenderer.formats import unpack_rgb10

    cfg = VideoHDRConfig(channels=8, s2d=2)
    params = init_params(jax.random.PRNGKey(3), cfg)
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(9), len(leaves))
    params = jax.tree_util.tree_unflatten(tree, [
        (jax.random.normal(k, p.shape, jnp.float32) * 0.05).astype(p.dtype)
        for k, p in zip(keys, leaves)])
    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    w, h = 64, 44        # 44 % (4 shards * s2d 2) != 0 -> pads to 48
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=w, height=h, bits=10)
    plan = plan_pipeline(Settings(), src, dst)
    rng = np.random.default_rng(13)
    planes = tuple(jnp.asarray(p) for p in _nv12_planes(rng, w, h))

    ref = np.asarray(jax.jit(lambda ps: enhance_plane_chw(
        params, make_frame_fn(plan)(ps), cfg))(planes))
    fn = jax.jit(make_spatial_learned_fn(plan, mesh, params, cfg,
                                         "videohdr", pack_surface=True))
    got = np.asarray(fn(pad_shard_planes_rows(plan, mesh, planes)))
    _, surf_h_pad = spatial_padded_heights(plan, 4, surf_unit=2)
    assert got.shape == (surf_h_pad, w)
    dec = np.moveaxis(unpack_rgb10(got[:h].view(np.uint32)), -1, 0)
    d = np.abs(dec - ref)
    assert d.max() <= 0.02               # 1 bf16-ulp gain band, quantized
    psnr_db = -10 * np.log10(max(float((d ** 2).mean()), 1e-20))
    assert psnr_db >= 60.0
    # mesh-pad rows are black (alpha bits only)
    pad = got[h:].view(np.uint32)
    assert np.all(pad & 0x3FFFFFFF == 0)


def test_spatial_learned_guards():
    """s2d-divisibility and halo-size guards raise with guidance."""
    from videorenderer.models.superres import (SuperResConfig,
                                                   init_params)
    from videorenderer.parallel.spatial import make_spatial_learned_fn

    mesh = Mesh(np.array(jax.devices()[:4]), ("spatial",))
    src = SourceDescriptor(format=ColorFormat.NV12, width=64, height=44,
                           matrix=CSP.BT_709)
    cfg = SuperResConfig(channels=8, num_blocks=1, scale=2, s2d=8)
    params = init_params(jax.random.PRNGKey(0), cfg)
    plan = plan_pipeline(Settings(), src,
                         OutputDescriptor(width=64, height=44, bits=8))
    with pytest.raises(ValueError, match="divisible by cfg.s2d"):
        make_spatial_learned_fn(plan, mesh, params, cfg, "superres")

    # deep trunk on a short frame: halo exceeds the shard height
    cfg2 = SuperResConfig(channels=8, num_blocks=8, scale=2, s2d=4)
    params2 = init_params(jax.random.PRNGKey(0), cfg2)
    plan2 = plan_pipeline(Settings(), SourceDescriptor(
        format=ColorFormat.NV12, width=64, height=48, matrix=CSP.BT_709),
        OutputDescriptor(width=64, height=48, bits=8))
    with pytest.raises(ValueError, match="halo rows"):
        make_spatial_learned_fn(plan2, mesh, params2, cfg2, "superres")
