"""Dolby Vision end-to-end pipeline tests."""

import numpy as np
import pytest

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.csputils import CSP, Levels, Primaries, TRC
from videorenderer.ops import dovi as dovi_ops
from videorenderer.ops.tonemap import DoviTrims
from videorenderer.pipeline import VideoProcessor, plan_pipeline, _can_fuse


def _identity_meta():
    return dovi_ops.DoviMetadata(
        curves=(dovi_ops.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                    [1, -0.164553, -0.571353],
                                    [1, 1.8814, 0]]),
        ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
        rgb_to_lms_matrix=np.linalg.inv(dovi_ops.DOVI_LMS2RGB))


def test_dovi_plan_uses_rpu_matrix():
    meta = _identity_meta()
    src = SourceDescriptor(format=ColorFormat.P010, width=32, height=16,
                           transfer=TRC.PQ, primaries=Primaries.BT_2020,
                           matrix=CSP.BT_2020_NC, dovi=meta)
    dst = OutputDescriptor(width=32, height=16, bits=8)
    plan = plan_pipeline(Settings(), src, dst)
    assert plan.dovi is meta
    assert plan.convert_to_sdr
    assert not _can_fuse(plan)
    # matrix = rpu ycc matrix with offset folded into c
    np.testing.assert_allclose(plan.cmat_m, meta.ycc_to_rgb_matrix, atol=1e-9)
    np.testing.assert_allclose(
        plan.cmat_c, -meta.ycc_to_rgb_matrix @ meta.ycc_to_rgb_offset,
        atol=1e-9)


def test_dovi_process_runs():
    meta = _identity_meta()
    src = SourceDescriptor(format=ColorFormat.P010, width=32, height=16,
                           transfer=TRC.PQ, primaries=Primaries.BT_2020,
                           matrix=CSP.BT_2020_NC, dovi=meta,
                           dovi_trims=DoviTrims(l2_enabled=True,
                                                trim_slope=1.1,
                                                trim_power=1.05))
    dst = OutputDescriptor(width=64, height=32, bits=8)
    vp = VideoProcessor(Settings(), src, dst)
    y = np.full((16, 32), 600 << 6, np.uint16)
    u = np.full((8, 16), 512 << 6, np.uint16)
    v = np.full((8, 16), 512 << 6, np.uint16)
    out = np.asarray(vp.process((y, u, v)))
    assert out.shape == (3, 32, 64)
    assert np.all((out >= 0) & (out <= 1))
    # gray input through an identity-ish chain stays roughly neutral
    assert np.abs(out[0] - out[1]).max() < 0.1


def test_src_rect_crop():
    src = SourceDescriptor(format=ColorFormat.NV12, width=64, height=32,
                           matrix=CSP.BT_709, src_rect=(16, 8, 48, 24))
    dst = OutputDescriptor(width=32, height=16, bits=8)
    vp = VideoProcessor(Settings(use_dither=False), src, dst)
    rng = np.random.default_rng(0)
    y = rng.integers(0, 256, (32, 64), np.uint8)
    u = rng.integers(0, 256, (16, 32), np.uint8)
    v = rng.integers(0, 256, (16, 32), np.uint8)
    out = np.asarray(vp.process((y, u, v)))
    assert out.shape == (3, 16, 32)
    # compare against processing the pre-cropped planes directly
    src2 = SourceDescriptor(format=ColorFormat.NV12, width=32, height=16,
                            matrix=CSP.BT_709)
    vp2 = VideoProcessor(Settings(use_dither=False), src2, dst)
    out2 = np.asarray(vp2.process((y[8:24, 16:48], u[4:12, 8:24],
                                   v[4:12, 8:24])))
    np.testing.assert_allclose(out, out2, atol=1e-6)


def test_serving_fn_runtime_metadata():
    """One compiled serving program handles changing DoVi curves and HDR10
    metadata without retracing."""
    import jax
    import jax.numpy as jnp
    from videorenderer.config import ToneMapType
    from videorenderer.pipeline import make_serving_fn, HDR10Metadata

    meta = _identity_meta()
    src = SourceDescriptor(format=ColorFormat.P010, width=32, height=16,
                           transfer=TRC.PQ, primaries=Primaries.BT_2020,
                           matrix=CSP.BT_2020_NC, dovi=meta,
                           hdr10=HDR10Metadata())
    dst = OutputDescriptor(width=32, height=16, bits=10, hdr=True)
    st = Settings(convert_to_sdr=False, hdr_passthrough=True,
                  hdr_local_tone_mapping=True,
                  hdr_local_tone_mapping_type=ToneMapType.BT2390,
                  hdr_display_max_nits=600)
    plan = plan_pipeline(st, src, dst)
    assert plan.local_tonemap and plan.dovi is meta

    traces = []

    def raw(planes, rt):
        traces.append(1)
        return make_serving_fn(plan)(planes, rt)

    fn = jax.jit(raw)
    y = np.full((16, 32), 600 << 6, np.uint16)
    u = np.full((8, 16), 512 << 6, np.uint16)
    v = np.full((8, 16), 512 << 6, np.uint16)
    curves = {k: jnp.asarray(vv) for k, vv in dovi_ops.pack_curves(meta).items()}
    hdr = {k: jnp.asarray(vv, jnp.float32) for k, vv in dict(
        mastering_min_nits=0.005, mastering_max_nits=1000.0,
        max_cll=1000.0, max_fall=400.0, display_max_nits=600.0).items()}
    o1 = fn((y, u, v), {"dovi_curves": curves, "hdr": hdr})
    # new scene: different curves + metadata, same program
    curves2 = dict(curves)
    curves2["poly"] = curves["poly"] * 0.95
    hdr2 = dict(hdr)
    hdr2["max_cll"] = jnp.asarray(4000.0, jnp.float32)
    o2 = fn((y, u, v), {"dovi_curves": curves2, "hdr": hdr2})
    assert len(traces) == 1
    assert not np.allclose(np.asarray(o1), np.asarray(o2))


def test_serving_fn_runtime_procamp():
    """Runtime ProcAmp: the color matrix arrives as tensors; saturation
    change flows through without retrace."""
    import jax
    import jax.numpy as jnp
    from videorenderer.pipeline import make_serving_fn
    from videorenderer.csputils import (CSPParams, Colorspace, Levels,
                                            get_csp_matrix)

    src = SourceDescriptor(format=ColorFormat.NV12, width=32, height=16,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=32, height=16, bits=8)
    plan = plan_pipeline(Settings(use_dither=False), src, dst)
    traces = []

    def raw(planes, rt):
        traces.append(1)
        return make_serving_fn(plan)(planes, rt)

    fn = jax.jit(raw)
    rng = np.random.default_rng(0)
    planes = (rng.integers(0, 256, (16, 32), np.uint8),
              rng.integers(0, 256, (8, 16), np.uint8),
              rng.integers(0, 256, (8, 16), np.uint8))

    def cmat(sat):
        cm = get_csp_matrix(CSPParams(
            color=Colorspace(CSP.BT_709, Levels.TV), saturation=sat))
        return {"m": jnp.asarray(cm.m), "c": jnp.asarray(cm.c)}

    a = np.asarray(fn(planes, {"cmat": cmat(1.0)}))
    b = np.asarray(fn(planes, {"cmat": cmat(0.0)}))   # grayscale
    assert len(traces) == 1
    np.testing.assert_allclose(b[0], b[1], atol=1e-5)  # desaturated: R==G
    assert np.abs(a - b).max() > 0.01


def _poly_meta():
    """Non-identity 2-piece polynomial curves to exercise the reshape."""
    import numpy as np
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


@pytest.mark.parametrize("out_size", [(64, 32), (16, 8), (32, 16)])
def test_dovi_split_fused_matches_staged(out_size):
    """The DoVi split-fused path (banded kernels around the reshape) must
    match the staged path — VERDICT r1 item 5."""
    import jax
    from videorenderer.pipeline import _can_split_fuse, make_frame_fn

    ow, oh = out_size
    meta = _poly_meta()
    src = SourceDescriptor(format=ColorFormat.P010, width=32, height=16,
                           transfer=TRC.PQ, primaries=Primaries.BT_2020,
                           matrix=CSP.BT_2020_NC, dovi=meta,
                           dovi_trims=DoviTrims(l2_enabled=True,
                                                trim_slope=1.1))
    dst = OutputDescriptor(width=ow, height=oh, bits=8)
    plan = plan_pipeline(Settings(use_dither=False), src, dst)
    assert _can_split_fuse(plan) and not _can_fuse(plan)

    rng = np.random.default_rng(4)
    planes = (rng.integers(64, 941, (16, 32), np.uint16) << 6,
              rng.integers(64, 961, (8, 16), np.uint16) << 6,
              rng.integers(64, 961, (8, 16), np.uint16) << 6)
    staged = np.asarray(jax.jit(make_frame_fn(plan, fused=False))(planes))
    fused = np.asarray(jax.jit(make_frame_fn(plan, fused=True))(planes))
    assert fused.shape == staged.shape == (3, oh, ow)
    np.testing.assert_allclose(fused, staged, atol=3e-6)


def test_dovi_serving_uses_split_fused_path():
    """Serving mode routes DoVi through the split-fused path with runtime
    curves; per-scene curve updates don't retrace and match the staged
    result."""
    import jax
    import jax.numpy as jnp
    from videorenderer.pipeline import make_frame_fn, make_serving_fn

    meta = _poly_meta()
    src = SourceDescriptor(format=ColorFormat.P010, width=32, height=16,
                           transfer=TRC.PQ, primaries=Primaries.BT_2020,
                           matrix=CSP.BT_2020_NC, dovi=meta)
    dst = OutputDescriptor(width=64, height=32, bits=8)
    plan = plan_pipeline(Settings(use_dither=False), src, dst)

    traces = []

    def raw(planes, rt):
        traces.append(1)
        return make_serving_fn(plan)(planes, rt)

    fn = jax.jit(raw)
    rng = np.random.default_rng(5)
    planes = (rng.integers(64, 941, (16, 32), np.uint16) << 6,
              rng.integers(64, 961, (8, 16), np.uint16) << 6,
              rng.integers(64, 961, (8, 16), np.uint16) << 6)
    curves = {k: jnp.asarray(v) for k, v in dovi_ops.pack_curves(meta).items()}
    o1 = np.asarray(fn(planes, {"dovi_curves": curves}))
    # matches the static split-fused trace
    ref = np.asarray(jax.jit(make_frame_fn(plan, fused=True))(planes))
    np.testing.assert_allclose(o1, ref, atol=2e-6)
    # scene change: scaled curves, same compiled program
    curves2 = dict(curves)
    curves2["poly"] = curves["poly"] * 0.9
    o2 = np.asarray(fn(planes, {"dovi_curves": curves2}))
    assert len(traces) == 1
    assert not np.allclose(o1, o2)


def test_pack_curves_structure_guard():
    """pack_curves(like=plan_structure) raises when a scene's RPU changes
    the curve STRUCTURE (which requires a re-plan), instead of letting a
    structure-pruned serving program silently corrupt frames."""
    from videorenderer.ops import dovi as dovi_ops

    meta1 = _identity_meta()
    struct = dovi_ops.curve_structure(meta1)
    # values-only update: fine
    dovi_ops.pack_curves(meta1, like=struct)

    two_piece = dovi_ops.ReshapeCurve(
        pivots=(0.5,), method=(0, 0),
        poly=np.array([[0.0, 1.0, 0.0], [0.1, 0.9, 0.0]]))
    meta2 = dovi_ops.DoviMetadata(
        curves=(two_piece,) + meta1.curves[1:],
        ycc_to_rgb_matrix=meta1.ycc_to_rgb_matrix,
        ycc_to_rgb_offset=meta1.ycc_to_rgb_offset,
        rgb_to_lms_matrix=meta1.rgb_to_lms_matrix)
    with pytest.raises(ValueError, match="structure changed"):
        dovi_ops.pack_curves(meta2, like=struct)


def test_deint_session_mode_mixing_raises():
    from videorenderer.pipeline import plan_pipeline
    from videorenderer.runner import DeinterlaceSession

    plan = plan_pipeline(
        Settings(use_dither=False),
        SourceDescriptor(format=ColorFormat.NV12, width=32, height=16,
                         matrix=CSP.BT_709, interlaced=True),
        OutputDescriptor(width=32, height=16, bits=8))
    f = (np.zeros((16, 32), np.uint8), np.zeros((8, 16), np.uint8),
         np.zeros((8, 16), np.uint8))
    s = DeinterlaceSession(plan)
    s.push_batch(tuple(p[None] for p in f))
    with pytest.raises(RuntimeError, match="batched mode"):
        s.push(f)
    with pytest.raises(RuntimeError, match="batched mode"):
        s.flush()
    s2 = DeinterlaceSession(plan)
    s2.push(f)
    with pytest.raises(RuntimeError, match="streaming mode"):
        s2.push_batch(tuple(p[None] for p in f))
    with pytest.raises(RuntimeError, match="streaming mode"):
        s2.flush_batch()
