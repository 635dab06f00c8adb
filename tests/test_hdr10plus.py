"""HDR10+ (ST 2094-40) metadata consumption.

The reference only defines MediaSideDataHDR10Plus
(Include/IMediaSideData.h:67-130); here the scene statistics drive the
local tone map like DoVi L1 does, plus the 2094-40 basis curve itself.
"""

import numpy as np
import jax.numpy as jnp

from videorenderer.ops.hdr10plus import (HDR10PlusMetadata,
                                             HDR10PlusWindow,
                                             apply_hdr10plus_curve,
                                             hdr_params_from_hdr10plus,
                                             merge_hdr10,
                                             runtime_hdr_from_hdr10plus,
                                             scene_peak_nits)
from videorenderer.pipeline import (HDR10Metadata, OutputDescriptor,
                                        SourceDescriptor, plan_pipeline)
from videorenderer import ColorFormat, Settings
from videorenderer.csputils import CSP, Levels, Primaries, TRC


def _meta(peak_frac=0.2, avg_frac=0.02, pct=None):
    w = HDR10PlusWindow(maxscl=(peak_frac, peak_frac * 0.9, peak_frac * 0.8),
                        average_maxrgb=avg_frac,
                        distribution_maxrgb=pct or ())
    return HDR10PlusMetadata(windows=(w,))


def test_scene_peak_from_maxscl_and_percentile():
    assert scene_peak_nits(_meta(0.2)) == 2000.0
    # the 99.98% percentile wins when present
    m = _meta(0.2, pct=((50, 0.01), (99, 0.15)))
    assert scene_peak_nits(m) == 1500.0


def test_hdr_params_substitution():
    h = HDR10Metadata(mastering_max_nits=4000.0, max_cll=4000.0)
    p, t = hdr_params_from_hdr10plus(_meta(0.12, 0.03), h, 800.0, 5)
    assert p.mastering_max_nits == 1200.0          # scene peak, not static
    assert p.max_cll == 1200.0
    assert p.max_fall == 300.0
    assert p.display_max_nits == 800.0
    assert t == 5
    # empty metadata falls back to the static HDR10 block
    p2, _ = hdr_params_from_hdr10plus(HDR10PlusMetadata(
        windows=(HDR10PlusWindow(),)), h, 800.0, 5)
    assert p2.mastering_max_nits == 4000.0


def test_merge_and_runtime_dict():
    h = HDR10Metadata(max_cll=1000.0, max_fall=400.0)
    out = merge_hdr10(h, _meta(0.3, 0.06))
    assert out.max_cll == 3000.0 and out.max_fall == 600.0
    rt = runtime_hdr_from_hdr10plus(_meta(0.1), h, 1000.0)
    assert float(rt["mastering_max_nits"]) == 1000.0
    assert set(rt) == {"mastering_min_nits", "mastering_max_nits",
                       "max_cll", "max_fall", "display_max_nits"}


def test_plan_consumes_hdr10plus():
    src = SourceDescriptor(
        format=ColorFormat.P010, width=64, height=32,
        matrix=CSP.BT_2020_NC, primaries=Primaries.BT_2020, transfer=TRC.PQ,
        hdr10=HDR10Metadata(mastering_max_nits=4000.0),
        hdr10plus=_meta(0.15, 0.04))
    plan = plan_pipeline(Settings(hdr_local_tone_mapping=True,
                                  convert_to_sdr=False,
                                  hdr_display_max_nits=600),
                         src, OutputDescriptor(width=64, height=32,
                                               bits=10, hdr=True))
    assert plan.tonemap_params.mastering_max_nits == 1500.0
    assert plan.output_hdr10.max_cll == 1500.0


def test_basis_curve_properties():
    """Knee continuity, endpoint mapping and monotonicity of the 2094-40
    guided curve."""
    w = HDR10PlusWindow(tone_mapping_flag=1, knee_point_x=0.25,
                        knee_point_y=0.4,
                        bezier_curve_anchors=(0.45, 0.7, 0.85, 0.94))
    x = jnp.linspace(0.0, 1.0, 401)
    y = np.asarray(apply_hdr10plus_curve(x, w))
    assert abs(y[0]) < 1e-6
    assert abs(y[-1] - 1.0) < 1e-6
    k = int(0.25 * 400)
    np.testing.assert_allclose(y[k], 0.4, atol=1e-3)   # knee lands on ky
    assert np.all(np.diff(y) > -1e-6)                  # monotone
    # disabled flag is the identity
    w0 = HDR10PlusWindow(tone_mapping_flag=0)
    np.testing.assert_array_equal(np.asarray(apply_hdr10plus_curve(x, w0)),
                                  np.asarray(x))


def test_scene_peak_percentile_order_independent():
    """A (99, v) entry listed before (99.98, v') must not shadow the true
    peak percentile (ADVICE r2)."""
    m1 = HDR10PlusMetadata(windows=(HDR10PlusWindow(
        distribution_maxrgb=((99, 0.2), (99.98, 0.45)),),))
    m2 = HDR10PlusMetadata(windows=(HDR10PlusWindow(
        distribution_maxrgb=((99.98, 0.45), (99, 0.2)),),))
    from videorenderer.ops.hdr10plus import scene_peak_nits
    assert scene_peak_nits(m1) == scene_peak_nits(m2) == 4500.0


def _guided_meta(peak=0.4, avg=0.05, anchors=(0.4, 0.7, 0.9)):
    return HDR10PlusMetadata(windows=(HDR10PlusWindow(
        maxscl=(peak, peak, peak), average_maxrgb=avg,
        tone_mapping_flag=1, knee_point_x=0.25, knee_point_y=0.3,
        bezier_curve_anchors=anchors),))


def test_guided_curve_upgrades_operator():
    """tone_mapping_flag=1 upgrades the local tone map to selection 7 and
    the plan carries the window (the basis curve IS consumed, not just the
    scene statistics — ADVICE r2)."""
    meta = _guided_meta()
    src = SourceDescriptor(format=ColorFormat.P010, width=32, height=16,
                           matrix=CSP.BT_2020_NC, primaries=Primaries.BT_2020,
                           transfer=TRC.PQ, hdr10=HDR10Metadata(),
                           hdr10plus=meta)
    dst = OutputDescriptor(width=32, height=16, bits=10, hdr=True)
    st = Settings(convert_to_sdr=False, hdr_passthrough=True,
                  hdr_local_tone_mapping=True, hdr_display_max_nits=600)
    plan = plan_pipeline(st, src, dst)
    assert plan.tonemap_type == 7
    assert plan.hdr10plus_window is meta.windows[0]
    # statistics still substitute the mastering metadata
    assert plan.tonemap_params.max_cll == 4000.0
    # no curve flag -> operator unchanged
    plain = HDR10PlusMetadata(windows=(HDR10PlusWindow(
        maxscl=(0.4, 0.4, 0.4), average_maxrgb=0.05),))
    import dataclasses
    plan2 = plan_pipeline(st, dataclasses.replace(src, hdr10plus=plain), dst)
    assert plan2.tonemap_type == int(st.hdr_local_tone_mapping_type)


def test_guided_operator_variants_agree():
    """Selection 7 through the static and rt tone-map paths agrees; the curve actually reshapes (differs from statistics-only)."""
    from videorenderer.ops import tonemap as tm
    w0 = _guided_meta().windows[0]
    p = tm.HDRParams(mastering_min_nits=0.005, mastering_max_nits=4000.0,
                     max_cll=4000.0, max_fall=500.0, display_max_nits=600.0)
    rng = np.random.default_rng(3)
    pq = jnp.asarray(rng.random((3, 8, 16), np.float32) * 0.9)
    a = np.asarray(tm.local_tonemap_pq(pq, 7, p, axis=-3, window=w0))
    rt = {k: getattr(p, k) for k in ("mastering_min_nits",
                                     "mastering_max_nits", "max_cll",
                                     "max_fall", "display_max_nits")}
    b = np.asarray(tm.local_tonemap_pq_rt(pq, 7, rt, axis=-3, window=w0))
    np.testing.assert_allclose(a, b, atol=2e-6)
    stats_only = np.asarray(tm.local_tonemap_pq(pq, 1, p, axis=-3))
    assert not np.allclose(a, stats_only, atol=1e-3)
    # monotone in luminance along a gray ramp, pinned at the display peak
    ramp = jnp.stack([jnp.linspace(0.0, 1.0, 64)] * 3)[:, None, :]
    out = np.asarray(tm.local_tonemap_pq(ramp, 7, p, axis=-3, window=w0))
    assert np.all(np.diff(out[0, 0]) >= -1e-6)


def test_guided_curve_end_to_end_psnr():
    """Full pipeline with the guided curve engaged runs and quantizes."""
    meta = _guided_meta()
    src = SourceDescriptor(format=ColorFormat.P010, width=64, height=32,
                           matrix=CSP.BT_2020_NC, primaries=Primaries.BT_2020,
                           transfer=TRC.PQ, hdr10=HDR10Metadata(),
                           hdr10plus=meta)
    dst = OutputDescriptor(width=64, height=32, bits=10, hdr=True)
    st = Settings(convert_to_sdr=False, hdr_passthrough=True,
                  hdr_local_tone_mapping=True, hdr_display_max_nits=600)
    from videorenderer import VideoProcessor
    vp = VideoProcessor(st, src, dst)
    rng = np.random.default_rng(5)
    planes = (rng.integers(64, 941, (32, 64), np.uint16) << 6,
              rng.integers(64, 961, (16, 32), np.uint16) << 6,
              rng.integers(64, 961, (16, 32), np.uint16) << 6)
    out = np.asarray(vp.process(planes))
    assert out.shape == (3, 32, 64)
    assert np.all((out >= 0) & (out <= 1))
