"""Settings-driven VP deinterlacing through the VideoRenderer API.

The reference routes interlaced sources through the rate-converting VP per
vp_deinterlacing/deint_double without the caller's involvement
(Source/DX11VideoProcessor.cpp:2209-2225, 2176-2200); here
``VideoRenderer.process_frame`` must return the same frames an explicitly
driven ``DeinterlaceSession`` produces.
"""

import numpy as np
import pytest

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.api import VideoRenderer
from videorenderer.config import Deinterlacing
from videorenderer.csputils import CSP
from videorenderer.runner import DeinterlaceSession

W, H = 32, 16


def _open(double=True, tff=True, rotation=0, **st_extra):
    st = Settings(vp_deinterlacing=Deinterlacing.ENABLE, deint_double=double,
                  **st_extra)
    vr = VideoRenderer(st)
    src = SourceDescriptor(format=ColorFormat.NV12, width=W, height=H,
                           matrix=CSP.BT_709, interlaced=True,
                           top_field_first=tff)
    dst = OutputDescriptor(width=W, height=H, bits=8)
    if rotation:
        vr.flt_set("rotation", rotation)
    vr.open(src, dst)
    return vr


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (H, W), np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), np.uint8),
             rng.integers(0, 256, (H // 2, W // 2), np.uint8))
            for _ in range(n)]


def _drive_session(sess, frames):
    outs = []
    for f in frames:
        outs += [np.asarray(o) for o in sess.push(f)]
    outs += [np.asarray(o) for o in sess.flush()]
    return outs


def test_settings_routed_deint_matches_session_double_rate():
    frames = _frames(4)
    vr = _open(double=True)
    got = []
    for f in frames:
        outs = vr.process_frame(f)
        assert isinstance(outs, list)
        got += [np.asarray(o) for o in outs]
    got += [np.asarray(o) for o in vr.flush()]
    # first push fills the window; every frame emits 2 fields in the end
    assert len(got) == 2 * len(frames)

    want = _drive_session(DeinterlaceSession(vr._plan, double_rate=True),
                          frames)
    assert len(want) == len(got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_settings_routed_deint_single_rate():
    frames = _frames(3, seed=1)
    vr = _open(double=False)
    got = []
    for f in frames:
        got += [np.asarray(o) for o in vr.process_frame(f)]
    got += [np.asarray(o) for o in vr.flush()]
    assert len(got) == len(frames)
    want = _drive_session(DeinterlaceSession(vr._plan, double_rate=False),
                          frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_deint_disabled_keeps_progressive_contract():
    vr = _open()
    # flip the setting off live: back to the single-array contract
    vr.set_settings(Settings(vp_deinterlacing=Deinterlacing.DISABLE))
    out = vr.process_frame(_frames(1)[0])
    assert not isinstance(out, list)
    assert out.shape == (3, H, W)
    assert vr.flush() == []


def test_deint_blend_takes_pipeline_path():
    # deint_blend folds the field blend into the traced pipeline; the VP
    # session must not engage
    vr = _open(deint_blend=True)
    assert vr._deint is None
    out = vr.process_frame(_frames(1)[0])
    assert not isinstance(out, list)


def test_deint_composes_with_rotation_tail():
    # the post-scale tail (rotation) rides each emitted field, and the
    # dither phase stays pre-rotation exactly like the progressive path
    frames = _frames(3, seed=2)
    vr = _open(double=True, rotation=90)
    got = []
    for f in frames:
        got += [np.asarray(o) for o in vr.process_frame(f)]
    got += [np.asarray(o) for o in vr.flush()]
    # the plan ran at swapped dims; rotation lands in the real surface
    assert got[0].shape == (3, H, W)

    from videorenderer.ops import geometry as geo_ops
    want = _drive_session(DeinterlaceSession(vr._plan, double_rate=True),
                          frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            g, np.asarray(geo_ops.rotate_flip(w, 90, False)))


def test_deint_field_order_from_descriptor():
    frames = _frames(3, seed=3)
    vr = _open(double=True, tff=False)
    got = []
    for f in frames:
        got += [np.asarray(o) for o in vr.process_frame(f)]
    want = _drive_session(
        DeinterlaceSession(vr._plan, double_rate=True,
                           top_field_first=False), frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_deint_session_resets_on_reconfigure():
    import dataclasses
    from videorenderer.config import Upscaling
    frames = _frames(3, seed=4)
    vr = _open(double=True)
    vr.process_frame(frames[0])
    # live reconfigure to a different traced program: the temporal window
    # restarts (the reference re-inits the VP ref-frame ring)
    vr.set_settings(dataclasses.replace(vr.settings,
                                        upscaling=Upscaling.LANCZOS3))
    outs = vr.process_frame(frames[1])
    assert outs == []            # window refilling after the reset
    assert len(vr.process_frame(frames[2])) == 2


def test_deint_metrics_and_info():
    vr = _open(double=True)
    for f in _frames(3, seed=5):
        vr.process_frame(f)
    assert vr.metrics.draw_stats.frames == 4    # 2 frames x 2 fields emitted
    assert "Deinterlacing: motion-adaptive (double-rate)" \
        in vr.get_video_processor_info()
