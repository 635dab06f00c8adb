"""Fused linear-resample path must match the staged reference path."""

import numpy as np
import jax
import pytest

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.config import ChromaScaling, Downscaling, Upscaling
from videorenderer.csputils import CSP, Levels, Primaries, TRC
from videorenderer.pipeline import make_frame_fn, plan_pipeline, _can_fuse


def _planes(fmt, w, h, seed=0, bits=8):
    rng = np.random.default_rng(seed)
    if bits == 8:
        mk = lambda hh, ww: rng.integers(0, 256, (hh, ww), np.uint8)
    else:
        mk = lambda hh, ww: (rng.integers(0, 1024, (hh, ww), np.uint16) << 6)
    from videorenderer.formats import get_format_info
    shapes = get_format_info(fmt).plane_shapes(w, h)
    return tuple(mk(hh, ww) for hh, ww in shapes)


CASES = [
    # (fmt, bits, src WxH, dst WxH, settings overrides, src overrides)
    (ColorFormat.NV12, 8, (64, 48), (128, 96), {}, {}),
    (ColorFormat.NV12, 8, (64, 48), (32, 24),
     dict(upscaling=Upscaling.LANCZOS3), {}),
    (ColorFormat.P010, 10, (64, 48), (32, 24),
     dict(convert_to_sdr=True),
     dict(matrix=CSP.BT_2020_NC, primaries=Primaries.BT_2020, transfer=TRC.PQ)),
    (ColorFormat.YUY2, 8, (64, 32), (100, 60),
     dict(chroma_scaling=ChromaScaling.CATMULL_ROM), {}),
    (ColorFormat.YUV444P8, 8, (64, 32), (20, 12),
     dict(downscaling=Downscaling.LANCZOS, interpolate_at_50pct=True), {}),
    (ColorFormat.RGB24, 8, (32, 32), (64, 64), {}, {}),
    (ColorFormat.Y8, 8, (32, 32), (48, 48), {}, {}),
    (ColorFormat.NV12, 8, (64, 48), (128, 96),
     dict(deint_blend=True), dict(interlaced=True)),
]


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_fused_matches_staged(case):
    fmt, bits, (w, h), (ow, oh), st_over, src_over = case
    st = Settings(use_dither=False, **st_over)
    src = SourceDescriptor(format=fmt, width=w, height=h,
                           **({"matrix": CSP.BT_709} | src_over))
    dst = OutputDescriptor(width=ow, height=oh, bits=8)
    plan = plan_pipeline(st, src, dst)
    assert _can_fuse(plan)
    planes = _planes(fmt, w, h, bits=bits)
    staged = np.asarray(jax.jit(make_frame_fn(plan, fused=False))(planes))
    fused = np.asarray(jax.jit(make_frame_fn(plan, fused=True))(planes))
    assert fused.shape == staged.shape == (3, oh, ow)
    # outputs are quantized to 8 bits; float-rounding at a code boundary may
    # flip isolated codes by 1 LSB
    diff = np.abs(fused - staged)
    assert (diff > 0.5 / 255).mean() < 1e-3
    assert diff.max() <= 1.5 / 255


def test_jinc2_not_fused():
    st = Settings(upscaling=Upscaling.JINC2)
    src = SourceDescriptor(format=ColorFormat.NV12, width=32, height=32)
    dst = OutputDescriptor(width=64, height=64, bits=8)
    assert not _can_fuse(plan_pipeline(st, src, dst))


def test_shader_order_not_fused():
    st = Settings(vp_scaling=False)
    src = SourceDescriptor(format=ColorFormat.NV12, width=32, height=32)
    dst = OutputDescriptor(width=64, height=64, bits=8)
    assert not _can_fuse(plan_pipeline(st, src, dst))


def test_fused_with_dither_matches():
    st = Settings(use_dither=True)
    src = SourceDescriptor(format=ColorFormat.NV12, width=64, height=48,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=32, height=24, bits=8)
    plan = plan_pipeline(st, src, dst)
    planes = _planes(ColorFormat.NV12, 64, 48)
    staged = np.asarray(jax.jit(make_frame_fn(plan, fused=False))(planes))
    fused = np.asarray(jax.jit(make_frame_fn(plan, fused=True))(planes))
    # quantized outputs: allow rare 1-LSB flips at dither thresholds
    diff = np.abs(staged - fused) * 255
    assert (diff > 0.5).mean() < 1e-3


def test_config_fuzz_fused_vs_staged():
    """Seeded sweep over random (format, size, settings) combinations: the
    pipeline must build and run for every combination, and whenever the
    fused path is legal it must match the staged path."""
    from videorenderer.config import (ChromaScaling, Downscaling,
                                          Upscaling)
    from videorenderer.formats import get_format_info

    rng = np.random.default_rng(1234)
    fmts = [ColorFormat.NV12, ColorFormat.P010, ColorFormat.YUY2,
            ColorFormat.YUV420P8, ColorFormat.YUV422P8, ColorFormat.YUV444P8,
            ColorFormat.RGB24, ColorFormat.Y8, ColorFormat.AYUV]
    ups = list(Upscaling)
    downs = list(Downscaling)
    chromas = list(ChromaScaling)
    for trial in range(18):
        fmt = fmts[rng.integers(len(fmts))]
        info = get_format_info(fmt)
        dw, dh = info.chroma_div
        w = int(rng.integers(2, 9)) * 8 * dw
        h = int(rng.integers(2, 7)) * 8 * dh
        ow = int(rng.integers(2, 12)) * 8
        oh = int(rng.integers(2, 10)) * 8
        st = Settings(
            upscaling=ups[rng.integers(len(ups))],
            downscaling=downs[rng.integers(len(downs))],
            chroma_scaling=chromas[rng.integers(len(chromas))],
            interpolate_at_50pct=bool(rng.integers(2)),
            use_dither=bool(rng.integers(2)),
            vp_scaling=bool(rng.integers(2)))
        src = SourceDescriptor(format=fmt, width=w, height=h,
                               matrix=CSP.BT_709)
        dst = OutputDescriptor(width=ow, height=oh, bits=8)
        plan = plan_pipeline(st, src, dst)
        planes = _planes(fmt, w, h, seed=trial,
                         bits=10 if fmt == ColorFormat.P010 else 8)
        staged = np.asarray(make_frame_fn(plan, fused=False)(planes))
        assert staged.shape == (3, oh, ow), (trial, fmt, w, h, ow, oh)
        assert np.isfinite(staged).all(), (trial, fmt)
        auto = np.asarray(make_frame_fn(plan)(planes))
        if _can_fuse(plan):
            d = np.abs(auto - staged)
            assert (d > 1.5 / 255).mean() == 0, (trial, fmt, st)
            assert (d > 0.5 / 255).mean() < 5e-3, (trial, fmt, st)
        else:
            assert auto.shape == staged.shape
