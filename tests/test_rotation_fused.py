"""Rotation algebra: axis-map transforms, dither pattern transforms, and
make_frame_fn's rotation vs rotating the finished surface.  Reference semantics: rotation is a vertex permutation of
the resize pass, not an extra pass (FillVertices + ResizeShaderPass,
Source/DX11VideoProcessor.cpp:130-179,3115-3199)."""

import numpy as np
import jax.numpy as jnp
import pytest

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.csputils import CSP
from videorenderer.ops import dither as dither_ops
from videorenderer.ops import geometry as geo
from videorenderer.pipeline import make_frame_fn, plan_pipeline

ALL_RF = [(r, f) for r in (0, 90, 180, 270) for f in (False, True)]


@pytest.mark.parametrize("rotation,flip", ALL_RF)
def test_transform_axis_maps_algebra(rotation, flip):
    """rotate_flip(Wy^T P Wx) == Wy'^T rotate_flip(P) Wx' exactly."""
    rng = np.random.default_rng(rotation + flip)
    hi, ho, wi, wo = 6, 9, 5, 7
    wy = rng.standard_normal((hi, ho))
    wx = rng.standard_normal((wi, wo))
    p = rng.standard_normal((hi, wi))
    out = wy.T @ p @ wx
    ref = np.asarray(geo.rotate_flip(jnp.asarray(out), rotation, flip))
    wy2, wx2 = geo.transform_axis_maps(wy, wx, rotation, flip)
    p2 = np.asarray(geo.rotate_flip(jnp.asarray(p), rotation, flip))
    got = np.asarray(wy2).T @ p2 @ np.asarray(wx2)
    np.testing.assert_allclose(got, ref, atol=1e-12)


@pytest.mark.parametrize("rotation,flip", ALL_RF)
def test_transform_axis_maps_none_passthrough(rotation, flip):
    wy2, wx2 = geo.transform_axis_maps(None, None, rotation, flip)
    assert wy2 is None and wx2 is None


@pytest.mark.parametrize("rotation,flip", ALL_RF)
def test_bayer_field_transform(rotation, flip):
    """bayer_field with rf_decompose flags == the same rotate_flip of the
    plain tiled field (the pre-rotation dither phase, exactly)."""
    tr, fr, fc = geo.rf_decompose(rotation, flip)
    plain = np.asarray(dither_ops.bayer_field(64, 64))
    ref = np.asarray(geo.rotate_flip(jnp.asarray(plain), rotation, flip))
    got = np.asarray(dither_ops.bayer_field(64, 64, transpose=tr,
                                            flip_rows=fr, flip_cols=fc))
    np.testing.assert_array_equal(got, ref)


def test_make_frame_fn_rotation_fallback_matches():
    """Fused path: make_frame_fn(rotation=...) == rotate_flip of the
    unrotated output, bit-for-bit (the wrapper composition)."""
    rng = np.random.default_rng(3)
    w, h = 64, 48
    planes = (rng.integers(0, 256, (h, w), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8),
              rng.integers(0, 256, (h // 2, w // 2), np.uint8))
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=128, height=96, bits=8)
    plan = plan_pipeline(Settings(), src, dst)
    base = np.asarray(make_frame_fn(plan, pack_surface=True)(planes))
    for rotation, flip in ((90, True), (180, False), (270, False)):
        got = np.asarray(make_frame_fn(plan, pack_surface=True,
                                       rotation=rotation,
                                       flip=flip)(planes))
        ref = np.asarray(geo.rotate_flip(jnp.asarray(base), rotation, flip))
        np.testing.assert_array_equal(got, ref)
