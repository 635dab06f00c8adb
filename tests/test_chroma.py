"""Chroma upsampling vs the per-pixel HLSL oracle."""

import numpy as np
import pytest

from videorenderer.config import ChromaScaling
from videorenderer.csputils import ChromaLocation
from videorenderer.ops import chroma

from oracle import chroma_upsample_420, chroma_upsample_422

_LOC = {
    "mpeg2": ChromaLocation.MPEG2,
    "mpeg1": ChromaLocation.MPEG1,
    "cosited": ChromaLocation.COSITED,
}
_METHOD = {
    "nearest": ChromaScaling.NEAREST,
    "bilinear": ChromaScaling.BILINEAR,
    "catmullrom": ChromaScaling.CATMULL_ROM,
}


@pytest.mark.parametrize("method", ["nearest", "bilinear", "catmullrom"])
@pytest.mark.parametrize("loc", ["mpeg2", "mpeg1", "cosited"])
def test_420_matches_oracle(method, loc):
    rng = np.random.default_rng(42)
    c = rng.random((6, 8))
    ref = chroma_upsample_420(c, method, loc, 12, 16)
    got = np.asarray(chroma.upsample_chroma(
        c.astype(np.float64), 420, _METHOD[method], _LOC[loc]))
    np.testing.assert_allclose(got, ref, atol=1e-12)


@pytest.mark.parametrize("method", ["nearest", "bilinear", "catmullrom"])
def test_422_matches_oracle(method):
    rng = np.random.default_rng(7)
    c = rng.random((4, 8))
    ref = chroma_upsample_422(c, method, 16)
    got = np.asarray(chroma.upsample_chroma(
        c.astype(np.float64), 422, _METHOD[method]))
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_constant_preserved():
    c = np.full((4, 4), 0.37)
    for method in ChromaScaling:
        out = np.asarray(chroma.upsample_chroma(c, 420, method,
                                                ChromaLocation.MPEG2))
        assert out.shape == (8, 8)
        np.testing.assert_allclose(out, 0.37, atol=1e-12)


def test_444_identity():
    c = np.random.default_rng(0).random((4, 4))
    out = np.asarray(chroma.upsample_chroma(c, 444, ChromaScaling.BILINEAR))
    np.testing.assert_array_equal(out, c)


def test_batched_leading_dims():
    rng = np.random.default_rng(3)
    c = rng.random((2, 2, 4, 4))  # (batch, planes, H, W)
    out = np.asarray(chroma.upsample_chroma(c, 420, ChromaScaling.BILINEAR))
    assert out.shape == (2, 2, 8, 8)
    single = np.asarray(chroma.upsample_chroma(c[1, 0], 420, ChromaScaling.BILINEAR))
    np.testing.assert_allclose(out[1, 0], single, atol=1e-12)


def test_blend_deinterlace():
    y = np.arange(16, dtype=np.float64).reshape(4, 4)
    out = np.asarray(chroma.blend_deinterlace_luma(y))
    # interior row: (2*y[r] + y[r-1] + y[r+1]) / 4
    np.testing.assert_allclose(out[1], (2 * y[1] + y[0] + y[2]) / 4)
    # edge rows clamp
    np.testing.assert_allclose(out[0], (2 * y[0] + y[0] + y[1]) / 4)
