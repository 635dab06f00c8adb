"""Resizers vs the per-pixel HLSL oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from videorenderer.config import Downscaling, Upscaling
from videorenderer.ops import scale

from oracle import conv_resize_axis, interp_resize_axis

_UP = {
    "mitchell": Upscaling.MITCHELL,
    "catmullrom": Upscaling.CATMULL_ROM,
    "lanczos2": Upscaling.LANCZOS2,
    "lanczos3": Upscaling.LANCZOS3,
}
_DOWN = {
    "box": Downscaling.BOX,
    "bilinear": Downscaling.BILINEAR,
    "hamming": Downscaling.HAMMING,
    "bicubic": Downscaling.BICUBIC,
    "bicubic_sharp": Downscaling.BICUBIC_SHARP,
    "lanczos": Downscaling.LANCZOS,
}


@pytest.mark.parametrize("method", list(_UP))
@pytest.mark.parametrize("sizes", [(8, 13), (8, 16), (10, 24), (12, 7)])
def test_upscale_matrix_matches_oracle(method, sizes):
    in_size, out_size = sizes
    rng = np.random.default_rng(1)
    img = rng.random((5, in_size))
    ref = interp_resize_axis(img, out_size, method)
    mat = scale.upscale_matrix(_UP[method], in_size, out_size)
    got = img @ mat
    np.testing.assert_allclose(got, ref, atol=1e-12)


@pytest.mark.parametrize("filt", list(_DOWN))
@pytest.mark.parametrize("sizes", [(16, 7), (24, 8), (17, 5)])
def test_downscale_matrix_matches_oracle(filt, sizes):
    in_size, out_size = sizes
    rng = np.random.default_rng(2)
    img = rng.random((4, in_size))
    ref = conv_resize_axis(img, out_size, filt)
    mat = scale.downscale_matrix(_DOWN[filt], in_size, out_size)
    got = img @ mat
    np.testing.assert_allclose(got, ref, atol=1e-12)


def test_columns_sum_to_one():
    for m in _UP.values():
        mat = scale.upscale_matrix(m, 9, 20)
        np.testing.assert_allclose(mat.sum(axis=0), 1.0, atol=1e-9)
    for m in _DOWN.values():
        mat = scale.downscale_matrix(m, 20, 9)
        np.testing.assert_allclose(mat.sum(axis=0), 1.0, atol=1e-9)


def test_catmullrom_reproduces_linear_ramp():
    """Catmull-Rom interpolation is exact on linear functions (interior)."""
    mat = scale.upscale_matrix(Upscaling.CATMULL_ROM, 8, 16)
    x = np.arange(8.0)
    y = x @ mat
    expected = (np.arange(16) + 0.5) * 8 / 16 - 0.5
    np.testing.assert_allclose(y[3:-3], expected[3:-3], atol=1e-12)


def test_nearest_upscale():
    mat = scale.upscale_matrix(Upscaling.NEAREST, 4, 8)
    x = np.array([1.0, 2.0, 3.0, 4.0])
    np.testing.assert_allclose(x @ mat, np.repeat(x, 2), atol=0)


def test_box_downscale_is_average():
    mat = scale.downscale_matrix(Downscaling.BOX, 8, 4)
    x = np.arange(8.0)
    np.testing.assert_allclose(x @ mat, x.reshape(4, 2).mean(1), atol=1e-12)


def test_selection_rule():
    # equal size: None
    assert scale.select_scaler(100, 100, Upscaling.LANCZOS3, Downscaling.HAMMING, True) is None
    # shrink by <2 with 50% rule: use the *upscale* filter
    kind, m = scale.select_scaler(100, 60, Upscaling.LANCZOS3, Downscaling.HAMMING, True)
    assert kind == "up" and m == Upscaling.LANCZOS3
    # shrink by >2: downscale filter
    kind, m = scale.select_scaler(100, 40, Upscaling.LANCZOS3, Downscaling.HAMMING, True)
    assert kind == "down" and m == Downscaling.HAMMING
    # 50% rule off: any shrink uses the downscale filter
    kind, m = scale.select_scaler(100, 60, Upscaling.LANCZOS3, Downscaling.HAMMING, False)
    assert kind == "down"


def test_resize_plane_two_pass():
    rng = np.random.default_rng(5)
    img = rng.random((3, 12, 16)).astype(np.float32)
    out = np.asarray(scale.resize_plane(img, 6, 40,
                                        upscaling=Upscaling.CATMULL_ROM,
                                        downscaling=Downscaling.HAMMING))
    assert out.shape == (3, 6, 40)
    # X pass first (upscale 16->40), then Y (12->6 uses upscale filter since <2x)
    mx = scale.upscale_matrix(Upscaling.CATMULL_ROM, 16, 40)
    my = scale.upscale_matrix(Upscaling.CATMULL_ROM, 12, 6)
    ref = np.einsum("chw,wW,hH->cHW", img.astype(np.float64), mx, my)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_jinc2_constant_and_shape():
    img = np.full((2, 8, 8), 0.6, np.float32)
    out = np.asarray(scale.jinc2_resize(img, 20, 12))
    assert out.shape == (2, 20, 12)
    np.testing.assert_allclose(out, 0.6, atol=1e-5)


def test_jinc2_identity_at_integer_positions():
    """At 1:1 scale the sample point coincides with a texel center; the jinc
    weight at d=0 dominates but neighbors contribute — verify reproduction of
    a linear ramp (jinc2 reproduces constants and is near-exact on ramps
    away from edges)."""
    x = np.tile(np.arange(16, dtype=np.float64) / 15.0, (8, 1))
    out = np.asarray(scale.jinc2_resize(x, 8, 16))
    np.testing.assert_allclose(out[:, 2:-2], x[:, 2:-2], atol=5e-3)


def test_jinc2_phase_path_matches_gather():
    """Rational-scale phase decomposition == the general gather formulation."""
    from videorenderer.ops.scale import _jinc2_phases, _phase_period
    rng = np.random.default_rng(9)
    x = rng.random((2, 24, 32)).astype(np.float32)
    for (oh, ow) in [(48, 64), (36, 48), (24, 32)]:
        qy, py = _phase_period(24, oh)
        qx, px = _phase_period(32, ow)
        assert qy <= 8 and qx <= 8
        fast = np.asarray(_jinc2_phases(jnp.asarray(x), oh, ow, qy, py, qx, px))
        slow = np.asarray(scale._jinc2_gather(jnp.asarray(x), oh, ow))
        np.testing.assert_allclose(fast, slow, atol=1e-5)


def test_band_diagonals_stencil_matches_matmul():
    from videorenderer.ops.scale import (band_diagonals,
                                             stencil_resize_last_axis,
                                             stencil_resize_rows)
    from videorenderer.ops.chroma import chroma_upsample_matrices
    from videorenderer.config import ChromaScaling
    from videorenderer.csputils import ChromaLocation
    # composed chroma-up x downscale at net scale 1 (the 4K->1080p case)
    ux, uy = chroma_upsample_matrices(64, 32, 420, ChromaScaling.BILINEAR,
                                      ChromaLocation.MPEG2)
    wx = scale.upscale_matrix(Upscaling.LANCZOS3, 128, 64)
    wy = scale.upscale_matrix(Upscaling.LANCZOS3, 64, 32)
    cwx = ux @ wx
    cwy = uy @ wy
    dx = band_diagonals(np.asarray(cwx))
    dy = band_diagonals(np.asarray(cwy))
    assert dx is not None and dy is not None
    rng = np.random.default_rng(0)
    x = rng.random((2, 32, 64)).astype(np.float32)
    ref = np.einsum("chw,wW,hH->cHW", x.astype(np.float64), cwx, cwy)
    got = np.asarray(stencil_resize_rows(
        stencil_resize_last_axis(jnp.asarray(x), dx), dy))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_band_diagonals_rejects_wide_or_nonsquare():
    from videorenderer.ops.scale import band_diagonals
    assert band_diagonals(np.asarray(scale.upscale_matrix(
        Upscaling.LANCZOS3, 64, 128))) is None   # non-square
    wide = np.ones((64, 64))
    assert band_diagonals(wide) is None          # full band


def test_lanczos3_reference_bug_compat():
    """The compat switch reproduces the reference's duplicated Q0/Q1 tap
    (ps_interpolation_lanczos3.hlsl samples pos-1.5 twice)."""
    fixed = scale.upscale_matrix(Upscaling.LANCZOS3, 16, 40)
    buggy = scale.upscale_matrix(Upscaling.LANCZOS3, 16, 40,
                                 reference_bug_compat=True)
    assert not np.allclose(fixed, buggy)
    np.testing.assert_allclose(buggy.sum(axis=0), 1.0, atol=1e-9)


def test_jinc2_lowrank_matches_gather():
    """The low-rank separable (matmul) formulation == the general gather
    formulation, rational and irrational-period scales alike, to the
    documented truncation bound: the SVD rank cutoff _JINC2_SV_CUTOFF
    drops singular values <= 1e-4 relative, so weights (and therefore
    [0,1]-signal outputs) may differ from the exact gather by a few times
    that — an ~-80 dB floor, far below the 8-bit quantization the
    pipeline ends in.  2x upscales are rank-4 EXACT (tested at 1e-6)."""
    from videorenderer.ops.scale import _jinc2_lowrank
    rng = np.random.default_rng(10)
    x = rng.random((2, 24, 32)).astype(np.float32)
    for (oh, ow) in [(48, 64), (36, 48), (37, 53), (24, 61)]:
        lr = np.asarray(_jinc2_lowrank(jnp.asarray(x), oh, ow))
        slow = np.asarray(scale._jinc2_gather(jnp.asarray(x), oh, ow))
        atol = 1e-6 if (2 * 24, 2 * 32) == (oh, ow) else 5e-4
        np.testing.assert_allclose(lr, slow, atol=atol)


def test_jinc2_lowrank_normalization_vectors():
    """wsum factorization == the true per-pixel weight sums, to the same
    _JINC2_SV_CUTOFF truncation bound (numerator and normalization
    truncate together, so the resample RATIO error stays first-order)."""
    from videorenderer.ops.scale import (_jinc2_g, _jinc2_tap_data,
                                             jinc2_lr_matrices)
    in_h, out_h, in_w, out_w = 20, 47, 30, 29
    _, _, ay, bx = jinc2_lr_matrices(in_h, out_h, in_w, out_w)
    _, fy = _jinc2_tap_data(in_h, out_h)
    _, fx = _jinc2_tap_data(in_w, out_w)
    offs = np.arange(4) - 1
    for y in (0, 11, 46):
        for x in (0, 17, 28):
            w = _jinc2_g((fy[y] - offs)[:, None] ** 2
                         + (fx[x] - offs)[None, :] ** 2)
            np.testing.assert_allclose(ay[y] @ bx[x], w.sum(), rtol=5e-4)
