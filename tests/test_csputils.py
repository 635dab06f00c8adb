"""Unit tests for the colorspace math (port of Source/csputils.cpp)."""

import numpy as np
import pytest

from videorenderer import csputils as cs


def test_bt709_tv_matrix_known_values():
    """BT.709 limited-range 8-bit: the canonical YCbCr->RGB matrix."""
    p = cs.CSPParams(color=cs.Colorspace(cs.CSP.BT_709, cs.Levels.TV),
                     input_bits=8, texture_bits=8)
    m = cs.get_csp_matrix(p)
    # mp_get_csp_mul(8,8) == 1, so ymul = 255/219, cmul = 255/224
    assert m.m[0, 0] == pytest.approx(255 / 219, rel=1e-6)
    # Y column identical for R,G,B
    assert m.m[1, 0] == pytest.approx(m.m[0, 0])
    assert m.m[2, 0] == pytest.approx(m.m[0, 0])
    # R-V coefficient: 2*(1-Kr) * cmul
    assert m.m[0, 2] == pytest.approx(2 * (1 - 0.2126) * 255 / 224, rel=1e-6)
    # R has no U contribution
    assert m.m[0, 1] == pytest.approx(0.0, abs=1e-12)
    # B has no V contribution
    assert m.m[2, 2] == pytest.approx(0.0, abs=1e-12)


def test_black_maps_to_black_white_to_white():
    """Y=16/255*..., U=V=128 must map to RGB 0; Y=235 to RGB 1."""
    for space, bits in [(cs.CSP.BT_709, 8), (cs.CSP.BT_601, 8),
                        (cs.CSP.BT_2020_NC, 10), (cs.CSP.SMPTE_240M, 8)]:
        p = cs.CSPParams(color=cs.Colorspace(space, cs.Levels.TV),
                         input_bits=bits, texture_bits=bits)
        cm = cs.get_csp_matrix(p)
        maxv = (1 << bits) - 1
        black = np.array([16 << (bits - 8), 128 << (bits - 8), 128 << (bits - 8)]) / maxv
        white = np.array([235 << (bits - 8), 128 << (bits - 8), 128 << (bits - 8)]) / maxv
        rgb_black = cm.m @ black + cm.c
        rgb_white = cm.m @ white + cm.c
        np.testing.assert_allclose(rgb_black, 0.0, atol=2e-3)
        np.testing.assert_allclose(rgb_white, 1.0, atol=2e-3)


def test_full_range_identity_points():
    p = cs.CSPParams(color=cs.Colorspace(cs.CSP.BT_709, cs.Levels.PC),
                     input_bits=8, texture_bits=8)
    cm = cs.get_csp_matrix(p)
    rgb = cm.m @ np.array([0, 128 / 255, 128 / 255]) + cm.c
    np.testing.assert_allclose(rgb, 0.0, atol=2e-3)


def test_ycgco_matrix():
    p = cs.CSPParams(color=cs.Colorspace(cs.CSP.YCGCO, cs.Levels.PC),
                     input_bits=8, texture_bits=8)
    cm = cs.get_csp_matrix(p)
    # YCgCo: R = Y - Cg + Co etc. — sign structure preserved after scaling
    assert cm.m[0, 1] < 0 and cm.m[0, 2] > 0
    assert cm.m[1, 1] > 0 and abs(cm.m[1, 2]) < 1e-9
    assert cm.m[2, 1] < 0 and cm.m[2, 2] < 0


def test_invert_cmat_roundtrip():
    p = cs.CSPParams(color=cs.Colorspace(cs.CSP.BT_709, cs.Levels.TV))
    cm = cs.get_csp_matrix(p)
    inv = cs.invert_cmat(cm)
    yuv = np.array([0.3, 0.6, 0.45])
    rgb = cm.m @ yuv + cm.c
    back = inv.m @ rgb + inv.c
    np.testing.assert_allclose(back, yuv, atol=1e-10)


def test_rgb2xyz_bt709_known():
    """BT.709 RGB->XYZ matrix (Lindbloom reference values)."""
    m = cs.rgb2xyz_matrix(cs.Primaries.BT_709)
    expected = np.array([
        [0.4124, 0.3576, 0.1805],
        [0.2126, 0.7152, 0.0722],
        [0.0193, 0.1192, 0.9505],
    ])
    np.testing.assert_allclose(m, expected, atol=2e-4)


def test_gamut_2020_to_709_known():
    """BT.2020->BT.709 matrix, well-known values (e.g. BT.2407 Annex 1)."""
    m = cs.bt2020_to_bt709_matrix()
    expected = np.array([
        [1.6605, -0.5876, -0.0728],
        [-0.1246, 1.1329, -0.0083],
        [-0.0182, -0.1006, 1.1187],
    ])
    np.testing.assert_allclose(m, expected, atol=2e-4)
    # rows of the inverse-direction product: white maps to white
    np.testing.assert_allclose(m @ np.ones(3), np.ones(3), atol=1e-6)


def test_gamut_identity():
    m = cs.gamut_conversion_matrix(cs.Primaries.BT_709, cs.Primaries.BT_709)
    np.testing.assert_allclose(m, np.eye(3), atol=1e-12)


def test_hue_saturation_applied():
    p0 = cs.CSPParams(color=cs.Colorspace(cs.CSP.BT_709, cs.Levels.TV))
    p1 = cs.CSPParams(color=cs.Colorspace(cs.CSP.BT_709, cs.Levels.TV),
                      saturation=0.5)
    m0 = cs.get_csp_matrix(p0)
    m1 = cs.get_csp_matrix(p1)
    np.testing.assert_allclose(m1.m[:, 1:], 0.5 * m0.m[:, 1:], atol=1e-9)
    np.testing.assert_allclose(m1.m[:, 0], m0.m[:, 0], atol=1e-12)


def test_trc_peaks():
    assert cs.trc_nom_peak(cs.TRC.PQ) == pytest.approx(10000 / 203)
    assert cs.trc_is_hdr(cs.TRC.PQ)
    assert not cs.trc_is_hdr(cs.TRC.BT_1886)


def test_default_matrix_for_size():
    assert cs.default_matrix_for_size(720, 576) == cs.CSP.BT_601
    assert cs.default_matrix_for_size(1920, 1080) == cs.CSP.BT_709


def test_settings_roundtrip_with_vp_formats():
    from videorenderer.config import Settings, VPEnableFormats, Upscaling
    s = Settings(vp_formats=VPEnableFormats(nv12=False, yuy2=False),
                 upscaling=Upscaling.LANCZOS3, sdr_display_nits=9999)
    d = s.to_dict()
    back = Settings.from_dict(d)
    assert back.vp_formats.nv12 is False and back.vp_formats.p01x is True
    assert back.upscaling == Upscaling.LANCZOS3
    assert back.sdr_display_nits == 400  # clamped on load (registry behavior)
