"""Tests for the format registry and frame unpackers."""

import numpy as np
import pytest

from videorenderer.formats import (ColorFormat, ColorSystem, FORMATS,
                                       get_format_info, pack_rgb8, pack_rgb10,
                                       unpack_frame, unpack_rgb10)


def test_registry_complete():
    # all 39 enum members except NONE have a row
    assert len(FORMATS) == 39
    for fmt, info in FORMATS.items():
        assert info.cformat == fmt
        assert info.plane_bits in (8, 16)
        assert info.subsampling in (400, 420, 422, 444)


def test_plane_shapes():
    info = get_format_info(ColorFormat.NV12)
    assert info.plane_shapes(1920, 1080) == [(1080, 1920), (540, 960), (540, 960)]
    info = get_format_info(ColorFormat.YUY2)
    assert info.plane_shapes(1920, 1080) == [(1080, 1920), (1080, 960), (1080, 960)]


def test_nv12_unpack():
    w, h = 8, 4
    y = np.arange(w * h, dtype=np.uint8).reshape(h, w)
    u = np.full((h // 2, w // 2), 100, np.uint8)
    v = np.full((h // 2, w // 2), 200, np.uint8)
    uv = np.stack([u, v], axis=-1).reshape(h // 2, w)
    buf = np.concatenate([y.ravel(), uv.ravel()]).tobytes()
    f = unpack_frame(ColorFormat.NV12, buf, w, h)
    np.testing.assert_array_equal(f.planes[0], y)
    np.testing.assert_array_equal(f.planes[1], u)
    np.testing.assert_array_equal(f.planes[2], v)


def test_p010_unpack_msb_aligned():
    w, h = 4, 2
    y10 = np.array([[64, 512, 940, 1023], [0, 1, 2, 3]], np.uint16)
    y = (y10 << 6)
    u = np.array([[512, 300]], np.uint16) << 6
    v = np.array([[100, 700]], np.uint16) << 6
    uv = np.stack([u, v], -1).reshape(1, 4)
    buf = np.concatenate([y.ravel(), uv.ravel()]).astype(np.uint16).tobytes()
    f = unpack_frame(ColorFormat.P010, buf, w, h)
    np.testing.assert_array_equal(f.planes[0], y)
    np.testing.assert_array_equal(f.planes[1], u)
    np.testing.assert_array_equal(f.planes[2], v)


def test_yv12_swaps_uv():
    w, h = 4, 2
    y = np.zeros((h, w), np.uint8)
    v = np.full((1, 2), 7, np.uint8)   # V plane comes first in YV12
    u = np.full((1, 2), 9, np.uint8)
    buf = np.concatenate([y.ravel(), v.ravel(), u.ravel()]).tobytes()
    f = unpack_frame(ColorFormat.YV12, buf, w, h)
    assert f.planes[1][0, 0] == 9   # U
    assert f.planes[2][0, 0] == 7   # V


def test_yuy2_unpack():
    w, h = 4, 1
    # Y0 U0 Y1 V0 | Y2 U1 Y3 V1
    buf = bytes([10, 100, 20, 200, 30, 101, 40, 201])
    f = unpack_frame(ColorFormat.YUY2, buf, w, h)
    np.testing.assert_array_equal(f.planes[0], [[10, 20, 30, 40]])
    np.testing.assert_array_equal(f.planes[1], [[100, 101]])
    np.testing.assert_array_equal(f.planes[2], [[200, 201]])


def test_uyvy_unpack():
    buf = bytes([100, 10, 200, 20, 101, 30, 201, 40])
    f = unpack_frame(ColorFormat.UYVY, buf, 4, 1)
    np.testing.assert_array_equal(f.planes[0], [[10, 20, 30, 40]])
    np.testing.assert_array_equal(f.planes[1], [[100, 101]])
    np.testing.assert_array_equal(f.planes[2], [[200, 201]])


def test_yuv420p10_shifted():
    w, h = 4, 2
    y = np.full((h, w), 512, np.uint16)
    u = np.full((1, 2), 512, np.uint16)
    v = np.full((1, 2), 512, np.uint16)
    buf = np.concatenate([y.ravel(), u.ravel(), v.ravel()]).tobytes()
    f = unpack_frame(ColorFormat.YUV420P10, buf, w, h)
    assert f.planes[0][0, 0] == 512 << 6


def test_gbrp_reorders_to_rgb():
    w, h = 2, 1
    g = np.array([[1, 2]], np.uint8)
    b = np.array([[3, 4]], np.uint8)
    r = np.array([[5, 6]], np.uint8)
    buf = np.concatenate([g.ravel(), b.ravel(), r.ravel()]).tobytes()
    f = unpack_frame(ColorFormat.GBRP8, buf, w, h)
    np.testing.assert_array_equal(f.planes[0], r)
    np.testing.assert_array_equal(f.planes[1], g)
    np.testing.assert_array_equal(f.planes[2], b)


def test_rgb24_bgr_order():
    buf = bytes([255, 0, 0,  0, 255, 0])  # blue px, green px (BGR)
    f = unpack_frame(ColorFormat.RGB24, buf, 2, 1)
    assert f.planes[0][0, 0] == 0 and f.planes[2][0, 0] == 255   # R, B
    assert f.planes[1][0, 1] == 255                               # G


def test_y410_bitfields():
    u, y, v = 100, 600, 900
    dword = np.array([u | (y << 10) | (v << 20) | (3 << 30)], np.uint32)
    f = unpack_frame(ColorFormat.Y410, dword.tobytes(), 1, 1)
    assert f.planes[0][0, 0] == y << 6
    assert f.planes[1][0, 0] == u << 6
    assert f.planes[2][0, 0] == v << 6


def test_r210_big_endian():
    r, g, b = 1000, 500, 250
    dword = np.array([(r << 20) | (g << 10) | b], np.uint32).byteswap()
    f = unpack_frame(ColorFormat.R210, dword.tobytes(), 1, 1)
    assert f.planes[0][0, 0] == r << 6
    assert f.planes[1][0, 0] == g << 6
    assert f.planes[2][0, 0] == b << 6


def test_v210_unpack():
    w, h = 6, 1
    vals = dict(U0=10, Y0=20, V0=30, Y1=40, U2=50, Y2=60,
                V2=70, Y3=80, U4=90, Y4=100, V4=110, Y5=120)
    dw = np.array([
        vals["U0"] | (vals["Y0"] << 10) | (vals["V0"] << 20),
        vals["Y1"] | (vals["U2"] << 10) | (vals["Y2"] << 20),
        vals["V2"] | (vals["Y3"] << 10) | (vals["U4"] << 20),
        vals["Y4"] | (vals["V4"] << 10) | (vals["Y5"] << 20),
    ], np.uint32)
    row = np.zeros(32, np.uint32)  # 128-byte aligned row
    row[:4] = dw
    f = unpack_frame(ColorFormat.V210, row.tobytes(), w, h)
    np.testing.assert_array_equal(f.planes[0][0], np.array([20, 40, 60, 80, 100, 120]) << 6)
    np.testing.assert_array_equal(f.planes[1][0], np.array([10, 50, 90]) << 6)
    np.testing.assert_array_equal(f.planes[2][0], np.array([30, 70, 110]) << 6)


def test_rgb10_roundtrip():
    rng = np.random.default_rng(0)
    rgb = np.round(rng.random((4, 4, 3)) * 1023) / 1023
    packed = pack_rgb10(rgb)
    back = unpack_rgb10(packed)
    np.testing.assert_allclose(back, rgb, atol=1e-7)


def test_b64a_big_endian():
    a, r, g, b = 0xFFFF, 0x1234, 0x5678, 0x9ABC
    px = np.array([a, r, g, b], np.uint16).byteswap()
    f = unpack_frame(ColorFormat.B64A, px.tobytes(), 1, 1)
    assert f.planes[0][0, 0] == r
    assert f.planes[1][0, 0] == g
    assert f.planes[2][0, 0] == b
