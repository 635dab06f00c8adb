"""Native C++ repack library vs the numpy reference unpackers."""

import numpy as np
import pytest

from videorenderer import formats
from videorenderer.formats import ColorFormat, unpack_frame
from videorenderer.io import native


pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native library unavailable")


@pytest.mark.parametrize("fmt,packsize,dtype", [
    (ColorFormat.NV12, 1.5, np.uint8),
    (ColorFormat.P010, 3, np.uint16),
    (ColorFormat.P210, 4, np.uint16),
    (ColorFormat.YUY2, 2, np.uint8),
    (ColorFormat.UYVY, 2, np.uint8),
    (ColorFormat.Y210, 8, np.uint16),
    (ColorFormat.RGB24, 3, np.uint8),
    (ColorFormat.ARGB32, 4, np.uint8),
    (ColorFormat.R210, 4, np.uint8),
])
def test_native_matches_numpy(fmt, packsize, dtype):
    w, h = 48, 16
    info = formats.get_format_info(fmt)
    nbytes = info.buffer_size(w, h)
    rng = np.random.default_rng(0)
    buf = rng.integers(0, 256, nbytes, dtype=np.uint8).tobytes()

    formats.USE_NATIVE = False
    ref = unpack_frame(fmt, buf, w, h)
    formats.USE_NATIVE = True
    got = unpack_frame(fmt, buf, w, h)
    assert len(got.planes) == len(ref.planes)
    for a, b in zip(got.planes, ref.planes):
        np.testing.assert_array_equal(a, b)


def test_native_v210():
    w, h = 48, 4
    row_bytes = ((w + 47) // 48) * 128
    rng = np.random.default_rng(1)
    buf = rng.integers(0, 256, row_bytes * h, dtype=np.uint8).tobytes()
    formats.USE_NATIVE = False
    ref = unpack_frame(ColorFormat.V210, buf, w, h)
    formats.USE_NATIVE = True
    got = unpack_frame(ColorFormat.V210, buf, w, h)
    for a, b in zip(got.planes, ref.planes):
        np.testing.assert_array_equal(a, b)


def test_native_pack():
    rng = np.random.default_rng(2)
    rgb = rng.random((3, 8, 8)).astype(np.float32)
    out8 = native.pack_rgb8(rgb)
    ref8 = formats.pack_rgb8(np.moveaxis(rgb, 0, -1))
    np.testing.assert_array_equal(out8, ref8)
    out10 = native.pack_rgb10(rgb)
    ref10 = formats.pack_rgb10(np.moveaxis(rgb, 0, -1).astype(np.float64))
    np.testing.assert_array_equal(out10, ref10)


@pytest.mark.parametrize("fn,args", [
    (native.nv12_split, ()),
    (native.p010_split, ()),
    (lambda b, w, h: native.packed422_to_planar(b, w, h, "yuy2"), ()),
    (lambda b, w, h: native.packed422_to_planar(b, w, h, "y210"), ()),
    (lambda b, w, h: native.packed422_to_planar(b, w, h, "v210"), ()),
    (lambda b, w, h: native.rgb_to_planar(b, w, h, "rgb24"), ()),
    (lambda b, w, h: native.rgb_to_planar(b, w, h, "r210"), ()),
])
def test_native_rejects_short_buffer(fn, args):
    """Truncated frame buffers return None (falling back to the numpy path,
    which raises cleanly) instead of reading out of bounds in C."""
    w, h = 48, 16
    short = np.zeros(16, np.uint8)  # far too small for any 48x16 frame
    assert fn(short, w, h) is None


def test_native_rebuilds_on_stale_so(tmp_path, monkeypatch):
    """A source file newer than the .so triggers a rebuild (ADVICE r1: stale
    -march=native binaries must not mask source edits)."""
    import os
    import time
    so = native._LIB_PATH
    src = native._NATIVE_DIR / "frame_copy.cpp"
    if not so.exists():
        pytest.skip("no built library")
    # make the source look newer, then force a fresh load
    os.utime(src, (time.time() + 2, time.time() + 2))
    old_mtime = so.stat().st_mtime
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native._load() is not None
    assert so.stat().st_mtime > old_mtime
    os.utime(src)  # restore sane mtimes


def test_native_pitched_no_intermediate(monkeypatch):
    """Pitched buffers repack through the native *_p copiers directly —
    formats.repitch (the intermediate host copy) is never called
    (VERDICT r2 #7; the reference copiers take src_pitch,
    Source/Helper.cpp:414-428)."""
    if not native.available():
        pytest.skip("native library unavailable")
    w, h, pitch = 32, 16, 48
    rng = np.random.default_rng(9)
    tight = rng.integers(0, 256, w * h * 3 // 2, np.uint8)
    seg_y = tight[:w * h].reshape(h, w)
    seg_uv = tight[w * h:].reshape(h // 2, w)
    buf = np.zeros(pitch * h + pitch * (h // 2), np.uint8)
    for r in range(h):
        buf[r * pitch:r * pitch + w] = seg_y[r]
    off = pitch * h
    for r in range(h // 2):
        buf[off + r * pitch:off + r * pitch + w] = seg_uv[r]

    ref = formats.unpack_frame(formats.ColorFormat.NV12, tight.tobytes(),
                               w, h)

    def boom(*a, **k):
        raise AssertionError("repitch called on the native pitched path")

    monkeypatch.setattr(formats, "repitch", boom)
    got = formats.unpack_frame(formats.ColorFormat.NV12, buf.tobytes(),
                               w, h, pitch=pitch)
    for g, r in zip(got.planes, ref.planes):
        np.testing.assert_array_equal(g, r)

    # negative (bottom-up) pitch on the RGB24 native path
    rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
    bott = np.zeros((h, 64 * 3), np.uint8)
    for r in range(h):
        bott[h - 1 - r, :w * 3] = rgb[r].reshape(-1)
    ref2 = formats.unpack_frame(formats.ColorFormat.RGB24,
                                rgb.tobytes(), w, h)
    got2 = formats.unpack_frame(formats.ColorFormat.RGB24, bott.tobytes(),
                                w, h, pitch=-64 * 3)
    for g, r in zip(got2.planes, ref2.planes):
        np.testing.assert_array_equal(g, r)
