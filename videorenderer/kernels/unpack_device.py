"""Device-side packed-format unpacking (v210 / Y210 / biplanar UV split).

The host-side numpy/C++ repack (videorenderer/formats.py, native/) is
fine for file workflows, but a production ingest path wants the *packed*
bytes shipped to device memory (smallest transfer) and unpacked there.
These are integer bit-twiddling ops that XLA compiles into a couple of
fused kernels — the equivalent of the reference's SIMD repack running on
the GPU-copy side instead of the CPU (Source/Helper.cpp:703-760 CopyFrameV210,
Source/DX11VideoProcessor.cpp:1213-1252 plane binding).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def v210_unpack_device(dwords: jnp.ndarray, width: int):
    """(..., row_dwords) uint32 v210 rows -> (Y, U, V) uint16 MSB-aligned
    planes ((..., W), (..., W/2), (..., W/2)).

    v210 packs 6 pixels per 4 dwords with the component sequence
    U0 Y0 V0 | Y1 U2 Y2 | V2 Y3 U4 | Y4 V4 Y5 (10 bits each, little-endian).
    """
    lead = dwords.shape[:-1]
    row_dwords = dwords.shape[-1]
    groups = row_dwords // 4
    d = dwords.reshape(lead + (groups, 4))
    c0 = (d & 0x3FF).astype(jnp.uint16) << 6
    c1 = ((d >> 10) & 0x3FF).astype(jnp.uint16) << 6
    c2 = ((d >> 20) & 0x3FF).astype(jnp.uint16) << 6

    y = jnp.stack([c1[..., 0], c0[..., 1], c2[..., 1],
                   c1[..., 2], c0[..., 3], c2[..., 3]], axis=-1)
    u = jnp.stack([c0[..., 0], c1[..., 1], c2[..., 2]], axis=-1)
    v = jnp.stack([c2[..., 0], c0[..., 2], c1[..., 3]], axis=-1)
    y = y.reshape(lead + (groups * 6,))[..., :width]
    u = u.reshape(lead + (groups * 3,))[..., :width // 2]
    v = v.reshape(lead + (groups * 3,))[..., :width // 2]
    return y, u, v


def y210_unpack_device(words: jnp.ndarray, width: int):
    """(..., W*2) uint16 Y210/Y216 rows (Y0 U Y1 V) -> (Y, U, V) planes."""
    lead = words.shape[:-1]
    q = words.reshape(lead + (width // 2, 4))
    y = q[..., 0::2].reshape(lead + (width,))
    return y, q[..., 1], q[..., 3]


def nv12_split_device(buf: jnp.ndarray, width: int, height: int):
    """(..., H*W*3/2) uint8/uint16 NV12/P010 buffer -> (Y, U, V) planes."""
    lead = buf.shape[:-1]
    ysize = width * height
    y = buf[..., :ysize].reshape(lead + (height, width))
    uv = buf[..., ysize:].reshape(lead + (height // 2, width // 2, 2))
    return y, uv[..., 0], uv[..., 1]


def _shift10to16(v):
    """10-bit codes -> MSB-aligned 16-bit (the <<6 texture convention)."""
    return v.astype(jnp.uint16) << 6


def ayuv_unpack_device(buf: jnp.ndarray, width: int, height: int):
    """(..., H*W*4) uint8 AYUV (byte order V U Y A, MSDN layout) ->
    (Y, U, V) uint8 planes — device analogue of the host AYUV branch in
    formats.unpack_frame (reference samples it on-GPU,
    Source/Shaders.cpp:120-127)."""
    lead = buf.shape[:-1]
    a = buf.reshape(lead + (height, width, 4))
    return a[..., 2], a[..., 1], a[..., 0]


def y410_unpack_device(dwords: jnp.ndarray, width: int, height: int):
    """(..., H*W) uint32 Y410 dwords (U 0-9 | Y 10-19 | V 20-29 | A) ->
    (Y, U, V) uint16 MSB-aligned planes."""
    lead = dwords.shape[:-1]
    d = dwords.reshape(lead + (height, width))
    u = _shift10to16(d & 0x3FF)
    y = _shift10to16((d >> 10) & 0x3FF)
    v = _shift10to16((d >> 20) & 0x3FF)
    return y, u, v


def y416_unpack_device(words: jnp.ndarray, width: int, height: int):
    """(..., H*W*4) uint16 Y416 (U Y V A) -> (Y, U, V) uint16 planes."""
    lead = words.shape[:-1]
    a = words.reshape(lead + (height, width, 4))
    return a[..., 1], a[..., 0], a[..., 2]


def rgb24_unpack_device(buf: jnp.ndarray, width: int, height: int):
    """(..., H*W*3) uint8 BGR (DIB convention, CopyFrameRGB24
    Source/Helper.cpp:430-470) -> (R, G, B) uint8 planes."""
    lead = buf.shape[:-1]
    a = buf.reshape(lead + (height, width, 3))
    return a[..., 2], a[..., 1], a[..., 0]


def bgra32_unpack_device(buf: jnp.ndarray, width: int, height: int):
    """(..., H*W*4) uint8 BGRA/BGRX -> (R, G, B) uint8 planes."""
    lead = buf.shape[:-1]
    a = buf.reshape(lead + (height, width, 4))
    return a[..., 2], a[..., 1], a[..., 0]


def rgb48_unpack_device(words: jnp.ndarray, width: int, height: int,
                        order: str = "rgb"):
    """(..., H*W*3) uint16 RGB48/BGR48 -> (R, G, B) uint16 planes
    (CopyFrameRGB48/CopyFrameBGR48, Source/Helper.cpp:472-530)."""
    lead = words.shape[:-1]
    a = words.reshape(lead + (height, width, 3))
    if order == "bgr":
        return a[..., 2], a[..., 1], a[..., 0]
    return a[..., 0], a[..., 1], a[..., 2]


def bgra64_unpack_device(words: jnp.ndarray, width: int, height: int):
    """(..., H*W*4) uint16 BGRA64 -> (R, G, B) uint16 planes."""
    lead = words.shape[:-1]
    a = words.reshape(lead + (height, width, 4))
    return a[..., 2], a[..., 1], a[..., 0]


def b64a_unpack_device(words: jnp.ndarray, width: int, height: int):
    """(..., H*W*4) uint16 b64a (big-endian A R G B, CopyFrameB64A) ->
    (R, G, B) uint16 planes."""
    lead = words.shape[:-1]
    a = words.reshape(lead + (height, width, 4))
    sw = ((a & jnp.uint16(0xFF)) << 8) | (a >> 8)     # byteswap u16
    return sw[..., 1], sw[..., 2], sw[..., 3]


def r210_unpack_device(dwords: jnp.ndarray, width: int, height: int):
    """(..., H*W) uint32 r210 big-endian dwords -> (R, G, B) uint16
    MSB-aligned planes (CopyFrameR210, Source/Helper.cpp:762-790)."""
    lead = dwords.shape[:-1]
    d = dwords.reshape(lead + (height, width))
    # byteswap via shifts (XLA int ops)
    sw = (((d & 0xFF) << 24) | ((d & 0xFF00) << 8)
          | ((d >> 8) & 0xFF00) | (d >> 24))
    r = _shift10to16((sw >> 20) & 0x3FF)
    g = _shift10to16((sw >> 10) & 0x3FF)
    b = _shift10to16(sw & 0x3FF)
    return r, g, b


def p01x_split_device(buf: jnp.ndarray, width: int, height: int,
                      div_h: int = 2):
    """(..., H*W + (H//div_h)*W) uint8/uint16 biplanar buffer (NV12/P010/
    P016/P210/P216) -> (Y, U, V) planes."""
    lead = buf.shape[:-1]
    ysize = width * height
    y = buf[..., :ysize].reshape(lead + (height, width))
    uv = buf[..., ysize:].reshape(lead + (height // div_h, width // 2, 2))
    return y, uv[..., 0], uv[..., 1]


def yuy2_unpack_device(buf: jnp.ndarray, width: int, height: int,
                       order: str = "yuy2"):
    """(..., H*W*2) uint8 YUY2 (Y0 U Y1 V) or UYVY (U Y0 V Y1) -> planar."""
    lead = buf.shape[:-1]
    q = buf.reshape(lead + (height, width // 2, 4))
    if order == "uyvy":
        y = jnp.stack([q[..., 1], q[..., 3]], axis=-1)
        u, v = q[..., 0], q[..., 2]
    else:
        y = jnp.stack([q[..., 0], q[..., 2]], axis=-1)
        u, v = q[..., 1], q[..., 3]
    return y.reshape(lead + (height, width)), u, v


def _v210_frame(buf, w, h):
    row_dwords = ((w + 47) // 48) * 32
    lead = buf.shape[:-1]
    return v210_unpack_device(buf.reshape(lead + (h, row_dwords)), w)


def _y210_frame(buf, w, h):
    lead = buf.shape[:-1]
    return y210_unpack_device(buf.reshape(lead + (h, w * 2)), w)


_DEVICE_UNPACKERS = {
    "NV12": p01x_split_device,
    "P010": p01x_split_device,
    "P016": p01x_split_device,
    "P210": lambda b, w, h: p01x_split_device(b, w, h, 1),
    "P216": lambda b, w, h: p01x_split_device(b, w, h, 1),
    "YUY2": yuy2_unpack_device,
    "UYVY": lambda b, w, h: yuy2_unpack_device(b, w, h, "uyvy"),
    "Y210": _y210_frame,
    "Y216": _y210_frame,
    "v210": _v210_frame,
    "AYUV": ayuv_unpack_device,
    "Y410": y410_unpack_device,
    "Y416": y416_unpack_device,
    "RGB24": rgb24_unpack_device,
    "RGB32": bgra32_unpack_device,
    "ARGB32": bgra32_unpack_device,
    "RGB48": rgb48_unpack_device,
    "BGR48": lambda b, w, h: rgb48_unpack_device(b, w, h, "bgr"),
    "BGRA64": bgra64_unpack_device,
    "b64a": b64a_unpack_device,
    "r210": r210_unpack_device,
}

# numpy view dtype of the flat per-frame buffer each unpacker expects
DEVICE_BUFFER_DTYPE = {
    "NV12": np.uint8, "P010": np.uint16, "P016": np.uint16,
    "P210": np.uint16, "P216": np.uint16,
    "YUY2": np.uint8, "UYVY": np.uint8,
    "Y210": np.uint16, "Y216": np.uint16, "v210": np.uint32,
    "AYUV": np.uint8, "Y410": np.uint32, "Y416": np.uint16,
    "RGB24": np.uint8, "RGB32": np.uint8, "ARGB32": np.uint8,
    "RGB48": np.uint16, "BGR48": np.uint16, "BGRA64": np.uint16,
    "b64a": np.uint16, "r210": np.uint32,
}


def has_device_unpacker(fmt_name: str) -> bool:
    return fmt_name in _DEVICE_UNPACKERS


def unpack_frame_device(fmt_name: str, buf: jnp.ndarray, width: int,
                        height: int):
    """Dispatch device-side unpack by ColorFormat name over a flat
    (..., n_words) device buffer; raises KeyError for formats without a
    device unpacker (use the host path).  The Y210/P010-class 10-bit
    formats come out MSB-aligned already (the container stores them so);
    Y410/v210/r210 shift in-op."""
    fn = _DEVICE_UNPACKERS.get(fmt_name)
    if fn is None:
        raise KeyError(f"no device unpacker for {fmt_name}")
    return fn(buf, width, height)
