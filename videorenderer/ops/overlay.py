"""Subtitle / OSD composition: premultiplied alpha blending with dirty
rects, and the SDR-overlay-on-PQ brightness compensation.

Reference equivalents:
 * subtitle alpha-blt quads (CDX11SubPic AlphaBlt, Source/SubPic/DX11SubPic.cpp)
   and the player-callback path DrawSubtitles
   (Source/DX11VideoProcessor.cpp:3247-3295)
 * IMFVideoMixerBitmap alpha-bitmap OSD (Source/DX11VideoProcessor.cpp:4553-4623)
 * ps_convert_bitmap_to_pq.hlsl — SDR OSD pre-compensated to PQ at
   100/50/30 nits (iHdrOsdBrightness), constants in TransferPQ
   (Source/DX11Helper.h:267-272)
"""

from __future__ import annotations

import jax.numpy as jnp

from .transfer import linear_to_st2084, srgb_like_to_linear

# OSD nits per iHdrOsdBrightness setting (PropPage choices 100/50/30 nits)
OSD_NITS = (100.0, 50.0, 30.0)


def alpha_blend(base: jnp.ndarray, overlay_rgb: jnp.ndarray,
                overlay_alpha: jnp.ndarray) -> jnp.ndarray:
    """Straight (non-premultiplied) alpha blend: out = ov*a + base*(1-a).

    base: (..., 3, H, W); overlay_rgb: (3, H, W) or broadcastable;
    overlay_alpha: (H, W) or (1, H, W), in [0,1].
    """
    a = overlay_alpha
    if a.ndim == base.ndim - 1:
        a = a[..., None, :, :]
    return overlay_rgb * a + base * (1.0 - a)


def alpha_blend_premultiplied(base: jnp.ndarray, overlay_rgb_premul: jnp.ndarray,
                              overlay_alpha: jnp.ndarray) -> jnp.ndarray:
    """Premultiplied blend (D3D SRC_ONE/INV_SRC_ALPHA, the subpic path):
    out = ov + base*(1-a)."""
    a = overlay_alpha
    if a.ndim == base.ndim - 1:
        a = a[..., None, :, :]
    return overlay_rgb_premul + base * (1.0 - a)


def blend_in_rect(base: jnp.ndarray, overlay_rgb: jnp.ndarray,
                  overlay_alpha: jnp.ndarray, x: int, y: int,
                  premultiplied: bool = False) -> jnp.ndarray:
    """Composite a small overlay at (x, y) — the dirty-rect path (ISubPic
    GetDirtyRect/AlphaBlt): only the overlay-sized region is touched, via a
    static update-slice.  Overlays are clipped to the frame bounds
    (ClipToSurface analogue, Source/Helper.cpp)."""
    fh, fw = base.shape[-2], base.shape[-1]
    h, w = overlay_alpha.shape[-2], overlay_alpha.shape[-1]
    # clip overlay to the surface
    ox = max(0, -x)
    oy = max(0, -y)
    x = max(0, x)
    y = max(0, y)
    h = min(h - oy, fh - y)
    w = min(w - ox, fw - x)
    if h <= 0 or w <= 0:
        return base
    ov_rgb = overlay_rgb[..., oy:oy + h, ox:ox + w]
    ov_a = overlay_alpha[..., oy:oy + h, ox:ox + w]
    region = base[..., :, y:y + h, x:x + w]
    blend = alpha_blend_premultiplied if premultiplied else alpha_blend
    blended = blend(region, ov_rgb, ov_a)
    return base.at[..., :, y:y + h, x:x + w].set(blended)


_SURFACE_BITS = {"rgb10a2": (1023.0, (0, 10, 20), -1073741824),
                 "rgba8": (255.0, (0, 8, 16), -16777216)}


def _unpack_dwords(dwords: jnp.ndarray, fmt: str) -> jnp.ndarray:
    """(..., h, w) int32 packed dwords -> (..., 3, h, w) float [0,1]."""
    maxv, shifts, _ = _SURFACE_BITS[fmt]
    mask = jnp.int32(int(maxv))
    chans = [((dwords >> s) & mask).astype(jnp.float32) / maxv
             for s in shifts]
    return jnp.stack(chans, axis=-3)


def _pack_dwords(rgb: jnp.ndarray, fmt: str) -> jnp.ndarray:
    """(..., 3, h, w) float [0,1] -> (..., h, w) int32 packed dwords (same
    math as pipeline._pack_surface_xla)."""
    maxv, shifts, alpha = _SURFACE_BITS[fmt]
    q = lambda x: (jnp.clip(x, 0.0, 1.0) * maxv + 0.5).astype(jnp.int32)
    out = jnp.int32(alpha)
    for i, s in enumerate(shifts):
        out = out | (q(rgb[..., i, :, :]) << s)
    return out


def blend_in_rect_packed(surface: jnp.ndarray, overlay_rgb: jnp.ndarray,
                         overlay_alpha: jnp.ndarray, x: int, y: int,
                         fmt: str, premultiplied: bool = False) -> jnp.ndarray:
    """:func:`blend_in_rect` on a packed R10G10B10A2/RGBA8 dword surface —
    the reference's semantics exactly: subtitles/OSD/alpha-bitmap draw onto
    the swap-chain backbuffer *after* the dithered final pass
    (Source/DX11VideoProcessor.cpp:2741-2767), so the blend reads and
    rewrites quantized backbuffer codes.  Only the dirty rect is unpacked,
    blended in float, requantized (round-to-nearest, the ROP's UNORM write)
    and repacked; the rest of the surface is untouched — the featured
    playback path keeps the packed surface's 3x output-memory saving."""
    fh, fw = surface.shape[-2], surface.shape[-1]
    h, w = overlay_alpha.shape[-2], overlay_alpha.shape[-1]
    ox, oy = max(0, -x), max(0, -y)
    x, y = max(0, x), max(0, y)
    h = min(h - oy, fh - y)
    w = min(w - ox, fw - x)
    if h <= 0 or w <= 0:
        return surface
    ov_rgb = overlay_rgb[..., oy:oy + h, ox:ox + w]
    ov_a = overlay_alpha[..., oy:oy + h, ox:ox + w]
    region = _unpack_dwords(surface[..., y:y + h, x:x + w], fmt)
    blend = alpha_blend_premultiplied if premultiplied else alpha_blend
    blended = _pack_dwords(blend(region, ov_rgb, ov_a), fmt)
    return surface.at[..., y:y + h, x:x + w].set(blended)


def sdr_bitmap_to_pq(rgb: jnp.ndarray, osd_brightness: int = 0) -> jnp.ndarray:
    """ps_convert_bitmap_to_pq.hlsl: sRGB-encoded OSD -> PQ signal at the
    selected OSD luminance so overlays read correctly on an HDR pass-through
    output. linear = srgb^2.2 * (nits/10000) in PQ."""
    nits = OSD_NITS[max(0, min(2, osd_brightness))]
    lin = srgb_like_to_linear(rgb) * (nits / 10000.0)
    return linear_to_st2084(lin, 1.0)
