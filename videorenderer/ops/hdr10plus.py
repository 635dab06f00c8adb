"""HDR10+ (SMPTE ST 2094-40) dynamic metadata.

The reference defines the side-data struct (MediaSideDataHDR10Plus,
Include/IMediaSideData.h:67-130) but never consumes it.  Here the per-scene
statistics drive tone mapping the same way DoVi L1 does (ops/dovi_ext.py):

 * :func:`scene_peak_nits` — the scene's true peak from maxscl (or the
   99.98% distribution percentile when present), replacing the static
   mastering peak;
 * :func:`hdr_params_from_hdr10plus` — per-scene HDRParams for the local
   tone map (maxCLL ← scene peak, maxFALL ← average maxRGB);
 * :func:`runtime_hdr_from_hdr10plus` — the serving-mode rt["hdr"] scalars,
   so per-scene updates never retrace;
 * :func:`merge_hdr10` — output-side HDR10 static metadata fallbacks;
 * :func:`apply_hdr10plus_curve` — the ST 2094-40 guided tone map itself
   (knee + Nth-order Bernstein/Bezier basis curve) as a traced elementwise
   op on normalized linear luminance.

Conventions follow the struct's comment ("rational values normalized as
double"): maxscl / average_maxrgb / percentiles are linear [0, 1] fractions
of 10 000 nits; knee/bezier fields are already normalized.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from .tonemap import HDRParams


@dataclass(frozen=True)
class HDR10PlusWindow:
    """One processing window's transform parameters (window 0 = full frame;
    MediaSideDataHDR10Plus.windows[i], Include/IMediaSideData.h:78-114)."""

    maxscl: tuple[float, float, float] = (0.0, 0.0, 0.0)
    average_maxrgb: float = 0.0
    # (percentage, percentile-value) pairs, value in [0,1] of 10000 nits
    distribution_maxrgb: tuple[tuple[int, float], ...] = ()
    fraction_bright_pixels: float = 0.0
    tone_mapping_flag: int = 0
    knee_point_x: float = 0.0
    knee_point_y: float = 0.0
    bezier_curve_anchors: tuple[float, ...] = ()
    color_saturation_mapping_flag: int = 0
    color_saturation_weight: float = 1.0


@dataclass(frozen=True)
class HDR10PlusMetadata:
    """MediaSideDataHDR10Plus analogue (window list + target luminance)."""

    windows: tuple[HDR10PlusWindow, ...] = field(
        default_factory=lambda: (HDR10PlusWindow(),))
    targeted_system_display_maximum_luminance: float = 0.0


def scene_peak_nits(meta: HDR10PlusMetadata) -> float:
    """Per-scene source peak: the 99.98% maxRGB percentile when the
    distribution carries it (the conventional HDR10+ peak estimator),
    otherwise max(maxscl); 0 when the metadata is empty."""
    w = meta.windows[0] if meta.windows else HDR10PlusWindow()
    # highest percentage >= 99 (tuple order varies between encoders; a
    # (99, v) entry listed before (99.98, v') must not shadow the peak)
    best = max((e for e in w.distribution_maxrgb if e[0] >= 99),
               key=lambda e: e[0], default=None)
    if best is not None:
        return float(best[1]) * 10000.0
    return float(max(w.maxscl)) * 10000.0


def scene_average_nits(meta: HDR10PlusMetadata) -> float:
    w = meta.windows[0] if meta.windows else HDR10PlusWindow()
    return float(w.average_maxrgb) * 10000.0


def hdr_params_from_hdr10plus(meta: HDR10PlusMetadata, hdr10,
                              display_max_nits: float,
                              tonemap_type: int) -> tuple[HDRParams, int]:
    """Local-tone-map parameters with the scene statistics substituted for
    the static mastering metadata (the DoVi-L1 pattern,
    ops/dovi_ext.hdr_params_from_extensions).  When the window carries a
    guided basis curve (tone_mapping_flag=1) the operator upgrades to
    selection 7 — :func:`videorenderer.ops.tonemap.st2094_40_guided`
    consumes the knee + Bezier anchors (the L1→ST2094-10 upgrade pattern,
    ops/dovi_ext.hdr_params_from_extensions)."""
    peak = scene_peak_nits(meta)
    avg = scene_average_nits(meta)
    mn = hdr10.mastering_min_nits if hdr10 is not None else 0.005
    w0 = meta.windows[0] if meta.windows else HDR10PlusWindow()
    if w0.tone_mapping_flag and peak > 0.0:
        tonemap_type = 7
    if peak <= 0.0:
        h = hdr10
        if h is None:
            from ..pipeline import HDR10Metadata
            h = HDR10Metadata()
        return (HDRParams(mastering_min_nits=h.mastering_min_nits,
                          mastering_max_nits=h.mastering_max_nits,
                          max_cll=h.max_cll, max_fall=h.max_fall,
                          display_max_nits=float(display_max_nits)),
                tonemap_type)
    return (HDRParams(mastering_min_nits=float(mn),
                      mastering_max_nits=float(peak),
                      max_cll=float(peak),
                      max_fall=float(avg) if avg > 0 else float(peak) * 0.4,
                      display_max_nits=float(display_max_nits)),
            tonemap_type)


def merge_hdr10(hdr10, meta: HDR10PlusMetadata):
    """Output-side HDR10 static metadata with scene peak merged in
    (the analogue of the DoVi merge for the swap-chain metadata)."""
    import dataclasses
    from ..pipeline import HDR10Metadata
    peak = scene_peak_nits(meta)
    if hdr10 is None:
        hdr10 = HDR10Metadata()
    if peak <= 0.0:
        return hdr10
    return dataclasses.replace(
        hdr10, max_cll=max(hdr10.max_cll, peak),
        max_fall=max(hdr10.max_fall, scene_average_nits(meta)))


def runtime_hdr_from_hdr10plus(meta: HDR10PlusMetadata, hdr10,
                               display_max_nits: float) -> dict:
    """Serving-mode rt["hdr"] scalars per scene (no retrace)."""
    p, _ = hdr_params_from_hdr10plus(meta, hdr10, display_max_nits, 0)
    return {
        "mastering_min_nits": np.float32(p.mastering_min_nits),
        "mastering_max_nits": np.float32(p.mastering_max_nits),
        "max_cll": np.float32(p.max_cll),
        "max_fall": np.float32(p.max_fall),
        "display_max_nits": np.float32(display_max_nits),
    }


def apply_hdr10plus_curve(x: jnp.ndarray, w: HDR10PlusWindow) -> jnp.ndarray:
    """ST 2094-40 guided tone mapping on normalized linear luminance
    x in [0, 1] (source-peak relative): linear segment below the knee,
    an (N+1)-order Bernstein basis curve above it,

        y = ky + (1 - ky) * B((x - kx) / (1 - kx)),   x > kx
        y = x * ky / kx,                              x <= kx
        B(t) = sum_k C(N, k) t^k (1-t)^(N-k) * P_k,   P_0 = 0, P_N = 1,

    with the window's anchors as interior control points (static -> the
    polynomial unrolls into elementwise FMAs)."""
    if not w.tone_mapping_flag:
        return x
    kx, ky = float(w.knee_point_x), float(w.knee_point_y)
    anchors = tuple(float(a) for a in w.bezier_curve_anchors)
    n = len(anchors) + 1
    ctrl = (0.0,) + anchors + (1.0,)
    t = jnp.clip((x - kx) / max(1.0 - kx, 1e-6), 0.0, 1.0)
    omt = 1.0 - t
    # Horner-free Bernstein accumulation: sum_k C(n,k) t^k (1-t)^(n-k) P_k
    acc = None
    tk = jnp.ones_like(t)
    # powers of (1-t) descending: compute omt^(n-k) as omt_pow[k]
    for k in range(n + 1):
        coef = math.comb(n, k) * ctrl[k]
        if coef != 0.0:
            term = coef * tk * omt ** (n - k)
            acc = term if acc is None else acc + term
        tk = tk * t
    bez = acc if acc is not None else jnp.zeros_like(t)
    above = ky + (1.0 - ky) * bez
    below = x * (ky / max(kx, 1e-6)) if kx > 0 else jnp.zeros_like(x)
    return jnp.where(x <= kx, below, above)
