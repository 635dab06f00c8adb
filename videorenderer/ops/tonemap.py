"""HDR tone-mapping operators (device-side, jnp).

Ports of the reference's shaders:
 - Hable "convert to SDR" curve: Shaders/convert/hdr_tone_mapping.hlsl
 - the 6 selectable local tone-map operators + ICtCp + Dolby L2 trims:
   Shaders/d3d11/ps_hdr10_tonemap.hlsl

Conventions: unless stated otherwise, "linear" values are in **nits-scaled
linear light** matching each shader's expectations (the local tone-map shader
works on ``ST2084ToLinear(pq, 10000)`` absolute nits; the Hable SDR path
works on ``ST2084ToLinear(pq, 10000/sdr_nits)`` relative light).

The RGB channel stacking axis is configurable (default -1); the planar
(C, H, W) pipeline passes ``axis=0``.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp

import numpy as np

from .transfer import (ST2084_C1, ST2084_C2, ST2084_C3, ST2084_M1, ST2084_M2,
                       linear_to_st2084, p_to_st2084, pow_pos, st2084_to_linear,
                       st2084_to_p)

_BT2020_LUMA = (0.2627, 0.6780, 0.0593)

# image of the 1e-6-nits luma clamp in the m1-power domain:
# (1e-6 / 10000) ** M1
_P_EPS = float((1e-10) ** ST2084_M1)


def _pq_encode_scalar(nits: float) -> float:
    """Host-side (numpy float64) LinearToST2084 for scalar plan constants —
    keeps traced code free of jnp scalar round-trips."""
    x = (max(nits, 0.0) / 10000.0) ** ST2084_M1
    return float(((ST2084_C1 + ST2084_C2 * x) / (1.0 + ST2084_C3 * x)) ** ST2084_M2)


def _pq_decode_scalar(pq: float) -> float:
    x = max(pq, 0.0) ** (1.0 / ST2084_M2)
    x = max(x - ST2084_C1, 0.0) / (ST2084_C2 - ST2084_C3 * x)
    return float(x ** (1.0 / ST2084_M1) * 10000.0)


def _luma(rgb: jnp.ndarray, axis: int) -> jnp.ndarray:
    # scalar FMAs rather than a dot with a weight vector: XLA fuses them
    # into the surrounding elementwise chain
    r, g, b = jnp.split(rgb, 3, axis=axis)
    w0, w1, w2 = (float(w) for w in _BT2020_LUMA)
    return w0 * r + w1 * g + w2 * b


# -- Hable (the "Convert to SDR" fixed curve) --------------------------------

def _hable(x: jnp.ndarray) -> jnp.ndarray:
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


_HABLE_DIV = ((4.8 * (0.15 * 4.8 + 0.10 * 0.50) + 0.20 * 0.02)
              / (4.8 * (0.15 * 4.8 + 0.50) + 0.20 * 0.30)) - 0.02 / 0.30


def tonemap_hable_sdr(rgb: jnp.ndarray) -> jnp.ndarray:
    """ToneMappingHable (hdr_tone_mapping.hlsl:1-13): Hable curve normalized
    so input 4.8 maps to 1.0."""
    return _hable(rgb) / _HABLE_DIV


# -- the 6 local tone-map operators (ps_hdr10_tonemap.hlsl) -------------------

@dataclass(frozen=True)
class HDRParams:
    """HDRParamsConstantBuffer (ps_hdr10_tonemap.hlsl:13-22)."""

    mastering_min_nits: float = 0.0
    mastering_max_nits: float = 1000.0
    max_cll: float = 1000.0
    max_fall: float = 400.0
    display_max_nits: float = 1000.0


def aces_film(x: jnp.ndarray) -> jnp.ndarray:
    """ACESFilmTonemap (ps_hdr10_tonemap.hlsl:33-46)."""
    A, B, C, D, E = 2.51, 0.03, 2.43, 0.59, 0.14
    return (x * (A * x + B)) / (x * (C * x + D) + E)


def reinhard(x: jnp.ndarray) -> jnp.ndarray:
    """ReinhardTonemap (ps_hdr10_tonemap.hlsl:48-51)."""
    return x / (1.0 + x)


def habel(x: jnp.ndarray) -> jnp.ndarray:
    """HabelTonemap (ps_hdr10_tonemap.hlsl:53-57) — unnormalized Hable."""
    return _hable(x)


def mobius(x: jnp.ndarray, display_max_nits: float) -> jnp.ndarray:
    """MobiusTonemap (ps_hdr10_tonemap.hlsl:59-64)."""
    return x / (1.0 + x / (display_max_nits + 1e-6))


def _bt2390_pq_p(pq_rgb: jnp.ndarray, max_pq, target_pq, ks, passthrough,
                 axis: int) -> jnp.ndarray:
    """BT.2390 EETF on PQ-coded RGB in the m1-power domain — the exact math
    of decode -> :func:`bt2390` -> encode with the per-channel EOTF/OETF
    round trip collapsed: the hue-preserving linear scale s becomes
    ``p * s**M1`` where ``s**M1 = p(mapped)/p(avg)`` falls out of values
    already computed.  16 vector pows/pixel become 12 (the tone map is the
    whole transcendental tower of the HDR passthrough chain,
    Shaders/d3d11/ps_hdr10_tonemap.hlsl:66-117).  ``max_pq``/``target_pq``/
    ``ks`` are host floats or traced scalars; ``passthrough`` is a python
    or traced bool (display at least as bright as the source peak)."""
    # Static fast path: accept python AND numpy bools (a traced jax scalar is
    # neither, so tracing safety is preserved); `is True` alone would miss an
    # np.bool_ and silently run the full EETF tower.
    if isinstance(passthrough, (bool, np.bool_)) and passthrough:
        # statically bright display: no EETF at all
        return p_to_st2084(st2084_to_p(pq_rgb))
    p_ch = st2084_to_p(pq_rgb)                        # 1 pow / ch
    lin = pow_pos(p_ch, 1.0 / ST2084_M1)              # 1 pow / ch (linear/1e4)
    avg = _luma(lin, axis)
    p_avg = pow_pos(avg, ST2084_M1)                   # 1 pow
    e1 = p_to_st2084(p_avg)                           # 1 pow
    t = (e1 - ks) / jnp.maximum(1e-6, max_pq - ks)
    t2, t3 = t * t, t * t * t
    e2s = ((2 * t3 - 3 * t2 + 1) * ks + (t3 - 2 * t2 + t) * (max_pq - ks)
           + (-2 * t3 + 3 * t2) * target_pq)
    e2 = jnp.where(e1 > ks, e2s, e1)
    p_mapped = st2084_to_p(e2)                        # 1 pow
    # scale = mapped/max(avg, 1e-6 nits) in linear == this ratio in p
    s_m1 = jnp.where(avg <= 1e-10, 1.0,
                     p_mapped / jnp.maximum(p_avg, _P_EPS))
    s_m1 = jnp.where(passthrough, 1.0, s_m1)
    return p_to_st2084(p_ch * s_m1)                   # 1 pow / ch


def _st2094_10_pq_p(pq_rgb: jnp.ndarray, c1, c2, c3, passthrough,
                    axis: int) -> jnp.ndarray:
    """ST 2094-10 EETF (sel 6) in the m1-power domain: the rational spline
    yields a luma scale; applying it as ``s**M1`` in p skips the per-channel
    OETF's first pow and the EOTF's second (12 -> 10 vector pows/pixel).
    ``c1``/``c2``/``c3`` are the nits-domain spline coefficients (host
    floats or traced scalars)."""
    p_ch = st2084_to_p(pq_rgb)                        # 1 pow / ch
    lin = pow_pos(p_ch, 1.0 / ST2084_M1)              # 1 pow / ch
    xn = _luma(lin, axis) * 10000.0                   # nits
    yn = (c1 + c2 * xn) / (1.0 + c3 * xn)
    scale = jnp.where(xn > 0.0, yn / jnp.maximum(xn, 1e-9), 1.0)
    s_m1 = pow_pos(scale, ST2084_M1)                  # 1 pow
    s_m1 = jnp.where(passthrough, 1.0, s_m1)
    return p_to_st2084(p_ch * s_m1)                   # 1 pow / ch


def bt2390(rgb: jnp.ndarray, p: HDRParams, axis: int = -1) -> jnp.ndarray:
    """BT2390Tonemap (ps_hdr10_tonemap.hlsl:66-117): BT.2390 EETF Hermite
    roll-off in PQ space on the BT.2020 luma average, hue-preserving scale.
    Input/output in absolute nits."""
    safe_max_cll = p.max_cll if p.max_cll > 10.0 else (
        p.mastering_max_nits if p.mastering_max_nits > 10.0 else 1000.0)
    if p.display_max_nits >= safe_max_cll:
        return rgb

    avg = _luma(rgb, axis)
    max_cll_pq = _pq_encode_scalar(safe_max_cll)
    target_pq = _pq_encode_scalar(p.display_max_nits)
    e1 = linear_to_st2084(avg, 10000.0)

    ks = max(0.0, 1.5 * target_pq - 0.5 * max_cll_pq)
    t = (e1 - ks) / max(1e-6, max_cll_pq - ks)
    t2 = t * t
    t3 = t2 * t
    e2_spline = ((2.0 * t3 - 3.0 * t2 + 1.0) * ks
                 + (t3 - 2.0 * t2 + t) * (max_cll_pq - ks)
                 + (-2.0 * t3 + 3.0 * t2) * target_pq)
    e2 = jnp.where(e1 > ks, e2_spline, e1)
    mapped = st2084_to_linear(e2, 10000.0)
    scale = jnp.where(avg <= 1e-6, 1.0, mapped / jnp.maximum(avg, 1e-6))
    return rgb * scale


def _smoothstep(edge0: float, edge1: float, x: float) -> float:
    t = min(max((x - edge0) / (edge1 - edge0), 0.0), 1.0)
    return t * t * (3.0 - 2.0 * t)


def _st2094_10_coeffs(p: HDRParams) -> tuple[float, float, float]:
    """Host-side spline coefficients of the ST 2094-10 EETF — the CPU/
    cbuffer half of ps_hdr10_tonemap.hlsl:119-189 (knee adaptation + the
    rational through the (min, knee, max) anchors)."""
    pq1 = _pq_encode_scalar

    src_min = pq1(p.mastering_min_nits)
    src_max = pq1(p.max_cll)
    src_avg = pq1(p.max_fall)
    dst_min = pq1(0.0)
    dst_max = pq1(p.display_max_nits)

    min_knee, max_knee, def_knee, knee_adaptation = 0.1, 0.8, 0.4, 0.4

    def lerp(a, b, t):
        return a + (b - a) * t

    src_knee_min = lerp(src_min, src_max, min_knee)
    src_knee_max = lerp(src_min, src_max, max_knee)
    dst_knee_min = lerp(dst_min, dst_max, min_knee)
    dst_knee_max = lerp(dst_min, dst_max, max_knee)

    src_knee = src_avg if p.max_fall > 0.0 else lerp(src_min, src_max, def_knee)
    src_knee = min(max(src_knee, src_knee_min), src_knee_max)

    target = (src_knee - src_min) / (src_max - src_min)
    adapted = lerp(dst_min, dst_max, target)
    tuning = 1.0 - _smoothstep(max_knee, def_knee, target) * _smoothstep(min_knee, def_knee, target)
    adaptation = lerp(knee_adaptation, 1.0, tuning)
    dst_knee = lerp(src_knee, adapted, adaptation)
    dst_knee = min(max(dst_knee, dst_knee_min), dst_knee_max)

    x1, x2, x3 = p.mastering_min_nits, _pq_decode_scalar(src_knee), p.max_cll
    y1, y2, y3 = 0.0, _pq_decode_scalar(dst_knee), p.display_max_nits

    m00 = x2 * x3 * (y2 - y3)
    m01 = x1 * x3 * (y3 - y1)
    m02 = x1 * x2 * (y1 - y2)
    m10 = x3 * y3 - x2 * y2
    m11 = x1 * y1 - x3 * y3
    m12 = x2 * y2 - x1 * y1
    m20 = x3 - x2
    m21 = x1 - x3
    m22 = x2 - x1
    coef0 = m00 * y1 + m01 * y2 + m02 * y3
    coef1 = m10 * y1 + m11 * y2 + m12 * y3
    coef2 = m20 * y1 + m21 * y2 + m22 * y3
    k = 1.0 / (x3 * y3 * (x1 - x2) + x2 * y2 * (x3 - x1) + x1 * y1 * (x2 - x3))
    return k * coef0, k * coef1, k * coef2


def st2094_10(rgb: jnp.ndarray, p: HDRParams, axis: int = -1) -> jnp.ndarray:
    """ST209410Tonemap (ps_hdr10_tonemap.hlsl:119-189): ST 2094-10 EETF via a
    rational spline through (min, knee, max) anchor points."""
    if p.display_max_nits >= p.max_cll:
        return rgb

    c1, c2, c3 = _st2094_10_coeffs(p)

    x_nits = _luma(rgb, axis)
    y_nits = (c1 + c2 * x_nits) / (1.0 + c3 * x_nits)
    scale = jnp.where(x_nits > 0.0, y_nits / jnp.maximum(x_nits, 1e-9), 1.0)
    return rgb * scale


# -- ICtCp + Dolby Vision L2 trims -------------------------------------------

def rgb_to_ictcp(rgb_nits: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """RGB_to_ICTCP (ps_hdr10_tonemap.hlsl:191-208): BT.2020 RGB nits ->
    ICtCp via the LMS/4096 integer matrices."""
    r, g, b = jnp.split(rgb_nits, 3, axis=axis)
    l = (1688.0 * r + 2146.0 * g + 262.0 * b) / 4096.0
    m = (683.0 * r + 2951.0 * g + 462.0 * b) / 4096.0
    s = (99.0 * r + 309.0 * g + 3688.0 * b) / 4096.0
    l = linear_to_st2084(l, 10000.0)
    m = linear_to_st2084(m, 10000.0)
    s = linear_to_st2084(s, 10000.0)
    i = (2048.0 * l + 2048.0 * m) / 4096.0
    ct = (6610.0 * l - 13613.0 * m + 7003.0 * s) / 4096.0
    cp = (17933.0 * l - 17390.0 * m - 543.0 * s) / 4096.0
    return jnp.concatenate([i, ct, cp], axis=axis)


def ictcp_to_rgb(ictcp: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """ICTCP_to_RGB (ps_hdr10_tonemap.hlsl:210-229)."""
    i, ct, cp = jnp.split(ictcp, 3, axis=axis)
    l = i + 0.00860904 * ct + 0.11102963 * cp
    m = i - 0.00860904 * ct - 0.11102963 * cp
    s = i + 0.56003134 * ct - 0.32062717 * cp
    l = st2084_to_linear(l, 10000.0)
    m = st2084_to_linear(m, 10000.0)
    s = st2084_to_linear(s, 10000.0)
    r = 3.43660669 * l - 2.50645212 * m + 0.06984542 * s
    g = -0.79132956 * l + 1.98360045 * m - 0.19227090 * s
    b = -0.02594990 * l - 0.09891371 * m + 1.12486361 * s
    return jnp.concatenate([r, g, b], axis=axis)


@dataclass(frozen=True)
class DoviTrims:
    """DolbyConstants cbuffer (ps_hdr10_tonemap.hlsl:24-33)."""

    chroma_weight: float = 0.0
    saturation_gain: float = 1.0
    trim_slope: float = 1.0
    trim_offset: float = 0.0
    trim_power: float = 1.0
    l2_enabled: bool = False


def apply_l2_trim(rgb_nits: jnp.ndarray, t: DoviTrims, axis: int = -1) -> jnp.ndarray:
    """ApplyL2Trim (ps_hdr10_tonemap.hlsl:231-248): intensity trim in ICtCp
    with highlight-weighted saturation."""
    ictcp = rgb_to_ictcp(rgb_nits, axis=axis)
    i, ct, cp = jnp.split(ictcp, 3, axis=axis)
    orig_i = i
    i = jnp.maximum(i * t.trim_slope + t.trim_offset, 0.0)
    i = jnp.power(i, jnp.maximum(t.trim_power, 0.1))
    sat = jnp.maximum(t.saturation_gain, 0.0)
    hw = jnp.clip(orig_i * 2.0, 0.0, 1.0)
    eff = sat + (1.0 - sat) * hw * (1.0 - t.chroma_weight)
    ct = ct * eff
    cp = cp * eff
    return ictcp_to_rgb(jnp.concatenate([i, ct, cp], axis=axis), axis=axis)


def dolby_vision_trims(linear: jnp.ndarray, t: DoviTrims, axis: int = -1,
                       pq_input: bool = False) -> jnp.ndarray:
    """DolbyVisionTrims (ps_hdr10_tonemap.hlsl:250-263): slope/offset/power in
    PQ plus chroma-weighted saturation; in/out linear (10000-nit scale) unless
    ``pq_input`` (the convert-color codegen variant, Source/Shaders.cpp:788-796,
    operates directly on PQ-encoded values)."""
    color = linear if pq_input else linear_to_st2084(linear, 10000.0)
    color = jnp.power(jnp.maximum(color * t.trim_slope + t.trim_offset, 0.0),
                      t.trim_power)
    y = _luma(color, axis)
    color = color * jnp.power(
        jnp.maximum((1.0 + t.chroma_weight) * color / jnp.maximum(y, 1e-9), 0.0),
        t.saturation_gain)
    return color if pq_input else st2084_to_linear(color, 10000.0)


def _st2094_10_coeffs_rt(mmin, mcll, mfall, disp):
    """Traced-scalar twin of :func:`_st2094_10_coeffs` (serving mode: the
    metadata arrives as traced scalars, so knee adaptation must trace)."""
    def enc(v):
        return linear_to_st2084(v, 10000.0)

    def dec(v):
        return st2084_to_linear(v, 10000.0)

    def sstep(e0, e1v, x):
        t = jnp.clip((x - e0) / (e1v - e0), 0.0, 1.0)
        return t * t * (3.0 - 2.0 * t)

    def lerp(a, b, t):
        return a + (b - a) * t

    src_min, src_max = enc(mmin), enc(mcll)
    src_avg = enc(mfall)
    dst_min, dst_max = enc(jnp.zeros_like(disp)), enc(disp)
    mk, xk, dk, ka = 0.1, 0.8, 0.4, 0.4
    skn, skx = lerp(src_min, src_max, mk), lerp(src_min, src_max, xk)
    dkn, dkx = lerp(dst_min, dst_max, mk), lerp(dst_min, dst_max, xk)
    src_knee = jnp.where(mfall > 0.0, src_avg, lerp(src_min, src_max, dk))
    src_knee = jnp.clip(src_knee, skn, skx)
    target = (src_knee - src_min) / (src_max - src_min)
    adapted = lerp(dst_min, dst_max, target)
    tuning = 1.0 - sstep(xk, dk, target) * sstep(mk, dk, target)
    adaptation = lerp(ka, 1.0, tuning)
    dst_knee = jnp.clip(lerp(src_knee, adapted, adaptation), dkn, dkx)
    x1, x2, x3 = mmin, dec(src_knee), mcll
    y1, y2, y3 = jnp.zeros_like(disp), dec(dst_knee), disp
    m00 = x2 * x3 * (y2 - y3)
    m01 = x1 * x3 * (y3 - y1)
    m02 = x1 * x2 * (y1 - y2)
    m10 = x3 * y3 - x2 * y2
    m11 = x1 * y1 - x3 * y3
    m12 = x2 * y2 - x1 * y1
    m20, m21, m22 = x3 - x2, x1 - x3, x2 - x1
    k = 1.0 / (x3 * y3 * (x1 - x2) + x2 * y2 * (x3 - x1)
               + x1 * y1 * (x2 - x3))
    c1 = k * (m00 * y1 + m01 * y2 + m02 * y3)
    c2 = k * (m10 * y1 + m11 * y2 + m12 * y3)
    c3 = k * (m20 * y1 + m21 * y2 + m22 * y3)
    return c1, c2, c3


def local_tonemap_pq_rt(pq_rgb: jnp.ndarray, selection: int, p: dict,
                        trims: DoviTrims | None = None,
                        axis: int = -1, window=None) -> jnp.ndarray:
    """Runtime-parameter variant of :func:`local_tonemap_pq`: the HDR10
    luminance metadata arrives as traced scalars (keys mastering_min_nits /
    mastering_max_nits / max_cll / max_fall / display_max_nits), so per-title
    or per-scene metadata changes never retrace.  All Python branches of the
    static version become jnp.where masks; the operator ``selection`` stays
    static (different math).
    """
    def enc(v):
        return linear_to_st2084(v, 10000.0)

    def dec(v):
        return st2084_to_linear(v, 10000.0)

    mmin = jnp.asarray(p["mastering_min_nits"], pq_rgb.dtype)
    mmax = jnp.asarray(p["mastering_max_nits"], pq_rgb.dtype)
    mcll = jnp.asarray(p["max_cll"], pq_rgb.dtype)
    mfall = jnp.asarray(p["max_fall"], pq_rgb.dtype)
    disp = jnp.asarray(p["display_max_nits"], pq_rgb.dtype)

    l2 = trims is not None and trims.l2_enabled
    if selection == 5 and not l2:   # BT.2390, m1-power-domain fast path
        safe = jnp.where(mcll > 10.0, mcll,
                         jnp.where(mmax > 10.0, mmax, 1000.0))
        max_pq = enc(safe)
        target_pq = enc(disp)
        ks = jnp.maximum(0.0, 1.5 * target_pq - 0.5 * max_pq)
        return _bt2390_pq_p(pq_rgb, max_pq, target_pq, ks, disp >= safe, axis)
    if selection == 6 and not l2:   # ST 2094-10, m1-power-domain fast path
        c1, c2, c3 = _st2094_10_coeffs_rt(mmin, mcll, mfall, disp)
        return _st2094_10_pq_p(pq_rgb, c1, c2, c3, disp >= mcll, axis)

    color = dec(pq_rgb)
    if l2:
        color = dolby_vision_trims(color, trims, axis=axis)

    if selection == 7:  # ST 2094-40 guided (max_cll carries the scene peak)
        color = st2094_40_guided(color, disp, mcll, window, axis=axis)
        return enc(color)

    if selection == 5:  # BT.2390
        safe = jnp.where(mcll > 10.0, mcll, jnp.where(mmax > 10.0, mmax, 1000.0))
        avg = _luma(color, axis)
        max_pq = enc(safe)
        target_pq = enc(disp)
        ks = jnp.maximum(0.0, 1.5 * target_pq - 0.5 * max_pq)
        e1 = enc(avg)
        t = (e1 - ks) / jnp.maximum(1e-6, max_pq - ks)
        t2, t3 = t * t, t * t * t
        e2s = ((2 * t3 - 3 * t2 + 1) * ks + (t3 - 2 * t2 + t) * (max_pq - ks)
               + (-2 * t3 + 3 * t2) * target_pq)
        e2 = jnp.where(e1 > ks, e2s, e1)
        mapped = dec(e2)
        scale = jnp.where(avg <= 1e-6, 1.0, mapped / jnp.maximum(avg, 1e-6))
        mapped_rgb = color * scale
        out = jnp.where(disp >= safe, color, mapped_rgb)
        return enc(out)

    if selection == 6:  # ST 2094-10 (L2-trims path; else the fast branch ran)
        c1, c2, c3 = _st2094_10_coeffs_rt(mmin, mcll, mfall, disp)
        xn = _luma(color, axis)
        yn = (c1 + c2 * xn) / (1.0 + c3 * xn)
        scale = jnp.where(xn > 0.0, yn / jnp.maximum(xn, 1e-9), 1.0)
        out = jnp.where(disp >= mcll, color, color * scale)
        return enc(out)

    base = jnp.maximum(disp, mmax)
    eff = jnp.minimum(base, mcll)
    fall_adj = jnp.minimum(base / jnp.maximum(mfall, 1e-6), 1.0)
    c = jnp.clip(color / eff, 0.0, 1.0) * fall_adj
    if selection == 2:
        c = reinhard(c)
    elif selection == 3:
        c = habel(c)
    elif selection == 4:
        c = c / (1.0 + c / (disp + 1e-6))
    else:
        c = aces_film(c)
    return linear_to_st2084(c * disp, 10000.0)


def st2094_40_guided(color: jnp.ndarray, disp, peak, window,
                     axis: int = -1) -> jnp.ndarray:
    """ST 2094-40 (HDR10+) guided tone map — selection 7: scene luminance
    normalized to the scene peak runs through the metadata's knee + Bezier
    basis curve (:func:`videorenderer.ops.hdr10plus.apply_hdr10plus_curve`),
    rescaled to the display peak, ratio-preserving on RGB.  The curve's
    knee/anchors are STATIC (plan metadata, like the reshape structure);
    ``disp``/``peak`` may be traced scalars (serving mode).  Linear in/out,
    nits domain."""
    from .hdr10plus import apply_hdr10plus_curve
    kx = float(window.knee_point_x)
    ky = float(window.knee_point_y)
    xn = _luma(color, axis) / peak
    yn = apply_hdr10plus_curve(jnp.clip(xn, 0.0, 1.0), window)
    # below the knee the curve is exactly linear (slope ky/kx), so the
    # scale is constant there — avoids the 0/0 at black
    slope0 = (ky / kx) if kx > 1e-6 else 1.0
    scale = jnp.where(xn <= max(kx, 1e-6), slope0 * disp / peak,
                      yn * disp / jnp.maximum(xn * peak, 1e-9))
    return jnp.where(disp >= peak, color, color * scale)


def local_tonemap_pq(pq_rgba: jnp.ndarray, selection: int, p: HDRParams,
                     trims: DoviTrims | None = None, axis: int = -1,
                     window=None) -> jnp.ndarray:
    """Full ps_hdr10_tonemap main() (ps_hdr10_tonemap.hlsl:265-331):
    PQ in -> PQ out, operator chosen by ``selection`` (ToneMapType).
    Channel axis must hold exactly R,G,B.  ``selection == 7``: the HDR10+
    guided curve (``window`` = the plan's HDR10PlusWindow)."""
    l2 = trims is not None and trims.l2_enabled
    if selection == 5 and not l2:   # BT.2390, m1-power-domain fast path
        safe = p.max_cll if p.max_cll > 10.0 else (
            p.mastering_max_nits if p.mastering_max_nits > 10.0 else 1000.0)
        max_pq = _pq_encode_scalar(safe)
        target_pq = _pq_encode_scalar(p.display_max_nits)
        ks = max(0.0, 1.5 * target_pq - 0.5 * max_pq)
        return _bt2390_pq_p(pq_rgba, max_pq, target_pq, ks,
                            p.display_max_nits >= safe, axis)
    if selection == 6 and not l2:   # ST 2094-10, m1-power-domain fast path
        if p.display_max_nits >= p.max_cll:
            return p_to_st2084(st2084_to_p(pq_rgba))
        c1, c2, c3 = _st2094_10_coeffs(p)
        return _st2094_10_pq_p(pq_rgba, c1, c2, c3, False, axis)

    color = st2084_to_linear(pq_rgba, 10000.0)
    if l2:
        color = dolby_vision_trims(color, trims, axis=axis)

    if selection == 7:
        color = st2094_40_guided(color, float(p.display_max_nits),
                                 float(p.max_cll), window, axis=axis)
        return linear_to_st2084(color, 10000.0)
    if selection == 5:
        color = bt2390(color, p, axis=axis)
        return linear_to_st2084(color, 10000.0)
    if selection == 6:
        color = st2094_10(color, p, axis=axis)
        return linear_to_st2084(color, 10000.0)

    base_lum = max(p.display_max_nits, p.mastering_max_nits)
    effective_max = min(base_lum, p.max_cll)
    fall_adj = min(base_lum / p.max_fall, 1.0) if p.max_fall else 1.0

    color = jnp.clip(color / effective_max, 0.0, 1.0) * fall_adj
    if selection == 2:
        color = reinhard(color)
    elif selection == 3:
        color = habel(color)
    elif selection == 4:
        color = mobius(color, p.display_max_nits)
    else:  # 1 and fallback
        color = aces_film(color)
    color = color * p.display_max_nits
    return linear_to_st2084(color, 10000.0)
