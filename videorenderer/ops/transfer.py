"""Electro-optical transfer functions (device-side, jnp).

Ports of the reference's HLSL include library:
 - SMPTE ST 2084 (PQ):  Shaders/convert/st2084.hlsl
 - ARIB STD-B67 (HLG):  Shaders/convert/hlg.hlsl
 - power gammas used by the convert-color codegen
   (Source/Shaders.cpp:893-922)

All functions are elementwise over arrays of linear/encoded values; XLA
fuses them into surrounding producers/consumers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# ST 2084 constants (Shaders/convert/st2084.hlsl:1-5)
ST2084_M1 = 2610.0 / (4096.0 * 4.0)
ST2084_M2 = (2523.0 / 4096.0) * 128.0
ST2084_C1 = 3424.0 / 4096.0
ST2084_C2 = (2413.0 / 4096.0) * 32.0
ST2084_C3 = (2392.0 / 4096.0) * 32.0


def pow_pos(x: jnp.ndarray, e) -> jnp.ndarray:
    """``x ** e`` for x >= 0 and positive e (static float or traced
    scalar), as ``exp2(e * log2(x))`` with a zero-base guard.

    This is the hot operation of every elementwise chain (the PQ/HLG/gamma
    pow towers).  ``jnp.power``'s generic lowering spends extra
    transcendental ops on negative-base/integer-exponent handling it
    never needs here.  pow lowers to the same exp/log pair internally;
    divergence on the PQ round trip is <= 1.3e-4 (~94 dB), far inside
    the 55 dB parity budget.
    """
    z = x <= 0.0
    r = jnp.exp2(e * jnp.log2(jnp.where(z, 1.0, x)))
    return jnp.where(z, 0.0, r)


def st2084_to_linear(x: jnp.ndarray, factor: float | jnp.ndarray) -> jnp.ndarray:
    """PQ EOTF (ST2084ToLinear, st2084.hlsl:9-16).

    ``factor`` scales the decoded [0,1] signal; the reference uses
    10000/sdr_nits ("LuminanceScale", Source/DX11VideoProcessor.cpp:893) so
    1.0 out == the SDR white level, or 10000.0 for absolute nits.
    """
    x = pow_pos(jnp.maximum(x, 0.0), 1.0 / ST2084_M2)
    # the rational term's denominator crosses zero for PQ inputs > ~1.995
    # (possible after resize overshoot on out-of-gamut signals); the HLSL
    # NaNs there (pragma 3571 in st2084.hlsl) — clamp to keep the EOTF
    # total.  Bit-identical for every input <= ~1.995.
    x = jnp.maximum(x - ST2084_C1, 0.0) / jnp.maximum(
        ST2084_C2 - ST2084_C3 * x, 1e-6)
    x = pow_pos(x, 1.0 / ST2084_M1)
    return x * factor


def linear_to_st2084(x: jnp.ndarray, divider: float | jnp.ndarray) -> jnp.ndarray:
    """PQ OETF (LinearToST2084, st2084.hlsl:18-25)."""
    # cap keeps inf out of the rational term (inf/inf = NaN) on absurd
    # overshoot inputs; no representable sane signal reaches 1e30 x divider
    x = pow_pos(jnp.minimum(jnp.maximum(x / divider, 0.0), 1e30), ST2084_M1)
    x = (ST2084_C1 + ST2084_C2 * x) / (1.0 + ST2084_C3 * x)
    return pow_pos(x, ST2084_M2)


def st2084_to_p(x: jnp.ndarray) -> jnp.ndarray:
    """PQ code -> ``p = (linear/10000) ** M1`` — the EOTF stopped one pow
    short (the "m1-power domain").  ``st2084_to_linear(x, f) ==
    pow_pos(st2084_to_p(x), 1/M1) * f``.  Compositions that re-encode to PQ
    can do their scaling in p and skip the ``^(1/M1)`` / ``^M1`` pair
    entirely (a hue-preserving scale s on linear RGB is ``p * s**M1`` in p
    — see the BT.2390 fast path in ops.tonemap)."""
    x = pow_pos(jnp.maximum(x, 0.0), 1.0 / ST2084_M2)
    # same denominator guard as st2084_to_linear
    return jnp.maximum(x - ST2084_C1, 0.0) / jnp.maximum(
        ST2084_C2 - ST2084_C3 * x, 1e-6)


def p_to_st2084(p: jnp.ndarray) -> jnp.ndarray:
    """``(linear/10000) ** M1`` -> PQ code: the OETF minus its first pow.
    ``linear_to_st2084(x, 10000.0) == p_to_st2084(pow_pos(x/10000, M1))``.
    The clip mirrors linear_to_st2084's 1e30 overshoot cap (1e30**M1 ~
    6e4) so the rational term stays finite."""
    p = jnp.clip(p, 0.0, 6.1e4)
    p = (ST2084_C1 + ST2084_C2 * p) / (1.0 + ST2084_C3 * p)
    return pow_pos(p, ST2084_M2)


# HLG constants (Shaders/convert/hlg.hlsl:1-8)
_B67_A = 0.17883277
_B67_B = 0.28466892
_B67_C = 0.55991073
_B67_INV_R2 = 4.0


def inverse_hlg(x: jnp.ndarray) -> jnp.ndarray:
    """HLG inverse OETF (inverse_HLG, hlg.hlsl:1-11): signal -> scene light
    in [0,12]."""
    lo = x * x * _B67_INV_R2
    hi = jnp.exp((x - _B67_C) / _B67_A) + _B67_B
    return jnp.where(x <= 0.5, lo, hi)


def hlg_to_linear(rgb: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """HLG signal -> display-light with the reference's OOTF
    (HLGtoLinear, hlg.hlsl:13-21): per-pixel BT.2020 luminance drives a
    system-gamma 1.2 boost at a 2000-nit nominal display.

    ``rgb`` has R,G,B stacked along ``axis``.
    """
    rgb = inverse_hlg(rgb)
    # scalar-unrolled luminance (kernel-safe: no array constants)
    w = (0.2627, 0.6780, 0.0593)
    comps = [jax.lax.index_in_dim(rgb, i, axis, keepdims=True)
             for i in range(3)]
    ys = 2000.0 * (w[0] * comps[0] + w[1] * comps[1] + w[2] * comps[2])
    return rgb * pow_pos(jnp.maximum(ys, 1e-7), 0.2)


def srgb_like_to_linear(x: jnp.ndarray, gamma: float = 2.2) -> jnp.ndarray:
    """Simple power-law decode used by the fix/convert shaders
    (e.g. ps_fix_bt2020.hlsl: ``pow(color, 2.2)``)."""
    return pow_pos(jnp.clip(x, 0.0, 1.0), gamma)


def linear_to_srgb_like(x: jnp.ndarray, gamma: float = 2.2) -> jnp.ndarray:
    """Power-law encode (``pow(color, 1/2.2)``, Source/Shaders.cpp:917-923)."""
    return pow_pos(jnp.clip(x, 0.0, 1.0), 1.0 / gamma)
