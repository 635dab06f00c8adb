"""Chroma upsampling (4:2:0 / 4:2:2 -> 4:4:4) with chroma-location siting.

Port of the reference's convert-color shader codegen chroma section
(ShaderGetPixels, Source/Shaders.cpp:82-529).  The HLSL samples a half-res
chroma texture at per-output-pixel offsets; because the scale factor is
exactly 2 (or 2x1), every output pixel falls into one of 2 (per axis) fixed
sampling *phases* with constant filter weights.  The array form is
therefore phase composition: for each axis and each parity, a small static
stencil (shifted adds with edge clamp) produces the phase plane, and the
phases are interleaved by reshape.  No gathers, fully fusable elementwise
work.

Derivation of the phase weights (texel centers at integer+0.5 in HLSL):

* Bilinear 420 (CHROMA_Bilinear, default): sample position for luma pixel x
  is ``(x+0.5)/W + chroma_offset``, mapped into the chroma texture.  For
  MPEG-2 siting (offset +0.5dx horizontally, Source/Shaders.cpp:132-136)
  the horizontal phases are (exact), (1/2,1/2); vertical phases are
  (1/4,3/4), (3/4,1/4).
* Catmull-Rom 420 (Source/Shaders.cpp:242-250): ``t = frac(Tex*wh/2) +
  chromaPos2`` takes exactly two values per axis (parity of the luma pixel),
  e.g. {0, 1/2} horizontally and {-1/4, +1/4} vertically for MPEG-2; the
  4-tap weights (code_CatmullRom_weights, Source/Shaders.cpp:66-72) are then
  constants per phase.
* 4:2:2 (packed and planar, Source/Shaders.cpp:252-264): horizontal only —
  even pixels sample the co-sited chroma texel directly; odd pixels use
  bilinear average or the CATMULLROM_05 half-phase kernel
  ``(9*(c1+c2)-(c0+c3))/16`` (Source/Shaders.cpp:144-146).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import ChromaScaling
from ..csputils import ChromaLocation


def catmullrom_weights(t: float) -> tuple[float, float, float, float]:
    """code_CatmullRom_weights (Source/Shaders.cpp:66-72) for taps at
    offsets (-1, 0, 1, 2) from the base texel."""
    t2, t3 = t * t, t * t * t
    w0 = t2 - (t3 + t) / 2
    w1 = t3 * 1.5 + 1 - t2 * 2.5
    w2 = t2 * 2 + t / 2 - t3 * 1.5
    w3 = (t3 - t2) / 2
    return (w0, w1, w2, w3)


# Per-phase 1D stencils: {phase: (offsets, weights)}
PhaseTaps = dict[int, tuple[tuple[int, ...], tuple[float, ...]]]


def _phase_taps_420(method: ChromaScaling, loc: ChromaLocation, axis: str) -> PhaseTaps:
    """Stencils for one axis of the 2x 420 upsample, per output parity."""
    if method == ChromaScaling.NEAREST:
        return {0: ((0,), (1.0,)), 1: ((0,), (1.0,))}

    # chroma-position offsets in *chroma texel* units added to the base
    # sampling position (derived from strChromaPos / strChromaPos2,
    # Source/Shaders.cpp:118-137). Base (no siting) sampling position for
    # luma pixel 2k+p is k + (2p-1)/4 relative to chroma texel k.
    # With texel centers at +0.5, luma pixel 2k+p maps to chroma position
    # k + (2p-1)/4 before siting; the shifts below are the HLSL offsets
    # converted to chroma-texel units:  MPEG-2 "+float2(dx*0.5,0)" -> +1/4
    # horizontally; co-sited also +1/4 vertically; MPEG-1 (center) none.
    # Cross-checked against strChromaPos2 in the Catmull-Rom path: e.g.
    # MPEG-2 frac values {1/4, 3/4} + (-1/4, -1/2) == {0, 1/2} horizontally
    # and {-1/4, +1/4} vertically — identical to (2p-1)/4 + shift.
    if loc == ChromaLocation.COSITED:
        shift_x, shift_y = 0.25, 0.25
    elif loc == ChromaLocation.MPEG1:
        shift_x, shift_y = 0.0, 0.0
    else:  # MPEG2 (default)
        shift_x, shift_y = 0.25, 0.0
    shift = shift_x if axis == "x" else shift_y

    taps: PhaseTaps = {}
    for phase in (0, 1):
        # fractional position t of the output sample between chroma texels
        t = (-0.25 if phase == 0 else 0.25) + shift
        if method == ChromaScaling.BILINEAR:
            if t == 0.0:
                taps[phase] = ((0,), (1.0,))
            elif t > 0:
                taps[phase] = ((0, 1), (1.0 - t, t))
            else:
                taps[phase] = ((-1, 0), (-t, 1.0 + t))
        elif method == ChromaScaling.CATMULL_ROM:
            taps[phase] = ((-1, 0, 1, 2), catmullrom_weights(t))
        else:
            raise ValueError(method)
    return taps


def _phase_taps_422(method: ChromaScaling) -> PhaseTaps:
    """Horizontal stencils for 4:2:2 (chroma co-sited with even luma)."""
    if method == ChromaScaling.NEAREST:
        return {0: ((0,), (1.0,)), 1: ((0,), (1.0,))}
    if method == ChromaScaling.BILINEAR:
        return {0: ((0,), (1.0,)), 1: ((0, 1), (0.5, 0.5))}
    if method == ChromaScaling.CATMULL_ROM:
        # CATMULLROM_05: (9*(c1+c2)-(c0+c3))/16 (Source/Shaders.cpp:144-146)
        return {0: ((0,), (1.0,)),
                1: ((-1, 0, 1, 2), (-1 / 16, 9 / 16, 9 / 16, -1 / 16))}
    raise ValueError(method)


def _shift(p: jnp.ndarray, off: int, axis: int) -> jnp.ndarray:
    """Edge-clamped shifted view: result[i] = p[clamp(i + off)] along axis."""
    if off == 0:
        return p
    n = p.shape[axis]
    if off > 0:
        pad = [(0, 0)] * p.ndim
        pad[axis] = (0, off)
        return jnp.moveaxis(jnp.moveaxis(jnp.pad(p, pad, mode="edge"), axis, 0)[off:off + n], 0, axis)
    pad = [(0, 0)] * p.ndim
    pad[axis] = (-off, 0)
    return jnp.moveaxis(jnp.moveaxis(jnp.pad(p, pad, mode="edge"), axis, 0)[:n], 0, axis)


def _apply_stencil(p: jnp.ndarray, taps: tuple[tuple[int, ...], tuple[float, ...]],
                   axis: int) -> jnp.ndarray:
    offs, ws = taps
    out = None
    for off, w in zip(offs, ws):
        term = _shift(p, off, axis) * jnp.asarray(w, dtype=p.dtype)
        out = term if out is None else out + term
    return out


def _upsample2x_axis(p: jnp.ndarray, taps: PhaseTaps, axis: int) -> jnp.ndarray:
    """2x upsample along ``axis`` by computing both parity phases and
    interleaving (out[2k + phase] = stencil_phase(p)[k])."""
    ph0 = _apply_stencil(p, taps[0], axis)
    ph1 = _apply_stencil(p, taps[1], axis)
    stacked = jnp.stack([ph0, ph1], axis=axis + 1)  # (..., n, 2, ...)
    new_shape = list(p.shape)
    new_shape[axis] *= 2
    return stacked.reshape(new_shape)


def upsample2x_matrix(n_in: int, taps: PhaseTaps) -> np.ndarray:
    """The 1D 2x upsample expressed as an (n_in, 2*n_in) weight matrix —
    used to *compose* chroma upsampling with the resize matrices so both run
    as one matmul per axis (see pipeline._make_fused_fn).  Rows are
    edge-clamped exactly like :func:`_shift`."""
    m = np.zeros((n_in, 2 * n_in), dtype=np.float64)
    for phase in (0, 1):
        offs, ws = taps[phase]
        for k in range(n_in):
            out_col = 2 * k + phase
            for off, w in zip(offs, ws):
                src = min(max(k + off, 0), n_in - 1)
                m[src, out_col] += w
    return m


def chroma_upsample_matrices(n_w: int, n_h: int, subsampling: int,
                             method: ChromaScaling, loc: ChromaLocation
                             ) -> tuple[np.ndarray | None, np.ndarray | None]:
    """(Ux, Uy) upsample matrices for a chroma plane of size (n_h, n_w);
    None where no upsampling happens on that axis."""
    if subsampling in (444, 400):
        return None, None
    if subsampling == 422:
        return upsample2x_matrix(n_w, _phase_taps_422(method)), None
    if subsampling == 420:
        ux = upsample2x_matrix(n_w, _phase_taps_420(method, loc, "x"))
        uy = upsample2x_matrix(n_h, _phase_taps_420(method, loc, "y"))
        return ux, uy
    raise ValueError(subsampling)


def blend_deinterlace_matrix(n: int) -> np.ndarray:
    """Blend deinterlace as an (n, n) row-filter matrix (for folding into
    the luma Y-axis resize): out[r] = (2*y[r] + y[r-1] + y[r+1]) / 4."""
    m = np.zeros((n, n), dtype=np.float64)
    for r in range(n):
        m[r, r] += 0.5
        m[min(max(r - 1, 0), n - 1), r] += 0.25
        m[min(max(r + 1, 0), n - 1), r] += 0.25
    return m


def upsample_chroma(c: jnp.ndarray, subsampling: int,
                    method: ChromaScaling = ChromaScaling.BILINEAR,
                    loc: ChromaLocation = ChromaLocation.MPEG2) -> jnp.ndarray:
    """Upsample a chroma plane (or stacked planes) to luma resolution.

    ``c``: float array (..., Hc, Wc); last two dims are spatial.
    Returns (..., H, W) per the subsampling mode (420: 2x2, 422: 2x in W).
    """
    if subsampling == 444 or subsampling == 400:
        return c
    if subsampling == 422:
        return _upsample2x_axis(c, _phase_taps_422(method), axis=c.ndim - 1)
    if subsampling == 420:
        cx = _upsample2x_axis(c, _phase_taps_420(method, loc, "x"), axis=c.ndim - 1)
        return _upsample2x_axis(cx, _phase_taps_420(method, loc, "y"), axis=cx.ndim - 2)
    raise ValueError(f"unsupported subsampling: {subsampling}")


def blend_deinterlace_luma(y: jnp.ndarray) -> jnp.ndarray:
    """Blend-deinterlace applied to luma during conversion
    (Source/Shaders.cpp:232-237): y' = (2*y[r] + y[r-1] + y[r+1]) / 4."""
    axis = y.ndim - 2
    up = _shift(y, -1, axis)
    down = _shift(y, 1, axis)
    return (y * 2 + up + down) * jnp.asarray(0.25, dtype=y.dtype)
