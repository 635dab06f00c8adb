"""Dolby Vision reshaping (poly + MMR) and the LMS color pipeline.

Reference equivalents:
 * RPU metadata model: ``MediaSideDataDOVIMetadata``
   (Include/IMediaSideData.h:146-230)
 * curve upload & fixed-point scaling: SetShaderDoviCurves(Poly)
   (Source/DX11VideoProcessor.cpp:990-1130) — coefficients are scaled by
   2^-coef_log2_denom, pivots normalized by the base-layer bit depth, and
   unused pivot slots padded with +inf
 * the generated reshape HLSL: ShaderDoviReshape(Poly)
   (Source/Shaders.cpp:531-589) and reshape_mmr (Source/Shaders.cpp:733-763)
 * the LMS->RGB post-matrix chain with PQ round-trip
   (Source/Shaders.cpp:824-859)

Array form: the per-pixel pivot binary tree + data-dependent branch becomes a
**branch-free masked evaluation**: piece index = sum of (s >= pivot_k)
comparisons; every piece's polynomial/MMR value is selected by an equality
mask.  Since the piece *type* (poly vs MMR) and MMR order are static
metadata, only the pieces that exist are evaluated — the jit trace
specializes exactly like the reference's runtime-generated HLSL.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class ReshapeCurve:
    """One component's piecewise reshape curve, already normalized (the
    analogue of PS_DOVI_CURVE after SetShaderDoviCurves scaling).

    pivots: (num_pieces - 1,) interior pivots in [0,1], ascending.
    method: per piece, 0 = polynomial, 1 = MMR.
    poly:   (num_pieces, 3) coefficients c0 + c1*s + c2*s^2.
    mmr_order/mmr_constant/mmr_coef: per-piece MMR data; mmr_coef is
    (num_pieces, 3, 7): [order-1][3 linear + 4 cross terms].
    """

    pivots: tuple[float, ...]
    method: tuple[int, ...]
    poly: np.ndarray
    mmr_order: tuple[int, ...] = ()
    mmr_constant: tuple[float, ...] = ()
    mmr_coef: np.ndarray | None = None

    @property
    def num_pieces(self) -> int:
        return len(self.method)

    @property
    def has_mmr(self) -> bool:
        return any(m == 1 for m in self.method)


@dataclass(frozen=True)
class DoviMetadata:
    """Normalized Dolby Vision mapping + color metadata
    (MediaSideDataDOVIMetadata, Include/IMediaSideData.h:146-230)."""

    curves: tuple[ReshapeCurve, ReshapeCurve, ReshapeCurve]
    ycc_to_rgb_matrix: np.ndarray    # (3,3)
    ycc_to_rgb_offset: np.ndarray    # (3,)
    rgb_to_lms_matrix: np.ndarray    # (3,3)
    # ST 2094-10 L1 (min/max/avg PQ) and L2 trims are carried separately by
    # the pipeline (tonemap.DoviTrims / HDR10Metadata).


def identity_curve() -> ReshapeCurve:
    return ReshapeCurve(pivots=(), method=(0,),
                        poly=np.array([[0.0, 1.0, 0.0]]))


# The BT.2020 LMS->RGB (Hunt-Pointer-Estevez, no crosstalk) constant used by
# the codegen (Source/Shaders.cpp:825-829).
DOVI_LMS2RGB = np.array([
    [3.06441879, -2.16597676, 0.10155818],
    [-0.65612108, 1.78554118, -0.12943749],
    [0.01736321, -0.04725154, 1.03004253],
])


def from_rpu_mapping(num_pivots, pivots, mapping_idc, poly_order, poly_coef,
                     mmr_order, mmr_constant, mmr_coef,
                     bl_bit_depth: int, coef_log2_denom: int) -> ReshapeCurve:
    """Build a normalized curve from raw RPU fixed-point fields, applying the
    same scaling as SetShaderDoviCurves (Source/DX11VideoProcessor.cpp:996-997):
    coefficients * 2^-coef_log2_denom, pivots / (2^bl_bit_depth - 1)."""
    scale = 1.0 / ((1 << bl_bit_depth) - 1)
    scale_coef = 1.0 / (1 << coef_log2_denom)
    n = int(num_pivots) - 1
    piv = tuple(float(pivots[i + 1]) * scale for i in range(n - 1))
    method = tuple(int(mapping_idc[i]) for i in range(n))
    poly = np.zeros((n, 3))
    morder, mconst = [], []
    mcoef = np.zeros((n, 3, 7))
    for i in range(n):
        if method[i] == 0:
            poly[i, 0] = scale_coef * poly_coef[i][0]
            poly[i, 1] = scale_coef * poly_coef[i][1] if poly_order[i] >= 1 else 0.0
            poly[i, 2] = scale_coef * poly_coef[i][2] if poly_order[i] >= 2 else 0.0
            morder.append(0)
            mconst.append(0.0)
        else:
            morder.append(int(mmr_order[i]))
            mconst.append(scale_coef * float(mmr_constant[i]))
            for j in range(int(mmr_order[i])):
                for k in range(7):
                    mcoef[i, j, k] = scale_coef * float(mmr_coef[i][j][k])
    return ReshapeCurve(pivots=piv, method=method, poly=poly,
                        mmr_order=tuple(morder), mmr_constant=tuple(mconst),
                        mmr_coef=mcoef)


def _comp(x: jnp.ndarray, i: int, axis: int) -> jnp.ndarray:
    """Static channel extraction by basic indexing (a slice, where
    jnp.take would lower to a gather)."""
    idx = [slice(None)] * x.ndim
    idx[axis if axis >= 0 else x.ndim + axis] = i
    return x[tuple(idx)]


def _piece_index(s: jnp.ndarray, pivots: tuple[float, ...]) -> jnp.ndarray:
    """Branch-free piece selection: idx = sum(s >= pivot_k)."""
    idx = jnp.zeros(s.shape, dtype=jnp.int32)
    for p in pivots:
        idx = idx + (s >= jnp.asarray(p, s.dtype)).astype(jnp.int32)
    return idx


def _eval_mmr(curve: ReshapeCurve, piece: int, sig: list[jnp.ndarray]) -> jnp.ndarray:
    """reshape_mmr (Source/Shaders.cpp:733-763): s = c + sum over orders j of
    dot(w_lin_j, sig^j) + dot(w_cross_j, sigX^j), sigX = (s0s1, s0s2, s1s2,
    s0s1s2)."""
    s0, s1, s2 = sig
    lin = [s0, s1, s2]
    cross = [s0 * s1, s0 * s2, s1 * s2, s0 * s1 * s2]
    acc = jnp.asarray(curve.mmr_constant[piece], s0.dtype)
    order = curve.mmr_order[piece]
    lin_j = lin
    cross_j = cross
    out = acc
    for j in range(order):
        if j > 0:
            lin_j = [a * b for a, b in zip(lin_j, lin)]
            cross_j = [a * b for a, b in zip(cross_j, cross)]
        w = curve.mmr_coef[piece, j]
        out = out + sum(float(w[k]) * lin_j[k] for k in range(3))
        out = out + sum(float(w[3 + k]) * cross_j[k] for k in range(4))
    return out


def reshape(ycc: jnp.ndarray, meta: DoviMetadata, axis: int = -3) -> jnp.ndarray:
    """Apply the per-component piecewise reshape to the (Y, Cb, Cr) signal
    (ShaderDoviReshape, Source/Shaders.cpp:554-589). ``ycc`` stacked on
    ``axis``; returns the reshaped signal clamped to [0,1]."""
    comps = [_comp(ycc, i, axis) for i in range(3)]
    sig = [jnp.clip(c, 0.0, 1.0) for c in comps]
    out = []
    for c in range(3):
        curve = meta.curves[c]
        s = sig[c]
        if curve.num_pieces == 1:
            if curve.method[0] == 0:
                c0, c1, c2 = (float(v) for v in curve.poly[0])
                val = (c2 * s + c1) * s + c0
            else:
                val = _eval_mmr(curve, 0, sig)
        else:
            idx = _piece_index(s, curve.pivots)
            val = jnp.zeros_like(s)
            for i in range(curve.num_pieces):
                if curve.method[i] == 0:
                    c0, c1, c2 = (float(v) for v in curve.poly[i])
                    piece_val = (c2 * s + c1) * s + c0
                else:
                    piece_val = _eval_mmr(curve, i, sig)
                val = jnp.where(idx == i, piece_val, val)
        out.append(jnp.clip(val, 0.0, 1.0))
    return jnp.stack(out, axis=axis)


def pack_curves(meta: DoviMetadata, like: tuple | None = None) -> dict:
    """Pack the three reshape curves into fixed-shape arrays so the reshape
    can be traced ONCE and fed per-frame/per-scene RPU updates as runtime
    tensors (no jit retrace when the curve values change — the analogue of
    the reference updating the DoVi cbuffers per sample,
    Source/DX11VideoProcessor.cpp:990-1130).

    Shapes (C=3 components, P=8 max pieces, 7 interior pivots):
      pivots (C,7) padded with +inf; poly (C,P,3); is_mmr (C,P);
      mmr_const (C,P); mmr_coef (C,P,3,7); mmr_order (C,P)

    ``like``: the serving plan's :func:`curve_structure` — the compiled
    program prunes its evaluation to that structure, so feeding it curves
    with a DIFFERENT structure would silently corrupt frames; passing
    ``like`` makes the drift raise here instead (re-plan on structural
    change, the "regenerate the shader" case).
    """
    if like is not None:
        got = curve_structure(meta)
        if got != like:
            raise ValueError(
                "DoVi curve structure changed: the serving plan was built "
                f"for {like} but this scene's metadata has {got}; rebuild "
                "the plan (values-only updates never retrace, structural "
                "changes are the shader-regeneration case)")
    C, P = 3, 8
    pivots = np.full((C, 7), np.inf, np.float32)
    poly = np.zeros((C, P, 3), np.float32)
    is_mmr = np.zeros((C, P), np.float32)
    mmr_const = np.zeros((C, P), np.float32)
    mmr_coef = np.zeros((C, P, 3, 7), np.float32)
    mmr_order = np.zeros((C, P), np.float32)
    for c, curve in enumerate(meta.curves):
        n = curve.num_pieces
        for i, p in enumerate(curve.pivots):
            pivots[c, i] = p
        poly[c, :n] = curve.poly
        # pieces beyond n: replicate the last piece so the masked select is
        # always well-defined
        poly[c, n:] = curve.poly[n - 1]
        for i in range(n):
            if curve.method[i] == 1:
                is_mmr[c, i] = 1.0
                mmr_const[c, i] = curve.mmr_constant[i]
                mmr_order[c, i] = curve.mmr_order[i]
                mmr_coef[c, i] = curve.mmr_coef[i]
    return {"pivots": pivots, "poly": poly, "is_mmr": is_mmr,
            "mmr_const": mmr_const, "mmr_coef": mmr_coef,
            "mmr_order": mmr_order}


def curve_structure(meta: DoviMetadata) -> tuple:
    """STATIC reshape structure — per channel (num_pieces, per-piece kinds,
    per-piece MMR orders) — for trace specialization of
    :func:`reshape_dynamic`.  Scene/RPU updates that change curve VALUES
    never retrace; a structural change (piece count, poly↔MMR, MMR order)
    requires a RE-PLAN — exactly when the reference would regenerate its
    reshape HLSL rather than just re-uploading the cbuffer.  Serving users
    should pack each scene with ``pack_curves(meta, like=plan_structure)``
    so a structural drift raises instead of corrupting frames."""
    for cv in meta.curves:
        if cv.has_mmr and len(cv.mmr_order) != cv.num_pieces:
            raise ValueError("malformed ReshapeCurve: mmr_order needs one "
                             "entry per piece (use from_rpu_mapping)")
    return tuple((cv.num_pieces, cv.method, cv.mmr_order)
                 for cv in meta.curves)


def _eval_mmr_rt(const, coef, order: int, sig, dtype, order_mask=None):
    """MMR with traced per-piece (const, (3,7) coef) and STATIC unrolled
    ``order`` — pure elementwise math so XLA fuses it (no (..., P)
    intermediates).  ``order_mask``: optional traced per-piece order value;
    each order-j term is gated by (order_mask > j) so a structure-free
    caller can evaluate to the maximum order with runtime masking."""
    s0, s1, s2 = sig
    lin = [s0, s1, s2]
    cross = [s0 * s1, s0 * s2, s1 * s2, s0 * s1 * s2]
    out = const.astype(dtype)
    lin_j, cross_j = lin, cross
    for j in range(order):
        if j > 0:
            lin_j = [a * b for a, b in zip(lin_j, lin)]
            cross_j = [a * b for a, b in zip(cross_j, cross)]
        w = coef[j]
        t_lin = sum(w[k] * lin_j[k] for k in range(3))
        t_cross = sum(w[3 + k] * cross_j[k] for k in range(4))
        if order_mask is not None:
            m = (order_mask > j).astype(dtype)
            t_lin = t_lin * m
            t_cross = t_cross * m
        out = out + t_lin
        out = out + t_cross
    return out


def reshape_dynamic(ycc: jnp.ndarray, curves: dict, axis: int = -3,
                    structure: tuple | None = None) -> jnp.ndarray:
    """Branch-free reshape with *runtime* curve tensors (see
    :func:`pack_curves`): piece selection by pivot comparisons, piece values
    mask-combined — all pure elementwise math that XLA fuses into one pass
    (an earlier einsum-over-pieces form materialized (..., 8) HBM
    intermediates and ran 14x slower at 4K).

    ``structure`` (from :func:`curve_structure` of the plan's metadata)
    statically prunes the evaluation to the pieces/kinds/orders that exist;
    without it every piece evaluates both a polynomial and an order-3 MMR
    with runtime masks (values-only updates still never retrace)."""
    comps = [_comp(ycc, i, axis) for i in range(3)]
    sig = [jnp.clip(c, 0.0, 1.0) for c in comps]
    dt = sig[0].dtype
    out = []
    for c in range(3):
        s = sig[c]
        piv = curves["pivots"][c]                                # (7,)
        if structure is not None:
            n_pieces, kinds, orders = structure[c]
        else:
            n_pieces, kinds, orders = 8, None, None

        def piece_val(p):
            pc = curves["poly"][c, p]
            pv_poly = (pc[2] * s + pc[1]) * s + pc[0]
            if kinds is not None:
                if kinds[p] == 0:
                    return pv_poly
                return _eval_mmr_rt(curves["mmr_const"][c, p],
                                    curves["mmr_coef"][c, p],
                                    int(orders[p]), sig, dt)
            pv_mmr = _eval_mmr_rt(curves["mmr_const"][c, p],
                                  curves["mmr_coef"][c, p], 3, sig, dt,
                                  order_mask=curves["mmr_order"][c, p])
            return jnp.where(curves["is_mmr"][c, p] > 0, pv_mmr, pv_poly)

        if n_pieces == 1:
            val = piece_val(0)
        else:
            idx = jnp.zeros(s.shape, jnp.int32)
            for k in range(n_pieces - 1):
                idx = idx + (s >= piv[k]).astype(jnp.int32)
            val = piece_val(0)
            for p in range(1, n_pieces):
                val = jnp.where(idx == p, piece_val(p), val)
        out.append(jnp.clip(val, 0.0, 1.0))
    return jnp.stack(out, axis=axis)


def build_ycc_to_rgb_cmat(meta: DoviMetadata, brightness: float = 0.0,
                          contrast: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """DoVi replaces the standard YUV->RGB matrix with the RPU's ycc_to_rgb
    matrix/offset (SetShaderConvertColorParams DoVi branch,
    Source/DX11VideoProcessor.cpp:817-836)."""
    m = meta.ycc_to_rgb_matrix * contrast
    c = np.full(3, brightness) - m @ meta.ycc_to_rgb_offset
    return m, c


def lms_pipeline_matrix(meta: DoviMetadata) -> np.ndarray:
    """mat = DOVI_LMS2RGB @ rgb_to_lms (Source/Shaders.cpp:830-837)."""
    return DOVI_LMS2RGB @ meta.rgb_to_lms_matrix


def apply_lms_matrix(rgb_pq: jnp.ndarray, meta: DoviMetadata,
                     axis: int = -3) -> jnp.ndarray:
    """PQ EOTF -> LMS-combined matrix -> PQ OETF
    (Source/Shaders.cpp:845-859), all at the 1.0 = 10000-nit PQ scale.

    Static identity fold: when the RPU's LMS matrices are mutual inverses
    (the common case for profile 8.1 streams — no LMS crosstalk), the
    combined matrix is I and EOTF -> I -> OETF is exactly the input clamp,
    so the 12-pow/pixel round trip folds away AT TRACE TIME.  The matrix
    is a static plan property (per-scene rt updates carry curves only), so
    the fold can never desync a serving program; the reference shader runs
    the round trip unconditionally (Source/Shaders.cpp:845-859) — this is
    the tracing-is-codegen win, not a semantics change (the fold is also
    MORE exact than the fp32 round trip it replaces)."""
    from .transfer import linear_to_st2084, st2084_to_linear

    mat_np = lms_pipeline_matrix(meta)
    if np.allclose(mat_np, np.eye(3), atol=1e-12):
        return jnp.maximum(rgb_pq, 0.0)
    # python-float constants: weakly typed, so the math stays in the input
    # dtype (numpy f64 scalars would promote a float32 program to float64)
    mat = [[float(v) for v in row] for row in mat_np]
    x = st2084_to_linear(jnp.maximum(rgb_pq, 0.0), 1.0)
    r, g, b = (_comp(x, i, axis) for i in range(3))
    y = jnp.stack([mat[i][0] * r + mat[i][1] * g + mat[i][2] * b
                   for i in range(3)], axis=axis)
    return linear_to_st2084(jnp.maximum(y, 0.0), 1.0)
