"""Image resizing — the reference's resizer shader family as matmuls.

The reference implements scaling as per-pixel gather loops in HLSL:
 - upscale ("interpolation"): Shaders/d3d11/ps_interpolation_spline4.hlsl
   (Mitchell / Catmull-Rom), ps_interpolation_lanczos2/3.hlsl
 - downscale ("convolution"): Shaders/d3d11/ps_convolution.hlsl over
   Shaders/resize/convolution_filters.hlsl (box / bilinear / hamming /
   bicubic A=-0.5 / bicubic A=-1.5 / lanczos), each compiled separately for
   X and Y (Shaders/compile_shaders.cmd)
 - one-pass 2D Jinc2 with anti-ringing:
   Shaders/examples/resizer_onepass_jinc2.hlsl
 - per-axis up-vs-down selection with the 50% threshold rule
   (ResizeShaderPass, Source/DX11VideoProcessor.cpp:3115-3199)

Because all shapes are static under jit, every output pixel's taps and
weights are known at trace time.  Each separable pass therefore becomes a
dense (in_size x out_size) weight-matrix **matmul** (gathers -> matmuls),
which XLA hands to the device's BLAS library.  Weight matrices are built
host-side in float64 and baked as constants.

Sampling-semantics notes (verified against the HLSL):
 * texel centers sit at integer+0.5; ``pos = (j+0.5)*in/out - 0.5`` is the
   source-texel-space position of output texel j (interpolation shaders).
 * the convolution shader measures tap distance as ``(n - pos + 0.5)/scale``
   with ``pos = (j+0.5)*scale + 0.5`` — i.e. from the texel *left edge* —
   and normalizes by the weight sum.
 * out-of-range taps clamp to the edge texel (D3D CLAMP addressing); the
   matrices accumulate those weights onto row 0 / in-1.
 * the reference's ps_interpolation_lanczos3.hlsl samples Q0 and Q1 from the
   same coordinate (pos-1.5) — an upstream typo that drops the outermost
   left tap.  We implement the mathematically correct 6-tap kernel and keep
   a ``reference_bug_compat`` switch for bit-parity testing.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Downscaling, Upscaling

# ---------------------------------------------------------------------------
# filter kernels (host-side, float64) — convolution_filters.hlsl
# ---------------------------------------------------------------------------


def _filter_box(x: np.ndarray) -> np.ndarray:
    return ((x >= -0.5) & (x < 0.5)).astype(np.float64)


def _filter_bilinear(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax < 1.0, 1.0 - ax, 0.0)


def _filter_hamming(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    out = np.zeros_like(ax)
    nz = (ax > 0) & (ax < 1.0)
    xpi = ax[nz] * np.pi
    out[nz] = np.sin(xpi) / xpi * (0.54 + 0.46 * np.cos(xpi))
    out[ax == 0] = 1.0
    return out


def _filter_bicubic(a: float):
    def f(x: np.ndarray) -> np.ndarray:
        ax = np.abs(x)
        out = np.zeros_like(ax)
        m1 = ax < 1.0
        m2 = (ax >= 1.0) & (ax < 2.0)
        out[m1] = ((a + 2.0) * ax[m1] - (a + 3.0)) * ax[m1] * ax[m1] + 1.0
        out[m2] = (((ax[m2] - 5) * ax[m2] + 8) * ax[m2] - 4) * a
        return out
    return f


def _sinc(x: np.ndarray) -> np.ndarray:
    out = np.ones_like(x)
    nz = x != 0
    xpi = x[nz] * np.pi
    out[nz] = np.sin(xpi) / xpi
    return out


def _filter_lanczos3(x: np.ndarray) -> np.ndarray:
    out = np.zeros_like(x)
    m = (x >= -3.0) & (x < 3.0)
    out[m] = _sinc(x[m]) * _sinc(x[m] / 3.0)
    return out


# {Downscaling: (filter_fn, filter_support)} — convolution_filters.hlsl
_DOWN_FILTERS = {
    Downscaling.BOX: (_filter_box, 0.5),
    Downscaling.BILINEAR: (_filter_bilinear, 1.0),
    Downscaling.HAMMING: (_filter_hamming, 1.0),
    Downscaling.BICUBIC: (_filter_bicubic(-0.5), 2.0),
    Downscaling.BICUBIC_SHARP: (_filter_bicubic(-1.5), 2.0),
    Downscaling.LANCZOS: (_filter_lanczos3, 3.0),
}


# ---------------------------------------------------------------------------
# weight-matrix builders
# ---------------------------------------------------------------------------


def _accumulate(mat: np.ndarray, taps: np.ndarray, w: np.ndarray, j: int) -> None:
    """Scatter tap weights into column j with edge clamp."""
    n_in = mat.shape[0]
    idx = np.clip(taps, 0, n_in - 1)
    np.add.at(mat[:, j], idx, w)


@functools.cache
def upscale_matrix(method: Upscaling, in_size: int, out_size: int,
                   reference_bug_compat: bool = False) -> np.ndarray:
    """(in_size, out_size) interpolation matrix for one axis.

    Implements the exact tap/weight math of the ps_interpolation_* shaders;
    each column sums to 1.
    """
    mat = np.zeros((in_size, out_size), dtype=np.float64)
    for j in range(out_size):
        pos = (j + 0.5) * in_size / out_size - 0.5
        t = pos - math.floor(pos)
        base = int(math.floor(pos))

        if method == Upscaling.NEAREST:
            # point sampling: texel floor((j+0.5)*in/out)
            _accumulate(mat, np.array([int((j + 0.5) * in_size / out_size)]),
                        np.array([1.0]), j)
            continue

        if method in (Upscaling.MITCHELL, Upscaling.CATMULL_ROM):
            t2, t3 = t * t, t * t * t
            if method == Upscaling.MITCHELL:
                # ps_interpolation_spline4.hlsl METHOD==0
                w = (np.array([1., 16., 1., 0.]) / 18.
                     + np.array([-.5, 0., .5, 0.]) * t
                     + np.array([5., -12., 9., -2.]) / 6. * t2
                     + np.array([-7., 21., -21., 7.]) / 18. * t3)
            else:
                # ps_interpolation_spline4.hlsl METHOD==1
                w = (np.array([-.5, 0., .5, 0.]) * t
                     + np.array([1., -2.5, 2., -.5]) * t2
                     + np.array([-.5, 1.5, -1.5, .5]) * t3)
                w[1] += 1.0
            _accumulate(mat, base + np.arange(-1, 3), w, j)
        elif method == Upscaling.LANCZOS2:
            # ps_interpolation_lanczos2.hlsl
            if t == 0.0:
                _accumulate(mat, np.array([base]), np.array([1.0]), j)
                continue
            wset = np.array([1 + t, t, 1 - t, 2 - t]) * np.pi
            w = np.sin(wset) * np.sin(wset * 0.5) / (wset * wset * 0.5)
            wc = 1.0 - w.sum()
            w[1] += wc * (1.0 - t)
            w[2] += wc * t
            _accumulate(mat, base + np.arange(-1, 3), w, j)
        elif method == Upscaling.LANCZOS3:
            # ps_interpolation_lanczos3.hlsl (corrected taps; see module doc)
            if t == 0.0:
                _accumulate(mat, np.array([base]), np.array([1.0]), j)
                continue
            wset0 = (np.array([2., 1., 0.]) + t) * np.pi
            wset1 = (np.array([1., 2., 3.]) - t) * np.pi
            w0 = np.sin(wset0) * np.sin(wset0 * .5) / (wset0 * wset0 * .5)
            w1 = np.sin(wset1) * np.sin(wset1 * .5) / (wset1 * wset1 * .5)
            wc = 1.0 - (w0.sum() + w1.sum())
            w0[2] += wc * (1.0 - t)
            w1[0] += wc * t
            if reference_bug_compat:
                taps = base + np.array([-2, -2, 0, 1, 2, 3])
            else:
                taps = base + np.arange(-2, 4)
            _accumulate(mat, taps, np.concatenate([w0, w1]), j)
        else:
            raise ValueError(f"not a separable upscale method: {method!r}")
    return mat


@functools.cache
def downscale_matrix(method: Downscaling, in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) convolution matrix for one axis
    (ps_convolution.hlsl:28-43 semantics)."""
    filt, support0 = _DOWN_FILTERS[method]
    scale = in_size / out_size
    support = support0 * scale
    ss = 1.0 / scale
    mat = np.zeros((in_size, out_size), dtype=np.float64)
    for j in range(out_size):
        # evaluation order matches the HLSL (Tex*wh + 0.5) so boundary taps of
        # discontinuous filters (box) fall on the same side
        pos = (j + 0.5) / out_size * in_size + 0.5
        low = int(math.floor(pos - support))
        high = int(math.ceil(pos + support))
        n = np.arange(low, high)
        w = filt((n - pos + 0.5) * ss)
        s = w.sum()
        if s == 0.0:
            w = np.zeros_like(w)
            w[len(w) // 2] = 1.0
        else:
            w = w / s
        _accumulate(mat, n, w, j)
    return mat


# ---------------------------------------------------------------------------
# application
# ---------------------------------------------------------------------------


# Matmul precision for the resize contractions.  At DEFAULT precision a
# float32 matmul may run in TF32 (10-bit mantissa, ~1e-3 relative error),
# which fails the >=55 dB PSNR bar; HIGHEST keeps full float32.
RESIZE_PRECISION = jax.lax.Precision.HIGHEST


def resize_axis(x: jnp.ndarray, mat: np.ndarray, axis: int,
                dtype=jnp.float32, precision=None) -> jnp.ndarray:
    """Apply a (in,out) weight matrix along ``axis`` as a matmul."""
    m = jnp.asarray(mat, dtype=dtype)
    moved = jnp.moveaxis(x, axis, -1)
    out = jnp.matmul(moved, m, preferred_element_type=jnp.float32,
                     precision=precision or RESIZE_PRECISION)
    return jnp.moveaxis(out.astype(x.dtype), -1, axis)


def select_scaler(in_size: int, out_size: int, upscaling: Upscaling,
                  downscaling: Downscaling, interpolate_at_50pct: bool):
    """Per-axis filter choice (ResizeShaderPass,
    Source/DX11VideoProcessor.cpp:3120-3139): no-op if equal; the
    *downscale* filter only when in > k*out (k=2 with the 50% rule, else 1);
    the upscale interpolation filter otherwise."""
    if in_size == out_size:
        return None
    k = 2 if interpolate_at_50pct else 1
    if in_size > k * out_size:
        return ("down", downscaling)
    return ("up", upscaling)


def jinc2_passes(in_h: int, in_w: int, out_h: int, out_w: int,
                 interpolate_at_50pct: bool):
    """Per-axis pass roles when the upscaler is Jinc2, mirroring
    ResizeShaderPass's selection (Source/DX11VideoProcessor.cpp:3120-3139):
    returns (x_role, y_role), each None (no-op), "up" (the 2D Jinc2 shader
    handles this axis) or "down" (separable convolution pass)."""
    k = 2 if interpolate_at_50pct else 1

    def role(i, o):
        if i == o:
            return None
        return "down" if i > k * o else "up"

    return role(in_w, out_w), role(in_h, out_h)


def build_axis_matrix(choice, in_size: int, out_size: int) -> np.ndarray | None:
    if choice is None:
        return None
    kind, method = choice
    if kind == "down":
        return downscale_matrix(method, in_size, out_size)
    return upscale_matrix(method, in_size, out_size)


def resize_plane(x: jnp.ndarray, out_h: int, out_w: int,
                 upscaling: Upscaling = Upscaling.CATMULL_ROM,
                 downscaling: Downscaling = Downscaling.HAMMING,
                 interpolate_at_50pct: bool = True) -> jnp.ndarray:
    """Separable two-pass resize of (..., H, W) to (..., out_h, out_w) with
    the reference's per-axis up/down selection.  X pass first, then Y —
    matching the intermediate-texture order in ResizeShaderPass."""
    h, w = x.shape[-2], x.shape[-1]
    if (h, w) == (out_h, out_w):
        return x

    if upscaling == Upscaling.JINC2:
        rx, ry = jinc2_passes(h, w, out_h, out_w, interpolate_at_50pct)
        if "up" in (rx, ry):
            # Any Jinc2-upscaled axis runs the one-pass 2D shader for its
            # pass; a mixed down axis gets its own separable convolution
            # pass, in ResizeShaderPass's X-then-Y two-pass order (the 2D
            # shader resamples the other axis at scale 1, as the reference's
            # intermediate-texture passes do).
            if rx == "up" and ry in ("up", None):
                return jinc2_resize(x, out_h, out_w)
            if rx is not None:
                x = (jinc2_resize(x, h, out_w) if rx == "up" else
                     resize_axis(x, downscale_matrix(downscaling, w, out_w),
                                 axis=-1))
            if ry is not None:
                x = (jinc2_resize(x, out_h, out_w) if ry == "up" else
                     resize_axis(x, downscale_matrix(downscaling, h, out_h),
                                 axis=-2))
            return x

    cx = select_scaler(w, out_w, upscaling, downscaling, interpolate_at_50pct)
    cy = select_scaler(h, out_h, upscaling, downscaling, interpolate_at_50pct)
    mx = build_axis_matrix(cx, w, out_w)
    my = build_axis_matrix(cy, h, out_h)
    if mx is not None:
        x = resize_axis(x, mx, axis=-1)
    if my is not None:
        x = resize_axis(x, my, axis=-2)
    return x


# ---------------------------------------------------------------------------
# diagonal-band stencils: same-size narrow-band maps as shifted FMAs
# ---------------------------------------------------------------------------


def band_diagonals(mat: np.ndarray, max_band: int = 16):
    """For a square matrix whose nonzeros hug the diagonal, return
    {offset d: weight vector w_d} with w_d[j] = mat[j+d, j]; None if the
    band exceeds ``max_band`` or the matrix isn't square.

    A map like the composed chroma-upsample x resize at net scale 1 (e.g.
    4K P010 chroma -> 1080p: 1920->1920) has band ~8; as a dense matmul
    it wastes most of its FLOPs on zeros, while as shifted multiply-adds it
    is a handful of fused elementwise ops."""
    n, m = mat.shape
    if n != m:
        return None
    nz_r, nz_c = np.nonzero(mat)
    if len(nz_r) == 0:
        return None
    d = nz_r - nz_c
    if d.max() - d.min() + 1 > max_band:
        return None
    diags = {}
    for off in range(int(d.min()), int(d.max()) + 1):
        w = np.zeros(m, mat.dtype)
        j0 = max(0, -off)
        j1 = min(m, n - off)
        idx = np.arange(j0, j1)
        w[idx] = mat[idx + off, idx]
        if np.any(w):
            diags[off] = w
    return diags


def stencil_resize_last_axis(x: jnp.ndarray, diags: dict,
                             dtype=jnp.float32) -> jnp.ndarray:
    """out[..., j] = sum_d x[..., j+d] * w_d[j] (zero beyond the edge —
    the matrix already folded clamping into its edge weights)."""
    n = x.shape[-1]
    xf = x.astype(dtype)
    out = None
    for off, w in diags.items():
        if off == 0:
            term = xf * jnp.asarray(w, dtype)
        elif off > 0:
            pad = [(0, 0)] * (x.ndim - 1) + [(0, off)]
            shifted = jnp.pad(xf[..., off:], pad)
            term = shifted * jnp.asarray(w, dtype)
        else:
            pad = [(0, 0)] * (x.ndim - 1) + [(-off, 0)]
            shifted = jnp.pad(xf[..., :off], pad)
            term = shifted * jnp.asarray(w, dtype)
        out = term if out is None else out + term
    return out


def stencil_resize_rows(x: jnp.ndarray, diags: dict,
                        dtype=jnp.float32) -> jnp.ndarray:
    """Row-axis version of :func:`stencil_resize_last_axis`."""
    n = x.shape[-2]
    xf = x.astype(dtype)
    out = None
    for off, w in diags.items():
        wv = jnp.asarray(w, dtype)[:, None]
        if off == 0:
            term = xf * wv
        elif off > 0:
            pad = [(0, 0)] * (x.ndim - 2) + [(0, off), (0, 0)]
            term = jnp.pad(xf[..., off:, :], pad) * wv
        else:
            pad = [(0, 0)] * (x.ndim - 2) + [(-off, 0), (0, 0)]
            term = jnp.pad(xf[..., :off, :], pad) * wv
        out = term if out is None else out + term
    return out


# ---------------------------------------------------------------------------
# Jinc2 (one-pass 2D, non-separable) with anti-ringing
# ---------------------------------------------------------------------------

_JINC2_WINDOW_SINC = 0.416
_JINC2_SINC = 0.985
_JINC2_AR_STRENGTH = 0.8


@functools.cache
def _jinc2_tap_data(in_size: int, out_size: int):
    """Per-output-axis base indices and fractional offsets (static)."""
    j = np.arange(out_size)
    tex = (j + 0.5) * in_size / out_size  # texel-space coordinate of center
    base = np.floor(tex - 0.5).astype(np.int64)  # tc = floor(tex-0.5)+0.5
    frac = (tex - 0.5) - base                    # pc - tc in [0,1)
    return base, frac


def _phase_period(in_size: int, out_size: int) -> tuple[int, int]:
    """(q, p): output positions repeat with period q while input steps by p
    (q = out/gcd, p = in/gcd)."""
    g = math.gcd(in_size, out_size)
    return out_size // g, in_size // g


def _jinc2_phases(x: jnp.ndarray, out_h: int, out_w: int,
                  qy: int, py: int, qx: int, px: int) -> jnp.ndarray:
    """Phase-decomposed Jinc2: for rational scales the fractional position
    cycles with period (qy, qx), so every phase pair has a *constant* 4x4
    weight stencil and its taps are static strided slices — gathers become
    shifted multiply-adds that XLA fuses (and anti-ringing likewise)."""
    h, w = x.shape[-2], x.shape[-1]
    wa = _JINC2_WINDOW_SINC * np.pi
    wb = _JINC2_SINC * np.pi
    by, fy = _jinc2_tap_data(h, out_h)
    bx, fx = _jinc2_tap_data(w, out_w)
    kh, kw = out_h // qy, out_w // qx

    pad = 4 + max(py, px)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(pad, pad), (pad, pad)],
                 mode="edge")

    def resampler(d2: float) -> float:
        if d2 == 0.0:
            return wa * wb
        d = math.sqrt(d2)
        return math.sin(d * wa) * math.sin(d * wb) / d2

    rows_out = []
    for ry in range(qy):
        cy = int(by[ry])           # base row offset for this phase (k=0)
        ty = float(fy[ry])
        cols_out = []
        for rx in range(qx):
            cx = int(bx[rx])
            tx = float(fx[rx])
            acc = None
            wsum = 0.0
            center = []
            for jo in range(4):
                for io in range(4):
                    wgt = resampler((ty - (jo - 1)) ** 2 + (tx - (io - 1)) ** 2)
                    wsum += wgt
                    r0 = pad + cy + jo - 1
                    c0 = pad + cx + io - 1
                    tap = xp[..., r0:r0 + py * kh:py, c0:c0 + px * kw:px]
                    if jo in (1, 2) and io in (1, 2):
                        center.append(tap)
                    term = tap * jnp.asarray(wgt, x.dtype)
                    acc = term if acc is None else acc + term
            out = acc / jnp.asarray(wsum, x.dtype)
            mn = jnp.minimum(jnp.minimum(center[0], center[1]),
                             jnp.minimum(center[2], center[3]))
            mx = jnp.maximum(jnp.maximum(center[0], center[1]),
                             jnp.maximum(center[2], center[3]))
            clamped = jnp.clip(out, mn, mx)
            cols_out.append(out + (clamped - out) * _JINC2_AR_STRENGTH)
        # interleave the qx column phases
        col = jnp.stack(cols_out, axis=-1).reshape(cols_out[0].shape[:-1]
                                                   + (kw * qx,))
        rows_out.append(col)
    res = jnp.stack(rows_out, axis=-1)          # (..., kh, W_out, qy)
    res = jnp.swapaxes(res, -1, -2)             # (..., kh, qy, W_out)
    return res.reshape(res.shape[:-3] + (kh * qy, kw * qx))


def jinc2_resize(x: jnp.ndarray, out_h: int, out_w: int,
                 epilogue=None) -> jnp.ndarray:
    """One-pass 2D Jinc2 resample with anti-ringing
    (Shaders/examples/resizer_onepass_jinc2.hlsl).

    Weights: ``resampler(d) = sin(d*wa)*sin(d*wb)/d^2`` over the 4x4 texel
    neighborhood (d = Euclidean distance in texel units), normalized by the
    weight sum; anti-ringing lerps toward the clamp against the center 2x2
    min/max with strength 0.8.

    Dispatch by phase period: small rational periods (both <= 8) take the
    exact phase-decomposed shifted-FMA path (:func:`_jinc2_phases`);
    every other geometry runs the low-rank separable formulation
    (:func:`_jinc2_lowrank`) as ~5 pairs of matmuls.  ``epilogue``: an
    optional elementwise tail (e.g. dither) applied to the result.
    """
    h, w = x.shape[-2], x.shape[-1]
    qy, py = _phase_period(h, out_h)
    qx, px = _phase_period(w, out_w)
    if qy <= 8 and qx <= 8:
        out = _jinc2_phases(x, out_h, out_w, qy, py, qx, px)
        return out if epilogue is None else epilogue(out)
    return _jinc2_lowrank(x, out_h, out_w, epilogue=epilogue)


# ---------------------------------------------------------------------------
# low-rank separable Jinc2: the matmul formulation
# ---------------------------------------------------------------------------
#
# The 2D Jinc2 weight field is a function of a SUM: w(y,jo,x,io) =
# g(dy^2 + dx^2) with g(s) = sin(sqrt(s)*wa)*sin(sqrt(s)*wb)/s.  Kernels of
# the form g(a+b) on a compact domain have rapidly-decaying singular values
# (g is analytic); numerically g on [0,4]^2 is rank 5 to ~8e-8 relative and
# rank 6 to ~2e-10.  Expanding g(a+b) ~= sum_k phi_k(a) psi_k(b) turns the
# non-separable 2D resample into a SUM OF ~5 SEPARABLE RESIZES, each a pair
# of weight-matrix matmuls — replacing both the 16-gather path and the
# per-phase shifted-FMA path for long phase periods.  The phase-pair
# weight normalization 1/wsum(y,x) factors the
# same way (wsum = sum_k ay_k (x) bx_k, an outer product), and the
# anti-ringing min/max over the center 2x2 taps is separable by axis.

_JINC2_RANK = 5
_JINC2_GRID_N = 1024


def _jinc2_g(d2: np.ndarray) -> np.ndarray:
    wa = _JINC2_WINDOW_SINC * np.pi
    wb = _JINC2_SINC * np.pi
    d2 = np.asarray(d2, np.float64)
    d = np.sqrt(d2)
    return np.where(d2 == 0.0, wa * wb,
                    np.sin(d * wa) * np.sin(d * wb)
                    / np.where(d2 == 0.0, 1.0, d2))


@functools.cache
def _jinc2_lr_basis():
    """SVD basis of g(a+b) over the dy^2 domain grid [0,4]:
    (grid, Vk (N,K), U/S (N,K)) such that g(a+b) ~= [g(a+grid)@Vk] @
    [(U/S)^T g(grid+b)]."""
    grid = np.linspace(0.0, 4.0, _JINC2_GRID_N)
    hm = _jinc2_g(grid[:, None] + grid[None, :])
    u, s, vt = np.linalg.svd(hm)
    k = _JINC2_RANK
    return grid, np.ascontiguousarray(vt[:k].T), np.ascontiguousarray(u[:, :k] / s[:k])


# Rational periods up to this use the exact two-sided SVD over the finite
# d2-value sets (minimal rank at the cutoff; the matrix is <= 4q x 4q, so
# q=64 is a ~256x256 SVD, microseconds and memoized).  Above it, the
# continuous-grid basis at fixed rank _JINC2_RANK applies.  64 covers the
# rotation configs' 32-phase vertical pass (rank 5 -> 4 vs the grid basis).
_JINC2_DISCRETE_Q = 64
# Rank cutoff: dropping singular values of s_k/s_0 <= t perturbs the
# NORMALIZED per-pixel weight fields by ~1e1*t max (measured 1.0e-3 at
# t=1e-4 for the 32/9+9/8 rotation geometry; weighting/ALS refits don't
# improve it — the plain SVD is already near-optimal in that metric).
# 1e-4 keeps every geometry above ~70 dB output PSNR — beyond both the
# 55 dB oracle bar and the ~59 dB floor 8-bit quantization imposes on
# random content — while letting long-period spectra shed trailing ranks:
# the rotation configs' 32/9 vertical pass goes rank 5 -> 4 (one matmul
# pair fewer; about 70 dB against the float64 oracle instead of about
# 80).  2x upscales are rank-4 EXACT and bit-unaffected.  Tighten to 3e-7
# to recover the old accuracy at the cost of the extra rank.
_JINC2_SV_CUTOFF = 1e-4


@functools.lru_cache(maxsize=8)
def jinc2_lr_matrices(in_h: int, out_h: int, in_w: int, out_w: int):
    """Per-rank banded axis matrices + normalization vectors:

      (Ay: K x (in_h, out_h), Bx: K x (in_w, out_w),
       ay (out_h, K), bx (out_w, K))

    with resample(x) ~= [sum_k Ay_k^T x Bx_k] / (ay @ bx^T).

    For small rational phase periods the dy^2/dx^2 value sets are finite,
    so a discrete two-sided SVD over exactly those values gives the MINIMAL
    rank (2x upscale is rank 4 EXACTLY — g(a+b) with 4 distinct a values);
    otherwise the continuous grid basis (rank 5 at ~8e-8) applies."""
    offs = np.arange(4) - 1

    def d2_of(in_size, out_size):
        base, frac = _jinc2_tap_data(in_size, out_size)
        return (frac[:, None] - offs[None, :]) ** 2          # (out, 4)

    d2y = d2_of(in_h, out_h)
    d2x = d2_of(in_w, out_w)
    qy, _ = _phase_period(in_h, out_h)
    qx, _ = _phase_period(in_w, out_w)

    if qy <= _JINC2_DISCRETE_Q and qx <= _JINC2_DISCRETE_Q:
        av = np.unique(d2y.round(12))
        bv = np.unique(d2x.round(12))
        hm = _jinc2_g(av[:, None] + bv[None, :])
        u, s, vt = np.linalg.svd(hm, full_matrices=False)
        k = max(int(np.sum(s > s[0] * _JINC2_SV_CUTOFF)), 1)
        # row factors at the a-values, col factors at the b-values
        fy = u[:, :k] * s[:k]                               # (na, k)
        fx = vt[:k].T                                        # (nb, k)
        ay_fac = fy[np.searchsorted(av, d2y.round(12).ravel())].reshape(
            d2y.shape + (k,))
        bx_fac = fx[np.searchsorted(bv, d2x.round(12).ravel())].reshape(
            d2x.shape + (k,))
    else:
        grid, vk, uos = _jinc2_lr_basis()
        gy = _jinc2_g(d2y[:, :, None] + grid[None, None, :])
        gx = _jinc2_g(d2x[:, :, None] + grid[None, None, :])
        ay_fac = np.einsum("otn,nk->otk", gy, vk)
        bx_fac = np.einsum("otn,nk->otk", gx, uos)

    def assemble(in_size, out_size, fac):
        base, _ = _jinc2_tap_data(in_size, out_size)
        mats = []
        for kk in range(fac.shape[-1]):
            m = np.zeros((in_size, out_size))
            for jo in range(4):
                rows = np.clip(base + jo - 1, 0, in_size - 1)
                np.add.at(m, (rows, np.arange(out_size)), fac[:, jo, kk])
            mats.append(np.ascontiguousarray(m, np.float32))
        return tuple(mats), fac.sum(axis=1)                  # sums: (out, K)

    ay_mats, ay = assemble(in_h, out_h, ay_fac)
    bx_mats, bx = assemble(in_w, out_w, bx_fac)
    return ay_mats, bx_mats, ay, bx


def _jinc2_center_minmax(x: jnp.ndarray, out_h: int, out_w: int):
    """Min/max over the center 2x2 taps (anti-ringing bound), separably:
    pairwise row min/max gathered at the base rows, then columns."""
    h, w = x.shape[-2], x.shape[-1]
    by, _ = _jinc2_tap_data(h, out_h)
    bx, _ = _jinc2_tap_data(w, out_w)
    r0 = jnp.asarray(np.clip(by, 0, h - 1))
    r1 = jnp.asarray(np.clip(by + 1, 0, h - 1))
    c0 = jnp.asarray(np.clip(bx, 0, w - 1))
    c1 = jnp.asarray(np.clip(bx + 1, 0, w - 1))
    x0 = jnp.take(x, r0, axis=-2)
    x1 = jnp.take(x, r1, axis=-2)
    mn_r = jnp.minimum(x0, x1)
    mx_r = jnp.maximum(x0, x1)
    mn = jnp.minimum(jnp.take(mn_r, c0, axis=-1), jnp.take(mn_r, c1, axis=-1))
    mx = jnp.maximum(jnp.take(mx_r, c0, axis=-1), jnp.take(mx_r, c1, axis=-1))
    return mn, mx


def _jinc2_lowrank(x: jnp.ndarray, out_h: int, out_w: int,
                   epilogue=None) -> jnp.ndarray:
    """2D Jinc2 via the low-rank separable expansion (see module note).
    ``epilogue``: optional elementwise tail (e.g. dither) applied to the
    resampled image."""
    h, w = x.shape[-2], x.shape[-1]
    ay_mats, bx_mats, ay, bx = jinc2_lr_matrices(h, out_h, w, out_w)
    apply_w = lambda t, m: resize_axis(t, m, -1)
    apply_h = lambda t, m: resize_axis(t, m, -2)

    xf = x.astype(jnp.float32)
    un = None
    for ak, bk in zip(ay_mats, bx_mats):
        t = apply_h(apply_w(xf, bk), ak)
        un = t if un is None else un + t
    wsum = jnp.matmul(jnp.asarray(ay, jnp.float32),
                      jnp.asarray(bx.T, jnp.float32),
                      precision=jax.lax.Precision.HIGHEST)
    out = un / wsum
    mn, mx = _jinc2_center_minmax(xf, out_h, out_w)
    clamped = jnp.clip(out, mn, mx)
    out = out + (clamped - out) * _JINC2_AR_STRENGTH
    if epilogue is not None:
        out = epilogue(out)
    return out.astype(x.dtype)


def _jinc2_gather(x: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """General (irrational-phase) Jinc2 via per-tap gathers."""
    h, w = x.shape[-2], x.shape[-1]
    wa = _JINC2_WINDOW_SINC * np.pi
    wb = _JINC2_SINC * np.pi

    by, fy = _jinc2_tap_data(h, out_h)
    bx, fx = _jinc2_tap_data(w, out_w)

    # Distances from the sample point to the 16 texel centers decompose into
    # small per-axis 1-D arrays; the (oh, ow) weight fields are computed on
    # device per tap (baking them as constants would put a ~0.5 GB literal
    # into the program for a 4K target).
    offs = np.arange(-1, 3)
    dy = jnp.asarray((fy[:, None] - offs[None, :]) ** 2, dtype=x.dtype)  # (oh,4)
    dx = jnp.asarray((fx[:, None] - offs[None, :]) ** 2, dtype=x.dtype)  # (ow,4)

    rows = [np.clip(by + o, 0, h - 1) for o in offs]
    cols = [np.clip(bx + o, 0, w - 1) for o in offs]

    out = None
    wsum = None
    center = []
    for jo, r in enumerate(rows):
        xr = jnp.take(x, jnp.asarray(r), axis=-2)
        for io, c in enumerate(cols):
            tap = jnp.take(xr, jnp.asarray(c), axis=-1)  # (..., oh, ow)
            if jo in (1, 2) and io in (1, 2):
                center.append(tap)
            d2 = dy[:, None, jo] + dx[None, :, io]       # (oh, ow)
            d = jnp.sqrt(d2)
            wgt = jnp.where(d2 == 0.0, wa * wb,
                            jnp.sin(d * wa) * jnp.sin(d * wb)
                            / jnp.where(d2 == 0.0, 1.0, d2))
            term = tap * wgt
            out = term if out is None else out + term
            wsum = wgt if wsum is None else wsum + wgt
    out = out / wsum

    # Anti-ringing (JINC2_AR_ENABLE): clamp toward center 2x2 min/max.
    mn = jnp.minimum(jnp.minimum(center[0], center[1]),
                     jnp.minimum(center[2], center[3]))
    mx = jnp.maximum(jnp.maximum(center[0], center[1]),
                     jnp.maximum(center[2], center[3]))
    clamped = jnp.clip(out, mn, mx)
    return out + (clamped - out) * _JINC2_AR_STRENGTH
