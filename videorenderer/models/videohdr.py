"""Learned SDR->HDR inverse tone mapping — the "RTX Video HDR" slot.

The reference exposes NVIDIA's driver-side "TrueHDR" video processor
extension (SetRTXVideoHDR, Source/D3D11VP.cpp:846-891), gated to 8-bit SDR
sources being presented on an HDR display (InitializeD3D11VP,
Source/DX11VideoProcessor.cpp selection of ``m_bVPUseRTXVideoHDR``).  That
is an opaque NN; the equivalent here is explicit: a compact conv net
that predicts a per-pixel luminance-expansion gain over a deterministic
inverse-tone-mapping base, producing BT.2020 PQ output.

The deterministic base (usable without trained weights) follows the common
inverse-Reinhard expansion: linearize sRGB, expand highlights toward the
display peak, convert 709->2020 primaries, encode PQ.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .. import csputils
from ..ops import transfer


@dataclass(frozen=True)
class VideoHDRConfig:
    """Gain net: the convs run in an ``s2d``x space-to-depth domain
    (1080p -> 270x480 grid, 48-channel input) so the matmuls are wide,
    predicting one log-gain per subpixel phase; with 3/16/1 channels at
    full resolution every conv would be a narrow product.  Receptive field grows from 7x7 to 7*s2d x 7*s2d pixels —
    the right scale for luminance-expansion context."""
    channels: int = 64
    s2d: int = 4
    peak_nits: float = 1000.0
    sdr_nits: float = 203.0       # BT.2408 reference white
    dtype: object = jnp.bfloat16


def inverse_tonemap_base_linear(rgb_srgb: jnp.ndarray, cfg: VideoHDRConfig,
                                axis: int = -3) -> jnp.ndarray:
    """Deterministic SDR->HDR expansion up to linear BT.2020 nits: sRGB ->
    linear -> inverse-Reinhard highlight expansion to ``peak_nits`` ->
    BT.2020.  (:func:`apply_fn` gains this *before* PQ encoding, skipping
    the encode+decode pair a PQ-domain base would force — 12 pows/pixel.)"""
    lin_n = transfer.srgb_like_to_linear(rgb_srgb)  # 0..1, 1 = SDR white
    # inverse Reinhard parameterized so SDR white lands on the display peak:
    # out = s*x / (1 - x*(1 - s/k)); x=1 -> k, slope ~s near black
    s, k = cfg.sdr_nits, cfg.peak_nits
    expanded = s * lin_n / jnp.maximum(1.0 - lin_n * (1.0 - s / k), s / k)
    expanded = jnp.minimum(expanded, k)
    gm = jnp.asarray(csputils.gamut_conversion_matrix(
        csputils.Primaries.BT_709, csputils.Primaries.BT_2020), expanded.dtype)
    r, g, b = (jnp.take(expanded, i, axis=axis) for i in range(3))
    x = jnp.stack([gm[i, 0] * r + gm[i, 1] * g + gm[i, 2] * b
                   for i in range(3)], axis=axis)
    return jnp.maximum(x, 0.0)


def inverse_tonemap_base(rgb_srgb: jnp.ndarray, cfg: VideoHDRConfig,
                         axis: int = -3) -> jnp.ndarray:
    """Deterministic SDR->HDR expansion: sRGB -> linear nits -> inverse-
    Reinhard highlight expansion to ``peak_nits`` -> BT.2020 -> PQ."""
    return transfer.linear_to_st2084(
        inverse_tonemap_base_linear(rgb_srgb, cfg, axis=axis), 10000.0)


def init_params(key: jax.Array, cfg: VideoHDRConfig = VideoHDRConfig()):
    """3-layer s2d-domain gain net: 3k^2 -> C -> C -> k^2 (one log-gain
    per subpixel phase, channel order (d, e)); zero-init output so the
    untrained model reduces exactly to the deterministic base."""
    def conv_init(k, cin, cout, zero=False):
        if zero:
            w = jnp.zeros((3, 3, cin, cout), jnp.float32)
        else:
            std = float(np.sqrt(2.0 / (9 * cin)))
            w = jax.random.normal(k, (3, 3, cin, cout), jnp.float32) * std
        return {"w": w.astype(cfg.dtype), "b": jnp.zeros((cout,), cfg.dtype)}

    k1, k2, k3 = jax.random.split(key, 3)
    s = cfg.s2d
    return {
        "c1": conv_init(k1, 3 * s * s, cfg.channels),
        "c2": conv_init(k2, cfg.channels, cfg.channels),
        "c3": conv_init(k3, cfg.channels, s * s, zero=True),
    }


def _conv(x, p):
    # bf16 operands/output (f32 internal accumulation); see the
    # dtype rationale in models/superres.py::_conv
    y = jax.lax.conv_general_dilated(
        x, p["w"].astype(x.dtype), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + p["b"].astype(y.dtype)


def _gain_s2d(params, h0: jnp.ndarray, row_valid=None) -> jnp.ndarray:
    """(n, hh, ww, 3k^2) s2d pixels -> (n, hh, ww, k^2) raw (pre-tanh)
    gain logits, channel order (d, e).  ``row_valid``: optional (lo, hi)
    s2d-row frame bounds — zeroes each conv's out-of-frame rows so the
    spatially sharded path reproduces whole-frame SAME-padding semantics
    (see models/superres._row_valid_mask)."""
    from .superres import _row_valid_mask
    row_mask = _row_valid_mask(h0.shape[-3], row_valid, h0.dtype)
    mk = (lambda a: a) if row_mask is None else (lambda a: a * row_mask)
    h = mk(jax.nn.relu(_conv(h0, params["c1"])))
    h = mk(jax.nn.relu(_conv(h, params["c2"])))
    return _conv(h, params["c3"])


def apply_fn(params, sdr_rgb_nhwc: jnp.ndarray,
             cfg: VideoHDRConfig = VideoHDRConfig()) -> jnp.ndarray:
    """(N,H,W,3) sRGB in [0,1] -> (N,H,W,3) PQ/BT.2020 in [0,1].

    The net predicts a per-pixel log-gain field (computed in the s2d
    domain, one output channel per subpixel phase) applied to the base
    expansion's linear light; zero-initialized output layer => identity
    to the base."""
    from .superres import _space_to_depth
    x = sdr_rgb_nhwc
    k = cfg.s2d
    n, in_h, in_w, _ = x.shape
    ph, pw = (-in_h) % k, (-in_w) % k
    xp = (jnp.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
          if ph or pw else x)
    g = _gain_s2d(params, _space_to_depth(xp.astype(cfg.dtype), k))
    # d2s the (d, e) gain channels back to per-pixel (N, H, W)
    hh, ww = g.shape[1], g.shape[2]
    g = g.reshape(n, hh, ww, k, k).transpose(0, 1, 3, 2, 4) \
        .reshape(n, hh * k, ww * k)
    if ph or pw:
        g = g[:, :in_h, :in_w]
    log_gain = jnp.tanh(g.astype(jnp.float32)) * 2.0   # gain in [e^-2, e^2]

    # gain the base's LINEAR light directly: encoding the base to PQ and
    # decoding it back (the naive composition) is 12 wasted pows/pixel
    base_lin = inverse_tonemap_base_linear(jnp.moveaxis(x, -1, -3), cfg,
                                           axis=-3)
    gained = base_lin * jnp.exp(log_gain)[:, None]
    out = transfer.linear_to_st2084(gained, 10000.0)
    return jnp.moveaxis(out, -3, -1)


def enhance_plane_chw(params, rgb_chw: jnp.ndarray,
                      cfg: VideoHDRConfig = VideoHDRConfig(),
                      row_valid=None) -> jnp.ndarray:
    """Pipeline hook: (..., 3, H, W) sRGB -> PQ/BT.2020 — CHW-native.

    Same model as :func:`apply_fn`: the s2d transform runs at source
    resolution straight from CHW, and the gain field's depth-to-space is
    a permutation GEMM against a one-hot spread matrix (the
    interleave-as-matmul trick from models/superres.py) — no NHWC
    tensor and no interleave transpose anywhere.  tanh/exp commute
    with the permutation, so numerics match apply_fn exactly up to f32
    elementwise order."""
    from .superres import _spread_matrix
    lead = rgb_chw.shape[:-3]
    x = rgb_chw.reshape((-1,) + rgb_chw.shape[-3:])
    k = cfg.s2d
    n, _, in_h, in_w = x.shape
    ph, pw = (-in_h) % k, (-in_w) % k
    xp = (jnp.pad(x, ((0, 0), (0, 0), (0, ph), (0, pw)), mode="edge")
          if ph or pw else x)
    hh, ww = xp.shape[-2] // k, xp.shape[-1] // k
    h0 = xp.astype(cfg.dtype).reshape(n, 3, hh, k, ww, k) \
        .transpose(0, 2, 4, 3, 5, 1).reshape(n, hh, ww, k * k * 3)
    g = _gain_s2d(params, h0, row_valid)            # (n, hh, ww, k*k)
    lhs = g.reshape(n, hh, ww, k, k)
    g = jax.lax.dot_general(
        lhs, jnp.asarray(_spread_matrix(ww, k), cfg.dtype),
        (((2, 4), (0, 1)), ((), ())))               # (n, hh, k, ww*k)
    g = g.reshape(n, hh * k, ww * k)
    if ph or pw:
        g = g[:, :in_h, :in_w]
    log_gain = jnp.tanh(g.astype(jnp.float32)) * 2.0
    base_lin = inverse_tonemap_base_linear(x, cfg, axis=-3)
    out = transfer.linear_to_st2084(base_lin * jnp.exp(log_gain)[:, None],
                                    10000.0)
    return out.reshape(lead + rgb_chw.shape[-3:])
