"""Learned super-resolution — the "SuperRes" slot of the fixed-function VP.

The reference enables vendor super-resolution blocks (NVIDIA SuperRes GUID /
Intel VPE, Source/D3D11VP.cpp:712-844) gated by source size per the
``SUPERRES_*`` setting.  Those are opaque driver NNs; the equivalent here
is an explicit model: an ESPCN-style residual conv net with pixel-shuffle
upsampling, run in bfloat16.

Pure-functional JAX (init/apply/train_step); parameters are a pytree, so the
model composes with jax.sharding for data-parallel training and with the
frame pipeline as a post-resize enhancement hook (the reference applies
SuperRes *instead of* VP scaling; here the model consumes the bicubic
2x-upscaled frame and predicts a residual detail layer, which is the robust
formulation for arbitrary content).

Size gating mirrors SetSuperRes (Source/D3D11VP.cpp:804-844): a level only
engages when the source is at most the level's resolution class and the
target is larger.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass


import jax
import jax.numpy as jnp
import numpy as np

from ..config import SuperResolution

# max source size per gating level (Source/D3D11VP.cpp:806-836 classes)
_GATE_LIMITS = {
    SuperResolution.SD: (1024, 576),
    SuperResolution.P720: (1280, 720),
    SuperResolution.P1080: (1920, 1080),
    SuperResolution.P1440: (2560, 1440),
}


def superres_engages(level: SuperResolution, src_w: int, src_h: int,
                     dst_w: int, dst_h: int) -> bool:
    """Size gate: level covers the source size AND we are upscaling."""
    if level == SuperResolution.DISABLE:
        return False
    lw, lh = _GATE_LIMITS[level]
    return src_w <= lw and src_h <= lh and (dst_w > src_w or dst_h > src_h)


@dataclass(frozen=True)
class SuperResConfig:
    """Defaults: the conv stack runs in a ``s2d``× space-to-depth domain
    (1080p -> 270x480 grid) so the per-pixel matmuls have 128-wide channel
    dims instead of the naive ESPCN shape's 32 at full resolution — the
    same per-pixel FLOP budget in fewer, wider products.  Whether this
    layout beats plain NHWC convolutions on the GPU is not measured."""
    channels: int = 128
    num_blocks: int = 4
    scale: int = 2           # output upscale factor
    s2d: int = 4             # space-to-depth factor for the conv domain
    dtype: object = jnp.bfloat16


def _conv(x, w, b):
    # all-bf16 operands/output: the convolution accumulates in f32
    # internally and rounds once at the output, and uniform dtypes keep
    # the conv VJP legal (preferred_element_type=f32
    # would hand the transpose an f32 cotangent against bf16 weights)
    y = jax.lax.conv_general_dilated(
        x, w.astype(x.dtype),
        window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + b.astype(y.dtype)


def init_params(key: jax.Array, cfg: SuperResConfig = SuperResConfig()):
    """He-init conv stack: head, residual body, pixel-shuffle tail."""
    def conv_init(k, kh, kw, cin, cout):
        std = float(np.sqrt(2.0 / (kh * kw * cin)))
        w = jax.random.normal(k, (kh, kw, cin, cout), dtype=jnp.float32) * std
        return {"w": w.astype(cfg.dtype), "b": jnp.zeros((cout,), cfg.dtype)}

    k = cfg.s2d
    keys = jax.random.split(key, cfg.num_blocks * 2 + 3)
    params = {
        "head": conv_init(keys[0], 3, 3, 3 * k * k, cfg.channels),
        "body": [
            {"c1": conv_init(keys[1 + 2 * i], 3, 3, cfg.channels, cfg.channels),
             "c2": conv_init(keys[2 + 2 * i], 3, 3, cfg.channels, cfg.channels)}
            for i in range(cfg.num_blocks)
        ],
        # zero-init tail: the residual starts at exactly zero, so an
        # untrained net IS the nearest-upsample baseline (standard
        # residual-branch init; large He-init tails start ~3 Charbonnier
        # units away and waste the first epochs un-learning noise)
        "tail": {"w": jnp.zeros((3, 3, cfg.channels,
                                 3 * (cfg.scale * k) ** 2), cfg.dtype),
                 "b": jnp.zeros((3 * (cfg.scale * k) ** 2,), cfg.dtype)},
    }
    return params


def _space_to_depth(x: jnp.ndarray, k: int) -> jnp.ndarray:
    """(N, H, W, C) -> (N, H/k, W/k, C*k*k); channel order (di, dj, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // k, k, w // k, k, c)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(n, h // k, w // k, k * k * c)


def _depth_to_space(x: jnp.ndarray, k: int, c_out: int) -> jnp.ndarray:
    """(N, H, W, k*k*c_out) -> (N, H*k, W*k, c_out); inverse channel order."""
    n, h, w, _ = x.shape
    x = x.reshape(n, h, w, k, k, c_out)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(n, h * k, w * k, c_out)


def _row_valid_mask(hh: int, row_valid, dtype):
    """(hh, 1, 1) 0/1 mask of s2d-domain rows inside ``row_valid=(lo, hi)``
    (local coordinates; lo/hi may be traced).  Used by the spatially
    sharded path (parallel/spatial.make_spatial_learned_fn): zeroing every
    conv's out-of-frame output rows reproduces SAME zero-padding semantics
    at the GLOBAL frame edges layer-by-layer — without it, out-of-frame
    halo rows accumulate relu(bias) activations that whole-frame SAME
    padding never sees, and edge shards drift from the single-chip
    result."""
    if row_valid is None:
        return None
    lo, hi = row_valid
    r = jnp.arange(hh)
    return ((r >= lo) & (r < hi)).astype(dtype)[:, None, None]


def _trunk(params, h: jnp.ndarray, row_mask=None) -> jnp.ndarray:
    """Head + residual body + tail on s2d-domain features (NHWC).
    ``row_mask``: optional (hh, 1, 1) validity mask applied after every
    conv (see :func:`_row_valid_mask`)."""
    mk = (lambda a: a) if row_mask is None else (lambda a: a * row_mask)
    h = mk(jax.nn.relu(_conv(h, params["head"]["w"], params["head"]["b"])))
    for blk in params["body"]:
        r = mk(jax.nn.relu(_conv(h, blk["c1"]["w"], blk["c1"]["b"])))
        r = mk(_conv(r, blk["c2"]["w"], blk["c2"]["b"]))
        h = h + r
    return _conv(h, params["tail"]["w"], params["tail"]["b"])


def apply_fn(params, lr_rgb: jnp.ndarray, cfg: SuperResConfig = SuperResConfig()):
    """lr_rgb: (N, H, W, 3) in [0,1] -> (N, H*scale, W*scale, 3).

    Predicts a residual over nearest-upsampled input (stable identity init
    behavior).  With ``cfg.s2d > 1`` the conv stack runs in the
    space-to-depth domain — (H/k, W/k) grid, channels*k*k-wide matmuls —
    and the tail pixel-shuffles by ``scale*k`` straight back to output
    resolution (one domain change in, one out; no per-conv shuffles).
    """
    x = lr_rgb.astype(cfg.dtype)
    k, s = cfg.s2d, cfg.scale
    n, in_h, in_w, _ = x.shape
    ph, pw = (-in_h) % k, (-in_w) % k
    if ph or pw:                       # pad to the s2d grid, crop at the end
        x = jnp.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)), mode="edge")
    h = _space_to_depth(x, k) if k > 1 else x
    res = _trunk(params, h)
    res = _depth_to_space(res, s * k, 3)
    base = jnp.repeat(jnp.repeat(x, s, axis=1), s, axis=2)
    out = (base + res).astype(jnp.float32)
    if ph or pw:
        out = out[:, :in_h * s, :in_w * s, :]
    return out


@functools.lru_cache(maxsize=None)
def _tail_reorder(cfg: SuperResConfig):
    """Host-side constants for the CHW tail (cached per config).

    Returns ``(perm, base_taps)``: ``perm`` permutes the standard tail
    channel order ch=(d*K+e)*3+c into (d*3+c)*K+e (e minor, so the lane
    interleave becomes one GEMM, see :func:`apply_fn_chw`); ``base_taps``
    (3, 3, 3k^2, 3KK) rides the tail conv as extra input taps on the
    head-input channels, reproducing the nearest-upsampled base exactly
    (weight 1.0 at the 1x1 center, per subpixel phase)."""
    k, s = cfg.s2d, cfg.scale
    K = s * k
    perm = np.empty(3 * K * K, np.int64)
    taps = np.zeros((3, 3, 3 * k * k, 3 * K * K), np.float32)
    for d in range(K):
        for e in range(K):
            for c in range(3):
                new = (d * 3 + c) * K + e
                perm[new] = (d * K + e) * 3 + c
                taps[1, 1, ((d // s) * k + (e // s)) * 3 + c, new] = 1.0
    return perm, taps


@functools.lru_cache(maxsize=8)
def _spread_matrix(ww: int, K: int) -> np.ndarray:
    """(ww, K, ww*K) one-hot: M[xi, e, K*xi + e] = 1 — the lane-interleave
    as a permutation GEMM instead of an XLA transpose."""
    M = np.zeros((ww, K, ww * K), np.float32)
    xi = np.arange(ww)[:, None]
    e = np.arange(K)[None, :]
    M[xi, e, xi * K + e] = 1.0
    return M


def apply_fn_chw(params, rgb_chw: jnp.ndarray,
                 cfg: SuperResConfig = SuperResConfig(), row_valid=None):
    """(N, 3, H, W) in [0,1] -> (N, 3, H*scale, W*scale) — the SAME model
    as :func:`apply_fn` staying channels-first at both 4K ends, with the
    depth-to-space interleave done by a matmul.

    Why: a 4K NHWC f32 tensor has C=3 minor, and the explicit d2s/repeat
    interleaves are pure data movement at full output size.  Here:

     * tail channels are permuted to (d, c, e) so splitting e off the
       lane dim is free;
     * the nearest base + bias fold into the tail conv (identity taps on
       the concatenated head input) — no 4K `repeat`;
     * the W interleave out[..., K*xi+e] is ONE dot_general against a
       one-hot (ww, K, ww*K) matrix: the interleave is the GEMM's output
       indexing;
     * every remaining move is a major-dim reshape/transpose (free).

    Numerics: identical taps with f32 accumulation; rounds to bf16 once
    where the staged path rounds twice (tests/test_models.py gates 2-ulp
    agreement with apply_fn)."""
    x = rgb_chw.astype(cfg.dtype)
    k, s = cfg.s2d, cfg.scale
    K = s * k
    n, _, in_h, in_w = x.shape
    ph, pw = (-in_h) % k, (-in_w) % k
    if ph or pw:
        x = jnp.pad(x, ((0, 0), (0, 0), (0, ph), (0, pw)), mode="edge")
    hh, ww = x.shape[-2] // k, x.shape[-1] // k
    # s2d from CHW: (n,3,hh,k,ww,k) -> (n,hh,ww,k,k,3) -> (n,hh,ww,k*k*3)
    h0 = x.reshape(n, 3, hh, k, ww, k).transpose(0, 2, 4, 3, 5, 1) \
        .reshape(n, hh, ww, k * k * 3)
    row_mask = _row_valid_mask(hh, row_valid, cfg.dtype)
    mk = (lambda a: a) if row_mask is None else (lambda a: a * row_mask)
    h = mk(jax.nn.relu(_conv(h0, params["head"]["w"], params["head"]["b"])))
    for blk in params["body"]:
        r = mk(jax.nn.relu(_conv(h, blk["c1"]["w"], blk["c1"]["b"])))
        r = mk(_conv(r, blk["c2"]["w"], blk["c2"]["b"]))
        h = h + r
    perm, taps = _tail_reorder(cfg)
    w_aug = jnp.concatenate(
        [params["tail"]["w"][..., perm], jnp.asarray(taps, cfg.dtype)],
        axis=2)
    res = _conv(jnp.concatenate([h, h0], -1), w_aug,
                params["tail"]["b"][perm])     # (n, hh, ww, 3KK) (d,c,e)
    lhs = res.reshape(n, hh, ww, 3 * K, K)
    out = jax.lax.dot_general(
        lhs, jnp.asarray(_spread_matrix(ww, K), cfg.dtype),
        (((2, 4), (0, 1)), ((), ())))          # (n, hh, 3K, ww*K)
    out = out.reshape(n, hh, K, 3, ww * K).transpose(0, 3, 1, 2, 4) \
        .reshape(n, 3, hh * K, ww * K).astype(jnp.float32)
    if ph or pw:
        out = out[..., :in_h * s, :in_w * s]
    return out


def loss_fn(params, lr, hr, cfg: SuperResConfig = SuperResConfig()):
    """Charbonnier loss (smooth L1) — standard for SR training."""
    pred = apply_fn(params, lr, cfg)
    eps = 1e-3
    return jnp.mean(jnp.sqrt((pred - hr) ** 2 + eps * eps))


def sgd_train_step(params, opt_state, lr_batch, hr_batch,
                   cfg: SuperResConfig = SuperResConfig(),
                   learning_rate: float = 1e-3):
    """One momentum-SGD step; pure function of (params, opt_state, batch).
    ``opt_state`` is a momentum pytree mirroring params."""
    loss, grads = jax.value_and_grad(loss_fn)(params, lr_batch, hr_batch, cfg)

    def upd(p, m, g):
        m_new = 0.9 * m + g.astype(jnp.float32)
        return (p.astype(jnp.float32) - learning_rate * m_new).astype(p.dtype), m_new

    flat_p, tree = jax.tree_util.tree_flatten(params)
    flat_m = jax.tree_util.tree_leaves(opt_state)
    flat_g = jax.tree_util.tree_leaves(grads)
    new_p, new_m = [], []
    for p, m, g in zip(flat_p, flat_m, flat_g):
        pn, mn = upd(p, m, g)
        new_p.append(pn)
        new_m.append(mn)
    return (jax.tree_util.tree_unflatten(tree, new_p),
            jax.tree_util.tree_unflatten(tree, new_m), loss)


def init_opt_state(params):
    return jax.tree_util.tree_map(
        lambda p: jnp.zeros(p.shape, jnp.float32), params)


def enhance_plane_chw(params, rgb_chw: jnp.ndarray,
                      cfg: SuperResConfig = SuperResConfig(),
                      row_valid=None) -> jnp.ndarray:
    """Pipeline hook: (..., 3, H, W) float -> (..., 3, H*s, W*s) — the
    CHW-native path (see :func:`apply_fn_chw`): same model as
    moveaxis(apply_fn(moveaxis)) within 2 bf16 ulps, with no 4K NHWC
    relayouts and the d2s interleave as a matmul.  ``row_valid``: optional
    (lo, hi) s2d-row frame bounds for the sharded path (see
    :func:`_row_valid_mask`)."""
    lead = rgb_chw.shape[:-3]
    x = rgb_chw.reshape((-1,) + rgb_chw.shape[-3:])
    y = apply_fn_chw(params, x, cfg, row_valid=row_valid)
    return y.reshape(lead + y.shape[-3:])
