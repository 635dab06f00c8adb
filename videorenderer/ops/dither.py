"""Quantization / dithering — the "final pass".

Port of Shaders/d3d11/ps_final_pass.hlsl: the reference tiles a 32x32
float16 dither texture (resource IDF_DITHER_32X32_FLOAT16,
Source/DX11VideoProcessor.cpp dither texture load) over the target and
quantizes ``floor(pixel * Q + dither) / Q``.

The reference's binary dither texture cannot be copied; we generate the
canonical 32x32 ordered (Bayer) matrix instead, which has the same uniform
[0,1) distribution and tiling semantics.  A stochastic (per-frame random)
dither using ``jax.random`` is also provided.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

DITHER_SIZE = 32


@functools.cache
def bayer_matrix(n: int = DITHER_SIZE) -> np.ndarray:
    """Recursive Bayer ordered-dither matrix, values in [0, 1)."""
    assert n and (n & (n - 1)) == 0, "size must be a power of two"
    m = np.array([[0]], dtype=np.int64)
    size = 1
    while size < n:
        m = np.block([[4 * m + 0, 4 * m + 2],
                      [4 * m + 3, 4 * m + 1]])
        size *= 2
    return ((m.astype(np.float64) + 0.5) / (n * n)).astype(np.float32)


def _requantize(codes: jnp.ndarray, q: float) -> jnp.ndarray:
    """codes/q via reciprocal multiply, one rounding rule for every path
    (a division and a reciprocal multiply can differ in the last ulp); the
    clamp restores the exact 1.0 endpoint (q * (1/q) rounds up)."""
    return jnp.minimum(codes * np.float32(1.0 / q), 1.0)


def _tile_to(pattern: jnp.ndarray, h: int, w: int) -> jnp.ndarray:
    ph, pw = pattern.shape
    reps = ((h + ph - 1) // ph, (w + pw - 1) // pw)
    return jnp.tile(pattern, reps)[:h, :w]


def ordered_dither(img: jnp.ndarray, bits: int,
                   row_offset: "int | jnp.ndarray" = 0) -> jnp.ndarray:
    """Ordered-dither quantization to ``bits`` (ps_final_pass.hlsl:24-28):
    ``floor(pixel * Q + dither) / Q`` with QUANTIZATION = 2**bits - 1.

    ``img``: float array whose last two dims are (H, W); leading dims
    (channels/batch) broadcast over the same tiled pattern, matching the
    reference (one dither texture shared by R, G and B).

    ``row_offset``: global row index of the first local row — local row i
    dithers with pattern row ``(i + row_offset) % 32``.  Required for
    row-sharded execution (shard_map) so every shard uses the phase it
    would have in the unsharded frame; may be a traced scalar
    (``jax.lax.axis_index * shard_rows``).
    """
    q = float(2 ** bits - 1)
    h, w = img.shape[-2], img.shape[-1]
    pat = jnp.asarray(bayer_matrix())
    if isinstance(row_offset, (int, np.integer)):
        if row_offset % DITHER_SIZE:
            pat = jnp.asarray(np.roll(bayer_matrix(),
                                      -(row_offset % DITHER_SIZE), axis=0))
    else:
        pat = jnp.roll(pat, -(row_offset % DITHER_SIZE), axis=0)
    d = _tile_to(pat, h, w).astype(img.dtype)
    return _requantize(jnp.floor(img * q + d), q)


def bayer_field(h: int, w: int, row0: int = 0, col0: int = 0,
                transpose: bool = False, flip_rows: bool = False,
                flip_cols: bool = False) -> jnp.ndarray:
    """The 32x32 Bayer pattern tiled to (h, w), computed from iota bit math
    (no array constant to embed in the program).  Bit-identical to tiling
    :func:`bayer_matrix`: digit b of the base-4 value is
    ``2*bit_b(i^j) + bit_b(i)`` with weight ``4**(4-b)``.

    ``transpose``/``flip_rows``/``flip_cols`` (ops.geometry.rf_decompose
    order) emit the pattern as the same transform of the tiled field —
    how the fused-rotation paths keep the dither phase of the
    PRE-rotation frame while writing the rotated surface directly (valid
    at any tile origin that is a multiple of 32 on both axes)."""
    ii = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + row0) & (DITHER_SIZE - 1)
    jj = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + col0) & (DITHER_SIZE - 1)
    if flip_rows:
        ii = (DITHER_SIZE - 1) - ii
    if flip_cols:
        jj = (DITHER_SIZE - 1) - jj
    if transpose:
        ii, jj = jj, ii
    x = jnp.bitwise_xor(ii, jj)
    v = jnp.zeros((h, w), jnp.int32)
    for b in range(5):
        digit = ((x >> b) & 1) * 2 + ((ii >> b) & 1)
        v = v + (digit << (2 * (4 - b)))
    return (v.astype(jnp.float32) + 0.5) / float(DITHER_SIZE * DITHER_SIZE)


def ordered_dither_iota(img: jnp.ndarray, bits: int,
                        row0: int = 0, col0: int = 0,
                        transpose: bool = False, flip_rows: bool = False,
                        flip_cols: bool = False) -> jnp.ndarray:
    """:func:`ordered_dither` with the pattern generated from iota (same
    quantization rule and values).  The transform
    flags pass through to :func:`bayer_field`."""
    q = float(2 ** bits - 1)
    h, w = img.shape[-2], img.shape[-1]
    d = bayer_field(h, w, row0, col0, transpose=transpose,
                    flip_rows=flip_rows, flip_cols=flip_cols).astype(img.dtype)
    return _requantize(jnp.floor(img * q + d), q)


def random_dither(img: jnp.ndarray, bits: int, key: jax.Array) -> jnp.ndarray:
    """Per-pixel uniform random dither (the "random dither" bench config):
    same quantization rule with U[0,1) noise instead of the tiled pattern."""
    q = float(2 ** bits - 1)
    noise = jax.random.uniform(key, img.shape, dtype=img.dtype)
    return _requantize(jnp.floor(img * q + noise), q)


def quantize(img: jnp.ndarray, bits: int) -> jnp.ndarray:
    """Plain round-to-nearest quantization (dither disabled,
    Settings.use_dither == False path)."""
    q = float(2 ** bits - 1)
    return _requantize(jnp.round(img * q), q)
