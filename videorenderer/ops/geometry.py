"""Geometric transforms: rotation, flip, stereo-3D repacking.

Reference behavior:
 * rotation/flip are exposed through IExFilterConfig ("rotation", "flip",
   Source/VideoRenderer.cpp:1335-1559) and applied during the resize pass by
   vertex permutation (FillVertices, Source/DX11VideoProcessor.cpp:130-179;
   rotation-aware axis swap in ResizeShaderPass,
   Source/DX11VideoProcessor.cpp:3125-3135).
 * stereo3d half-over/under -> interlaced: ps_halfoverunder_to_interlace
   (Source/DX11VideoProcessor.cpp:4072-4084).

These are pure layout ops (transpose/reverse) that XLA folds into
surrounding copies.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def rotate_flip(x: jnp.ndarray, rotation: int = 0, flip: bool = False) -> jnp.ndarray:
    """Rotate by 0/90/180/270 degrees (clockwise, matching the renderer's
    display rotation) and/or mirror horizontally.  Operates on the last two
    (H, W) dims."""
    if rotation not in (0, 90, 180, 270):
        raise ValueError(f"rotation must be 0/90/180/270, got {rotation}")
    if rotation == 90:
        x = jnp.flip(jnp.swapaxes(x, -2, -1), axis=-1)
    elif rotation == 180:
        x = jnp.flip(x, axis=(-2, -1))
    elif rotation == 270:
        x = jnp.flip(jnp.swapaxes(x, -2, -1), axis=-2)
    if flip:
        x = jnp.flip(x, axis=-1)
    return x


def rf_decompose(rotation: int, flip: bool) -> tuple[bool, bool, bool]:
    """Decompose :func:`rotate_flip` into (transpose, flip_rows, flip_cols)
    applied in that order — the canonical form the fused-rotation paths
    use to transform axis maps and dither patterns instead of moving the
    full-size output (the reference rides rotation inside the resize
    pass, Source/DX11VideoProcessor.cpp:3125-3135)."""
    tr, fr, fc = {0: (False, False, False), 90: (True, False, True),
                  180: (False, True, True), 270: (True, True, False)}[rotation]
    if flip:
        fc = not fc
    return tr, fr, fc


def transform_axis_maps(wy, wx, rotation: int, flip: bool):
    """Transform separable (row-map, col-map) matrices so that running the
    pipeline on ``rotate_flip``-ed input planes with the returned maps
    yields exactly ``rotate_flip(pipeline(planes))``.

    For ``OUT = Wy^T P Wx`` and any axis permutation/reversal ``T``:
    ``T(OUT) = Wy'^T T(P) Wx'`` with transpose swapping the maps and each
    output-axis reversal reversing the corresponding map in BOTH indices
    (input rows reverse with the rotated plane, output columns with the
    rotated surface).  ``None`` maps (identity axes) stay ``None`` — a
    reversed identity is the identity."""
    tr, fr, fc = rf_decompose(rotation, flip)
    if tr:
        wy, wx = wx, wy
    rr = lambda m: None if m is None else np.asarray(m)[::-1, ::-1]
    if fr:
        wy = rr(wy)
    if fc:
        wx = rr(wx)
    return wy, wx


def rotated_size(width: int, height: int, rotation: int) -> tuple[int, int]:
    """Source size after rotation (GetSourceRect swap,
    Source/VideoProcessor.cpp:30-50)."""
    if rotation in (90, 270):
        return height, width
    return width, height


def half_overunder_to_interlace(x: jnp.ndarray) -> jnp.ndarray:
    """Stereo3D half-over/under -> row-interlaced
    (ps_halfoverunder_to_interlace.hlsl): even output rows sample the top
    half, odd rows the bottom half, both at the output row's vertical
    position within the half."""
    h = x.shape[-2]
    half = h // 2
    top = x[..., :half, :]
    bottom = x[..., half:half * 2, :]
    # output row r: source half-row r//2 from top (r even) / bottom (r odd)
    stacked = jnp.stack([top, bottom], axis=-2)   # (..., half, 2, W)
    shape = list(x.shape)
    shape[-2] = half * 2
    return stacked.reshape(shape)
