"""Deinterlacing kernels.

The reference delegates deinterlacing to the fixed-function GPU video
processor (rate-conversion caps selection, Source/D3D11VP.cpp:292-331;
past/future reference-frame rings, Source/D3D11VP.h:26-193; second-field
output via ``OutputIndex=1``, Source/D3D11VP.cpp:893-960) with a shader-path
fallback of blend deinterlacing inside the convert shader
(Source/Shaders.cpp:232-237).  Double-rate field output renders two frames
per input sample (Source/DX11VideoProcessor.cpp:2176-2197).

Here the fixed-function block is replaced by explicit kernels:
 * ``bob``        — per-field line doubling with linear interpolation
 * ``weave``      — no-op recombination (progressive content in an
                    interlaced container)
 * ``blend``      — field-average (the reference's shader fallback)
 * ``motion_adaptive`` — weave where static, bob where moving, decided by a
   per-pixel temporal difference against the previous/next frames — the
   explicit analogue of the driver's motion-adaptive rate conversion.

All functions operate on (..., H, W) planes; temporal neighbors are separate
arrays (the pipeline runner maintains the sliding window, mirroring the
reference's ``VideoTextureBuffer`` ring).

Field convention: ``top_field_first=True`` means field 0 occupies even rows
(the top field) and renders first; field 1 (odd rows) renders at
+frame_duration/2, like the reference's second-field pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# bob/motion_adaptive use full-array math — two edge-clamped contiguous
# row shifts + a row-parity iota mask — rather than strided row slices
# (x[::2]) and interleaves, so XLA fuses them into one elementwise pass.
# The selected values are bit-identical to the sliced formulation.

def _bob_neighbors(frame: jnp.ndarray, use_top: bool):
    """(up, dn) rows so that (up+dn)/2 equals bob's reconstruction at every
    *opposite-field* row (kept-field rows of up/dn are unused):
    reconstructed row r averages frame[r-1] and frame[r+1], with bob's
    field-internal clamping at the edges."""
    if use_top:
        up = jnp.concatenate([frame[..., :1, :], frame[..., :-1, :]],
                             axis=-2)
        # bottom clamp: the last odd row averages field rows H-2 twice
        dn = jnp.concatenate([frame[..., 1:, :], frame[..., -2:-1, :]],
                             axis=-2)
    else:
        # top clamp: row 0 averages field row 1 twice
        up = jnp.concatenate([frame[..., 1:2, :], frame[..., :-1, :]],
                             axis=-2)
        dn = jnp.concatenate([frame[..., 1:, :], frame[..., -1:, :]],
                             axis=-2)
    return up, dn


def _opposite_mask(frame: jnp.ndarray, use_top: bool) -> jnp.ndarray:
    rows = jax.lax.broadcasted_iota(jnp.int32, frame.shape, frame.ndim - 2)
    return (rows & 1) == (1 if use_top else 0)


def bob(frame: jnp.ndarray, field: int, top_field_first: bool = True) -> jnp.ndarray:
    """Line-doubling bob: keep the active field's rows, reconstruct the
    missing rows as the average of vertical neighbors (edge-clamped).

    ``field``: 0 = first temporal field, 1 = second.
    """
    use_top = (field == 0) == top_field_first
    up, dn = _bob_neighbors(frame, use_top)
    return jnp.where(_opposite_mask(frame, use_top), (up + dn) * 0.5, frame)


def weave(frame: jnp.ndarray) -> jnp.ndarray:
    """Identity — both fields belong to the same time instant."""
    return frame


def blend(frame: jnp.ndarray) -> jnp.ndarray:
    """Field blend: y' = (2*y[r] + y[r-1] + y[r+1]) / 4, the same math as the
    convert-shader fallback (Source/Shaders.cpp:232-237)."""
    up = jnp.concatenate([frame[..., :1, :], frame[..., :-1, :]], axis=-2)
    down = jnp.concatenate([frame[..., 1:, :], frame[..., -1:, :]], axis=-2)
    return (2.0 * frame + up + down) * 0.25


def motion_adaptive(frame: jnp.ndarray, prev: jnp.ndarray, nxt: jnp.ndarray,
                    field: int, top_field_first: bool = True,
                    threshold: float = 8.0 / 255.0) -> jnp.ndarray:
    """Motion-adaptive deinterlace over a past/future window.

    Where the temporal difference between the *same* field of ``prev`` and
    ``nxt`` is small, weave (full vertical detail); where it is large, fall
    back to bob interpolation.  The soft transition uses a linear ramp of
    width ``threshold`` (motion in [thr, 2*thr] blends weave->bob), which is
    branch-free and fuses into one elementwise pass.
    """
    use_top = (field == 0) == top_field_first
    up, dn = _bob_neighbors(frame, use_top)
    bob_rows = (up + dn) * 0.5
    # motion measured on the opposite field rows (the ones we'd weave in);
    # kept-field rows of the full-array computation are masked out below
    motion = jnp.abs(nxt - prev)
    alpha = jnp.clip((motion - threshold) / threshold, 0.0, 1.0)  # 0=static
    mixed = frame + (bob_rows - frame) * alpha
    return jnp.where(_opposite_mask(frame, use_top), mixed, frame)


def double_rate_fields(frame: jnp.ndarray, top_field_first: bool = True):
    """Yield the two bob fields for double-rate output
    (Source/DX11VideoProcessor.cpp:2176-2197): field 0 at t, field 1 at
    t + duration/2."""
    return (bob(frame, 0, top_field_first), bob(frame, 1, top_field_first))
