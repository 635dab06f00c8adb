"""Dither pattern generation: iota (kernel-safe) vs the recursive matrix."""

import numpy as np
import jax.numpy as jnp


def test_bayer_field_matches_matrix():
    """Iota-generated (kernel-safe) Bayer pattern == the recursive matrix,
    including row/col offsets."""
    from videorenderer.ops.dither import bayer_field, bayer_matrix
    ref = np.tile(bayer_matrix(32), (3, 3))
    got = np.asarray(bayer_field(96, 96))
    np.testing.assert_array_equal(got, ref.astype(np.float32))
    got_off = np.asarray(bayer_field(32, 32, row0=7, col0=13))
    np.testing.assert_array_equal(got_off,
                                  ref[7:7 + 32, 13:13 + 32].astype(np.float32))


def test_ordered_dither_iota_matches_classic():
    from videorenderer.ops.dither import ordered_dither, ordered_dither_iota
    rng = np.random.default_rng(3)
    img = rng.random((3, 40, 70)).astype(np.float32)
    a = np.asarray(ordered_dither(jnp.asarray(img), 8))
    b = np.asarray(ordered_dither_iota(jnp.asarray(img), 8))
    np.testing.assert_array_equal(a, b)
