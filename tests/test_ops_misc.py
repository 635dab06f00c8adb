"""Tests for deinterlace, geometry, overlay and Dolby Vision ops."""

import numpy as np
import jax.numpy as jnp
import pytest

from videorenderer.ops import deinterlace as di
from videorenderer.ops import dovi, geometry, overlay, transfer


# -- deinterlace --------------------------------------------------------------

def test_bob_keeps_field_rows():
    f = np.arange(32, dtype=np.float32).reshape(8, 4)
    top = np.asarray(di.bob(jnp.asarray(f), field=0))
    np.testing.assert_array_equal(top[0::2], f[0::2])          # top field kept
    np.testing.assert_allclose(top[1], (f[0] + f[2]) / 2)      # interp rows
    bot = np.asarray(di.bob(jnp.asarray(f), field=1))
    np.testing.assert_array_equal(bot[1::2], f[1::2])
    np.testing.assert_allclose(bot[2], (f[1] + f[3]) / 2)
    np.testing.assert_allclose(bot[0], f[1])                   # clamp at top


def test_blend_matches_formula():
    f = np.random.default_rng(0).random((6, 4)).astype(np.float32)
    out = np.asarray(di.blend(jnp.asarray(f)))
    np.testing.assert_allclose(out[2], (2 * f[2] + f[1] + f[3]) / 4, atol=1e-7)


def test_motion_adaptive_static_weaves():
    f = np.random.default_rng(1).random((8, 4)).astype(np.float32)
    same = jnp.asarray(f)
    out = np.asarray(di.motion_adaptive(same, same, same, field=0))
    np.testing.assert_allclose(out, f, atol=1e-7)  # no motion -> weave = source


def test_motion_adaptive_moving_bobs():
    rng = np.random.default_rng(2)
    f = rng.random((8, 4)).astype(np.float32)
    prev = rng.random((8, 4)).astype(np.float32)   # large motion everywhere
    nxt = prev + 0.9
    out = np.asarray(di.motion_adaptive(jnp.asarray(f), jnp.asarray(prev),
                                        jnp.asarray(nxt), field=0))
    ref = np.asarray(di.bob(jnp.asarray(f), field=0))
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_double_rate():
    f = jnp.asarray(np.random.default_rng(3).random((8, 4)).astype(np.float32))
    a, b = di.double_rate_fields(f)
    assert a.shape == f.shape and b.shape == f.shape


# -- geometry ------------------------------------------------------------------

def test_rotate_flip_roundtrip():
    x = np.arange(24, dtype=np.float32).reshape(1, 4, 6)
    r90 = np.asarray(geometry.rotate_flip(jnp.asarray(x), 90))
    assert r90.shape == (1, 6, 4)
    np.testing.assert_array_equal(r90[0], np.rot90(x[0], k=-1))
    r180 = np.asarray(geometry.rotate_flip(jnp.asarray(x), 180))
    np.testing.assert_array_equal(r180[0], np.rot90(x[0], k=2))
    r270 = np.asarray(geometry.rotate_flip(jnp.asarray(x), 270))
    np.testing.assert_array_equal(r270[0], np.rot90(x[0], k=1))
    fl = np.asarray(geometry.rotate_flip(jnp.asarray(x), 0, flip=True))
    np.testing.assert_array_equal(fl[0], x[0, :, ::-1])
    assert geometry.rotated_size(1920, 1080, 90) == (1080, 1920)


def test_half_overunder():
    x = np.zeros((1, 8, 4), np.float32)
    x[:, :4] = 1.0   # top half = left eye
    out = np.asarray(geometry.half_overunder_to_interlace(jnp.asarray(x)))
    assert out.shape == (1, 8, 4)
    np.testing.assert_array_equal(out[0, 0::2], np.ones((4, 4)))
    np.testing.assert_array_equal(out[0, 1::2], np.zeros((4, 4)))


# -- overlay -------------------------------------------------------------------

def test_alpha_blend():
    base = jnp.zeros((3, 4, 4))
    ov = jnp.ones((3, 4, 4))
    a = jnp.full((4, 4), 0.25)
    out = np.asarray(overlay.alpha_blend(base, ov, a))
    np.testing.assert_allclose(out, 0.25, atol=1e-7)


def test_blend_in_rect():
    base = jnp.zeros((3, 8, 8))
    ov = jnp.ones((3, 2, 2))
    a = jnp.ones((2, 2))
    out = np.asarray(overlay.blend_in_rect(base, ov, a, x=3, y=4))
    assert out[0, 4, 3] == 1.0 and out[0, 5, 4] == 1.0
    assert out.sum() == 3 * 4  # only the 2x2 region per channel


def test_sdr_bitmap_to_pq_levels():
    white = jnp.ones((3, 1, 1))
    pq100 = float(np.asarray(overlay.sdr_bitmap_to_pq(white, 0))[0, 0, 0])
    pq30 = float(np.asarray(overlay.sdr_bitmap_to_pq(white, 2))[0, 0, 0])
    # 100-nit white in PQ ~ 0.508; 30-nit ~ 0.41; brighter setting is higher
    assert pq100 == pytest.approx(0.508, abs=5e-3)
    assert pq30 < pq100


# -- dolby vision ---------------------------------------------------------------

def _poly_curve(pieces):
    """pieces: list of (c0, c1, c2); pivots equally spaced."""
    n = len(pieces)
    pivots = tuple((i + 1) / n for i in range(n - 1))
    return dovi.ReshapeCurve(pivots=pivots, method=(0,) * n,
                             poly=np.array(pieces, dtype=np.float64))


def test_reshape_identity():
    meta = dovi.DoviMetadata(
        curves=(dovi.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.eye(3), ycc_to_rgb_offset=np.zeros(3),
        rgb_to_lms_matrix=np.eye(3))
    x = jnp.asarray(np.random.default_rng(0).random((3, 4, 4)))
    out = np.asarray(dovi.reshape(x, meta, axis=0))
    np.testing.assert_allclose(out, np.asarray(x), atol=1e-7)


def test_reshape_piecewise_poly():
    # two pieces: [0,0.5): y = 2x; [0.5,1]: y = 0.5 + (x-0.5) -> c0=0, c1=1
    curve = dovi.ReshapeCurve(pivots=(0.5,), method=(0, 0),
                              poly=np.array([[0.0, 2.0, 0.0], [0.0, 1.0, 0.0]]))
    meta = dovi.DoviMetadata(curves=(curve,) * 3,
                             ycc_to_rgb_matrix=np.eye(3),
                             ycc_to_rgb_offset=np.zeros(3),
                             rgb_to_lms_matrix=np.eye(3))
    x = jnp.asarray(np.array([[[0.25]], [[0.75]], [[0.5]]]))
    out = np.asarray(dovi.reshape(x, meta, axis=0))
    assert out[0, 0, 0] == pytest.approx(0.5)    # 2*0.25
    assert out[1, 0, 0] == pytest.approx(0.75)   # identity piece
    assert out[2, 0, 0] == pytest.approx(0.5)    # boundary: s>=pivot -> piece 1


def test_reshape_mmr_order1():
    # MMR piece: s' = 0.1 + 0.5*s0 + 0.25*s1 (+0 cross terms)
    coef = np.zeros((1, 3, 7))
    coef[0, 0, 0] = 0.5
    coef[0, 0, 1] = 0.25
    curve = dovi.ReshapeCurve(pivots=(), method=(1,),
                              poly=np.zeros((1, 3)), mmr_order=(1,),
                              mmr_constant=(0.1,), mmr_coef=coef)
    meta = dovi.DoviMetadata(curves=(curve, dovi.identity_curve(),
                                     dovi.identity_curve()),
                             ycc_to_rgb_matrix=np.eye(3),
                             ycc_to_rgb_offset=np.zeros(3),
                             rgb_to_lms_matrix=np.eye(3))
    x = jnp.asarray(np.array([[[0.4]], [[0.8]], [[0.2]]]))
    out = np.asarray(dovi.reshape(x, meta, axis=0))
    assert out[0, 0, 0] == pytest.approx(0.1 + 0.5 * 0.4 + 0.25 * 0.8)


def test_from_rpu_mapping_scaling():
    # 1 piece poly, coef_log2_denom=2 -> scale 0.25; bl_bit_depth=10
    curve = dovi.from_rpu_mapping(
        num_pivots=2, pivots=[0, 1023], mapping_idc=[0],
        poly_order=[1], poly_coef=[[4, 2, 0]],
        mmr_order=[0], mmr_constant=[0], mmr_coef=np.zeros((8, 3, 7)),
        bl_bit_depth=10, coef_log2_denom=2)
    assert curve.poly[0, 0] == pytest.approx(1.0)   # 4 * 2^-2
    assert curve.poly[0, 1] == pytest.approx(0.5)   # 2 * 2^-2
    assert curve.poly[0, 2] == 0.0                  # order 1 zeroes x^2


def test_lms_matrix_roundtrip_identity():
    meta = dovi.DoviMetadata(
        curves=(dovi.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.eye(3), ycc_to_rgb_offset=np.zeros(3),
        rgb_to_lms_matrix=np.linalg.inv(dovi.DOVI_LMS2RGB))
    pq = jnp.asarray(np.random.default_rng(1).random((3, 2, 2)) * 0.7 + 0.1)
    out = np.asarray(dovi.apply_lms_matrix(pq, meta, axis=0))
    np.testing.assert_allclose(out, np.asarray(pq), atol=1e-5)


def test_reshape_dynamic_matches_static():
    """Runtime-tensor reshape == trace-specialized reshape for mixed
    poly/MMR curves."""
    rng = np.random.default_rng(11)
    coef = np.zeros((2, 3, 7))
    coef[1, 0, :3] = [0.4, 0.3, 0.2]
    coef[1, 0, 3:] = [0.05, 0.04, 0.03, 0.02]
    coef[1, 1, :3] = [0.01, 0.02, 0.03]
    coef[1, 1, 3:] = [0.001, 0.002, 0.003, 0.004]
    mixed = dovi.ReshapeCurve(
        pivots=(0.5,), method=(0, 1),
        poly=np.array([[0.1, 0.8, 0.05], [0, 1, 0]]),
        mmr_order=(0, 2), mmr_constant=(0.0, 0.05), mmr_coef=coef)
    meta = dovi.DoviMetadata(
        curves=(mixed, dovi.identity_curve(), _poly_curve([(0.0, 0.5, 0.5)])),
        ycc_to_rgb_matrix=np.eye(3), ycc_to_rgb_offset=np.zeros(3),
        rgb_to_lms_matrix=np.eye(3))
    x = jnp.asarray(rng.random((3, 8, 8)))
    static = np.asarray(dovi.reshape(x, meta, axis=0))
    packed = {k: jnp.asarray(v) for k, v in dovi.pack_curves(meta).items()}
    dynamic = np.asarray(dovi.reshape_dynamic(x, packed, axis=0))
    np.testing.assert_allclose(dynamic, static, atol=1e-6)


def test_reshape_dynamic_no_retrace():
    """Changing curve values must not retrace the jitted function."""
    import jax
    meta = dovi.DoviMetadata(
        curves=(dovi.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.eye(3), ycc_to_rgb_offset=np.zeros(3),
        rgb_to_lms_matrix=np.eye(3))
    packed = {k: jnp.asarray(v) for k, v in dovi.pack_curves(meta).items()}
    traces = []

    @jax.jit
    def fn(x, curves):
        traces.append(1)
        return dovi.reshape_dynamic(x, curves, axis=0)

    x = jnp.asarray(np.random.default_rng(0).random((3, 4, 4)))
    fn(x, packed)
    packed2 = dict(packed)
    packed2["poly"] = packed["poly"] * 0.9
    fn(x, packed2)
    assert len(traces) == 1


def test_alpha_blend_premultiplied():
    base = jnp.full((3, 4, 4), 0.8)
    ov = jnp.full((3, 4, 4), 0.3)   # premultiplied color
    a = jnp.full((4, 4), 0.5)
    out = np.asarray(overlay.alpha_blend_premultiplied(base, ov, a))
    np.testing.assert_allclose(out, 0.3 + 0.8 * 0.5, atol=1e-7)


def test_blend_in_rect_negative_origin_clips():
    base = jnp.zeros((3, 8, 8))
    ov = jnp.ones((3, 4, 4))
    a = jnp.ones((4, 4))
    out = np.asarray(overlay.blend_in_rect(base, ov, a, x=-2, y=-2))
    assert out[0, 0, 0] == 1.0 and out[0, 1, 1] == 1.0
    assert out[0, 2, 2] == 0.0  # only the visible 2x2 corner landed
