"""Transfer functions and tone-map operators: anchor values + round trips."""

import numpy as np
import jax.numpy as jnp
import pytest

from videorenderer.ops import dither, tonemap, transfer


def test_pq_anchors():
    # PQ(x=1) decodes to the full 10000-nit peak
    assert float(transfer.st2084_to_linear(jnp.float64(1.0), 10000.0)) == pytest.approx(10000.0, rel=1e-6)
    # 100 nits encodes to ~0.508 (well-known anchor)
    v = float(transfer.linear_to_st2084(jnp.float64(100.0), 10000.0))
    assert v == pytest.approx(0.5081, abs=2e-3)
    # PQ OETF of 0 is c1**m2 (the HLSL does the same), ~7.3e-7
    assert float(transfer.linear_to_st2084(jnp.float64(0.0), 10000.0)) == pytest.approx(7.31e-7, rel=1e-2)


def test_pq_roundtrip():
    x = jnp.linspace(0.0, 1.0, 64, dtype=jnp.float64)
    lin = transfer.st2084_to_linear(x, 10000.0)
    back = transfer.linear_to_st2084(lin, 10000.0)
    # x=0 comes back as c1**m2 ~ 7.3e-7 (clamped EOTF toe) — true of the HLSL
    np.testing.assert_allclose(np.asarray(back), np.asarray(x), atol=1e-6)


def test_hlg_inverse_anchors():
    # inverse OETF: 0.5 -> 1.0 (scene light), 1.0 -> 12.0
    assert float(transfer.inverse_hlg(jnp.float64(0.5))) == pytest.approx(1.0, rel=1e-6)
    assert float(transfer.inverse_hlg(jnp.float64(1.0))) == pytest.approx(12.0, rel=1e-4)


def test_hlg_to_linear_ootf():
    rgb = jnp.full((3, 4, 4), 0.75, dtype=jnp.float64)
    out = np.asarray(transfer.hlg_to_linear(rgb, axis=0))
    # 0.75 -> inverse_HLG = exp((0.75-c)/a)+b ; OOTF boost with ys=2000*E
    e = float(transfer.inverse_hlg(jnp.float64(0.75)))
    expected = e * (2000.0 * e) ** 0.2
    np.testing.assert_allclose(out, expected, rtol=1e-6)


def test_hable_normalization():
    # ToneMappingHable(4.8) == 1.0 by construction
    assert float(tonemap.tonemap_hable_sdr(jnp.float64(4.8))) == pytest.approx(1.0, rel=1e-9)


def test_reinhard_and_aces():
    assert float(tonemap.reinhard(jnp.float64(1.0))) == pytest.approx(0.5)
    # ACES fitted curve maps ~0.18 to ~0.18-0.22 and is monotonic
    xs = jnp.linspace(0, 1, 32, dtype=jnp.float64)
    ys = np.asarray(tonemap.aces_film(xs))
    assert np.all(np.diff(ys) > 0)


def test_bt2390_passthrough_when_display_bright():
    p = tonemap.HDRParams(max_cll=500.0, display_max_nits=1000.0)
    rgb = jnp.full((3, 2, 2), 300.0, dtype=jnp.float64)
    out = np.asarray(tonemap.bt2390(rgb, p, axis=0))
    np.testing.assert_array_equal(out, np.asarray(rgb))


def test_bt2390_compresses_highlights():
    p = tonemap.HDRParams(max_cll=4000.0, display_max_nits=600.0,
                          mastering_max_nits=4000.0)
    hi = jnp.full((3, 1, 1), 3900.0, dtype=jnp.float64)
    out = np.asarray(tonemap.bt2390(hi, p, axis=0))
    assert out.max() < 700.0       # rolled off near display peak
    lo = jnp.full((3, 1, 1), 50.0, dtype=jnp.float64)
    out_lo = np.asarray(tonemap.bt2390(lo, p, axis=0))
    np.testing.assert_allclose(out_lo, 50.0, rtol=0.05)  # shadows preserved


def test_ictcp_roundtrip():
    rng = np.random.default_rng(0)
    rgb = jnp.asarray(rng.uniform(5.0, 900.0, (3, 4, 4)))
    ict = tonemap.rgb_to_ictcp(rgb, axis=0)
    back = np.asarray(tonemap.ictcp_to_rgb(ict, axis=0))
    np.testing.assert_allclose(back, np.asarray(rgb), rtol=2e-3)


def test_st2094_10_reduces_peak():
    p = tonemap.HDRParams(mastering_min_nits=0.005, max_cll=2000.0,
                          max_fall=400.0, display_max_nits=500.0)
    rgb = jnp.full((3, 1, 1), 1900.0, dtype=jnp.float64)
    out = np.asarray(tonemap.st2094_10(rgb, p, axis=0))
    assert out.max() < 1000.0


def test_local_tonemap_pq_shapes_and_range():
    pq = jnp.asarray(np.random.default_rng(1).random((3, 8, 8)))
    p = tonemap.HDRParams(max_cll=2000.0, display_max_nits=800.0)
    for sel in (1, 2, 3, 4, 5, 6):
        out = np.asarray(tonemap.local_tonemap_pq(pq, sel, p, axis=0))
        assert out.shape == pq.shape
        assert np.all(out >= -1e-6) and np.all(out <= 1.0 + 1e-6)


def test_bayer_matrix_properties():
    m = dither.bayer_matrix(32)
    assert m.shape == (32, 32)
    # uniform coverage: sorted values are (k+0.5)/1024
    vals = np.sort(m.ravel())
    np.testing.assert_allclose(vals, (np.arange(1024) + 0.5) / 1024, atol=1e-6)


def test_ordered_dither_quantizes():
    img = jnp.full((1, 8, 8), 0.5, dtype=jnp.float32)
    out = np.asarray(dither.ordered_dither(img, 8))
    # all outputs are exact 8-bit codes
    codes = out * 255.0
    np.testing.assert_allclose(codes, np.round(codes), atol=1e-4)


def test_ordered_dither_preserves_mean():
    """Over a full dither tile, mean quantization error ~ 0."""
    img = jnp.full((1, 32, 32), 100.4 / 255.0, dtype=jnp.float32)
    out = np.asarray(dither.ordered_dither(img, 8))
    assert abs(out.mean() * 255.0 - 100.4) < 0.05


def test_local_tonemap_rt_matches_static():
    """Runtime-params tone map == static version for every operator."""
    import jax
    pq = jnp.asarray(np.random.default_rng(3).random((3, 8, 8)))
    cases = [
        dict(mastering_min_nits=0.005, mastering_max_nits=4000.0,
             max_cll=4000.0, max_fall=1000.0, display_max_nits=600.0),
        dict(mastering_min_nits=0.0, mastering_max_nits=1000.0,
             max_cll=500.0, max_fall=200.0, display_max_nits=1000.0),  # bright display
    ]
    for prm in cases:
        p = tonemap.HDRParams(**prm)
        rt = {k: jnp.asarray(v, jnp.float64) for k, v in prm.items()}
        for sel in (1, 2, 3, 4, 5, 6):
            a = np.asarray(tonemap.local_tonemap_pq(pq, sel, p, axis=0))
            b = np.asarray(tonemap.local_tonemap_pq_rt(pq, sel, rt, axis=0))
            np.testing.assert_allclose(b, a, atol=2e-5,
                                       err_msg=f"sel={sel} prm={prm}")


def test_bt2390_p_domain_fast_path_matches_composition():
    """The m1-power-domain BT.2390 (sel 5) == explicit decode -> bt2390 ->
    encode, including the bright-display passthrough and black pixels."""
    rng = np.random.default_rng(7)
    pq = rng.random((3, 16, 16)).astype(np.float32)
    pq[:, 0, 0] = 0.0                       # exact black
    pq[:, 0, 1] = 1e-5                      # near-black (luma clamp region)
    pq = jnp.asarray(pq)
    for prm in (dict(max_cll=4000.0, display_max_nits=600.0),
                dict(max_cll=500.0, display_max_nits=1000.0)):   # passthrough
        p = tonemap.HDRParams(mastering_min_nits=0.005,
                              mastering_max_nits=1000.0,
                              max_fall=400.0, **prm)
        got = np.asarray(tonemap.local_tonemap_pq(pq, 5, p, axis=0))
        ref = np.asarray(transfer.linear_to_st2084(
            tonemap.bt2390(transfer.st2084_to_linear(pq, 10000.0), p, axis=0),
            10000.0))
        np.testing.assert_allclose(got, ref, atol=3e-5, err_msg=str(prm))


def test_st2094_10_p_domain_fast_path_matches_composition():
    """sel-6 m1-power-domain == explicit decode -> st2094_10 -> encode."""
    rng = np.random.default_rng(11)
    pq = rng.random((3, 16, 16)).astype(np.float32)
    pq[:, 0, 0] = 0.0
    pq = jnp.asarray(pq)
    for prm in (dict(max_cll=4000.0, display_max_nits=600.0),
                dict(max_cll=500.0, display_max_nits=1000.0)):   # passthrough
        p = tonemap.HDRParams(mastering_min_nits=0.005,
                              mastering_max_nits=1000.0,
                              max_fall=400.0, **prm)
        got = np.asarray(tonemap.local_tonemap_pq(pq, 6, p, axis=0))
        ref = np.asarray(transfer.linear_to_st2084(
            tonemap.st2094_10(transfer.st2084_to_linear(pq, 10000.0), p,
                              axis=0), 10000.0))
        np.testing.assert_allclose(got, ref, atol=3e-5, err_msg=str(prm))


def test_st2084_p_domain_roundtrip():
    """st2084_to_p / p_to_st2084 compose to the EOTF/OETF pair."""
    x = jnp.linspace(0.0, 1.0, 257)
    via_p = np.asarray(transfer.pow_pos(transfer.st2084_to_p(x),
                                        1.0 / transfer.ST2084_M1)) * 10000.0
    direct = np.asarray(transfer.st2084_to_linear(x, 10000.0))
    np.testing.assert_allclose(via_p, direct, rtol=1e-5, atol=1e-4)
    enc = np.asarray(transfer.p_to_st2084(
        transfer.pow_pos(jnp.asarray(direct) / 10000.0, transfer.ST2084_M1)))
    np.testing.assert_allclose(enc, np.asarray(x), atol=3e-5)


def test_local_tonemap_rt_no_retrace():
    import jax
    traces = []

    @jax.jit
    def fn(pq, prm):
        traces.append(1)
        return tonemap.local_tonemap_pq_rt(pq, 5, prm, axis=0)

    pq = jnp.asarray(np.random.default_rng(0).random((3, 4, 4)))
    base = dict(mastering_min_nits=0.005, mastering_max_nits=1000.0,
                max_cll=1000.0, max_fall=400.0, display_max_nits=800.0)
    fn(pq, {k: jnp.asarray(v) for k, v in base.items()})
    base["max_cll"] = 4000.0
    fn(pq, {k: jnp.asarray(v) for k, v in base.items()})
    assert len(traces) == 1
