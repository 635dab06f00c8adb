"""SuperRes + VideoHDR model tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from videorenderer.config import SuperResolution
from videorenderer.models import superres, videohdr


def test_superres_shapes_and_train_step():
    cfg = superres.SuperResConfig(channels=8, num_blocks=1, scale=2)
    params = superres.init_params(jax.random.PRNGKey(0), cfg)
    lr = jnp.asarray(np.random.default_rng(0).random((2, 8, 8, 3), np.float32))
    hr = jnp.asarray(np.random.default_rng(1).random((2, 16, 16, 3), np.float32))
    out = superres.apply_fn(params, lr, cfg)
    assert out.shape == (2, 16, 16, 3)
    opt = superres.init_opt_state(params)
    l0 = float(superres.loss_fn(params, lr, hr, cfg))
    p, o, loss = superres.sgd_train_step(params, opt, lr, hr, cfg,
                                         learning_rate=0.05)
    for _ in range(5):
        p, o, loss = superres.sgd_train_step(p, o, lr, hr, cfg,
                                             learning_rate=0.05)
    assert float(loss) < l0  # optimizing


def test_superres_gate():
    assert superres.superres_engages(SuperResolution.P1080, 1920, 1080, 3840, 2160)
    assert not superres.superres_engages(SuperResolution.SD, 1920, 1080, 3840, 2160)
    assert not superres.superres_engages(SuperResolution.P1080, 1920, 1080, 1920, 1080)
    assert not superres.superres_engages(SuperResolution.DISABLE, 640, 480, 1280, 960)


def test_superres_chw_hook():
    cfg = superres.SuperResConfig(channels=8, num_blocks=1, scale=2)
    params = superres.init_params(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray(np.random.default_rng(2).random((3, 8, 8), np.float32))
    y = superres.enhance_plane_chw(params, x, cfg)
    assert y.shape == (3, 16, 16)


def test_videohdr_zero_init_is_base():
    cfg = videohdr.VideoHDRConfig(channels=8)
    params = videohdr.init_params(jax.random.PRNGKey(0), cfg)
    x = jnp.asarray(np.random.default_rng(0).random((1, 8, 8, 3), np.float32))
    out = np.asarray(videohdr.apply_fn(params, x, cfg))
    base = np.asarray(videohdr.inverse_tonemap_base(
        jnp.moveaxis(x, -1, -3), cfg, axis=-3))
    np.testing.assert_allclose(out, np.moveaxis(base, -3, -1), atol=1e-5)
    assert np.all((out >= 0) & (out <= 1))


def test_videohdr_base_monotone_and_peak():
    cfg = videohdr.VideoHDRConfig(peak_nits=1000.0)
    ramp = jnp.asarray(np.linspace(0, 1, 16, dtype=np.float32).reshape(1, 1, 16)
                       .repeat(3, axis=0).reshape(3, 1, 16))
    pq = np.asarray(videohdr.inverse_tonemap_base(ramp, cfg, axis=-3))
    assert np.all(np.diff(pq[0, 0]) >= -1e-6)   # monotone
    # white maps near the display peak (1000 nits -> PQ ~0.751)
    assert pq[0, 0, -1] == pytest.approx(0.751, abs=0.03)


def test_superres_chw_path_matches_nhwc():
    """apply_fn_chw is the SAME model as apply_fn through a layout change
    (the CHW-native 4K path: base + bias fold into the tail conv, the d2s
    lane interleave is a permutation GEMM).  The fold rounds to bf16 once
    where the staged path rounds twice (conv output, then +base), so
    agreement is within 2 bf16 ulps of the output magnitude — including
    the pad-and-crop case and a non-zero bias."""
    for h, w, s2d in ((16, 16, 4), (18, 22, 4), (12, 20, 2)):
        cfg = superres.SuperResConfig(channels=16, num_blocks=2, scale=2,
                                      s2d=s2d)
        params = superres.init_params(jax.random.PRNGKey(3), cfg)
        # non-zero tail so the residual branch actually contributes
        params["tail"]["w"] = (
            jax.random.normal(jax.random.PRNGKey(4),
                              params["tail"]["w"].shape) * 0.05
        ).astype(cfg.dtype)
        params["tail"]["b"] = (
            jax.random.normal(jax.random.PRNGKey(5),
                              params["tail"]["b"].shape) * 0.05
        ).astype(cfg.dtype)
        x = np.random.default_rng(7).random((2, h, w, 3)).astype(np.float32)
        ref = np.asarray(superres.apply_fn(params, jnp.asarray(x), cfg))
        chw = np.asarray(superres.apply_fn_chw(
            params, jnp.asarray(np.moveaxis(x, -1, 1)), cfg))
        assert chw.shape == np.moveaxis(ref, -1, 1).shape
        tol = 2.0 ** -8 * 2.0 * max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(np.moveaxis(chw, 1, -1), ref, atol=tol)


def test_videohdr_chw_path_matches_nhwc():
    """videohdr.enhance_plane_chw (s2d-domain net + GEMM-spread gains) is
    the SAME model as apply_fn through a layout change; tanh/exp commute
    with the gain permutation, so outputs agree to f32 elementwise noise
    (including the pad-and-crop case)."""
    cfg = videohdr.VideoHDRConfig(channels=8)
    params = videohdr.init_params(jax.random.PRNGKey(0), cfg)
    # non-zero gain head so the net branch actually contributes
    params["c3"]["w"] = (jax.random.normal(jax.random.PRNGKey(1),
                                           params["c3"]["w"].shape)
                         * 0.1).astype(cfg.dtype)
    for h, w in ((16, 16), (18, 22)):
        x = np.random.default_rng(7).random((2, h, w, 3)).astype(np.float32)
        ref = np.asarray(videohdr.apply_fn(params, jnp.asarray(x), cfg))
        chw = np.asarray(videohdr.enhance_plane_chw(
            params, jnp.asarray(np.moveaxis(x, -1, 1)), cfg))
        np.testing.assert_allclose(np.moveaxis(chw, 1, -1), ref,
                                   atol=1e-6, rtol=1e-6)
