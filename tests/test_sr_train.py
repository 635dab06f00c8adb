"""SuperRes training subsystem: synthetic data, learning, DP sharding.

Reduced configs (tiny net / few steps) keep this CPU-friendly; the
shipped full-config checkpoint is gated separately by
test_sr_checkpoint.py when weights/superres_2x.npz exists.
"""

import numpy as np
import pytest

import jax

from videorenderer.models.sr_train import (degrade, evaluate_psnr,
                                               synth_frames, train)
from videorenderer.models.superres import (SuperResConfig, apply_fn,
                                               init_params)

TINY = SuperResConfig(channels=16, num_blocks=1, s2d=2)


def test_synth_frames_shape_range():
    d = synth_frames(seed=3, n=8, size=32)
    assert d.shape == (8, 32, 32, 3) and d.dtype == np.float32
    assert d.min() >= 0.0 and d.max() <= 1.0
    # content is not degenerate: per-frame variance exists
    assert (d.reshape(8, -1).std(axis=1) > 0.01).all()


def test_degrade_uses_framework_downscale():
    hr = synth_frames(seed=1, n=2, size=32)
    lr = degrade(hr, scale=2)
    assert lr.shape == (2, 16, 16, 3)
    # a constant frame survives degradation exactly (normalized filter)
    const = np.full((1, 32, 32, 3), 0.25, np.float32)
    np.testing.assert_allclose(degrade(const), 0.25, atol=1e-5)


def test_training_reduces_loss_and_beats_untrained():
    data = synth_frames(seed=5, n=48, size=32)
    val = synth_frames(seed=999, n=8, size=32)
    params, losses = train(TINY, steps=1000, batch=8, data_hr=data, seed=0,
                           learning_rate=2e-3)
    head = float(np.mean(losses[:10]))
    tail = float(np.mean(losses[-10:]))
    assert tail < 0.7 * head, (head, tail)
    net_db, base_db = evaluate_psnr(params, TINY, val)
    untrained = init_params(jax.random.PRNGKey(0), TINY)
    un_db, _ = evaluate_psnr(untrained, TINY, val)
    # the trained tiny net must beat the untrained (nearest-upsample)
    # net by >=1 dB AND the classical Catmull-Rom baseline outright
    assert net_db > un_db + 1.0, (net_db, un_db, base_db)
    assert net_db > base_db, (net_db, base_db)


def test_training_data_parallel_mesh():
    """DP over an 8-device CPU mesh: batch sharded, params replicated,
    gradient all-reduce inserted by XLA — loss must still go down."""
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh (conftest sets XLA_FLAGS)")
    mesh = Mesh(np.array(devs[:8]), ("data",))
    data = synth_frames(seed=5, n=48, size=32)
    params, losses = train(TINY, steps=40, batch=16, data_hr=data, seed=0,
                           learning_rate=3e-3, mesh=mesh)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < 0.85 * np.mean(losses[:8])
    # result applies fine outside the mesh
    out = apply_fn(params, degrade(data[:1]), TINY)
    assert np.isfinite(np.asarray(out)).all()


def test_natural_frames_statistics():
    """The generative natural-statistics frames: deterministic, bounded,
    and actually pink — the radially-averaged power spectrum must fall
    with frequency (slope well below white noise's flat spectrum)."""
    from videorenderer.models.sr_train import natural_frames
    a = natural_frames(seed=11, n=6, size=64)
    b = natural_frames(seed=11, n=6, size=64)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (6, 64, 64, 3) and a.dtype == np.float32
    assert a.min() >= 0.0 and a.max() <= 1.0
    assert (a.reshape(6, -1).std(axis=1) > 0.01).all()

    # spectral slope: log-power vs log-frequency regression on the luma
    luma = a.mean(axis=-1)
    spec = np.abs(np.fft.rfft2(luma - luma.mean(axis=(1, 2),
                                                keepdims=True))) ** 2
    fy = np.fft.fftfreq(64)[:, None]
    fx = np.fft.rfftfreq(64)[None, :]
    f = np.hypot(fy, fx)
    mask = f > 0
    lf = np.log(f[mask])
    slopes = []
    for i in range(6):
        lp = np.log(spec[i][mask] + 1e-12)
        slopes.append(np.polyfit(lf, lp, 1)[0])
    # pink-ish: average slope clearly negative (white noise would be ~0)
    assert np.mean(slopes) < -1.0, slopes


def test_natural_frames_train_smoke():
    """A tiny net trains on a natural-mix blend without degenerating."""
    from videorenderer.models.sr_train import natural_frames
    data = np.concatenate([synth_frames(seed=2, n=12, size=32),
                           natural_frames(seed=3, n=12, size=32)])
    params, losses = train(TINY, steps=30, batch=8, data_hr=data, seed=0,
                           learning_rate=3e-3)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-6:]) < np.mean(losses[:6])
