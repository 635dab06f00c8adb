"""VideoHDR training subsystem: synthetic HDR data, BT.2390 round trip,
learning, DP sharding.  Reduced configs keep this CPU-friendly; the
shipped checkpoint is gated by test_hdr_checkpoint.py when
weights/videohdr.npz exists."""

import numpy as np
import pytest

import jax

from videorenderer.models.hdr_train import (degrade_to_sdr,
                                                evaluate_pq_psnr,
                                                hdr_truth_pq,
                                                synth_hdr_frames, train)
from videorenderer.models.videohdr import (VideoHDRConfig, apply_fn,
                                               init_params)

TINY = VideoHDRConfig(channels=8)


def test_synth_hdr_frames_range():
    cfg = VideoHDRConfig()
    d = synth_hdr_frames(seed=3, n=6, size=32, cfg=cfg)
    assert d.shape == (6, 32, 32, 3) and d.dtype == np.float32
    assert d.min() >= 0.0 and d.max() <= cfg.peak_nits
    # highlights actually exist above the SDR range in the set
    assert d.max() > 2 * cfg.sdr_nits


def test_degrade_round_trip_monotone():
    """Tone-mapped SDR is in [0,1] and preserves ordering on gray ramps."""
    cfg = VideoHDRConfig()
    ramp = np.linspace(0, cfg.peak_nits, 64, dtype=np.float32)
    hdr = np.broadcast_to(ramp[None, :, None, None],
                          (1, 64, 8, 3)).copy()
    sdr = degrade_to_sdr(hdr, cfg)
    assert sdr.min() >= 0.0 and sdr.max() <= 1.0
    col = sdr[0, :, 4, 0]
    assert (np.diff(col) >= -1e-6).all()


def test_truth_pq_encoding():
    cfg = VideoHDRConfig()
    hdr = np.full((1, 4, 4, 3), cfg.peak_nits, np.float32)
    pq = hdr_truth_pq(hdr, cfg)
    # 1000 nits in PQ is ~0.7518 (ST 2084), and 709 white maps to 2020
    # white (gamut matrix rows sum to 1)
    assert np.allclose(pq, 0.7518, atol=2e-3), pq[0, 0, 0]


def test_training_reduces_loss_and_beats_base():
    data = synth_hdr_frames(seed=5, n=48, size=32, cfg=TINY)
    val = synth_hdr_frames(seed=999, n=8, size=32, cfg=TINY)
    params, losses = train(TINY, steps=400, batch=8, hdr_nits=data, seed=0,
                           learning_rate=2e-3)
    head = float(np.mean(losses[:10]))
    tail = float(np.mean(losses[-10:]))
    assert tail < 0.7 * head, (head, tail)
    net_db, base_db = evaluate_pq_psnr(params, TINY, val)
    # the trained net must beat the deterministic inverse-Reinhard base
    assert net_db > base_db + 1.0, (net_db, base_db)


def test_training_data_parallel_mesh():
    from jax.sharding import Mesh
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs the 8-device CPU mesh (conftest sets XLA_FLAGS)")
    mesh = Mesh(np.array(devs[:8]), ("data",))
    data = synth_hdr_frames(seed=5, n=48, size=32, cfg=TINY)
    params, losses = train(TINY, steps=40, batch=16, hdr_nits=data, seed=0,
                           learning_rate=2e-3, mesh=mesh)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < 0.9 * np.mean(losses[:8])
    out = apply_fn(params, jnp_sdr(data[:1]), TINY)
    assert np.isfinite(np.asarray(out)).all()


def jnp_sdr(hdr):
    import jax.numpy as jnp
    return jnp.asarray(degrade_to_sdr(hdr, TINY))
