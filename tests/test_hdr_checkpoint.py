"""Quality gate for the SHIPPED VideoHDR checkpoint: the trained gain net
must beat the deterministic inverse-Reinhard base at reconstructing HDR
from the framework's own BT.2390-tone-mapped SDR.  Skipped when no
checkpoint is present."""

import os

import pytest

import jax

from videorenderer.models.checkpoint import load_params
from videorenderer.models.hdr_train import (evaluate_pq_psnr,
                                                synth_hdr_frames)
from videorenderer.models.videohdr import VideoHDRConfig, init_params

CKPT = os.path.join(os.path.dirname(__file__), "..", "weights",
                    "videohdr.npz")


@pytest.mark.skipif(not os.path.exists(CKPT), reason="no shipped checkpoint")
def test_shipped_checkpoint_beats_base():
    cfg = VideoHDRConfig()
    params = load_params(CKPT, init_params(jax.random.PRNGKey(0), cfg))
    val = synth_hdr_frames(seed=424242, n=12, size=192, cfg=cfg)
    net_db, base_db = evaluate_pq_psnr(params, cfg, val)
    assert net_db > base_db, (net_db, base_db)
