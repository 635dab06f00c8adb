"""Quality gate for the SHIPPED SuperRes checkpoint: the trained net must
beat the pipeline's best classical interpolator (Catmull-Rom) on held-out
synthetic content — otherwise shipping it is pointless.  Skipped when no
checkpoint is present (fresh clone before training)."""

import os

import pytest

import jax

from videorenderer.models.checkpoint import load_params
from videorenderer.models.sr_train import evaluate_psnr, synth_frames
from videorenderer.models.superres import SuperResConfig, init_params

CKPT = os.path.join(os.path.dirname(__file__), "..", "weights",
                    "superres_2x.npz")


@pytest.mark.skipif(not os.path.exists(CKPT), reason="no shipped checkpoint")
def test_shipped_checkpoint_beats_catmull():
    cfg = SuperResConfig()
    params = load_params(CKPT, init_params(jax.random.PRNGKey(0), cfg))
    val = synth_frames(seed=424242, n=12, size=192)   # never trained on
    net_db, catmull_db = evaluate_psnr(params, cfg, val)
    assert net_db > catmull_db, (net_db, catmull_db)
