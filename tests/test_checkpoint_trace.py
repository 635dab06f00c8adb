"""Checkpointing + tracing utility tests."""

import numpy as np
import jax

from videorenderer.models import checkpoint, superres
from videorenderer.utils.trace import stage_timer
from videorenderer.stats import RenderStats


def test_checkpoint_roundtrip(tmp_path):
    cfg = superres.SuperResConfig(channels=8, num_blocks=1)
    params = superres.init_params(jax.random.PRNGKey(0), cfg)
    p = str(tmp_path / "sr.npz")
    checkpoint.save_params(p, params)
    zeros = jax.tree_util.tree_map(lambda x: x * 0, params)
    back = checkpoint.load_params(p, zeros)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_checkpoint_shape_mismatch(tmp_path):
    import pytest
    cfg = superres.SuperResConfig(channels=8, num_blocks=1)
    params = superres.init_params(jax.random.PRNGKey(0), cfg)
    p = str(tmp_path / "sr.npz")
    checkpoint.save_params(p, params)
    other = superres.init_params(jax.random.PRNGKey(0),
                                 superres.SuperResConfig(channels=16, num_blocks=1))
    with pytest.raises(ValueError):
        checkpoint.load_params(p, other)


def test_stage_timer():
    rs = RenderStats()
    with stage_timer(rs, "paint_s"):
        sum(range(1000))
    assert rs.paint_s > 0
