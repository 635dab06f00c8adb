"""Frame-parallel (DP) sharding tests on the virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.csputils import CSP
from videorenderer.parallel.mesh import (halo_exchange, make_mesh,
                                             shard_batch)
from videorenderer.pipeline import make_frame_fn, plan_pipeline


def test_make_mesh_and_shard_batch():
    mesh = make_mesh(8)
    assert mesh.shape["data"] == 8
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    sx = shard_batch(mesh, {"a": x})["a"]
    assert sx.sharding.spec == P("data", None)
    np.testing.assert_array_equal(np.asarray(sx), x)


def test_frame_parallel_pipeline_matches_single_device():
    mesh = make_mesh(8)
    w, h, b = 32, 16, 8
    src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                           matrix=CSP.BT_709)
    dst = OutputDescriptor(width=w, height=h, bits=8)
    plan = plan_pipeline(Settings(use_dither=False), src, dst)
    fn = make_frame_fn(plan)

    rng = np.random.default_rng(0)
    planes = (rng.integers(0, 256, (b, h, w), np.uint8),
              rng.integers(0, 256, (b, h // 2, w // 2), np.uint8),
              rng.integers(0, 256, (b, h // 2, w // 2), np.uint8))
    ref = np.asarray(jax.jit(fn)(planes))

    def put(x):
        return jax.device_put(
            x, NamedSharding(mesh, P("data", *([None] * (x.ndim - 1)))))

    sharded = tuple(put(jnp.asarray(p)) for p in planes)
    out = jax.jit(fn)(sharded)
    # output stays batch-sharded (embarrassingly parallel — no collectives)
    np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)


def test_halo_exchange_roundtrip():
    from jax import shard_map
    mesh = make_mesh(4)
    x = np.arange(4 * 8 * 4, dtype=np.float32).reshape(4 * 8, 4)

    fn = shard_map(lambda v: halo_exchange(v, 2, "data"), mesh=mesh,
                   in_specs=P("data", None), out_specs=P("data", None))
    sx = jax.device_put(x, NamedSharding(mesh, P("data", None)))
    out = np.asarray(jax.jit(fn)(sx))
    # each shard of 8 rows becomes 12 (2 halo rows each side)
    assert out.shape == (4 * 12, 4)
    # shard 1's top halo == shard 0's bottom rows
    np.testing.assert_array_equal(out[12:14], x[6:8])
    # shard 0's top halo replicates row 0 (edge clamp)
    np.testing.assert_array_equal(out[0], x[0])
    np.testing.assert_array_equal(out[1], x[0])


def test_spatial_resize_rows_highest_precision():
    """The row-sharded resize asks for full float32 products (a float32
    matmul at DEFAULT precision may run in TF32 on a GPU), and matches the
    unsharded matmul."""
    from jax import shard_map
    from videorenderer.ops.scale import upscale_matrix
    from videorenderer.parallel.mesh import spatial_resize_rows
    from videorenderer.config import Upscaling

    mesh = Mesh(np.array(jax.devices()[:4]), ("rows",))
    mat = upscale_matrix(Upscaling.CATMULL_ROM, 32, 64)
    x = np.random.default_rng(2).random((3, 32, 8)).astype(np.float32)
    fn = jax.jit(shard_map(
        lambda b: spatial_resize_rows(b, mat, 2, "rows"), mesh=mesh,
        in_specs=P(None, "rows", None), out_specs=P(None, "rows", None)))
    assert "HIGHEST" in fn.lower(x).as_text()
    ref = np.einsum("chw,hH->cHw", x.astype(np.float64), mat)
    np.testing.assert_allclose(np.asarray(fn(x)), ref, atol=1e-5)
