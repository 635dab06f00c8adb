"""Multi-chip scale-out: frame-parallel and spatially-sharded execution.

The reference is single-GPU; its only pipelining is the swap-chain depth
(SURVEY.md §2.7).  Here the first-class parallel axes are:

 * **data (frame) parallelism** — shard the batch/clip dimension across the
   mesh; zero cross-device traffic, the natural analogue of swap-chain
   pipelining.  This is the default for the throughput benchmark.
 * **spatial parallelism** — shard frame rows across devices for oversized
   frames; separable filters need halo rows at shard boundaries, exchanged
   with ``jax.lax.ppermute`` inside ``shard_map`` (the support
   radius is static per filter — convolution_filters.hlsl's
   ``filter_support``).

Both compose with the pure frame function from
:mod:`videorenderer.pipeline` via ``jax.jit`` + sharding annotations —
XLA inserts the collectives.
"""

from __future__ import annotations



import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.scale import RESIZE_PRECISION


def make_mesh(n_devices: int | None = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch(mesh: Mesh, tree, axis: str = "data"):
    """Place a pytree of (B, ...) arrays with B sharded over the mesh."""
    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, tree)


def jit_frame_parallel(frame_fn, mesh: Mesh, axis: str = "data"):
    """jit the per-frame function with batch-dim shardings PINNED on every
    input and output leaf (``with_sharding_constraint``), rather than relying
    on input-sharding propagation.  Fully embarrassingly parallel — no
    collectives are generated; a host-resident input is auto-sharded on the
    way in instead of being replicated."""
    def spec_for(x):
        return NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))

    def pin(tree):
        return jax.tree_util.tree_map(
            lambda x: jax.lax.with_sharding_constraint(x, spec_for(x)), tree)

    def fn(planes):
        return pin(frame_fn(pin(planes)))

    return jax.jit(fn)


# ---------------------------------------------------------------------------
# spatial sharding with halo exchange
# ---------------------------------------------------------------------------


def halo_exchange(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Extend a row-sharded block (..., Hs, W) with ``halo`` rows from each
    neighbor shard (edge-replicated at the global boundary), using paired
    ppermute shifts over the mesh ring.
    """
    if halo == 0:
        return x
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)

    # bottom rows of the previous shard -> our top halo
    send_down = x[..., -halo:, :]
    from_prev = jax.lax.ppermute(send_down, axis_name,
                                 [(i, (i + 1) % n) for i in range(n)])
    # top rows of the next shard -> our bottom halo
    send_up = x[..., :halo, :]
    from_next = jax.lax.ppermute(send_up, axis_name,
                                 [(i, (i - 1) % n) for i in range(n)])

    # at global edges replicate our own border rows (CLAMP addressing)
    top_edge = jnp.repeat(x[..., :1, :], halo, axis=-2)
    bottom_edge = jnp.repeat(x[..., -1:, :], halo, axis=-2)
    top = jnp.where(idx == 0, top_edge, from_prev)
    bottom = jnp.where(idx == n - 1, bottom_edge, from_next)
    return jnp.concatenate([top, x, bottom], axis=-2)


def spatial_resize_rows(x: jnp.ndarray, mat_full: np.ndarray, halo: int,
                        axis_name: str) -> jnp.ndarray:
    """Row-axis resize of a row-sharded tensor: each shard computes its slice
    of output rows from its halo-extended input rows.

    ``mat_full``: (H_in, H_out) global weight matrix.  Requires H_in, H_out
    divisible by the mesh axis size; the per-shard weight slice is selected
    statically (same for every shard only if the scale is shard-periodic, so
    we pass the full matrix and slice dynamically with a static shard size).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    h_in = mat_full.shape[0]
    h_out = mat_full.shape[1]
    hs_in = h_in // n
    hs_out = h_out // n

    ext = halo_exchange(x, halo, axis_name)  # (..., hs_in + 2*halo, W)

    # Weight rows seen by this shard: global rows [idx*hs_in - halo,
    # idx*hs_in + hs_in + halo) clamped; build a banded slice of mat_full for
    # every shard at trace time and select by index.
    mats = []
    for i in range(n):
        lo = i * hs_in - halo
        rows = np.arange(lo, lo + hs_in + 2 * halo)
        rows = np.clip(rows, 0, h_in - 1)
        block = mat_full[rows][:, i * hs_out:(i + 1) * hs_out]
        # zero out halo rows that were clamp-duplicates of interior rows to
        # avoid double counting: rebuild from the raw matrix instead
        m = np.zeros((hs_in + 2 * halo, hs_out))
        for r_local, r_global in enumerate(range(lo, lo + hs_in + 2 * halo)):
            if 0 <= r_global < h_in:
                m[r_local] = mat_full[r_global, i * hs_out:(i + 1) * hs_out]
        mats.append(m)
    mats = jnp.asarray(np.stack(mats), dtype=x.dtype)  # (n, hs_in+2h, hs_out)
    m = jax.lax.dynamic_index_in_dim(mats, idx, axis=0, keepdims=False)

    moved = jnp.moveaxis(ext, -2, -1)  # (..., W, hs_in+2h)
    out = jnp.matmul(moved, m, preferred_element_type=jnp.float32,
                     precision=RESIZE_PRECISION).astype(x.dtype)
    return jnp.moveaxis(out, -1, -2)   # (..., hs_out, W)
