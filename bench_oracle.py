#!/usr/bin/env python
"""Float64 per-config references for the benchmark suite.

Run on CPU with x64 (bench_configs.py spawns this automatically when a
reference is missing):

    JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python bench_oracle.py [key ...] [--force]

For each config the *staged* (non-fused) path runs at float64 on frame 0 of
the exact inputs the card runs; at float64 the staged
order is the ground-truth math (all fused-vs-staged differences are f32
rounding).  References land in ``.bench_refs/<key>.npy`` as float32 codes
(the quantized output grid is exactly representable there to ~1e-8 — far
below the 55 dB bar)."""

from __future__ import annotations

import os
import sys

import numpy as np

import jax

assert jax.config.read("jax_enable_x64"), \
    "run with JAX_ENABLE_X64=1 (float64 oracle)"

import jax.numpy as jnp

import bench_common as bc
from videorenderer.pipeline import (make_deint_fields_fn, make_frame_fn,
                                        make_serving_fn)


def _frame0(key):
    # frame content is batch-invariant (per-plane rngs, bench_common
    # RNG_SCHEME 2) so batch 1 here matches frame 0 of any timing batch
    fmt, w, h, _ = bc.input_spec(key)
    return tuple(p[0] for p in bc.make_planes(fmt, w, h, 1, seed=0))


def compute_ref(key: str) -> np.ndarray:
    plan = bc.build_plan(key)
    f64 = jnp.float64

    if key in ("c5", "c5s"):
        fmt, w, h, _ = bc.input_spec(key)
        b = bc.make_planes(fmt, w, h, 2, seed=0)
        f0 = tuple(p[0] for p in b)
        f1 = tuple(p[1] for p in b)
        fn = make_deint_fields_fn(plan, dtype=f64)
        field0, _ = fn(f0, f0, f1)      # stream start: prev clamps to cur
        ref = np.asarray(field0)
        if key == "c5s":
            rgb, alpha = bc.subtitle_overlay()
            ref = bc.np_blend_packed_codes(
                ref.astype(np.float64), rgb.astype(np.float64),
                alpha.astype(np.float64), bc.SUB_X, bc.SUB_Y, plan.dst.bits)
        return ref

    planes = _frame0(key)
    if key == "c7":
        return np.asarray(make_serving_fn(plan, dtype=f64)(
            planes, bc.c7_rt(0)))
    if key == "c8":
        return np.asarray(make_serving_fn(plan, dtype=f64)(
            planes, {"dovi_curves": bc.dovi_rt(0)}))

    out = make_frame_fn(plan, dtype=f64, fused=False)(planes)
    if key == "c3rot":
        from videorenderer.ops import geometry as geo
        out = geo.rotate_flip(out, 90, True)
    elif key == "c3sr":
        from videorenderer.models.superres import enhance_plane_chw
        params, cfg = bc.superres_params()
        out = enhance_plane_chw(params, out, cfg)
    elif key == "c1vh":
        from videorenderer.models.videohdr import enhance_plane_chw
        params, cfg = bc.videohdr_params()
        out = enhance_plane_chw(params, out, cfg)
    return np.asarray(out)


def main() -> None:
    import json
    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    force = "--force" in sys.argv
    keys = args or bc.ALL_KEYS
    os.makedirs(bc.REF_DIR, exist_ok=True)
    for key in keys:
        path = os.path.join(bc.REF_DIR, f"{key}.npy")
        spec_path = os.path.join(bc.REF_DIR, f"{key}.spec.json")
        spec = bc.ref_spec(key)
        if os.path.exists(path) and not force:
            try:
                cached = json.load(open(spec_path))
            except (OSError, ValueError):
                cached = None
            if cached == spec:
                print(f"{key}: cached")
                continue
        ref = compute_ref(key)
        np.save(path, ref.astype(np.float32))
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        print(f"{key}: wrote {path} {ref.shape}")


if __name__ == "__main__":
    main()
