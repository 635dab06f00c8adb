#!/usr/bin/env python
"""Per-config benchmark suite: every ``bench_common`` cell on one GPU.

Per cell, one JSON line:
 * throughput as the MEDIAN over ``REPEATS`` independently-timed groups of
   ``ITERS`` dispatches (each group ends in ``block_until_ready``), with the
   observed min-max spread;
 * PSNR vs the float64 staged-path oracle (``bench_oracle.py``, run in a
   CPU-only child process that never opens the card) on frame 0 of the
   same inputs being timed — the run fails below the 55 dB bar (40 dB for
   the learned rows: the nets are bfloat16 by design, so their oracle delta
   measures model numerics, not HLSL parity);
 * the device record (platform, kind, count, the card's name and power
   limit).

Inputs are device-resident (``runner.run_clip`` / ``bench_stream.py`` time
the host feed).  Refuses to run without a GPU.

Usage: python bench_configs.py [keys...]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

import jax

import bench_common as bc

WARMUP = 2
ITERS = 3
REPEATS = 5


def measure(dispatch, frames_per_iter: int) -> list[float]:
    """WARMUP dispatches, then REPEATS groups of ITERS dispatches, each group
    timed independently and ended by ``block_until_ready``."""
    n = 0
    for _ in range(WARMUP):
        out = dispatch(n)
        n += 1
    jax.block_until_ready(out)
    samples = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(ITERS):
            out = dispatch(n)
            n += 1
        jax.block_until_ready(out)
        samples.append(frames_per_iter * ITERS / (time.perf_counter() - t0))
    return samples


def device_batches(key, dev, seeds=(0, 1)):
    fmt, w, h, batch = bc.input_spec(key)
    return [jax.device_put(bc.make_planes(fmt, w, h, batch, seed=s), dev)
            for s in seeds]


def load_ref(key):
    path = os.path.join(bc.REF_DIR, f"{key}.npy")
    return np.load(path) if os.path.exists(path) else None


def _ref_fresh(key) -> bool:
    if load_ref(key) is None:
        return False
    try:
        with open(os.path.join(bc.REF_DIR, f"{key}.spec.json")) as f:
            return json.load(f) == bc.ref_spec(key)
    except (OSError, ValueError):
        return False


def ensure_refs(keys):
    """float64 references for ``keys`` that are missing or stale, computed
    by ``bench_oracle.py`` in a child process restricted to the CPU."""
    missing = [k for k in keys if not _ref_fresh(k)]
    if missing:
        env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1")
        subprocess.run([sys.executable, "bench_oracle.py", *missing],
                       env=env, check=True, stdout=sys.stderr)


def run_config(key: str, dev) -> tuple[list[float], float]:
    """Returns (fps samples, psnr_db)."""
    plan = bc.build_plan(key)
    batch = bc.input_spec(key)[3]
    bs = device_batches(key, dev)

    if key in ("c5", "c5s"):
        from videorenderer.runner import DeinterlaceSession
        sess = DeinterlaceSession(plan, double_rate=True, pack_surface=True)
        if key == "c5s":
            from videorenderer.ops.overlay import blend_in_rect_packed
            rgb, alpha = bc.subtitle_overlay()
            blend = jax.jit(lambda s: blend_in_rect_packed(
                s, rgb, alpha, x=bc.SUB_X, y=bc.SUB_Y, fmt="rgba8"))
        else:
            blend = lambda s: s
        # stream start: frame 0's first field, window (f0, f0, f1)
        first = [blend(o) for o in sess.push_batch(bs[0])]
        got = bc.decode_output(np.asarray(first[0][0]), plan)
        # two fields per input frame
        samples = measure(lambda i: [blend(o) for o in
                                     sess.push_batch(bs[i % 2])], 2 * batch)
        return samples, bc.psnr_db(got, load_ref(key))

    fn = jax.jit(bc.cell_frame_fn(key, plan))
    rts = [bc.cell_rt(key, i) for i in (0, 1)]
    samples = measure(lambda i: fn(bs[i % 2], rts[i % 2]), batch)
    got = bc.decode_output(np.asarray(fn(bs[0], rts[0])[0]), plan)
    return samples, bc.psnr_db(got, bc.reference_codes(key, plan,
                                                       load_ref(key)))


def main() -> None:
    from videorenderer.compile_cache import enable_compile_cache
    keys = [a for a in sys.argv[1:] if not a.startswith("-")] or bc.ALL_KEYS
    dev = bc.require_gpu()
    enable_compile_cache()
    ensure_refs(keys)
    device = bc.device_record()
    failures = []
    for key in keys:
        samples, psnr = run_config(key, dev)
        bar = bc.PSNR_BAR.get(key, bc.DEFAULT_BAR)
        ok = psnr >= bar
        if not ok:
            failures.append((key, psnr, bar))
        print(json.dumps({"key": key, "config": bc.NAMES[key],
                          "fps_median": float(np.median(samples)),
                          "fps_min": min(samples), "fps_max": max(samples),
                          "psnr_db": psnr, "psnr_ok": ok, "device": device}),
              flush=True)
    if failures:
        print(f"PSNR FAILURES: {failures}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
