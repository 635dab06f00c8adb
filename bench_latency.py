#!/usr/bin/env python
"""Real-time latency benchmark: per-frame (batch-1) render cost vs the
frame budget, on one GPU.

The reference's only implied performance contract is *real-time playback*:
render one frame in under its duration, twice per frame for double-rate
deinterlacing, drop the second field if late
(Source/DX11VideoProcessor.cpp:2176-2197, Source/renbase2.h:46-68).
This harness measures that at batch 1 per config:

 * ``latency_ms``  — median dispatch -> ``block_until_ready`` per-frame
   latency (what a present-blocking loop sees);
 * ``interval_ms`` — median steady-state frame interval with a dispatch
   queue depth of 2 (dispatch frame k, then wait for frame k-1) — the
   reference's swap-chain-queue presentation model
   (Source/DX11VideoProcessor.cpp:1494-1500: 1-6 buffered presents);
 * ``realtime_60``/``realtime_120`` — the depth-2 interval under
   16.67/8.33 ms.

Inputs are device-resident; refuses to run without a GPU.

Usage: python bench_latency.py [keys...]   (default: c1 c1vh c3 c3sr c4 c5 c8)
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax

import bench_common as bc

N = 30          # timed frames per config
WARMUP = 4
DEFAULT_KEYS = ["c1", "c1vh", "c3", "c3sr", "c4", "c5", "c8"]


def build_dispatch(key: str, dev):
    """Returns (dispatch(i) -> device array, frames_per_dispatch)."""
    plan = bc.build_plan(key)
    fmt, w, h, _ = bc.input_spec(key)
    # two alternating single-frame inputs so no dispatch can be deduped
    frames = [jax.device_put(bc.make_planes(fmt, w, h, 1, seed=s), dev)
              for s in (0, 1)]
    if key in ("c5", "c5s"):
        from videorenderer.pipeline import make_deint_fields_fn
        fn = jax.jit(make_deint_fields_fn(plan, pack_surface=True))
        # one dispatch = both fields of frame cur (2 presented frames)
        return (lambda i: fn(frames[i % 2], frames[(i + 1) % 2],
                             frames[i % 2])[1]), 2
    fn = jax.jit(bc.cell_frame_fn(key, plan))
    rts = [bc.cell_rt(key, i) for i in (0, 1)]
    return (lambda i: fn(frames[i % 2], rts[i % 2])), 1


def run_config(key: str, dev) -> dict:
    dispatch, fpd = build_dispatch(key, dev)
    for i in range(WARMUP):
        out = dispatch(i)
    out.block_until_ready()

    # blocking per-frame latency
    lat = []
    for i in range(N):
        t0 = time.perf_counter()
        dispatch(i).block_until_ready()
        lat.append((time.perf_counter() - t0) * 1e3 / fpd)

    # depth-2 pipelined interval: dispatch k, wait for k-1
    prev = dispatch(0)
    intervals = []
    t_last = time.perf_counter()
    for i in range(1, N + 1):
        cur = dispatch(i)
        prev.block_until_ready()
        now = time.perf_counter()
        intervals.append((now - t_last) * 1e3 / fpd)
        t_last = now
        prev = cur
    prev.block_until_ready()

    med_lat = float(np.median(lat))
    med_int = float(np.median(intervals))
    return {"config": bc.NAMES[key],
            "latency_ms": med_lat,
            "latency_minmax_ms": [min(lat), max(lat)],
            "interval_ms": med_int,
            "realtime_60": med_int < 1000.0 / 60.0,
            "realtime_120": med_int < 1000.0 / 120.0}


def main() -> None:
    from videorenderer.compile_cache import enable_compile_cache
    keys = [a for a in sys.argv[1:] if not a.startswith("-")] or DEFAULT_KEYS
    dev = bc.require_gpu()
    enable_compile_cache()
    device = bc.device_record()
    for key in keys:
        print(json.dumps({**run_config(key, dev), "device": device}),
              flush=True)


if __name__ == "__main__":
    main()
