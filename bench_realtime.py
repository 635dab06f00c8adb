#!/usr/bin/env python
"""Host-fed real-time sustain test: can the full end-to-end loop hold a
display rate with the quality manager in charge?

The reference's contract is per-frame: render within the frame duration,
drop when late (Source/DX11VideoProcessor.cpp:2176-2197, renbase2.h:46-68).
This harness plays N seconds of a clip at a target rate through
``PresentClock.schedule`` (the renbase2 quality loop) with a depth-2
dispatch queue (the swap-chain presentation model) and reports drops and
sync statistics — the end-to-end "sustains 4K60" verdict.

Two feeds per config:
 * device — frames pre-staged on the card (isolates the render path);
 * host — jax.device_put per frame inside the loop (the PCIe upload a
   player pays: ~25 MB per 4K P010 frame).

Refuses to run without a GPU.

Usage: python bench_realtime.py [--fps 60] [--seconds 5] [keys...]
  (default keys: c1 c4; add c2/c7/c8 freely; ``c5deint`` runs the
  double-rate deinterlace chain at ``--fps`` fields/s, default 120)
"""

from __future__ import annotations

import json
import sys
import time

import jax

import bench_common as bc
from videorenderer.pipeline import make_frame_fn
from videorenderer.runner import PresentClock
from videorenderer.stats import Metrics

DEFAULT_KEYS = ["c1", "c4"]
POOL = 8              # distinct frames cycled through the clip


def run(key: str, fps: float, seconds: float, dev) -> None:
    plan = bc.build_plan(key)
    fmt, w, h, _ = bc.input_spec(key)
    host_frames = [bc.make_planes(fmt, w, h, 1, seed=s) for s in range(POOL)]
    dev_frames = [jax.device_put(f, dev) for f in host_frames]
    fn = jax.jit(make_frame_fn(plan, pack_surface=True))
    fn(dev_frames[0]).block_until_ready()
    n = int(fps * seconds)

    for feed in ("device", "host"):
        metrics = Metrics()
        clock = PresentClock(fps=fps, metrics=metrics)
        prev = None
        rendered = 0
        t0 = time.perf_counter()
        for i in range(n):
            if not clock.schedule(i):
                continue
            clock.quality.on_render_start()
            if feed == "host":
                planes = jax.device_put(host_frames[i % POOL], dev)
            else:
                planes = dev_frames[i % POOL]
            cur = fn(planes)            # dispatch frame i
            if prev is not None:
                prev.block_until_ready()   # depth-2: wait for frame i-1
            prev = cur
            clock.quality.on_render_end()
            rendered += 1
        if prev is not None:
            prev.block_until_ready()
        wall = time.perf_counter() - t0
        snap = metrics.snapshot()
        print(json.dumps({
            "config": key, "feed": feed, "target_fps": fps,
            "frames": n, "rendered": rendered,
            "dropped": clock.dropped,
            "drop_pct": 100.0 * clock.dropped / n,
            "wall_s": wall,
            "sustained": clock.dropped == 0 and wall <= seconds * 1.02,
            "avg_sync_offset_ms": snap["avg_sync_offset_ms"],
            "dev_sync_offset_ms": snap["dev_sync_offset_ms"],
            "device": bc.device_record(),
        }), flush=True)


def run_deint_double_rate(fps: float, seconds: float, dev,
                          depth: int = 2) -> None:
    """Double-rate deinterlace sustain: the c5 chain through
    PresentClock.schedule at a device-fed ``fps`` (120 Hz = the 8.3 ms/field
    contract).  Each schedule tick is one FIELD; even ticks run the
    dual-field program for the next source frame (both fields of one
    program — the reference's field-2-at-+duration/2 model,
    Source/DX11VideoProcessor.cpp:2176-2197), odd ticks present the
    already-computed second field.  ``depth``: wait for every
    ``depth``-th present (2 = the swap-chain depth-2 model; in-order
    execution retires everything dispatched before it)."""
    from videorenderer.runner import DeinterlaceSession
    plan = bc.build_plan("c5")
    fmt, w, h, _ = bc.input_spec("c5")
    host_frames = [bc.make_planes(fmt, w, h, 1, seed=s) for s in range(POOL)]
    dev_frames = [jax.device_put(f, dev) for f in host_frames]
    n = int(fps * seconds)

    sess = DeinterlaceSession(plan, double_rate=True, pack_surface=True)
    pend = []
    for i in range(3):                 # prime the 3-frame window + compile
        pend = sess.push_batch(dev_frames[i % POOL])
    jax.block_until_ready(pend)

    metrics = Metrics()
    clock = PresentClock(fps=fps, metrics=metrics)
    rendered = 0
    last = None
    fi = 3
    t0 = time.perf_counter()
    for j in range(n):
        if j % 2 == 0:                 # the next sample arrives
            pend = sess.push_batch(dev_frames[fi % POOL])
            fi += 1
        if not clock.schedule(j):
            continue                   # this field's present is dropped
        clock.quality.on_render_start()
        out = pend[j % 2] if len(pend) > j % 2 else None
        if out is not None:
            last = out
            rendered += 1
            if rendered % depth == 0:
                out.block_until_ready()   # retires everything before it
        clock.quality.on_render_end()
    if last is not None:
        last.block_until_ready()
    wall = time.perf_counter() - t0
    snap = metrics.snapshot()
    print(json.dumps({
        "config": "c5 double-rate (fields)", "feed": "device",
        "queue_depth": depth,
        "target_fps": fps, "frames": n, "rendered": rendered,
        "dropped": clock.dropped,
        "drop_pct": 100.0 * clock.dropped / n,
        "wall_s": wall,
        "sustained": clock.dropped == 0 and wall <= seconds * 1.02,
        "avg_sync_offset_ms": snap["avg_sync_offset_ms"],
        "dev_sync_offset_ms": snap["dev_sync_offset_ms"],
        "device": bc.device_record(),
    }), flush=True)


def main() -> None:
    argv = sys.argv[1:]

    def arg(name, default, cast=float):
        return cast(argv[argv.index(name) + 1]) if name in argv else default
    fps = arg("--fps", 60.0)
    seconds = arg("--seconds", 5.0)
    keys = [a for a in argv if not a.startswith("-")
            and not a.replace(".", "").isdigit()] or DEFAULT_KEYS
    from videorenderer.compile_cache import enable_compile_cache
    dev = bc.require_gpu()
    enable_compile_cache()
    for key in keys:
        if key == "c5deint":
            run_deint_double_rate(arg("--fps", 120.0), seconds, dev,
                                  depth=arg("--depth", 2, int))
        else:
            run(key, fps, seconds, dev)


if __name__ == "__main__":
    main()
