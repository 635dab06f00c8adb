#!/usr/bin/env python
"""Multi-stream serving bench: N concurrent media types sharing ONE card
through one VideoRenderer's trace cache — the "many
players on one device" story.  Measures:

 * steady-state throughput while round-robining across N streams whose
   media types all differ (different sizes/transfers/chains), vs the
   single-stream rate — the cost of interleaving programs on one card;
 * media-type switch cost: set_settings/open across already-cached types
   must be retrace-free (the _fn_cache hit path), timed per switch — the
   analogue of Configure's minimal-rebuild promise
   (Source/DX11VideoProcessor.cpp:3812-4062);
 * first-open compile cost per stream (the price of a NEW media type).

Usage: python bench_multistream.py [--streams N] [--iters N] [--batch N]
Prints one JSON line per phase + a summary line.  Refuses to run without a
GPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax

import bench_common as bc
from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.api import VideoRenderer
from videorenderer.config import Upscaling
from videorenderer.csputils import CSP, Levels, Primaries, TRC
from videorenderer.pipeline import HDR10Metadata


def stream_defs(n: int):
    """N distinct media types: different sizes, depths and chains, like N
    players each with their own content."""
    base = [
        # (Settings, SourceDescriptor, OutputDescriptor)
        (Settings(),
         SourceDescriptor(format=ColorFormat.NV12, width=1920, height=1080,
                          matrix=CSP.BT_709),
         OutputDescriptor(width=1920, height=1080, bits=8)),
        (Settings(upscaling=Upscaling.LANCZOS3, convert_to_sdr=True),
         SourceDescriptor(format=ColorFormat.P010, width=3840, height=2160,
                          matrix=CSP.BT_2020_NC, levels=Levels.TV,
                          primaries=Primaries.BT_2020, transfer=TRC.PQ,
                          hdr10=HDR10Metadata()),
         OutputDescriptor(width=1920, height=1080, bits=10)),
        (Settings(upscaling=Upscaling.CATMULL_ROM),
         SourceDescriptor(format=ColorFormat.NV12, width=1280, height=720,
                          matrix=CSP.BT_709),
         OutputDescriptor(width=1920, height=1080, bits=8)),
        (Settings(convert_to_sdr=True),
         SourceDescriptor(format=ColorFormat.P010, width=1920, height=1080,
                          matrix=CSP.BT_2020_NC, levels=Levels.TV,
                          primaries=Primaries.BT_2020, transfer=TRC.HLG),
         OutputDescriptor(width=1920, height=1080, bits=8)),
        (Settings(upscaling=Upscaling.JINC2),
         SourceDescriptor(format=ColorFormat.NV12, width=1920, height=1080,
                          matrix=CSP.BT_709),
         OutputDescriptor(width=2560, height=1440, bits=8)),
        (Settings(),
         SourceDescriptor(format=ColorFormat.NV12, width=3840, height=2160,
                          matrix=CSP.BT_709),
         OutputDescriptor(width=1920, height=1080, bits=8)),
        (Settings(upscaling=Upscaling.LANCZOS2),
         SourceDescriptor(format=ColorFormat.NV12, width=1440, height=1080,
                          matrix=CSP.BT_709),
         OutputDescriptor(width=1920, height=1080, bits=8)),
        (Settings(convert_to_sdr=True, upscaling=Upscaling.CATMULL_ROM),
         SourceDescriptor(format=ColorFormat.P010, width=2560, height=1440,
                          matrix=CSP.BT_2020_NC, levels=Levels.TV,
                          primaries=Primaries.BT_2020, transfer=TRC.PQ),
         OutputDescriptor(width=1920, height=1080, bits=10)),
    ]
    return base[:n]


def make_batch(src: SourceDescriptor, batch: int, seed: int, dev):
    rng = np.random.default_rng(seed)
    w, h = src.width, src.height
    if src.format == ColorFormat.P010:
        planes = (rng.integers(64, 941, (batch, h, w), np.uint16) << 6,
                  rng.integers(64, 961, (batch, h // 2, w // 2),
                               np.uint16) << 6,
                  rng.integers(64, 961, (batch, h // 2, w // 2),
                               np.uint16) << 6)
    else:
        planes = (rng.integers(16, 236, (batch, h, w), np.uint8),
                  rng.integers(16, 241, (batch, h // 2, w // 2), np.uint8),
                  rng.integers(16, 241, (batch, h // 2, w // 2), np.uint8))
    return jax.device_put(planes, dev)


def main() -> None:
    def arg(name, default):
        return (int(sys.argv[sys.argv.index(name) + 1])
                if name in sys.argv else default)
    n_streams = arg("--streams", 6)
    iters = arg("--iters", 6)
    batch = arg("--batch", 16)
    from videorenderer.compile_cache import enable_compile_cache
    dev = bc.require_gpu()
    enable_compile_cache()

    defs = stream_defs(n_streams)
    vr = VideoRenderer(pack_surface=True)
    batches = []

    # -- phase 1: first-open compile cost per stream -------------------------
    opens = []
    for i, (st, src, dst) in enumerate(defs):
        b = make_batch(src, batch, seed=i, dev=dev)
        batches.append(b)
        t0 = time.perf_counter()
        vr.settings = st.validate()
        vr.open(src, dst)
        vr._fn(b).block_until_ready()
        opens.append(time.perf_counter() - t0)
    print(json.dumps({"phase": "first_open_compile_s",
                      "per_stream": opens}),
          flush=True)

    # -- phase 2: switch cost across cached types ----------------------------
    # every open() below must hit the _fn_cache (retrace-free Configure)
    switch = []
    for rep in range(3):
        for i, (st, src, dst) in enumerate(defs):
            t0 = time.perf_counter()
            vr.settings = st.validate()
            vr.open(src, dst)
            switch.append(time.perf_counter() - t0)
    print(json.dumps({"phase": "cached_switch_ms",
                      "median": 1e3 * float(np.median(switch)),
                      "max": 1e3 * float(np.max(switch))}),
          flush=True)

    # -- phase 3: steady-state round-robin serving ---------------------------
    fns = []
    for (st, src, dst) in defs:
        vr.settings = st.validate()
        vr.open(src, dst)
        fns.append(vr._fn)
    # warmup one pass
    out = None
    for fn, b in zip(fns, batches):
        out = fn(b)
    out.block_until_ready()
    t0 = time.perf_counter()
    frames = 0
    for it in range(iters):
        for fn, b in zip(fns, batches):
            out = fn(b)
            frames += batch
    out.block_until_ready()
    rr_fps = frames / (time.perf_counter() - t0)
    print(json.dumps({"phase": "round_robin",
                      "streams": n_streams, "fps_total": rr_fps,
                      "fps_per_stream": rr_fps / n_streams}),
          flush=True)

    # -- phase 4: single-stream reference (stream 0) -------------------------
    fn0, b0 = fns[0], batches[0]
    fn0(b0).block_until_ready()
    t0 = time.perf_counter()
    frames = 0
    for it in range(iters * n_streams):
        out = fn0(b0)
        frames += batch
    out.block_until_ready()
    solo_fps = frames / (time.perf_counter() - t0)
    print(json.dumps({"phase": "single_stream_ref",
                      "fps": solo_fps}), flush=True)

    print(json.dumps({
        "metric": "multistream_serving",
        "streams": n_streams,
        "round_robin_fps": rr_fps,
        "single_stream_fps": solo_fps,
        "cached_switch_ms_median": 1e3 * float(np.median(switch)),
        "note": "round-robin interleaves N different compiled programs on "
                "one card via the _fn_cache; switch cost is the cached "
                "open() (retrace-free Configure)",
        "device": bc.device_record(),
    }), flush=True)


if __name__ == "__main__":
    main()
