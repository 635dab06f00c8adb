#!/usr/bin/env python
"""End-to-end example: a player-like session using the full control surface.

Covers what a reference (MPC VR) integrator would do: open a media type,
configure settings live, attach subtitles and an OSD, process a clip with
real-time pacing and drop accounting, take screenshots, and read the stats.

Run (CPU is fine):
  JAX_PLATFORMS=cpu python examples/playback_session.py
"""

import dataclasses
import sys

import numpy as np

sys.path.insert(0, ".")

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor, VideoRenderer)
from videorenderer.config import Upscaling
from videorenderer.csputils import CSP, Levels
from videorenderer.io.image import save_image
from videorenderer.runner import PresentClock
from videorenderer.subtitles import TextEvent, TextSubtitleProvider


def synth_frame(i, w, h):
    """A moving gradient test pattern in NV12."""
    yy, xx = np.mgrid[0:h, 0:w]
    y = ((xx + yy + 4 * i) % 220 + 16).astype(np.uint8)
    u = np.full((h // 2, w // 2), 128 + 40 * np.sin(i / 8), np.uint8)
    v = np.full((h // 2, w // 2), 128 - 40 * np.cos(i / 8), np.uint8)
    return y, u, v


def main():
    w, h = 640, 360
    fps = 4.0  # a rate the CPU sustains for this demo

    vr = VideoRenderer(Settings(upscaling=Upscaling.LANCZOS3))
    vr.open(SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                             matrix=CSP.BT_709, levels=Levels.TV),
            OutputDescriptor(width=1280, height=720, bits=8))

    # subtitles + a user post-scale shader (vignette), like AddPostScaleShader
    vr.set_subtitle_provider(TextSubtitleProvider(
        [TextEvent(0.5, 2.5, "Hello from videorenderer")], size=20),
        threaded=False)
    vr.flt_set("cmd_addPostScaleShader", lambda rgb: rgb * 0.98 + 0.01)
    vr.flt_set("statsEnable", True)

    # warm up the compiled pipeline before starting the clock (a player
    # would do this while the graph is paused)
    vr.process_frame(synth_frame(0, w, h), time=0.0)

    # quality-managed pacing (renbase2 parity): schedule() runs the full
    # earliness/lateness state machine, sends famine/flood feedback to the
    # supplier hook, and books drops + sync offsets into vr.metrics
    quality_msgs = []
    clock = PresentClock(fps=fps, metrics=vr.metrics,
                         quality_sink=lambda m: (quality_msgs.append(m),
                                                 False)[1])
    for i in range(48):
        if not clock.schedule(i):
            continue                      # dropped: play the next one early
        planes = synth_frame(i, w, h)
        clock.quality.on_render_start()
        out = vr.process_frame(planes, time=i / fps)
        clock.quality.on_render_end()
    if quality_msgs:
        m = quality_msgs[-1]
        print(f"last quality message: {m.kind} proportion={m.proportion}")

    print(vr.get_video_processor_info())
    print("stats:", {k: round(v, 2) if isinstance(v, float) else v
                     for k, v in vr.get_stats().items()})

    save_image("/tmp/vrt_example_frame.png", vr.get_displayed_image())
    print("screenshot -> /tmp/vrt_example_frame.png")


if __name__ == "__main__":
    main()
