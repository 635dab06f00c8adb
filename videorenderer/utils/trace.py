"""Tracing / profiling utilities — the QPC-instrumentation analogue
(Source/Times.h:23-26, CRenderStats tick counters) plus device-side
profiling via the XLA profiler.

``stage_timer`` gives host-side per-stage wall times (feeding
stats.RenderStats, like the reference's copy/paint/present ticks around
each stage, Source/DX11VideoProcessor.cpp:2606,2802,2818).  ``device_trace``
wraps ``jax.profiler.trace`` so a processing run can be inspected in
TensorBoard/Perfetto; ``annotate`` adds named regions.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import jax

log = logging.getLogger("videorenderer")


@contextlib.contextmanager
def stage_timer(stats_obj, field: str):
    """Accumulate elapsed seconds into ``stats_obj.<field>``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        setattr(stats_obj, field,
                getattr(stats_obj, field) + (time.perf_counter() - t0))


@contextlib.contextmanager
def device_trace(logdir: str = "/tmp/vrt_trace"):
    """Capture an XLA device trace for the enclosed region."""
    os.makedirs(logdir, exist_ok=True)
    with jax.profiler.trace(logdir):
        yield
    log.info("device trace written to %s", logdir)


def annotate(name: str):
    """Named region visible in device traces (TraceAnnotation analogue)."""
    return jax.profiler.TraceAnnotation(name)


def dlog(fmt: str, *args) -> None:
    """DLog analogue (Utils/Util.h:20-37): debug-level, compiled out unless
    the logger is enabled."""
    if log.isEnabledFor(logging.DEBUG):
        log.debug(fmt, *args)
