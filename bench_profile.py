#!/usr/bin/env python
"""Device-time profile of one cell from a ``jax.profiler`` trace: where do
the microseconds of a frame go on the GPU?

Runs a cell's program (default: the headline chain, 4K P010 -> 1080p RGB10,
Lanczos3 + PQ->SDR + dither, packed surface), times an untraced window with
``block_until_ready``, then traces a second window and reduces the trace's
GPU kernel events: device busy time per frame, the idle share of the
window, the share of matrix-product kernels (the resize/chroma dots, which
XLA hands to cuBLAS/CUTLASS), and the top kernels by time.  The trace is
kept under ``.jax_profile/<key>/`` in the checkout.  Refuses to run
without a GPU.

Usage: python bench_profile.py [--batch N] [--iters N] [key]
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
import time

import jax

import bench_common as bc

GEMM = re.compile(r"gemm|cublas|cutlass|xmma|dot", re.I)


def _intervals_union(iv):
    total, end = 0, None
    for s, e in sorted(iv):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str) -> dict:
    """GPU kernel events of an ``.xplane.pb``: busy ns (union over
    streams), window ns, per-kernel-name totals and the product share."""
    pd = jax.profiler.ProfileData.from_file(path)
    iv, per_name, lines_seen = [], {}, set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines_seen.add(line.name)
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                iv.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_name[ev.name] = per_name.get(ev.name, 0) + ev.duration_ns
    if not iv:
        raise RuntimeError(f"no GPU kernel events in {path}; lines seen: "
                           f"{sorted(lines_seen)}")
    kernel_ns = sum(per_name.values())
    gemm_ns = sum(v for k, v in per_name.items() if GEMM.search(k))
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_ns": _intervals_union(iv),
            "window_ns": max(e for _, e in iv) - min(s for s, _ in iv),
            "kernel_ns": kernel_ns, "gemm_ns": gemm_ns,
            "gemm_share": gemm_ns / kernel_ns,
            "top_kernels": [(k[:120], v) for k, v in top],
            "lines": sorted(lines_seen)}


def main() -> None:
    from videorenderer.compile_cache import enable_compile_cache
    from videorenderer.pipeline import make_frame_fn, plan_pipeline

    def arg(name, default):
        return (int(sys.argv[sys.argv.index(name) + 1])
                if name in sys.argv else default)
    batch = arg("--batch", 8)
    iters = arg("--iters", 4)
    keys = [a for a in sys.argv[1:] if not a.startswith("-")
            and not a.isdigit()]
    key = keys[0] if keys else "headline"
    dev = bc.require_gpu()
    enable_compile_cache()

    if key == "headline":
        import bench
        fn = jax.jit(make_frame_fn(plan_pipeline(*bench.headline_settings()),
                                   pack_surface=True))
        planes = jax.device_put(bench.make_frames(batch, seed=0), dev)
        call = lambda: fn(planes)
    else:
        plan = bc.build_plan(key)
        fmt, w, h, _ = bc.input_spec(key)
        planes = jax.device_put(bc.make_planes(fmt, w, h, batch), dev)
        fn = jax.jit(bc.cell_frame_fn(key, plan))
        rt = bc.cell_rt(key, 0)
        call = lambda: fn(planes, rt)

    for _ in range(3):
        call().block_until_ready()
    t0 = time.perf_counter()
    outs = [call() for _ in range(iters)]
    jax.block_until_ready(outs)
    ms = (time.perf_counter() - t0) * 1e3 / (iters * batch)

    out_dir = os.path.join(".jax_profile", key)
    with jax.profiler.trace(out_dir):
        outs = [call() for _ in range(iters)]
        jax.block_until_ready(outs)
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    red = reduce_trace(path)
    frames = iters * batch
    print(json.dumps({
        "cell": key, "batch": batch, "iters": iters,
        "ms_per_frame_untraced": ms,
        "device_busy_ms_per_frame": red["busy_ns"] / 1e6 / frames,
        "idle_share_of_window": 1.0 - red["busy_ns"] / red["window_ns"],
        "gemm_share_of_kernel_time": red["gemm_share"],
        "gemm_ms_per_frame": red["gemm_ns"] / 1e6 / frames,
        "top_kernels_ms_per_frame": [(k, v / 1e6 / frames)
                                     for k, v in red["top_kernels"]],
        "trace_lines": red["lines"], "trace": path,
        "device": bc.device_record(),
    }))


if __name__ == "__main__":
    main()
