#!/usr/bin/env python
"""End-to-end streaming benchmark: host-fed frames through ``runner.run_clip``.

Does ``run_clip``'s issue-transfer-before-compute structure actually
overlap host->device copies with compute on the card?  Three modes over
identical inputs:

 * ``device``  — batches pre-uploaded, dispatch-only (upper bound);
 * ``overlap`` — ``runner.run_clip``: batch k+1's ``device_put`` is issued
   before batch k's compute is awaited (the reference's copy/paint overlap
   through the swap-chain queue, Source/DX11VideoProcessor.cpp:2143-2200);
 * ``serial``  — upload, SYNC, compute, SYNC per batch (no overlap).

Prints one JSON line with each mode's frames/s plus ``overlap_gain`` =
serial_time / overlap_time.  Gain > 1 demonstrates real copy/compute
overlap; gain ~= 1 means the transfers serialize.  Refuses to run without a
GPU.

Usage: python bench_stream.py [--4k] [--batches N] [--batch B]
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax

import bench_common as bc


def build(four_k: bool):
    from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                                   SourceDescriptor)
    from videorenderer.config import ChromaScaling, Upscaling
    from videorenderer.csputils import CSP, Levels, Primaries, TRC
    from videorenderer.pipeline import (HDR10Metadata, make_frame_fn,
                                            plan_pipeline)
    if four_k:
        src = SourceDescriptor(format=ColorFormat.P010, width=3840,
                               height=2160, matrix=CSP.BT_2020_NC,
                               levels=Levels.TV, primaries=Primaries.BT_2020,
                               transfer=TRC.PQ, hdr10=HDR10Metadata())
        dst = OutputDescriptor(width=1920, height=1080, bits=10)
        st = Settings(upscaling=Upscaling.LANCZOS3,
                      chroma_scaling=ChromaScaling.BILINEAR,
                      convert_to_sdr=True, use_dither=True)
    else:
        src = SourceDescriptor(format=ColorFormat.NV12, width=1920,
                               height=1080, matrix=CSP.BT_709,
                               levels=Levels.TV)
        dst = OutputDescriptor(width=1920, height=1080, bits=8)
        st = Settings(chroma_scaling=ChromaScaling.BILINEAR)
    plan = plan_pipeline(st, src, dst)
    return jax.jit(make_frame_fn(plan, pack_surface=True)), src


def host_batches(src, batch: int, n: int):
    out = []
    for k in range(n):
        rng = np.random.default_rng(k)
        h, w = src.height, src.width
        if src.format.name == "P010":
            out.append((
                rng.integers(64, 941, (batch, h, w), np.uint16) << 6,
                rng.integers(64, 961, (batch, h // 2, w // 2), np.uint16) << 6,
                rng.integers(64, 961, (batch, h // 2, w // 2), np.uint16) << 6))
        else:
            out.append((
                rng.integers(16, 236, (batch, h, w), np.uint8),
                rng.integers(16, 241, (batch, h // 2, w // 2), np.uint8),
                rng.integers(16, 241, (batch, h // 2, w // 2), np.uint8)))
    return out


def run_modes(fn, batches, dev):
    from videorenderer.runner import run_clip
    batch = batches[0][0].shape[0]
    n_frames = batch * len(batches)

    # compile + warm the transfer path
    warm = tuple(jax.device_put(p, dev) for p in batches[0])
    fn(warm).block_until_ready()

    results = {}

    # device-resident upper bound (two alternating pre-uploaded batches)
    dev_b = [tuple(jax.device_put(p, dev) for p in b) for b in batches[:2]]
    t0 = time.perf_counter()
    for i in range(len(batches)):
        out = fn(dev_b[i % 2])
    out.block_until_ready()
    results["device"] = n_frames / (time.perf_counter() - t0)

    # overlapped host feed (run_clip)
    t0 = time.perf_counter()
    res = run_clip(fn, iter(batches), device=dev)
    res.outputs[-1].block_until_ready()
    t_overlap = time.perf_counter() - t0
    results["overlap"] = n_frames / t_overlap

    # strict serial: upload, sync, compute, sync
    t0 = time.perf_counter()
    for b in batches:
        cur = jax.block_until_ready(
            tuple(jax.device_put(p, dev) for p in b))
        fn(cur).block_until_ready()
    t_serial = time.perf_counter() - t0
    results["serial"] = n_frames / t_serial

    results["overlap_gain"] = t_serial / t_overlap
    return results


def main() -> None:
    four_k = "--4k" in sys.argv
    def arg(name, default):
        return (int(sys.argv[sys.argv.index(name) + 1])
                if name in sys.argv else default)
    batch = arg("--batch", 8 if four_k else 16)
    n = arg("--batches", 8)
    from videorenderer.compile_cache import enable_compile_cache
    dev = bc.require_gpu()
    enable_compile_cache()
    fn, src = build(four_k)
    batches = host_batches(src, batch, n)
    r = run_modes(fn, batches, dev)
    print(json.dumps({
        "metric": ("4K HDR10->SDR" if four_k else "1080p SDR 1:1")
                  + " host-fed streaming (frames/s, incl. host->device feed)",
        "device_resident_fps": r["device"],
        "overlapped_fps": r["overlap"],
        "serial_fps": r["serial"],
        "overlap_gain": r["overlap_gain"],
        "batch": batch, "batches": n, "device": bc.device_record(),
    }))


if __name__ == "__main__":
    main()
