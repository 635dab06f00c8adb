#!/usr/bin/env python
"""Headline benchmark: 4K HDR10 -> SDR throughput on one GPU.

Pipeline (BASELINE.json north-star): 4K P010 (PQ, BT.2020 ncl, TV range)
-> chroma upsample (bilinear, MPEG-2 siting) -> YUV->RGB -> Lanczos3
two-pass resize to 1080p (the 50% rule routes a 2:1 shrink through the
interpolation filter, Source/DX11VideoProcessor.cpp:3120-3139) -> PQ EOTF ->
Hable tone-map -> BT.2020->709 gamut -> 2.2 gamma -> ordered dither to
RGB10.

Prints ONE JSON line: {"metric", "value" (frames/s), "unit", "psnr_db"
(vs the float64 oracle), "batch", "device"}.  Refuses to run without a GPU.
``numpy_oracle`` and ``make_frames`` are importable without side effects
(``chip_smoke.py`` uses them).
"""

from __future__ import annotations

import json
import time

import numpy as np

import jax

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                           SourceDescriptor, VideoProcessor)
from videorenderer.config import ChromaScaling, Upscaling
from videorenderer.csputils import (CSP, CSPParams, Colorspace, Levels,
                                        Primaries, TRC, get_csp_matrix,
                                        bt2020_to_bt709_matrix)
from videorenderer.ops.dither import bayer_matrix
from videorenderer.ops.scale import upscale_matrix
from videorenderer.pipeline import HDR10Metadata

W, H = 3840, 2160
OW, OH = 1920, 1080
BATCH = 16
WARMUP = 2
ITERS = 4


def make_frames(batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    y = rng.integers(64, 941, (batch, H, W), dtype=np.uint16) << 6
    u = rng.integers(64, 961, (batch, H // 2, W // 2), dtype=np.uint16) << 6
    v = rng.integers(64, 961, (batch, H // 2, W // 2), dtype=np.uint16) << 6
    return y, u, v


def numpy_oracle(y, u, v):
    """float64 reference of the exact same math (vectorized numpy)."""
    yf = y.astype(np.float64) / 65535.0
    uf = u.astype(np.float64) / 65535.0
    vf = v.astype(np.float64) / 65535.0

    def up420_bilinear_mpeg2(c):
        # horizontal phases: even exact, odd avg(k,k+1); vertical: (1/4,3/4)
        ce = c
        cn = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
        hx = np.empty((c.shape[0], c.shape[1] * 2))
        hx[:, 0::2] = ce
        hx[:, 1::2] = 0.5 * (ce + cn)
        up = np.concatenate([hx[:1], hx[:-1]], axis=0)
        dn = np.concatenate([hx[1:], hx[-1:]], axis=0)
        out = np.empty((hx.shape[0] * 2, hx.shape[1]))
        out[0::2] = 0.25 * up + 0.75 * hx
        out[1::2] = 0.75 * hx + 0.25 * dn
        return out

    uu = up420_bilinear_mpeg2(uf)
    vv = up420_bilinear_mpeg2(vf)
    cm = get_csp_matrix(CSPParams(color=Colorspace(CSP.BT_2020_NC, Levels.TV),
                                  input_bits=16, texture_bits=16))
    rgb = np.stack([cm.m[i, 0] * yf + cm.m[i, 1] * uu + cm.m[i, 2] * vv + cm.c[i]
                    for i in range(3)])

    mx = upscale_matrix(Upscaling.LANCZOS3, W, OW)
    my = upscale_matrix(Upscaling.LANCZOS3, H, OH)
    rgb = np.einsum("chw,wx->chx", rgb, mx)
    rgb = np.einsum("chw,hy->cyw", rgb, my)

    x = np.clip(rgb, 0.0, 1.0)
    m1, m2 = 2610 / 16384, 2523 / 4096 * 128
    c1, c2, c3 = 3424 / 4096, 2413 / 4096 * 32, 2392 / 4096 * 32
    x = np.power(np.maximum(x, 0), 1 / m2)
    x = np.maximum(x - c1, 0) / (c2 - c3 * x)
    x = np.power(x, 1 / m1) * (10000.0 / 125.0)

    def hable(q):
        A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        return ((q * (A * q + C * B) + D * E) / (q * (A * q + B) + D * F)) - E / F

    x = hable(x) / hable(np.float64(4.8))
    gm = bt2020_to_bt709_matrix()
    x = np.einsum("ij,jhw->ihw", gm, x)
    x = np.power(np.clip(x, 0, 1), 1 / 2.2)

    d = np.tile(bayer_matrix(32).astype(np.float64),
                ((OH + 31) // 32, (OW + 31) // 32))[:OH, :OW]
    return np.floor(np.clip(x, 0, 1) * 1023.0 + d) / 1023.0


def headline_settings():
    """The headline chain's (Settings, Source, Output)."""
    src = SourceDescriptor(format=ColorFormat.P010, width=W, height=H,
                           matrix=CSP.BT_2020_NC, levels=Levels.TV,
                           primaries=Primaries.BT_2020, transfer=TRC.PQ,
                           hdr10=HDR10Metadata())
    dst = OutputDescriptor(width=OW, height=OH, bits=10, hdr=False)
    st = Settings(upscaling=Upscaling.LANCZOS3,
                  chroma_scaling=ChromaScaling.BILINEAR,
                  convert_to_sdr=True, use_dither=True)
    return st, src, dst


def decode_rgb10(packed) -> np.ndarray:
    """R10G10B10A2 dwords -> (3, H, W) float codes."""
    d = np.asarray(packed).view(np.uint32)
    return np.stack([(d >> sh) & 0x3FF for sh in (0, 10, 20)],
                    axis=0).astype(np.float64) / 1023.0


def main() -> None:
    import bench_common as bc
    from videorenderer.compile_cache import enable_compile_cache

    dev = bc.require_gpu()
    enable_compile_cache()
    # packed-surface output: R10G10B10A2 dwords, the swap-chain backbuffer
    # the reference presents into (DXGI_FORMAT_R10G10B10A2_UNORM)
    vp = VideoProcessor(*headline_settings(), pack_surface=True)

    # distinct input batches so nothing can be cached/deduped
    batches = [tuple(jax.device_put(p, dev) for p in make_frames(BATCH, k))
               for k in range(2)]
    for _ in range(WARMUP + 1):
        vp.process(batches[0]).block_until_ready()
    t0 = time.perf_counter()
    for i in range(ITERS):
        out = vp.process(batches[i % 2])
    out.block_until_ready()
    fps = BATCH * ITERS / (time.perf_counter() - t0)

    # PSNR vs float64 oracle on frame 0 of the seed-0 batch (the pack is
    # lossless on the 10-bit dithered values)
    got = decode_rgb10(vp.process(batches[0])[0])
    y0, u0, v0 = make_frames(BATCH, seed=0)
    mse = np.mean((got - numpy_oracle(y0[0], u0[0], v0[0])) ** 2)
    psnr = float(10 * np.log10(1.0 / mse)) if mse > 0 else float("inf")

    print(json.dumps({
        "metric": "4K HDR10->SDR frames/s (P010->RGB10, Lanczos3 + "
                  "tone-map + dither, packed surface out)",
        "value": fps, "unit": "frames/s", "psnr_db": psnr,
        "batch": BATCH, "device": bc.device_record(),
    }))


if __name__ == "__main__":
    main()
