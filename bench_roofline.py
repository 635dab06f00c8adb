#!/usr/bin/env python
"""Roofline share per bench config, from an ANALYTIC traffic/FLOP model of
the XLA path and a measured frame rate:

 * bytes/frame — input planes, the explicit full-size float32
   intermediates (write + read), and the output surface;
 * dense FLOPs/frame — every resample is a dense (in, out) float32 matrix
   product at Precision.HIGHEST, so it costs 2 x rows x in x out whatever
   the filter's band (the waste ROADMAP Speed item 2 targets); the learned
   rows add their bf16 conv FLOPs from the parameter shapes.

The least time a frame could take is the larger of FLOPs over the peak
rate and bytes over the peak bandwidth; the roofline share is that over the
measured time.  Peaks come from ``PEAKS``, keyed by ``device_kind``; a device
that is not in the table is an error.  The peaks are the data sheet's, at
the part's full power limit: a card set lower (``card`` in each row, as
``nvidia-smi`` reports it) cannot reach them, so its shares read low.

The model is host arithmetic and never opens the card: the script runs
JAX on the CPU, so it may follow ``bench_configs.py`` on the same machine.

Usage:
  python bench_roofline.py results.jsonl   # bench_configs.py output lines
  python bench_roofline.py --print         # the model alone, per config
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

os.environ["JAX_PLATFORMS"] = "cpu"

import bench_common as bc  # noqa: E402
from videorenderer.formats import ColorSystem

# Published dense peaks, no sparsity (NVIDIA H100 Tensor Core GPU data
# sheet, SXM part, at its 700 W power limit).  float32 products at HIGHEST
# run outside the tensor cores, so their roof is the plain fp32 rate.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_tflops": 67.0, "tf32_tflops": 495.0,
                              "bf16_tflops": 989.0, "hbm_gbps": 3350.0,
                              "source": "NVIDIA H100 data sheet, SXM, 700 W"},
}


def peaks_for(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; add "
                       "them to bench_roofline.PEAKS with their source")
    return PEAKS[kind]


def _geometry(plan):
    info, src, dst = plan.info, plan.src, plan.dst
    dw, dh = info.chroma_div if info.cs_type == ColorSystem.YUV else (1, 1)
    vid_w, vid_h = dst.video_size
    return info, src.width, src.height, dw, dh, vid_w, vid_h


def _in_bytes(plan) -> float:
    info, w, h, dw, dh, _, _ = _geometry(plan)
    b = 2 if info.plane_bits > 8 else 1
    return w * h * b * (1 + 2 / (dw * dh))


def _dense_resample(plan, w, h, vid_w, vid_h, dw, dh, chans_full=1,
                    chans_sub=2):
    """(FLOPs, intermediate bytes) of W-then-H dense products: luma-size
    planes ``chans_full`` and chroma planes ``chans_sub`` (their composed
    maps read the subsampled plane)."""
    flops = inter = 0.0
    for n, sub_w, sub_h in ((chans_full, 1, 1), (chans_sub, dw, dh)):
        pw, ph = w // sub_w, h // sub_h
        if w != vid_w or sub_w > 1:      # the (composed) W map exists
            flops += n * 2.0 * ph * pw * vid_w
            inter += n * 2 * 4.0 * ph * vid_w          # f32 write + read
        if h != vid_h or sub_h > 1:
            flops += n * 2.0 * vid_w * ph * vid_h
    return flops, inter


def _conv_flops(params, domain_px: float) -> float:
    import jax
    return 2.0 * domain_px * sum(
        int(np.prod(np.shape(a))) for a in jax.tree_util.tree_leaves(params)
        if np.ndim(a) == 4)


def config_model(key: str) -> dict:
    """{'bytes', 'flops_f32', 'flops_bf16', 'note'} per output frame (per
    field for the double-rate deinterlace cells)."""
    plan = bc.build_plan(key)
    info, w, h, dw, dh, vid_w, vid_h = _geometry(plan)
    out = 4.0 * vid_w * vid_h
    by = _in_bytes(plan) + out

    if key in ("c3", "c3rot"):
        from videorenderer.ops import scale as scale_ops
        qy, _ = scale_ops._phase_period(h, vid_h)
        qx, _ = scale_ops._phase_period(w, vid_w)
        by += 2 * 3 * 4.0 * w * h                      # f32 RGB at source
        if qy <= 8 and qx <= 8:
            return {"bytes": by, "flops_f32": 3 * 16 * 2.0 * vid_w * vid_h,
                    "flops_bf16": 0.0, "note": "jinc2 phases (elementwise)"}
        k = len(scale_ops.jinc2_lr_matrices(h, vid_h, w, vid_w)[0])
        fl = k * 3 * (2.0 * h * w * vid_w + 2.0 * vid_w * h * vid_h)
        by += k * 3 * 2 * 4.0 * h * vid_w
        return {"bytes": by, "flops_f32": fl, "flops_bf16": 0.0,
                "note": f"jinc2 low-rank K={k}, dense"}

    if key in ("c3sr", "c1vh"):
        params, cfg = (bc.superres_params() if key == "c3sr"
                       else bc.videohdr_params())
        s2d = getattr(cfg, "s2d", 1)
        fl, inter = _dense_resample(plan, w, h, vid_w, vid_h, dw, dh)
        scale = getattr(cfg, "scale", 1) if key == "c3sr" else 1
        return {"bytes": by + inter + 3 * 4.0 * w * h
                + out * (scale * scale - 1),
                "flops_f32": fl,
                "flops_bf16": _conv_flops(params, (h // s2d) * (w // s2d)),
                "note": f"conv net s2d={s2d}"}

    if key == "c8":
        # stage A: chroma upsampled to source res; stage B: dense RGB resize
        fa = 2 * (2.0 * (h // dh) * (w // dw) * w + 2.0 * w * (h // dh) * h)
        fb, inter = _dense_resample(plan, w, h, vid_w, vid_h, 1, 1,
                                    chans_full=3, chans_sub=0)
        return {"bytes": by + inter + 2 * 3 * 4.0 * w * h,
                "flops_f32": fa + fb, "flops_bf16": 0.0,
                "note": "DoVi split-fused"}

    fl, inter = _dense_resample(plan, w, h, vid_w, vid_h, dw, dh)
    if key in ("c5", "c5s"):
        # per output FIELD (the rate bench_configs reports for these
        # cells): half of the 3-frame window read, one resampled field
        return {"bytes": 1.5 * _in_bytes(plan) + inter + out,
                "flops_f32": fl, "flops_bf16": 0.0,
                "note": "per field, 2 fields/frame"}
    return {"bytes": by + inter, "flops_f32": fl, "flops_bf16": 0.0,
            "note": "fused, dense maps"}


def roofline_row(key: str, fps: float, kind: str, card: str = "") -> dict:
    pk = peaks_for(kind)
    m = config_model(key)
    t_flop = (m["flops_f32"] / (pk["fp32_tflops"] * 1e12)
              + m["flops_bf16"] / (pk["bf16_tflops"] * 1e12))
    t_mem = m["bytes"] / (pk["hbm_gbps"] * 1e9)
    t_min = max(t_flop, t_mem)
    return {"key": key, "fps": fps, "device_kind": kind, "card": card,
            "peaks": pk["source"], "roofline_share": t_min * fps,
            "bound": "compute" if t_flop >= t_mem else "memory",
            "gflop_per_frame": (m["flops_f32"] + m["flops_bf16"]) / 1e9,
            "mb_per_frame": m["bytes"] / 1e6, "note": m["note"]}


def main() -> None:
    if "--print" in sys.argv:
        for key in bc.ALL_KEYS:
            print(json.dumps({"key": key, **config_model(key)}))
        return
    with open(sys.argv[1]) as f:
        for line in f:
            r = json.loads(line) if line.startswith("{") else {}
            if "fps_median" in r:
                dev = r["device"]
                print(json.dumps(roofline_row(r["key"], r["fps_median"],
                                              dev["kind"],
                                              dev.get("card", ""))))


if __name__ == "__main__":
    main()
