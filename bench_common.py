"""Shared definitions for the per-config benchmark suite.

Used by two kinds of process:
 * ``bench_configs.py`` and ``chip_smoke.py`` — run every config (cell) on
   the GPU;
 * ``bench_oracle.py`` — run with ``JAX_PLATFORMS=cpu JAX_ENABLE_X64=1``,
   it never opens the card and computes a float64 reference for frame 0 of
   each config's inputs through the framework's own *staged* path (the
   reference-order math; at float64 the operation order is immaterial at
   the 55 dB scale), cached under ``.bench_refs/``.

This gives every cell an on-card accuracy gate (PSNR vs float64) from one
source of truth for the config definitions.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.config import (ChromaScaling, Downscaling,
                                      SuperResolution, ToneMapType, Upscaling)
from videorenderer.csputils import CSP, Levels, Primaries, TRC
from videorenderer.pipeline import HDR10Metadata, plan_pipeline

REF_DIR = ".bench_refs"

# subtitle overlay geometry for config 5s (bottom-third subtitle band)
SUB_W, SUB_H, SUB_X, SUB_Y = 800, 96, 560, 950


# bump when the generation scheme changes: ensure_refs() compares this (via
# the .spec.json sidecar) so stale float64 references regenerate instead of
# silently gating PSNR against inputs that no longer match
RNG_SCHEME = 2


def make_planes(fmt: ColorFormat, w, h, batch, seed=0):
    # one independent rng per plane: frame i's content must not depend on
    # the batch size (a single sequential rng made frame 0's chroma shift
    # whenever a config's timing batch was retuned, silently invalidating
    # the cached float64 references)
    rngs = [np.random.default_rng((seed, i)) for i in range(3)]
    if fmt == ColorFormat.NV12:
        return (rngs[0].integers(16, 236, (batch, h, w), np.uint8),
                rngs[1].integers(16, 241, (batch, h // 2, w // 2), np.uint8),
                rngs[2].integers(16, 241, (batch, h // 2, w // 2), np.uint8))
    if fmt == ColorFormat.P010:
        return (rngs[0].integers(64, 941, (batch, h, w), np.uint16) << 6,
                rngs[1].integers(64, 961, (batch, h // 2, w // 2),
                                 np.uint16) << 6,
                rngs[2].integers(64, 961, (batch, h // 2, w // 2),
                                 np.uint16) << 6)
    raise ValueError(fmt)


def ref_spec(key: str) -> dict:
    """Identity of a cached float64 reference: if any of this changes, the
    .npy under ``.bench_refs/`` no longer matches the timed inputs and must
    regenerate (the batch size is deliberately absent — frames are
    batch-invariant under RNG_SCHEME 2)."""
    fmt, w, h, _ = input_spec(key)
    spec = {"fmt": fmt.name, "w": w, "h": h, "scheme": RNG_SCHEME}
    ckpt = {"c3sr": _SR_CKPT, "c1vh": _VH_CKPT}.get(key)
    if ckpt is not None:
        # the reference depends on the model weights: fingerprint the
        # shipped checkpoint so retraining invalidates the cached oracle
        import hashlib
        if os.path.exists(ckpt):
            with open(ckpt, "rb") as f:
                spec["weights"] = hashlib.sha256(f.read()).hexdigest()[:16]
        else:
            spec["weights"] = "init-v2"     # v2: zero-init tail
    return spec


def subtitle_overlay():
    """Deterministic subtitle-style overlay (rgb premul-free + alpha)."""
    rng = np.random.default_rng(99)
    rgb = np.ones((3, SUB_H, SUB_W), np.float32) * 0.95
    alpha = (rng.random((SUB_H, SUB_W)) > 0.45).astype(np.float32) * 0.85
    return rgb, alpha


_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "weights")
_SR_CKPT = os.path.join(_WEIGHTS, "superres_2x.npz")
_VH_CKPT = os.path.join(_WEIGHTS, "videohdr.npz")


def videohdr_params():
    """VideoHDR weights for the learned SDR->HDR row: the SHIPPED trained
    checkpoint when present, else deterministic init (== the analytic
    inverse-Reinhard base).  The oracle uses identical parameters either
    way, so the row's PSNR measures card-vs-CPU model numerics."""
    import jax
    from videorenderer.models.videohdr import VideoHDRConfig, init_params
    cfg = VideoHDRConfig()
    params = init_params(jax.random.PRNGKey(0), cfg)
    if os.path.exists(_VH_CKPT):
        from videorenderer.models.checkpoint import load_params
        params = load_params(_VH_CKPT, params)
    return params, cfg


def superres_params():
    """SuperRes weights for the learned-upscaler row: the SHIPPED trained
    checkpoint when present (what a user runs), else deterministic init.
    Either way the oracle uses the identical parameters, so the row's
    PSNR measures bfloat16 model numerics, not model quality."""
    import jax
    from videorenderer.models.superres import SuperResConfig, init_params
    cfg = SuperResConfig()
    params = init_params(jax.random.PRNGKey(0), cfg)
    if os.path.exists(_SR_CKPT):
        from videorenderer.models.checkpoint import load_params
        params = load_params(_SR_CKPT, params)
    return params, cfg


def dovi_meta():
    from videorenderer.ops import dovi as dovi_ops
    return dovi_ops.DoviMetadata(
        curves=(dovi_ops.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                    [1, -0.164553, -0.571353],
                                    [1, 1.8814, 0]]),
        ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
        rgb_to_lms_matrix=np.linalg.inv(dovi_ops.DOVI_LMS2RGB))


def dovi_rt(i: int):
    """Per-scene runtime curve tensors for config 8 (i = scene index)."""
    import jax.numpy as jnp
    from videorenderer.ops import dovi as dovi_ops
    return {k: jnp.asarray(v) * (1.0 - 0.01 * i)
            for k, v in dovi_ops.pack_curves(dovi_meta()).items()}


def c7_rt(i: int):
    """Per-scene HDR10 metadata scalars for config 7."""
    return {"hdr": {"mastering_min_nits": 0.005,
                    "mastering_max_nits": 2000.0,
                    "max_cll": 1200.0 + 100.0 * i, "max_fall": 450.0,
                    "display_max_nits": 650.0}}


# --------------------------------------------------------------------------
# config table: key -> (name, plan builder, input spec)
# --------------------------------------------------------------------------

def _src_nv12_1080():
    return SourceDescriptor(format=ColorFormat.NV12, width=1920, height=1080,
                            matrix=CSP.BT_709, levels=Levels.TV)


def _src_p010_4k(transfer=TRC.PQ, **kw):
    return SourceDescriptor(format=ColorFormat.P010, width=3840, height=2160,
                            matrix=CSP.BT_2020_NC, primaries=Primaries.BT_2020,
                            transfer=transfer, **kw)


def build_plan(key: str):
    """The (Settings, Source, Output) triple per config key."""
    if key == "c1":
        return plan_pipeline(
            Settings(chroma_scaling=ChromaScaling.BILINEAR),
            _src_nv12_1080(), OutputDescriptor(width=1920, height=1080, bits=8))
    if key == "c2":
        return plan_pipeline(
            Settings(upscaling=Upscaling.CATMULL_ROM,
                     downscaling=Downscaling.HAMMING),
            _src_p010_4k(hdr10=HDR10Metadata()),
            OutputDescriptor(width=1920, height=1080, bits=10))
    if key == "c3":
        return plan_pipeline(
            Settings(upscaling=Upscaling.JINC2, use_dither=True),
            _src_nv12_1080(), OutputDescriptor(width=3840, height=2160, bits=8))
    if key == "c3rot":
        # rotation 90: the pipeline runs at swapped dims and the content
        # rotates into the real 4K surface (api._rebuild semantics,
        # Source/DX11VideoProcessor.cpp:3125-3135)
        return plan_pipeline(
            Settings(upscaling=Upscaling.JINC2, use_dither=True),
            _src_nv12_1080(), OutputDescriptor(width=2160, height=3840, bits=8))
    if key == "c3sr":
        # SuperRes path: pipeline runs 1:1, the net performs the 2x
        return plan_pipeline(
            Settings(vp_superres=SuperResolution.P1080),
            _src_nv12_1080(), OutputDescriptor(width=1920, height=1080, bits=8))
    if key == "c1vh":
        # learned SDR->HDR (RTX Video HDR slot): pipeline converts 1:1 to
        # sRGB, the gain net emits PQ/BT.2020, packed RGB10
        return plan_pipeline(
            Settings(vp_rtx_video_hdr=True),
            _src_nv12_1080(),
            OutputDescriptor(width=1920, height=1080, bits=10))
    if key == "c4":
        return plan_pipeline(
            Settings(convert_to_sdr=True),
            _src_p010_4k(hdr10=HDR10Metadata(max_cll=4000, max_fall=1000)),
            OutputDescriptor(width=3840, height=2160, bits=8))
    if key in ("c5", "c5s"):
        return plan_pipeline(
            Settings(convert_to_sdr=True, upscaling=Upscaling.LANCZOS3),
            _src_p010_4k(TRC.HLG, interlaced=True),
            OutputDescriptor(width=1920, height=1080, bits=8))
    if key == "c6":
        return plan_pipeline(
            Settings(upscaling=Upscaling.LANCZOS3, convert_to_sdr=True),
            _src_p010_4k(hdr10=HDR10Metadata()),
            OutputDescriptor(width=1920, height=1080, bits=10))
    if key == "c7":
        return plan_pipeline(
            Settings(convert_to_sdr=False, hdr_passthrough=True,
                     hdr_local_tone_mapping=True,
                     hdr_local_tone_mapping_type=ToneMapType.BT2390,
                     hdr_display_max_nits=600),
            _src_p010_4k(hdr10=HDR10Metadata(mastering_max_nits=4000.0,
                                             max_cll=3000.0, max_fall=800.0)),
            OutputDescriptor(width=3840, height=2160, bits=10, hdr=True))
    if key == "c8":
        return plan_pipeline(
            Settings(convert_to_sdr=True, upscaling=Upscaling.CATMULL_ROM),
            _src_p010_4k(dovi=dovi_meta(), hdr10=HDR10Metadata()),
            OutputDescriptor(width=1920, height=1080, bits=10))
    if key == "c9":
        return plan_pipeline(
            Settings(upscaling=Upscaling.LANCZOS3, convert_to_sdr=True),
            SourceDescriptor(format=ColorFormat.P010, width=7680, height=4320,
                             matrix=CSP.BT_2020_NC,
                             primaries=Primaries.BT_2020, transfer=TRC.PQ,
                             hdr10=HDR10Metadata()),
            OutputDescriptor(width=3840, height=2160, bits=10))
    raise KeyError(key)


def input_spec(key: str):
    """(format, w, h, timing batch) per config.  The batches keep each
    dispatch at tens of milliseconds of device work with a few GB live;
    they are not yet picked from measurements on the card."""
    if key in ("c1", "c1vh", "c3", "c3rot", "c3sr"):
        return ColorFormat.NV12, 1920, 1080, 8
    if key in ("c2", "c4", "c5", "c5s", "c6", "c7", "c8"):
        return ColorFormat.P010, 3840, 2160, 8
    if key == "c9":
        return ColorFormat.P010, 7680, 4320, 2
    raise KeyError(key)


ALL_KEYS = ["c1", "c1vh", "c2", "c3", "c3rot", "c3sr", "c4", "c5", "c5s",
            "c6", "c7", "c8", "c9"]

NAMES = {
    "c1": "1. 1080p NV12->RGB8 1:1 + dither (packed surface out)",
    "c1vh": "1v. 1080p SDR -> HDR10 PQ (learned Video HDR, packed RGB10)",
    "c2": "2. 4K P010 -> 1080p RGB10 Catmull-Rom (60-frame clips, packed "
          "surface)",
    "c3": "3. 1080p -> 4K Jinc2 + anti-ringing (packed surface)",
    "c3rot": "3r. 1080p -> 4K Jinc2 + rotation 90 + flip (packed surface)",
    "c3sr": "3s. 1080p -> 4K SuperRes 2x (learned upscaler, packed surface)",
    "c4": "4. 4K HDR10 -> SDR RGB8 (tone-map at 4K, packed surface)",
    "c5": "5. 4K60 HLG -> SDR + motion-adaptive deint (fields out, packed "
          "surface)",
    "c5s": "5s. config 5 + subtitle/OSD alpha-blend on the packed surface",
    "c6": "6. 4K HDR10 -> 1080p, row-sharded (shard_map, 1-chip mesh, "
          "packed surface)",
    "c7": "7. 4K HDR10 passthrough + BT.2390 tone map, serving (per-scene "
          "metadata, no retrace, packed surface)",
    "c8": "8. 4K Dolby Vision -> 1080p SDR, serving (per-scene RPU curves, "
          "no retrace, packed surface)",
    "c9": "9. 8K HDR10 -> 4K SDR, row-sharded (oversized-frame path)",
}


def psnr_db(got: np.ndarray, ref: np.ndarray, peak: float = 1.0) -> float:
    mse = np.mean((got.astype(np.float64) - ref.astype(np.float64)) ** 2)
    return float(10 * np.log10(peak * peak / mse)) if mse > 0 else float("inf")


def decode_output(out: np.ndarray, plan) -> np.ndarray:
    """Device output (packed dwords or planar float) -> (3, H, W) float
    codes."""
    out = np.asarray(out)
    if out.dtype in (np.int32, np.uint32):
        d = out.view(np.uint32)
        if plan.dst.bits == 10:
            return np.stack([(d >> s) & 0x3FF for s in (0, 10, 20)],
                            axis=0).astype(np.float64) / 1023.0
        return np.stack([(d >> s) & 0xFF for s in (0, 8, 16)],
                        axis=0).astype(np.float64) / 255.0
    return out.astype(np.float64)


def np_blend_packed_codes(codes: np.ndarray, ov_rgb: np.ndarray,
                          ov_a: np.ndarray, x: int, y: int,
                          bits: int) -> np.ndarray:
    """Float64 reference of blend_in_rect_packed on decoded codes: blend in
    float against the quantized backbuffer, requantize round-half-up."""
    maxv = 1023.0 if bits == 10 else 255.0
    out = codes.copy()
    h, w = ov_a.shape
    region = out[:, y:y + h, x:x + w]
    blended = ov_rgb * ov_a + region * (1.0 - ov_a)
    out[:, y:y + h, x:x + w] = np.floor(
        np.clip(blended, 0.0, 1.0) * maxv + 0.5) / maxv
    return out


PSNR_BAR = {"c3sr": 40.0, "c1vh": 40.0}   # learned rows: bf16 nets by design
DEFAULT_BAR = 55.0


def cell_frame_fn(key: str, plan):
    """The per-batch program of a cell other than the deinterlace cells
    (c5, c5s run through ``runner.DeinterlaceSession``): ``fn(planes, rt)``
    -> the output surface (packed dwords; planar float for c9), ``rt`` being
    the serving cells' runtime metadata and ignored elsewhere."""
    import jax
    from videorenderer.pipeline import (_pack_surface_xla, make_frame_fn,
                                        make_serving_fn)
    if key in ("c6", "c9"):
        from jax.sharding import Mesh
        from videorenderer.parallel.spatial import make_spatial_frame_fn
        mesh = Mesh(np.array(jax.devices()[:1]), ("spatial",))
        fn = make_spatial_frame_fn(plan, mesh, pack_surface=key == "c6")
        return lambda planes, rt: fn(planes)
    if key in ("c7", "c8"):
        fn = make_serving_fn(plan, pack_surface=True)
        return lambda planes, rt: fn(planes, rt)
    if key == "c3rot":
        fn = make_frame_fn(plan, pack_surface=True, rotation=90, flip=True)
    elif key in ("c3sr", "c1vh"):
        if key == "c3sr":
            from videorenderer.models.superres import enhance_plane_chw
            params, cfg = superres_params()
        else:
            from videorenderer.models.videohdr import enhance_plane_chw
            params, cfg = videohdr_params()
        base = make_frame_fn(plan)
        fmt = "rgba8" if plan.dst.bits == 8 else "rgb10a2"
        fn = lambda p: _pack_surface_xla(
            enhance_plane_chw(params, base(p), cfg), fmt)
    else:
        fn = make_frame_fn(plan, pack_surface=True)
    return lambda planes, rt: fn(planes)


def cell_rt(key: str, i: int) -> dict:
    """Runtime metadata for scene ``i`` of a serving cell ({} elsewhere)."""
    if key == "c7":
        return c7_rt(i)
    if key == "c8":
        return {"dovi_curves": dovi_rt(i)}
    return {}


def reference_codes(key: str, plan, ref: np.ndarray) -> np.ndarray:
    """The float64 oracle on the output's code grid: the learned rows'
    references are unquantized floats, while the packed output is not."""
    if key in ("c3sr", "c1vh"):
        maxv = 1023.0 if plan.dst.bits == 10 else 255.0
        return np.floor(np.clip(ref, 0.0, 1.0) * maxv + 0.5) / maxv
    return ref


def require_gpu():
    """The first device, refusing anything but an NVIDIA GPU: a CUDA
    plugin that fails to load leaves JAX on the CPU without an error, and a
    CPU time must never pass for a device number."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX found {dev.platform} "
                         f"({dev.device_kind})")
    return dev


def nvidia_smi(query: str = "name,power.limit") -> str:
    """``nvidia-smi --query-gpu=<query> --format=csv,noheader``, one line per
    card (the card's name and power limit by default)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def device_record() -> dict:
    """What every on-card result is printed beside: JAX's view of the
    devices and the first card's name and power limit."""
    import jax
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "card": nvidia_smi().splitlines()[0]}
