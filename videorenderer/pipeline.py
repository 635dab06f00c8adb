"""Pipeline builder: config -> jit-compiled frame-processing function.

This is the JAX analogue of the reference's pipeline assembly:

 * media-type negotiation and path selection
   (CDX11VideoProcessor::InitMediaType, Source/DX11VideoProcessor.cpp:1742-1959)
 * runtime HLSL codegen specialization
   (GetShaderConvertColor, Source/Shaders.cpp:593-930)
 * render-pass orchestration
   (CDX11VideoProcessor::Process, Source/DX11VideoProcessor.cpp:3297-3436)

Where the reference generates HLSL text and calls D3DCompile, we compose
pure jnp functions and let XLA trace/compile them — tracing *is* the
codegen.  A (Settings, SourceDescriptor, OutputDescriptor) triple fully
determines the computation; all matrices/weights are baked as constants.

Stage order follows the reference's two backends:
 * ``vp_scaling=True`` (default; the "D3D11VP" order): convert color at
   source res (matrix only) -> resize -> post-scale corrections
   (HLG->PQ / HDR->SDR / BT.2020 fix) -> local tone-map -> dither.
 * ``vp_scaling=False`` (the "shader path" order): convert + corrections at
   source resolution (Source/Shaders.cpp:861-923 are appended to the convert
   shader) -> resize -> local tone-map -> dither.

Unlike the reference's fixconvert_* shaders we never need the
"fix incorrect BT.2020 YCbCr" matrix (ps_fix_bt2020.hlsl) in the VP order:
our convert stage always uses the correct matrix (the fix exists only
because the Windows fixed-function VP lacks BT.2020 support).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


import jax
import jax.numpy as jnp
import numpy as np

from . import csputils
from .config import Settings, Upscaling
from .csputils import (CSP, ChromaLocation, Colorspace, CSPParams, Levels,
                       Primaries, TRC)
from .formats import ColorFormat, ColorSystem, FormatInfo, get_format_info
from .ops import chroma as chroma_ops
from .ops import dither as dither_ops
from .ops import scale as scale_ops
from .ops import tonemap as tonemap_ops
from .ops import transfer as transfer_ops


@dataclass(frozen=True)
class HDR10Metadata:
    """HDR10 static metadata carried as media side data
    (MediaSideDataHDR / ...ContentLightLevel, consumed in
    Source/DX11VideoProcessor.cpp:2232-2267)."""

    mastering_min_nits: float = 0.005
    mastering_max_nits: float = 1000.0
    max_cll: float = 1000.0
    max_fall: float = 400.0


@dataclass(frozen=True)
class SourceDescriptor:
    """Media type + DXVA2 extended-format analogue (what InitMediaType
    parses from VIDEOINFOHEADER2, Source/DX11VideoProcessor.cpp:1757-1821)."""

    format: ColorFormat
    width: int
    height: int
    matrix: CSP = CSP.AUTO
    levels: Levels = Levels.AUTO
    primaries: Primaries = Primaries.AUTO
    transfer: TRC = TRC.AUTO
    chroma_location: ChromaLocation = ChromaLocation.UNKNOWN
    interlaced: bool = False
    # field order for interlaced content (AM_VIDEO_FLAG_FIELD1FIRST,
    # Source/DX11VideoProcessor.cpp:2216-2222); ignored when progressive
    top_field_first: bool = True
    hdr10: HDR10Metadata | None = None
    # Dolby Vision mapping + color metadata (MediaSideDataDOVIMetadata) and
    # the L2 trim block; presence switches the convert stage to the DoVi
    # chain (reshape -> RPU ycc matrix -> PQ/LMS round trip,
    # Source/DX11VideoProcessor.cpp:2276-2537, Source/Shaders.cpp:531-859).
    dovi: "object | None" = None            # ops.dovi.DoviMetadata
    dovi_trims: "object | None" = None      # ops.tonemap.DoviTrims
    # ST 2094-10 extension blocks (L1/L2/L3/L6 + ColorMetadata luminance,
    # ops.dovi_ext.DoviExtensions): resolved at plan time into tone-map
    # params / trims / output HDR10 metadata exactly as CopySample does
    # (Source/DX11VideoProcessor.cpp:2357-2500)
    dovi_ext: "object | None" = None
    # HDR10+ / ST 2094-40 dynamic metadata (MediaSideDataHDR10Plus,
    # Include/IMediaSideData.h:67-130 — struct-only in the reference; here
    # the scene statistics feed the tone map like DoVi L1 does,
    # ops.hdr10plus.HDR10PlusMetadata)
    hdr10plus: "object | None" = None
    # source crop rectangle (left, top, right, bottom) — the IBasicVideo
    # SetSourcePosition analogue; None = full frame
    src_rect: tuple[int, int, int, int] | None = None
    # ProcAmp (IMFVideoProcessor, Source/VideoProcessor.cpp:334-403);
    # brightness here is the reference's DXVA2 fixed-point value already
    # divided by 255 (SetShaderConvertColorParams, DX11VideoProcessor.cpp:839)
    brightness: float = 0.0   # -1..1
    contrast: float = 1.0
    hue_deg: float = 0.0
    saturation: float = 1.0

    def specified(self) -> "SourceDescriptor":
        """Apply SpecifyExtendedFormat defaulting (Source/Helper.cpp:1169-1212)
        + set_colorspace mapping (Source/Helper.cpp:949-1004)."""
        info = get_format_info(self.format)
        d = self
        if info.cs_type == ColorSystem.RGB:
            return dataclasses.replace(
                d, matrix=CSP.RGB, levels=Levels.PC,
                primaries=(d.primaries if d.primaries != Primaries.AUTO
                           else Primaries.BT_709),
                transfer=(d.transfer if d.transfer != TRC.AUTO else TRC.SRGB),
                chroma_location=ChromaLocation.UNKNOWN)
        chroma_loc = self.chroma_location
        if info.subsampling != 420:
            chroma_loc = ChromaLocation.UNKNOWN
        elif chroma_loc == ChromaLocation.UNKNOWN:
            chroma_loc = ChromaLocation.MPEG2
        levels = d.levels if d.levels != Levels.AUTO else Levels.TV
        matrix = d.matrix
        if matrix == CSP.AUTO:
            matrix = csputils.default_matrix_for_size(d.width, d.height)
        primaries = d.primaries if d.primaries != Primaries.AUTO else Primaries.BT_709
        transfer = d.transfer if d.transfer != TRC.AUTO else TRC.BT_1886
        return dataclasses.replace(
            d, matrix=matrix, levels=levels, primaries=primaries,
            transfer=transfer, chroma_location=chroma_loc)

    @property
    def is_hdr(self) -> bool:
        return self.transfer in (TRC.PQ, TRC.HLG)


@dataclass(frozen=True)
class OutputDescriptor:
    """Target surface description (swap-chain analogue)."""

    width: int
    height: int
    bits: int = 8            # quantization depth: 8 / 10; 16 = float16 out
    hdr: bool = False        # True: PQ/BT.2020 output (HDR passthrough)
    # video placement within the surface (IBasicVideo SetDestinationPosition
    # analogue): the scaled video lands in video_rect (l, t, r, b) and the
    # rest is filled black (FillBlack, Source/VideoProcessor.h:171-236).
    video_rect: tuple[int, int, int, int] | None = None

    @property
    def video_size(self) -> tuple[int, int]:
        if self.video_rect is None:
            return self.width, self.height
        l, t, r, b = self.video_rect
        return r - l, b - t


@dataclass(frozen=True)
class PipelinePlan:
    """Resolved static plan — everything the traced function needs."""

    settings: Settings
    src: SourceDescriptor
    dst: OutputDescriptor
    info: FormatInfo
    cmat_m: np.ndarray     # (3,3)
    cmat_c: np.ndarray     # (3,)
    apply_matrix: bool
    # correction stages (post-scale in VP order / in-convert in shader order)
    convert_to_sdr: bool       # PQ or HLG -> SDR (Hable + 2020->709 + gamma)
    hlg_to_pq: bool            # HDR passthrough of HLG source
    fix_bt2020_sdr: bool       # SDR BT.2020 primaries -> 709 display
    sdr_gamma: float           # source power gamma for fix_bt2020_sdr
    local_tonemap: bool
    dither_bits: int | None
    dovi: "object | None" = None        # ops.dovi.DoviMetadata
    dovi_trims: "object | None" = None  # ops.tonemap.DoviTrims
    dovi_ext: "object | None" = None    # ops.dovi_ext.DoviExtensions
    src_rect: tuple[int, int, int, int] | None = None
    # resolved local-tone-map parameters + (possibly L1-upgraded) operator
    tonemap_params: "object | None" = None   # ops.tonemap.HDRParams
    tonemap_type: int = 0
    # static ST 2094-40 window when tonemap_type == 7 (HDR10+ guided curve:
    # knee/anchors are plan structure, like the DoVi reshape curves)
    hdr10plus_window: "object | None" = None
    # output-side HDR10 static metadata (swap-chain SetHDRMetaData analogue,
    # Source/DX11VideoProcessor.cpp:2629-2739) — what a sink should program
    output_hdr10: HDR10Metadata | None = None


def _build_cmat(src: SourceDescriptor, info: FormatInfo) -> tuple[np.ndarray, np.ndarray, bool]:
    """Color matrix exactly as SetShaderConvertColorParams
    (Source/DX11VideoProcessor.cpp:813-890)."""
    params = CSPParams(
        color=Colorspace(space=src.matrix, levels=src.levels,
                         primaries=src.primaries, gamma=src.transfer),
        brightness=src.brightness,
        contrast=src.contrast,
        hue=src.hue_deg / 180.0 * np.pi,
        saturation=src.saturation,
        gray=info.cs_type == ColorSystem.GRAY,
        input_bits=info.depth,
        texture_bits=info.depth,
    )
    cm = csputils.get_csp_matrix(params)
    enable = (
        info.cs_type == ColorSystem.YUV
        or info.cformat in (ColorFormat.GBRP8, ColorFormat.GBRP10, ColorFormat.GBRP16)
        or params.gray
        or abs(params.brightness) > 1e-4
        or abs(params.contrast - 1.0) > 1e-4
    )
    return cm.m, cm.c, enable


def plan_pipeline(settings: Settings, src: SourceDescriptor,
                  dst: OutputDescriptor) -> PipelinePlan:
    """Static planning — the InitMediaType analogue."""
    src = src.specified()
    info = get_format_info(src.format)
    # DoVi engages whenever RPU metadata is present (the reference validates
    # it in CVideoProcessor::CheckDoviMetadata and then always prefers the
    # RPU pipeline; bHdrPreferDoVi only orders DoVi vs HDR10 profile 7/8
    # negotiation, which the caller resolves before handing us metadata).
    dovi = src.dovi
    if dovi is not None:
        # DoVi replaces the standard matrix with the RPU's ycc_to_rgb
        # (Source/DX11VideoProcessor.cpp:817-836)
        from .ops.dovi import build_ycc_to_rgb_cmat
        m, c = build_ycc_to_rgb_cmat(dovi, brightness=src.brightness,
                                     contrast=src.contrast)
        apply_matrix = True
    else:
        m, c, apply_matrix = _build_cmat(src, info)

    is_pq = src.transfer == TRC.PQ
    is_hlg = src.transfer == TRC.HLG and dovi is None
    bt2020 = src.primaries == Primaries.BT_2020

    dovi_trims = src.dovi_trims
    dovi_ext = src.dovi_ext
    if dovi_ext is not None and dovi_trims is None:
        from .ops import dovi_ext as dovi_ext_ops
        dovi_trims = dovi_ext_ops.select_l2_trims(
            dovi_ext, float(settings.hdr_display_max_nits))

    convert_to_sdr = (not dst.hdr) and settings.convert_to_sdr and (
        is_pq or is_hlg or dovi is not None)
    hlg_to_pq = dst.hdr and settings.hdr_passthrough and is_hlg
    # SDR source with BT.2020 primaries shown on a 709 display
    # (ps_fix_bt2020.hlsl; codegen branch Source/Shaders.cpp:892-915)
    fix_bt2020_sdr = bt2020 and not (is_pq or is_hlg) and not dst.hdr
    sdr_gamma = {
        TRC.LINEAR: 1.0, TRC.GAMMA18: 1.8, TRC.GAMMA20: 2.0,
        TRC.GAMMA26: 2.6, TRC.GAMMA28: 2.8,
    }.get(src.transfer, 2.2)
    local_tonemap = (dst.hdr and settings.hdr_local_tone_mapping
                     and (is_pq or is_hlg or dovi is not None))

    # resolve the tone-map parameter block once: L1 (+L3) extensions feed
    # min/max/maxCLL=max/maxFALL=avg and upgrade type 5 -> 6; otherwise the
    # (DoVi-merged) HDR10 mastering metadata applies
    # (Source/DX11VideoProcessor.cpp:2728-2736)
    tm_type = int(settings.hdr_local_tone_mapping_type)
    output_hdr10 = src.hdr10 if dst.hdr else None
    h10p_window = None
    if dovi_ext is not None:
        from .ops import dovi_ext as dovi_ext_ops
        tm_params, tm_type = dovi_ext_ops.hdr_params_from_extensions(
            dovi_ext, src.hdr10, float(settings.hdr_display_max_nits),
            tm_type)
        if dst.hdr:
            output_hdr10 = dovi_ext_ops.merge_hdr10(src.hdr10, dovi_ext)
    elif src.hdr10plus is not None:
        from .ops import hdr10plus as h10p_ops
        tm_params, tm_type = h10p_ops.hdr_params_from_hdr10plus(
            src.hdr10plus, src.hdr10, float(settings.hdr_display_max_nits),
            tm_type)
        if tm_type == 7:
            h10p_window = src.hdr10plus.windows[0]
        if dst.hdr:
            output_hdr10 = h10p_ops.merge_hdr10(src.hdr10, src.hdr10plus)
    else:
        h = src.hdr10 or HDR10Metadata()
        tm_params = tonemap_ops.HDRParams(
            mastering_min_nits=h.mastering_min_nits,
            mastering_max_nits=h.mastering_max_nits,
            max_cll=h.max_cll, max_fall=h.max_fall,
            display_max_nits=float(settings.hdr_display_max_nits))

    if src.src_rect is not None and info.cs_type == ColorSystem.YUV:
        dw, dh = info.chroma_div
        l, t, r, b = src.src_rect
        if l % dw or r % dw or t % dh or b % dh:
            raise ValueError(
                f"src_rect {src.src_rect} must align to the {info.name} "
                f"chroma grid ({dw}x{dh})")

    # positive: ordered dither to that depth; negative: plain rounding;
    # 0: float output, no quantization (TEXFMT_16FLOAT analogue)
    if dst.bits in (8, 10):
        dither_bits = dst.bits if settings.use_dither else -dst.bits
    else:
        dither_bits = 0

    return PipelinePlan(
        settings=settings, src=src, dst=dst, info=info,
        cmat_m=m, cmat_c=c, apply_matrix=apply_matrix,
        convert_to_sdr=convert_to_sdr, hlg_to_pq=hlg_to_pq,
        fix_bt2020_sdr=fix_bt2020_sdr, sdr_gamma=sdr_gamma,
        local_tonemap=local_tonemap, dither_bits=dither_bits,
        dovi=dovi, dovi_trims=dovi_trims, dovi_ext=dovi_ext,
        src_rect=src.src_rect, tonemap_params=tm_params,
        tonemap_type=tm_type, output_hdr10=output_hdr10,
        hdr10plus_window=h10p_window,
    )


@dataclass(frozen=True)
class OutputSignalInfo:
    """What the output pixels *are* — the swap-chain colorspace + HDR10
    metadata the reference programs every present
    (SetColorSpace1/SetHDRMetaData, Source/DX11VideoProcessor.cpp:2629-2739).
    Sinks persist this next to the pixels so a downstream consumer can
    display them correctly."""

    width: int
    height: int
    bits: int
    primaries: str        # Primaries name
    transfer: str         # TRC name ("PQ" for HDR out)
    matrix: str = "RGB"
    range: str = "full"
    hdr10: HDR10Metadata | None = None

    def to_dict(self) -> dict:
        d = {"width": self.width, "height": self.height, "bits": self.bits,
             "primaries": self.primaries, "transfer": self.transfer,
             "matrix": self.matrix, "range": self.range}
        if self.hdr10 is not None:
            d["hdr10"] = {
                "mastering_min_nits": self.hdr10.mastering_min_nits,
                "mastering_max_nits": self.hdr10.mastering_max_nits,
                "max_cll": self.hdr10.max_cll,
                "max_fall": self.hdr10.max_fall,
            }
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "OutputSignalInfo":
        h = d.get("hdr10")
        return cls(width=d["width"], height=d["height"], bits=d["bits"],
                   primaries=d["primaries"], transfer=d["transfer"],
                   matrix=d.get("matrix", "RGB"),
                   range=d.get("range", "full"),
                   hdr10=HDR10Metadata(**h) if h else None)


def output_signal_info(plan: PipelinePlan) -> OutputSignalInfo:
    """Resolve the output colorspace/transfer + HDR10 metadata from the plan:

     * HDR out: RGB full G2084 P2020 (the reference's fixed HDR swap-chain
       colorspace) + the (DoVi-merged) mastering/CLL metadata;
     * tone-mapped / BT.2020-fixed SDR: sRGB-like gamma in BT.709;
     * plain SDR: the source transfer/primaries pass through (the pipeline
       only applies the matrix + resize).
    """
    dst = plan.dst
    if dst.hdr:
        return OutputSignalInfo(
            width=dst.width, height=dst.height, bits=dst.bits,
            primaries=Primaries.BT_2020.name, transfer=TRC.PQ.name,
            hdr10=plan.output_hdr10 or HDR10Metadata())
    if plan.convert_to_sdr or plan.fix_bt2020_sdr:
        return OutputSignalInfo(
            width=dst.width, height=dst.height, bits=dst.bits,
            primaries=Primaries.BT_709.name, transfer=TRC.SRGB.name)
    return OutputSignalInfo(
        width=dst.width, height=dst.height, bits=dst.bits,
        primaries=plan.src.primaries.name, transfer=plan.src.transfer.name)


# ---------------------------------------------------------------------------
# traced stages — all take/return (..., 3, H, W) float arrays
# ---------------------------------------------------------------------------


def _normalize_planes(plan: PipelinePlan, planes, dtype) -> list[jnp.ndarray]:
    scale = 1.0 / (2.0 ** plan.info.plane_bits - 1.0)
    return [p.astype(dtype) * jnp.asarray(scale, dtype) for p in planes]


def _crop_planes(plan: PipelinePlan, planes):
    """Source-rect crop (IBasicVideo SetSourcePosition analogue): static
    slices per plane, chroma rect divided by the subsampling factors."""
    rect = plan.src_rect
    if rect is None:
        return planes
    l, t, r, b = rect
    dw, dh = plan.info.chroma_div
    out = []
    for i, p in enumerate(planes):
        if i == 0 or plan.info.cs_type != ColorSystem.YUV:
            out.append(p[..., t:b, l:r])
        else:
            out.append(p[..., t // dh:b // dh, l // dw:r // dw])
    return tuple(out)


def _convert_color(plan: PipelinePlan, planes: tuple[jnp.ndarray, ...],
                   dtype=jnp.float32, rt_curves: dict | None = None,
                   rt_cmat: dict | None = None) -> jnp.ndarray:
    """ConvertColorPass analogue: normalize, chroma upsample, 3x3 matrix.
    Returns (..., 3, H, W)."""
    info = plan.info
    s = plan.settings
    norm = _normalize_planes(plan, _crop_planes(plan, planes), dtype)

    if info.cs_type == ColorSystem.GRAY:
        y = norm[0]
        m, c = plan.cmat_m, plan.cmat_c
        rgb = jnp.stack([y * m[i, 0] + c[i] for i in range(3)], axis=-3)
        return rgb

    if info.cs_type == ColorSystem.YUV:
        y, u, v = norm
        if s.deint_blend and plan.src.interlaced and info.subsampling == 420:
            y = chroma_ops.blend_deinterlace_luma(y)
        uv = jnp.stack([u, v], axis=-3)
        uv = chroma_ops.upsample_chroma(
            uv, info.subsampling, s.chroma_scaling, plan.src.chroma_location)
        comps = jnp.concatenate([y[..., None, :, :], uv], axis=-3)
    else:
        comps = jnp.stack(norm, axis=-3)

    if plan.dovi is not None:
        # DoVi reshape on the raw ycc signal before the matrix
        # (ShaderGetPixels -> ShaderDoviReshape, Source/Shaders.cpp:809-817)
        from .ops import dovi as dovi_ops
        if rt_curves is not None:
            comps = dovi_ops.reshape_dynamic(
                comps, rt_curves, axis=-3,
                structure=dovi_ops.curve_structure(plan.dovi))
        else:
            comps = dovi_ops.reshape(comps, plan.dovi, axis=-3)

    if plan.apply_matrix:
        # runtime ProcAmp path: the matrix as traced tensors (the reference
        # updates the cbuffer per IMFVideoProcessor ProcAmp change)
        m, c = _rt_cmat(plan, {"cmat": rt_cmat}, dtype)
        rgb = _apply_cmat(m, c, comps[..., 0, :, :], comps[..., 1, :, :],
                          comps[..., 2, :, :])
    else:
        rgb = comps

    if plan.dovi is not None:
        # PQ EOTF -> (LMS2RGB @ rgb_to_lms) -> PQ OETF
        # (Source/Shaders.cpp:824-859)
        from .ops import dovi as dovi_ops
        rgb = dovi_ops.apply_lms_matrix(rgb, plan.dovi, axis=-3)
    return rgb


def _corrections(plan: PipelinePlan, rgb: jnp.ndarray,
                 trims=None) -> jnp.ndarray:
    """Post-scale correction shaders (selection in InitMediaType,
    Source/DX11VideoProcessor.cpp:1896-1930)."""
    s = plan.settings
    axis = -3
    if trims is None:
        trims = plan.dovi_trims
    if plan.convert_to_sdr:
        # ps_convert_pq_to_sdr.hlsl / HLG variant: -> linear(SDR-relative) ->
        # Hable -> 2020->709 -> sRGB-ish gamma
        luminance_scale = 10000.0 / s.sdr_display_nits  # SetShaderLuminanceParams
        x = jnp.clip(rgb, 0.0, 1.0)
        if plan.src.transfer == TRC.HLG and plan.dovi is None:
            # the reference runs HLGtoLinear -> LinearToST2084(1000) in one
            # pass, clips, then ST2084ToLinear(ls) in the next
            # (ps_convert_hlg_to_sdr.hlsl) because the two shader passes
            # can't fuse; the PQ round trip is algebraically
            # clip(x/1000, 0, 1) * ls — 12 vector pows/pixel fold away.
            # (DoVi L2 trims can't intervene here: that branch requires
            # plan.dovi, and DoVi sources never take the HLG branch.)
            x = transfer_ops.hlg_to_linear(x, axis=axis)
            x = jnp.clip(x * (1.0 / 1000.0), 0.0, 1.0) * luminance_scale
        else:
            if plan.dovi is not None and plan.dovi_trims is not None \
                    and plan.dovi_trims.l2_enabled:
                # L2 trims on the PQ signal (Source/Shaders.cpp:873-877)
                x = tonemap_ops.dolby_vision_trims(x, trims, axis=axis,
                                                   pq_input=True)
            x = transfer_ops.st2084_to_linear(x, luminance_scale)
        x = tonemap_ops.tonemap_hable_sdr(x)
        x = _gamut_2020_to_709(x, axis)
        return transfer_ops.linear_to_srgb_like(x)
    if plan.hlg_to_pq:
        # ps_convert_hlg_to_pq.hlsl
        x = jnp.clip(rgb, 0.0, 1.0)
        x = transfer_ops.hlg_to_linear(x, axis=axis)
        return transfer_ops.linear_to_st2084(x, 1000.0)
    if plan.fix_bt2020_sdr:
        # SDR BT.2020 -> 709 (codegen branch, Source/Shaders.cpp:892-915)
        x = transfer_ops.srgb_like_to_linear(rgb, plan.sdr_gamma)
        x = _gamut_2020_to_709(x, -3)
        return transfer_ops.linear_to_srgb_like(x)
    return rgb


def _gamut_2020_to_709(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """3x3 gamut matrix unrolled to elementwise FMAs, which XLA fuses with
    the neighbouring transfer functions."""
    gm = csputils.bt2020_to_bt709_matrix()
    r, g, b = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    return jnp.stack(
        [float(gm[i, 0]) * r + float(gm[i, 1]) * g + float(gm[i, 2]) * b
         for i in range(3)], axis=axis)


def _local_tonemap(plan: PipelinePlan, rgb: jnp.ndarray,
                   trims=None) -> jnp.ndarray:
    return tonemap_ops.local_tonemap_pq(
        rgb, plan.tonemap_type, plan.tonemap_params,
        trims=trims if trims is not None else plan.dovi_trims, axis=-3,
        window=plan.hdr10plus_window)


def _resolve_rt_trims(plan: PipelinePlan, rt: dict | None):
    """Serving-mode L2 trims: rt["l2_trims"] scalars override the plan's
    static DoviTrims (the stage must exist statically — plan with l2-enabled
    trims — for per-scene values to flow in without retracing, the way the
    reference re-uploads the DoVi dynamic cbuffer per sample,
    Source/DX11VideoProcessor.cpp:954-983)."""
    tr = rt.get("l2_trims") if rt else None
    if tr is None:
        return plan.dovi_trims
    return tonemap_ops.DoviTrims(
        chroma_weight=tr["chroma_weight"],
        saturation_gain=tr["saturation_gain"],
        trim_slope=tr["trim_slope"], trim_offset=tr["trim_offset"],
        trim_power=tr["trim_power"], l2_enabled=True)


def _final_pass(plan: PipelinePlan, rgb: jnp.ndarray,
                row_offset: "int | jnp.ndarray" = 0) -> jnp.ndarray:
    """ps_final_pass.hlsl: ordered dither + quantization, then placement of
    the video rect into the target surface with black fill (FillBlack).

    ``row_offset``: global row of local row 0 (row-sharded execution) so the
    dither pattern keeps its unsharded phase."""
    db = plan.dither_bits
    if db is not None and db != 0:
        if db < 0:
            rgb = dither_ops.quantize(jnp.clip(rgb, 0.0, 1.0), -db)
        else:
            rgb = dither_ops.ordered_dither(jnp.clip(rgb, 0.0, 1.0), db,
                                            row_offset=row_offset)
    rect = plan.dst.video_rect
    if rect is not None:
        l, t, r, b = rect
        surface = jnp.zeros(rgb.shape[:-2] + (plan.dst.height, plan.dst.width),
                            rgb.dtype)
        rgb = surface.at[..., t:b, l:r].set(rgb)
    return rgb


def surface_pack_format(dst: OutputDescriptor) -> str:
    """The packed-dword surface format for this output depth — the
    swap-chain backbuffer the reference presents into (8-bit flip chains
    use RGBA8, HDR/10-bit chains DXGI_FORMAT_R10G10B10A2_UNORM,
    Source/DX11VideoProcessor.cpp:1490-1530)."""
    if dst.bits == 10:
        return "rgb10a2"
    if dst.bits == 8:
        return "rgba8"
    raise ValueError("packed surface output needs an 8- or 10-bit "
                     f"OutputDescriptor, got bits={dst.bits}")


def _pack_surface_xla(rgb: jnp.ndarray, fmt: str) -> jnp.ndarray:
    """Surface packer: (..., 3, H, W) float [0,1] -> (..., H, W) int32
    dwords, red in the low bits and alpha saturated."""
    r = rgb[..., 0, :, :]
    g = rgb[..., 1, :, :]
    b = rgb[..., 2, :, :]
    if fmt == "rgb10a2":
        q = lambda x: (jnp.clip(x, 0.0, 1.0) * 1023.0 + 0.5).astype(jnp.int32)
        return q(r) | (q(g) << 10) | (q(b) << 20) | jnp.int32(-1073741824)
    if fmt == "rgba8":
        q = lambda x: (jnp.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.int32)
        return q(r) | (q(g) << 8) | (q(b) << 16) | jnp.int32(-16777216)
    raise ValueError(fmt)


def _separable_geometry(plan: PipelinePlan) -> bool:
    """True when every resize pass is a separable axis matrix (Jinc2's 2D
    one-pass shader is the only non-separable case)."""
    s = plan.settings
    src, dst = plan.src, plan.dst
    h, w = src.height, src.width
    if plan.src_rect is not None:
        l, t, r, b = plan.src_rect
        w, h = r - l, b - t
    dw, dh = dst.video_size
    if s.upscaling == Upscaling.JINC2:
        rx, ry = scale_ops.jinc2_passes(h, w, dh, dw, s.interpolate_at_50pct)
        if "up" in (rx, ry):
            return False
    return True


def _can_fuse(plan: PipelinePlan) -> bool:
    """The fused linear-resample path applies when everything between plane
    normalization and the first nonlinearity is linear: chroma upsample,
    (blend deinterlace), color matrix, separable resize.  That is the
    VP-order pipeline with a separable scaler; Jinc2 (non-separable 2D) and
    the shader-order (corrections before resize) fall back.  DoVi plans take
    the split-fused path instead (:func:`_can_split_fuse`) — the reshape is
    nonlinear in the ycc signal, so the resample can't cross it."""
    s = plan.settings
    if not s.vp_scaling:
        return False
    if plan.dovi is not None:
        return False
    return _separable_geometry(plan)


def _can_split_fuse(plan: PipelinePlan) -> bool:
    """DoVi variant of the fused path: the linear prefix splits at the
    reshape — chroma upsamples to *source* resolution, the reshape/matrix/
    LMS chain runs there (as the reference's convert pass does), and the
    RGB resizes to output resolution.  Requires the VP-order pipeline,
    separable scalers, and a planar-YUV source (DoVi RPUs describe ycc
    signals)."""
    s = plan.settings
    return (s.vp_scaling and plan.dovi is not None
            and plan.info.cs_type == ColorSystem.YUV
            and _separable_geometry(plan))


def _fused_apply2d(x_raw, mx, my, norm: float | None, dtype):
    """Apply optional (in,out) matrices along W then H to a plane — raw
    integer input normalized by ``norm`` when it is set, or already-float
    input with ``norm=None``."""
    x = x_raw if norm is None else (x_raw.astype(dtype)
                                    * jnp.asarray(norm, dtype))
    if mx is not None:
        x = scale_ops.resize_axis(x, mx, -1)
    if my is not None:
        x = scale_ops.resize_axis(x, my, -2)
    return x


def _compose(a: np.ndarray | None, b: np.ndarray | None):
    """Compose two (in,out) axis maps applied a-then-b."""
    if a is None:
        return b
    if b is None:
        return a
    return a @ b


def _rt_cmat(plan: PipelinePlan, rt: dict, dtype):
    """Color matrix (m, c): the runtime ProcAmp override ``rt["cmat"]`` when
    present, else the plan's."""
    cm = rt.get("cmat")
    if cm is not None:
        return jnp.asarray(cm["m"], dtype), jnp.asarray(cm["c"], dtype)
    return jnp.asarray(plan.cmat_m, dtype), jnp.asarray(plan.cmat_c, dtype)


def _apply_cmat(m, c, y, u, v) -> jnp.ndarray:
    """Per-pixel 3-vector FMA (cm_r/cm_g/cm_b/cm_c cbuffer,
    Source/Shaders.cpp:819-820) -> (..., 3, H, W)."""
    return jnp.stack([m[i, 0] * y + m[i, 1] * u + m[i, 2] * v + c[i]
                      for i in range(3)], axis=-3)


def _fused_tail(plan: PipelinePlan, rgb: jnp.ndarray, rt: dict,
                pack_format: str | None) -> jnp.ndarray:
    """Output-resolution chain of the fused programs: corrections, local
    tone map (runtime HDR10 scalars when ``rt["hdr"]`` is given), final
    pass and optional surface packing."""
    trims = _resolve_rt_trims(plan, rt)
    rgb = _corrections(plan, rgb, trims=trims)
    if plan.local_tonemap:
        hdr = rt.get("hdr")
        if hdr is not None:
            rgb = tonemap_ops.local_tonemap_pq_rt(
                rgb, plan.tonemap_type, hdr, trims=trims, axis=-3,
                window=plan.hdr10plus_window)
        else:
            rgb = _local_tonemap(plan, rgb, trims=trims)
    rgb = _final_pass(plan, rgb)
    if pack_format is not None:
        rgb = _pack_surface_xla(rgb, pack_format)
    return rgb


def _make_fused_fn(plan: PipelinePlan, dtype=jnp.float32, with_rt: bool = False,
                   pack_format: str | None = None):
    """Fused pipeline: chroma upsample + (blend deinterlace) + separable
    resize collapse into one matrix per plane per axis (linear maps
    compose), so the YUV->RGB matrix, transfer functions, tone map and
    dither all run at *output* resolution and no full-source-size float
    intermediate ever exists.  Equal (to float32 rounding) to the staged
    path — enforced by tests/test_fused.py."""
    s = plan.settings
    src, dst = plan.src, plan.dst
    info = plan.info

    src_w, src_h = src.width, src.height
    if plan.src_rect is not None:
        l, t, r, b = plan.src_rect
        src_w, src_h = r - l, b - t
    vid_w, vid_h = dst.video_size

    # luma/full-res axis maps
    cx = scale_ops.select_scaler(src_w, vid_w, s.upscaling,
                                 s.downscaling, s.interpolate_at_50pct)
    cy = scale_ops.select_scaler(src_h, vid_h, s.upscaling,
                                 s.downscaling, s.interpolate_at_50pct)
    wx = scale_ops.build_axis_matrix(cx, src_w, vid_w)
    wy = scale_ops.build_axis_matrix(cy, src_h, vid_h)

    blend = (s.deint_blend and src.interlaced and info.subsampling == 420
             and info.cs_type == ColorSystem.YUV)
    wy_luma = wy
    if blend:
        from .ops.chroma import blend_deinterlace_matrix
        wy_luma = _compose(blend_deinterlace_matrix(src_h), wy)

    if info.cs_type == ColorSystem.YUV:
        dw, dh = info.chroma_div
        ux, uy = chroma_ops.chroma_upsample_matrices(
            src_w // dw, src_h // dh, info.subsampling,
            s.chroma_scaling, plan.src.chroma_location)
        cwx = _compose(ux, wx)
        cwy = _compose(uy, wy)
    else:
        cwx = cwy = None

    norm = 1.0 / (2.0 ** info.plane_bits - 1.0)

    def fn(planes, rt=None):
        rt = rt or {}
        planes = _crop_planes(plan, planes)
        app = lambda p, a, b: _fused_apply2d(p, a, b, norm, dtype)
        if info.cs_type == ColorSystem.GRAY:
            y = app(planes[0], wx, wy)
            m, c = plan.cmat_m, plan.cmat_c
            rgb = jnp.stack([y * m[i, 0] + c[i] for i in range(3)], axis=-3)
        else:
            if info.cs_type == ColorSystem.YUV:
                comps = (app(planes[0], wx, wy_luma),
                         app(planes[1], cwx, cwy),
                         app(planes[2], cwx, cwy))
            else:
                comps = tuple(app(p, wx, wy) for p in planes)
            if plan.apply_matrix:
                rgb = _apply_cmat(*_rt_cmat(plan, rt, dtype), *comps)
            else:
                rgb = jnp.stack(comps, axis=-3)
        return _fused_tail(plan, rgb, rt, pack_format)

    if with_rt:
        return fn
    return lambda planes: fn(planes)


def _make_dovi_fused_fn(plan: PipelinePlan, dtype=jnp.float32,
                        with_rt: bool = False,
                        pack_format: str | None = None):
    """DoVi split-fused pipeline: the fusion splits at the (nonlinear)
    reshape.  Stage A normalizes the raw integer planes and upsamples
    chroma to full source resolution; the reshape (static curves or runtime
    ``rt["dovi_curves"]``), RPU matrix and LMS PQ round trip run there
    exactly as the reference's convert pass (Source/Shaders.cpp:809-859);
    stage B resizes R,G,B to the output and runs the tail there."""
    from .ops import dovi as dovi_ops
    s = plan.settings
    src, dst = plan.src, plan.dst
    info = plan.info

    src_w, src_h = src.width, src.height
    if plan.src_rect is not None:
        l, t, r, b = plan.src_rect
        src_w, src_h = r - l, b - t
    vid_w, vid_h = dst.video_size

    dw, dh = info.chroma_div
    ux, uy = chroma_ops.chroma_upsample_matrices(
        src_w // dw, src_h // dh, info.subsampling,
        s.chroma_scaling, src.chroma_location)

    blend = (s.deint_blend and src.interlaced and info.subsampling == 420)
    by = chroma_ops.blend_deinterlace_matrix(src_h) if blend else None

    cx = scale_ops.select_scaler(src_w, vid_w, s.upscaling,
                                 s.downscaling, s.interpolate_at_50pct)
    cy = scale_ops.select_scaler(src_h, vid_h, s.upscaling,
                                 s.downscaling, s.interpolate_at_50pct)
    wx = scale_ops.build_axis_matrix(cx, src_w, vid_w)
    wy = scale_ops.build_axis_matrix(cy, src_h, vid_h)

    norm = 1.0 / (2.0 ** info.plane_bits - 1.0)
    structure = dovi_ops.curve_structure(plan.dovi)

    def fn(planes, rt=None):
        rt = rt or {}
        y, u, v = _crop_planes(plan, planes)
        # stage A: integer planes -> source-res float ycc
        comps = jnp.stack([_fused_apply2d(y, None, by, norm, dtype),
                           _fused_apply2d(u, ux, uy, norm, dtype),
                           _fused_apply2d(v, ux, uy, norm, dtype)], axis=-3)
        rt_curves = rt.get("dovi_curves")
        if rt_curves is not None:
            comps = dovi_ops.reshape_dynamic(comps, rt_curves, axis=-3,
                                             structure=structure)
        else:
            comps = dovi_ops.reshape(comps, plan.dovi, axis=-3)
        rgb = _apply_cmat(*_rt_cmat(plan, rt, dtype), comps[..., 0, :, :],
                          comps[..., 1, :, :], comps[..., 2, :, :])
        rgb = dovi_ops.apply_lms_matrix(rgb, plan.dovi, axis=-3)
        # stage B: resize the PQ-encoded RGB to output res
        rgb = _fused_apply2d(rgb, wx, wy, None, dtype)
        return _fused_tail(plan, rgb, rt, pack_format)

    if with_rt:
        return fn
    return lambda planes: fn(planes)


def make_frame_fn(plan: PipelinePlan, dtype=jnp.float32, fused: bool | None = None,
                  pack_surface: bool = False,
                  rotation: int = 0, flip: bool = False):
    """Build the per-frame processing function (unjitted).

    Input: tuple of plane arrays (uint8/uint16), each (..., Hp, Wp) with
    matching leading batch dims.  Output: (..., 3, out_h, out_w) float32 in
    [0,1] (SDR/PQ encoded), quantized per the plan — or, with
    ``pack_surface``, an (..., out_h, out_w) int32 surface of packed
    R10G10B10A2/RGBA8 dwords (the swap-chain backbuffer analogue; view as
    uint32, decode with formats.unpack_rgb10).

    ``fused=None`` auto-selects the fused linear-resample path when legal
    (see :func:`_can_fuse`); ``False`` forces the staged reference path.

    ``rotation``/``flip`` produce ``rotate_flip(out, rotation, flip)`` of
    the finished surface (the packed dword IS one pixel)."""
    if rotation not in (0, 90, 180, 270):
        raise ValueError(f"rotation must be 0/90/180/270, got {rotation}")
    from .ops import geometry as geo_ops

    fmt = surface_pack_format(plan.dst) if pack_surface else None

    if fused is None:
        fused = _can_fuse(plan) or _can_split_fuse(plan)
    if fused:
        if plan.dovi is not None:
            base = _make_dovi_fused_fn(plan, dtype, pack_format=fmt)
        else:
            base = _make_fused_fn(plan, dtype, pack_format=fmt)
    else:
        base = _make_staged_fn(plan, dtype, fmt)
    if rotation == 0 and not flip:
        return base
    return lambda planes: geo_ops.rotate_flip(base(planes), rotation, flip)


def _make_staged_fn(plan: PipelinePlan, dtype, fmt: str | None):
    """The staged reference path: convert at source resolution, resize,
    then the post-scale chain — the reference's pass order."""
    s = plan.settings
    dst = plan.dst
    # Jinc2 with a dither-only tail: quantization rides the resample's
    # epilogue, saving the separate full-size final pass
    j2_tail = (s.upscaling == Upscaling.JINC2 and s.vp_scaling
               and not (plan.convert_to_sdr or plan.hlg_to_pq
                        or plan.fix_bt2020_sdr or plan.local_tonemap)
               and dst.video_rect is None
               and plan.dither_bits not in (None, 0))

    def _j2_epilogue(tile):
        db = plan.dither_bits
        if db < 0:
            return dither_ops.quantize(jnp.clip(tile, 0.0, 1.0), -db)
        return dither_ops.ordered_dither_iota(jnp.clip(tile, 0.0, 1.0), db)

    def _maybe_pack(rgb):
        return rgb if fmt is None else _pack_surface_xla(rgb, fmt)

    def fn(planes):
        rgb = _convert_color(plan, planes, dtype)
        if not s.vp_scaling:
            # shader-path order: corrections at source resolution
            rgb = _corrections(plan, rgb)
        vid_w, vid_h = dst.video_size
        if j2_tail:
            h, w = rgb.shape[-2], rgb.shape[-1]
            rx, ry = scale_ops.jinc2_passes(h, w, vid_h, vid_w,
                                            s.interpolate_at_50pct)
            if rx == "up" and ry in ("up", None) and (h, w) != (vid_h, vid_w):
                return _maybe_pack(scale_ops.jinc2_resize(
                    rgb, vid_h, vid_w, epilogue=_j2_epilogue))
        rgb = scale_ops.resize_plane(
            rgb, vid_h, vid_w,
            upscaling=s.upscaling, downscaling=s.downscaling,
            interpolate_at_50pct=s.interpolate_at_50pct)
        if s.vp_scaling:
            rgb = _corrections(plan, rgb)
        if plan.local_tonemap:
            rgb = _local_tonemap(plan, rgb)
        return _maybe_pack(_final_pass(plan, rgb))

    return fn


def serving_rt_keys(plan: PipelinePlan) -> set:
    """The rt keys this plan's serving program accepts — one per stage that
    exists statically (the reference's per-stage cbuffer discipline,
    independent of which execution path serves the plan)."""
    out = set()
    if plan.apply_matrix:
        out.add("cmat")
    if plan.local_tonemap:
        out.add("hdr")
    if plan.dovi_trims is not None and plan.dovi_trims.l2_enabled:
        out.add("l2_trims")
    if plan.dovi is not None:
        out.add("dovi_curves")
    return out


def make_serving_fn(plan: PipelinePlan, dtype=jnp.float32,
                    pack_surface: bool = False):
    """Serving-mode pipeline: ONE compiled program that takes per-frame
    runtime metadata alongside the planes, so title/scene changes never
    retrace (the reference analogously re-uploads cbuffers per sample
    rather than recompiling shaders):

      fn(planes, rt) with optional rt keys:
        "hdr"         — dict of HDR10 scalars for the local tone map
                        (see ops.tonemap.local_tonemap_pq_rt)
        "dovi_curves" — packed reshape tensors (ops.dovi.pack_curves)
        "cmat"        — {"m": (3,3), "c": (3,)} color-matrix override for
                        runtime ProcAmp (brightness/contrast/hue/saturation)
        "l2_trims"    — dict of DoVi L2 trim scalars (chroma_weight,
                        saturation_gain, trim_slope/offset/power); needs a
                        plan whose trims stage exists

    The plan decides *which* stages exist (static); rt supplies their
    parameters (dynamic) as traced tensors, so new values never retrace.

    The returned fn validates rt keys at trace time: unknown keys, or
    known keys whose stage does not exist in this plan, raise with the
    allowed set (a typo'd key must fail loudly, not be silently ignored).
    Attributes on the returned fn (survive one ``jax.jit`` wrap via
    inspection before jitting):

      fn.allowed_rt_keys — the plan's valid rt keys;
      fn.dovi_structure  — the reshape structure the program was traced
                           for (None without DoVi);
      fn.pack_curves(meta) — packs a scene's RPU curves validated against
                           that structure (structural drift raises instead
                           of silently corrupting frames).
    """
    s = plan.settings
    dst = plan.dst
    fmt = surface_pack_format(dst) if pack_surface else None

    allowed = serving_rt_keys(plan)
    structure = None
    if plan.dovi is not None:
        from .ops import dovi as dovi_ops
        structure = dovi_ops.curve_structure(plan.dovi)

    def _finish(inner):
        def checked(planes, rt=None):
            rt = rt or {}
            bad = set(rt) - allowed
            if bad:
                raise ValueError(
                    f"unknown serving rt key(s) {sorted(bad)}; this plan "
                    f"accepts {sorted(allowed)} (stage presence is static "
                    "— re-plan to add stages)")
            return inner(planes, rt)

        checked.allowed_rt_keys = frozenset(allowed)
        checked.dovi_structure = structure
        if structure is not None:
            from .ops import dovi as dovi_ops

            def pack_scene_curves(meta):
                return dovi_ops.pack_curves(meta, like=structure)

            checked.pack_curves = pack_scene_curves
        return checked

    if _can_fuse(plan):
        # the fused linear-prefix path supports the cmat/hdr/l2_trims
        # runtime hooks directly
        return _finish(_make_fused_fn(plan, dtype, with_rt=True,
                                      pack_format=fmt))
    if _can_split_fuse(plan):
        # DoVi serving: split-fused path with runtime reshape curves
        return _finish(_make_dovi_fused_fn(plan, dtype, with_rt=True,
                                           pack_format=fmt))

    def fn(planes, rt):
        rgb = _convert_color(plan, planes, dtype,
                             rt_curves=rt.get("dovi_curves"),
                             rt_cmat=rt.get("cmat"))
        trims = _resolve_rt_trims(plan, rt)
        if not s.vp_scaling:
            rgb = _corrections(plan, rgb, trims=trims)
        vid_w, vid_h = dst.video_size
        rgb = scale_ops.resize_plane(
            rgb, vid_h, vid_w,
            upscaling=s.upscaling, downscaling=s.downscaling,
            interpolate_at_50pct=s.interpolate_at_50pct)
        if s.vp_scaling:
            rgb = _corrections(plan, rgb, trims=trims)
        if plan.local_tonemap:
            hdr = rt.get("hdr")
            if hdr is not None:
                rgb = tonemap_ops.local_tonemap_pq_rt(
                    rgb, plan.tonemap_type, hdr, trims=trims, axis=-3,
                    window=plan.hdr10plus_window)
            else:
                rgb = _local_tonemap(plan, rgb, trims=trims)
        rgb = _final_pass(plan, rgb)
        if fmt is not None:
            rgb = _pack_surface_xla(rgb, fmt)
        return rgb

    return _finish(fn)


def make_deint_frame_fn(plan: PipelinePlan, field: int,
                        top_field_first: bool = True, dtype=jnp.float32,
                        motion_threshold: float = 8.0 / 255.0,
                        pack_surface: bool = False):
    """Per-field processing function for interlaced content: motion-adaptive
    deinterlace of every plane over a (prev, cur, next) window, then the
    regular pipeline — the explicit-kernel replacement of the D3D11VP
    rate-conversion blt with past/future reference frames
    (Source/D3D11VP.cpp:292-331,893-960).

    Signature: fn(prev_planes, cur_planes, next_planes) -> output frame for
    ``field`` (0 = first temporal field, 1 = second; render both for
    double-rate output, Source/DX11VideoProcessor.cpp:2176-2197).
    """
    from .ops import deinterlace as di

    base = make_frame_fn(plan, dtype, pack_surface=pack_surface)
    maxval = 2.0 ** plan.info.plane_bits - 1.0

    def fn(prev_planes, cur_planes, next_planes):
        deint = []
        for p, c, n in zip(prev_planes, cur_planes, next_planes):
            deint.append(di.motion_adaptive(
                c.astype(dtype), p.astype(dtype), n.astype(dtype),
                field=field, top_field_first=top_field_first,
                threshold=motion_threshold * maxval))
        return base(tuple(deint))

    return fn


def make_deint_fields_fn(plan: PipelinePlan, top_field_first: bool = True,
                         dtype=jnp.float32,
                         motion_threshold: float = 8.0 / 255.0,
                         pack_surface: bool = False):
    """Double-rate variant of :func:`make_deint_frame_fn`: ONE traced
    program renders BOTH temporal fields of a frame, so the integer→float
    casts are computed once and shared instead of once per field, and the
    two field renders dispatch as a single call.  Returns fn(prev, cur,
    next) -> (field0, field1)."""
    from .ops import deinterlace as di

    maxval = 2.0 ** plan.info.plane_bits - 1.0
    base = make_frame_fn(plan, dtype, pack_surface=pack_surface)

    def fn(prev_planes, cur_planes, next_planes):
        d0, d1 = [], []
        for p, c, n in zip(prev_planes, cur_planes, next_planes):
            cf = c.astype(dtype)
            pf = p.astype(dtype)
            nf = n.astype(dtype)
            kw = dict(top_field_first=top_field_first,
                      threshold=motion_threshold * maxval)
            d0.append(di.motion_adaptive(cf, pf, nf, field=0, **kw))
            d1.append(di.motion_adaptive(cf, pf, nf, field=1, **kw))
        return base(tuple(d0)), base(tuple(d1))

    return fn


class VideoProcessor:
    """High-level per-config processor: plan + jitted function.

    The analogue of CVideoProcessor/CDX11VideoProcessor: construct per
    media type (InitMediaType), then call :meth:`process` per frame/batch
    (ProcessSample -> Process).
    """

    def __init__(self, settings: Settings, src: SourceDescriptor,
                 dst: OutputDescriptor, dtype=jnp.float32,
                 pack_surface: bool = False):
        self.plan = plan_pipeline(settings, src, dst)
        self.dtype = dtype
        self.pack_surface = pack_surface
        self._fn = jax.jit(make_frame_fn(self.plan, dtype,
                                         pack_surface=pack_surface))

    def process(self, planes) -> jax.Array:
        """planes: sequence of numpy/jax arrays in canonical plane order."""
        return self._fn(tuple(jnp.asarray(p) for p in planes))

    def process_frame(self, frame) -> jax.Array:
        """Process an unpacked :class:`videorenderer.formats.PlanarFrame`."""
        return self.process(frame.planes)

    def process_packed(self, buf) -> jax.Array:
        """Ship the PACKED frame bytes to the device (smallest transfer) and
        unpack there — the analogue of the reference sampling packed
        textures on-GPU (Source/Shaders.cpp:82-529) instead of repacking on
        the CPU.  ``buf``: bytes or array holding one tightly-packed frame
        (leading batch dims allowed on arrays already shaped (..., n_words)).
        Falls back to the host unpackers for formats without a device
        unpacker."""
        from .formats import unpack_frame
        from .kernels.unpack_device import (DEVICE_BUFFER_DTYPE,
                                            has_device_unpacker,
                                            unpack_frame_device)
        info = self.plan.info
        src = self.plan.src
        if not has_device_unpacker(info.name):
            return self.process(
                unpack_frame(info.cformat, buf, src.width, src.height).planes)
        if isinstance(buf, (bytes, bytearray, memoryview)):
            buf = np.frombuffer(buf, DEVICE_BUFFER_DTYPE[info.name])
        if not hasattr(self, "_packed_fn"):
            self._packed_fn = jax.jit(lambda b: self._fn(unpack_frame_device(
                info.name, b, src.width, src.height)))
        return self._packed_fn(jnp.asarray(buf))
