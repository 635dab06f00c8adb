"""The plain-XLA paths that run on the GPU, each against an independent
formulation: fused vs staged resample chains, fused vs staged serving with
runtime parameters, the three Jinc2 formulations, the DoVi split-fused
chain, the double-rate deinterlace program, rotation and surface packing.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                           SourceDescriptor)
from videorenderer import formats as fmts
from videorenderer import pipeline
from videorenderer.config import Downscaling, ToneMapType, Upscaling
from videorenderer.csputils import CSP, Levels, Primaries, TRC
from videorenderer.ops import dovi as dovi_ops
from videorenderer.ops import geometry as geo
from videorenderer.ops import scale
from videorenderer.pipeline import (HDR10Metadata, make_deint_fields_fn,
                                    make_deint_frame_fn, make_frame_fn,
                                    make_serving_fn, plan_pipeline)


def _yuv_planes(fmt, w, h, seed=0, batch=()):
    rng = np.random.default_rng(seed)
    shapes = fmts.get_format_info(fmt).plane_shapes(w, h)
    if fmts.get_format_info(fmt).depth == 8:
        return tuple(rng.integers(0, 256, batch + s, np.uint8)
                     for s in shapes)
    return tuple(rng.integers(64, 941, batch + s, np.uint16) << 6
                 for s in shapes)


def _assert_codes_close(got, ref, lsb, max_lsb=1, frac=0.01):
    """Quantized outputs: at most ``max_lsb`` codes apart, and only on
    isolated quantization-boundary pixels."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= (max_lsb + 0.5) * lsb, d.max() / lsb
    assert (d > 0.5 * lsb).mean() < frac


# ---------------------------------------------------------------------------
# integer-input resample: fused (normalize + composed maps) vs staged
# ---------------------------------------------------------------------------

GEOMETRIES = [
    # (src WxH, dst WxH, settings overrides)
    ((512, 300), (256, 150), dict(upscaling=Upscaling.LANCZOS3)),
    ((256, 128), (512, 256), dict(upscaling=Upscaling.CATMULL_ROM)),
    ((512, 128), (128, 32), dict(downscaling=Downscaling.HAMMING,
                                 interpolate_at_50pct=False)),
    ((256, 64), (512, 64), dict(upscaling=Upscaling.LANCZOS3)),    # W only
    ((128, 128), (128, 256), dict(upscaling=Upscaling.CATMULL_ROM)),  # H only
    ((64, 48), (64, 48), {}),                                      # 1:1
]


@pytest.mark.parametrize("fmt", [ColorFormat.NV12, ColorFormat.P010],
                         ids=["u8", "u16"])
@pytest.mark.parametrize("geom", GEOMETRIES,
                         ids=[f"g{i}" for i in range(len(GEOMETRIES))])
def test_fused_integer_input_matches_staged(fmt, geom):
    """Raw uint8/uint16 planes: the fused path folds the UNORM
    normalization, chroma upsample and resize into per-axis matmuls; it
    must equal the staged convert -> resize order to float32 rounding."""
    (w, h), (ow, oh), st_over = geom
    plan = plan_pipeline(Settings(use_dither=False, **st_over),
                         SourceDescriptor(format=fmt, width=w, height=h,
                                          matrix=CSP.BT_709),
                         OutputDescriptor(width=ow, height=oh, bits=16))
    assert pipeline._can_fuse(plan)
    planes = _yuv_planes(fmt, w, h, seed=w + h)
    fused = np.asarray(jax.jit(make_frame_fn(plan))(planes))
    staged = np.asarray(jax.jit(make_frame_fn(plan, fused=False))(planes))
    assert fused.shape == staged.shape == (3, oh, ow)
    np.testing.assert_allclose(fused, staged, atol=2e-5)


# ---------------------------------------------------------------------------
# serving: runtime scalars through the fused tail vs the staged program
# ---------------------------------------------------------------------------

_HDR_RT = {"mastering_min_nits": 0.01, "mastering_max_nits": 2000.0,
           "max_cll": 1500.0, "max_fall": 500.0, "display_max_nits": 650.0}
_TRIMS_RT = {"chroma_weight": 0.1, "saturation_gain": 0.9,
             "trim_slope": 1.1, "trim_offset": 0.02, "trim_power": 0.95}
_CMAT_RT = {"m": np.array([[1.0, 0.1, 1.4], [0.9, -0.2, -0.7],
                           [1.1, 1.8, 0.05]]),
            "c": np.array([0.01, 0.02, -0.03])}


def _serving_plan(with_trims: bool):
    kw = {}
    if with_trims:
        from videorenderer.ops.dovi_ext import DoviExtensions, L2Extension
        kw["dovi_ext"] = DoviExtensions(
            l2=(L2Extension(target_max_pq=2851,   # ~600 nits
                            trim_slope=2200, trim_offset=2100,
                            trim_power=1800, trim_chroma_weight=2048,
                            trim_saturation_gain=2048),))
    src = SourceDescriptor(
        format=ColorFormat.P010, width=64, height=48,
        matrix=CSP.BT_2020_NC, primaries=Primaries.BT_2020, transfer=TRC.PQ,
        hdr10=HDR10Metadata(mastering_max_nits=4000.0, max_cll=3000.0,
                            max_fall=800.0), **kw)
    dst = OutputDescriptor(width=128, height=96, bits=10, hdr=True)
    st = Settings(convert_to_sdr=False, hdr_passthrough=True,
                  hdr_local_tone_mapping=True,
                  hdr_local_tone_mapping_type=ToneMapType.BT2390,
                  hdr_display_max_nits=600)
    return plan_pipeline(st, src, dst)


@pytest.mark.parametrize("with_trims,keys", [
    (False, ()),
    (False, ("cmat",)),
    (False, ("hdr",)),
    (True, ("hdr", "l2_trims")),
    (True, ("cmat", "hdr", "l2_trims")),
])
def test_serving_fused_matches_staged(monkeypatch, with_trims, keys):
    """The fused serving program with runtime color matrix, HDR10 scalars
    for the local tone map and DoVi L2 trims == the staged serving program
    given the same rt values."""
    plan = _serving_plan(with_trims)
    assert pipeline._can_fuse(plan)
    rt = {k: {"cmat": _CMAT_RT, "hdr": _HDR_RT, "l2_trims": _TRIMS_RT}[k]
          for k in keys}
    planes = _yuv_planes(ColorFormat.P010, 64, 48, seed=7)
    got = np.asarray(make_serving_fn(plan)(planes, rt))
    monkeypatch.setattr(pipeline, "_can_fuse", lambda p: False)
    ref = np.asarray(make_serving_fn(plan)(planes, rt))
    assert got.shape == ref.shape == (3, 96, 128)
    # 10-bit dithered output: the fused and staged contractions differ by
    # float32 rounding, so a value right at a dither threshold may flip by
    # one code (the trims' pow/EOTF chain can amplify that to two)
    _assert_codes_close(got, ref, 1 / 1023, max_lsb=2)


# ---------------------------------------------------------------------------
# Jinc2: phase, low-rank and gather formulations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,oh,ow", [(24, 32, 48, 64), (24, 32, 37, 53),
                                       (48, 64, 48, 128), (30, 40, 61, 90)])
def test_jinc2_lowrank_matches_gather_grid(h, w, oh, ow):
    """The low-rank dense path (what every long-period geometry runs) vs
    the per-tap gather formulation, and vs the phase path where the phase
    periods are short; the low-rank error is the documented SVD-cutoff
    band, exact for 2x."""
    x = np.random.default_rng(h * w).random((2, h, w)).astype(np.float32)
    lr = np.asarray(scale._jinc2_lowrank(jnp.asarray(x), oh, ow))
    ref = np.asarray(scale._jinc2_gather(jnp.asarray(x), oh, ow))
    assert lr.shape == ref.shape == (2, oh, ow)
    np.testing.assert_allclose(lr, ref, atol=1e-3)
    psnr = -10.0 * np.log10(np.mean((lr - ref) ** 2) + 1e-30)
    assert psnr > 65.0, psnr
    qy, py = scale._phase_period(h, oh)
    qx, px = scale._phase_period(w, ow)
    if qy <= 8 and qx <= 8:
        ph = np.asarray(scale._jinc2_phases(jnp.asarray(x), oh, ow,
                                            qy, py, qx, px))
        np.testing.assert_allclose(ph, ref, atol=1e-5)


@pytest.mark.parametrize("fmt,w,h,ow,oh", [
    (ColorFormat.NV12, 64, 48, 128, 96),     # 2x: rank-exact
    (ColorFormat.NV12, 64, 48, 160, 120),    # 2.5x: truncated rank
    (ColorFormat.YUY2, 64, 32, 128, 64),     # 4:2:2, W-only chroma
])
@pytest.mark.parametrize("pack", [False, True], ids=["planar", "packed"])
def test_jinc2_convert_dither_chain(fmt, w, h, ow, oh, pack):
    """Convert -> 2D Jinc2 (low-rank, dither epilogue) -> surface, vs the
    gather formulation followed by the ordinary final pass."""
    plan = plan_pipeline(
        Settings(upscaling=Upscaling.JINC2, use_dither=True),
        SourceDescriptor(format=fmt, width=w, height=h, matrix=CSP.BT_709),
        OutputDescriptor(width=ow, height=oh, bits=8))
    planes = _yuv_planes(fmt, w, h, seed=oh)
    got = np.asarray(make_frame_fn(plan, pack_surface=pack)(planes))
    rgb = pipeline._convert_color(plan, planes)
    ref = pipeline._final_pass(plan, scale._jinc2_gather(rgb, oh, ow))
    ref = np.asarray(ref)
    if pack:
        d = got.view(np.uint32)
        assert d.shape == (oh, ow)
        got = np.stack([(d >> s) & 0xFF for s in (0, 8, 16)], 0) / 255.0
    assert got.shape == ref.shape == (3, oh, ow)
    _assert_codes_close(got, ref, 1 / 255, frac=0.02)


# ---------------------------------------------------------------------------
# DoVi: split-fused vs staged
# ---------------------------------------------------------------------------

def _dovi_meta(kind: str):
    mats = dict(
        ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                    [1, -0.164553, -0.571353],
                                    [1, 1.8814, 0]]),
        ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
        rgb_to_lms_matrix=np.linalg.inv(dovi_ops.DOVI_LMS2RGB))
    if kind == "identity":
        return dovi_ops.DoviMetadata(curves=(dovi_ops.identity_curve(),) * 3,
                                     **mats)
    rng = np.random.default_rng(19)
    mmr = dovi_ops.ReshapeCurve(
        pivots=(), method=(1,), poly=np.zeros((1, 3)),
        mmr_order=(2,), mmr_constant=(0.4,),
        mmr_coef=rng.normal(0, 0.05, (1, 3, 7)))
    luma = dovi_ops.ReshapeCurve(
        pivots=(0.5,), method=(0, 0),
        poly=np.array([[0.02, 0.9, 0.1], [0.0, 1.0, -0.05]]))
    return dovi_ops.DoviMetadata(curves=(luma, mmr, mmr), **mats)


def _dovi_plan(meta, hdr_out: bool):
    src = SourceDescriptor(format=ColorFormat.P010, width=64, height=48,
                           transfer=TRC.PQ, primaries=Primaries.BT_2020,
                           matrix=CSP.BT_2020_NC, dovi=meta,
                           hdr10=HDR10Metadata())
    if hdr_out:
        return plan_pipeline(
            Settings(convert_to_sdr=False, hdr_passthrough=True,
                     hdr_local_tone_mapping=True,
                     hdr_local_tone_mapping_type=ToneMapType.BT2390,
                     hdr_display_max_nits=600,
                     upscaling=Upscaling.CATMULL_ROM), src,
            OutputDescriptor(width=128, height=96, bits=10, hdr=True))
    return plan_pipeline(Settings(convert_to_sdr=True), src,
                         OutputDescriptor(width=32, height=24, bits=10))


@pytest.mark.parametrize("curves", ["identity", "poly_mmr"])
@pytest.mark.parametrize("hdr_out", [False, True], ids=["sdr", "hdr"])
@pytest.mark.parametrize("runtime", [False, True], ids=["static", "rt"])
def test_dovi_split_fused_matches_staged(curves, hdr_out, runtime):
    """Stage A (chroma upsample + reshape + RPU matrix + LMS) at source
    resolution, stage B (resize + tail) at output resolution — with static
    or runtime reshape curves — vs the staged convert -> resize path."""
    meta = _dovi_meta(curves)
    plan = _dovi_plan(meta, hdr_out)
    assert pipeline._can_split_fuse(plan)
    planes = _yuv_planes(ColorFormat.P010, 64, 48, seed=17)
    ref = np.asarray(make_frame_fn(plan, fused=False)(planes))
    fn = make_serving_fn(plan)
    rt = ({"dovi_curves": {k: jnp.asarray(v) for k, v in
                           fn.pack_curves(meta).items()}}
          if runtime else {})
    got = np.asarray(fn(planes, rt))
    assert got.shape == ref.shape
    _assert_codes_close(got, ref, 1 / 1023, max_lsb=2)


# ---------------------------------------------------------------------------
# fuzz: random shapes through the fused and Jinc2 chains
# ---------------------------------------------------------------------------

def _fuzz_cases():
    rng = np.random.default_rng(77)
    cases = []
    for _ in range(3):      # lanczos3, fused path
        w, h = int(rng.integers(3, 20)) * 4, int(rng.integers(3, 16)) * 4
        ow, oh = int(rng.integers(3, 20)) * 4, int(rng.integers(3, 16)) * 4
        cases.append((Upscaling.LANCZOS3, w, h, ow, oh))
    for _ in range(2):      # jinc2 up/up, staged low-rank path
        w, h = int(rng.integers(6, 16)) * 4, int(rng.integers(6, 12)) * 4
        cases.append((Upscaling.JINC2, w, h, w * 2 + 8, h * 2 + 8))
    return cases


@pytest.mark.parametrize("case", _fuzz_cases(),
                         ids=[f"f{i}" for i in range(5)])
def test_fused_path_fuzz(case):
    """Randomized shapes: the default path (fused for separable filters,
    low-rank Jinc2 otherwise) against the staged path with the resample
    done by an independent formulation (dense matrices per axis; the
    Jinc2 gather)."""
    up, w, h, ow, oh = case
    plan = plan_pipeline(Settings(upscaling=up, use_dither=True),
                         SourceDescriptor(format=ColorFormat.NV12, width=w,
                                          height=h, matrix=CSP.BT_709),
                         OutputDescriptor(width=ow, height=oh, bits=8))
    planes = _yuv_planes(ColorFormat.NV12, w, h, seed=w * h + ow)
    got = np.asarray(make_frame_fn(plan)(planes))
    rgb = pipeline._convert_color(plan, planes)
    if up == Upscaling.JINC2:
        rgb = scale._jinc2_gather(rgb, oh, ow)
    else:
        rgb = scale.resize_plane(rgb, oh, ow, upscaling=up)
    ref = np.asarray(pipeline._final_pass(plan, rgb))
    assert got.shape == ref.shape == (3, oh, ow), case
    _assert_codes_close(got, ref, 1 / 255, frac=0.02)


# ---------------------------------------------------------------------------
# double-rate deinterlace: one program for both fields vs per-field
# ---------------------------------------------------------------------------

_DEINT_CASES = [
    # (src, dst, settings, packed)
    (SourceDescriptor(format=ColorFormat.P010, width=64, height=32,
                      matrix=CSP.BT_2020_NC, levels=Levels.TV,
                      primaries=Primaries.BT_2020, transfer=TRC.PQ,
                      interlaced=True, hdr10=HDR10Metadata()),
     OutputDescriptor(width=32, height=16, bits=8),
     Settings(convert_to_sdr=True, upscaling=Upscaling.LANCZOS3), False),
    (SourceDescriptor(format=ColorFormat.NV12, width=64, height=32,
                      matrix=CSP.BT_709, interlaced=True),
     OutputDescriptor(width=64, height=32, bits=8), Settings(), True),
    # chroma height 20: not a multiple of any tile size
    (SourceDescriptor(format=ColorFormat.NV12, width=64, height=40,
                      matrix=CSP.BT_709, interlaced=True),
     OutputDescriptor(width=32, height=24, bits=8),
     Settings(use_dither=False), False),
]


@pytest.mark.parametrize("case", _DEINT_CASES, ids=["hlg", "packed",
                                                    "nondiv"])
@pytest.mark.parametrize("tff", [True, False], ids=["tff", "bff"])
def test_deint_fields_match_per_field(case, tff):
    src, dst, st, packed = case
    plan = plan_pipeline(st, src, dst)
    p, c, n = (_yuv_planes(src.format, src.width, src.height, seed=s,
                           batch=(2,)) for s in range(3))
    both = make_deint_fields_fn(plan, top_field_first=tff,
                                pack_surface=packed)(p, c, n)
    for field in (0, 1):
        one = make_deint_frame_fn(plan, field, top_field_first=tff,
                                  pack_surface=packed)(p, c, n)
        got, ref = np.asarray(both[field]), np.asarray(one)
        assert got.shape == ref.shape
        assert got.shape[-2:] == (dst.height, dst.width)
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# rotation / flip and the surface packer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rotation,flip", [(r, f) for r in (0, 90, 180, 270)
                                           for f in (False, True)])
def test_jinc2_rotation_matches_rotate_flip(rotation, flip):
    """Rotation on the Jinc2 chain == rotate_flip of the unrotated packed
    surface, bit for bit (a packed dword is one pixel)."""
    plan = plan_pipeline(
        Settings(upscaling=Upscaling.JINC2, use_dither=True),
        SourceDescriptor(format=ColorFormat.NV12, width=64, height=48,
                         matrix=CSP.BT_709),
        OutputDescriptor(width=128, height=96, bits=8))
    planes = _yuv_planes(ColorFormat.NV12, 64, 48, seed=17)
    base = np.asarray(make_frame_fn(plan, pack_surface=True)(planes))
    got = np.asarray(make_frame_fn(plan, pack_surface=True,
                                   rotation=rotation, flip=flip)(planes))
    ref = np.asarray(geo.rotate_flip(jnp.asarray(base), rotation, flip))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fmt", ["rgb10a2", "rgba8"])
@pytest.mark.parametrize("batch", [(), (2,)], ids=["frame", "batch"])
def test_pack_surface_round_trip(fmt, batch):
    """Packing dithered codes into dwords is lossless: decoding returns the
    planar codes exactly, and alpha is saturated."""
    bits = 10 if fmt == "rgb10a2" else 8
    maxc = 2 ** bits - 1
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, maxc + 1, batch + (3, 16, 24)) / maxc
    d = np.asarray(pipeline._pack_surface_xla(jnp.asarray(codes), fmt)
                   ).view(np.uint32)
    assert d.shape == batch + (16, 24)
    if bits == 10:
        got = np.moveaxis(fmts.unpack_rgb10(d), -1, -3)
        assert np.all(d >> 30 == 3)
    else:
        got = np.stack([(d >> s) & 0xFF for s in (0, 8, 16)], -3) / 255.0
        assert np.all(d >> 24 == 0xFF)
    np.testing.assert_allclose(got, codes, atol=1e-6)


@pytest.mark.parametrize("fmt", [ColorFormat.NV12, ColorFormat.P010])
def test_spatial_one_shard_matches_single_chip(fmt):
    """The spatial fused builder on a 1-shard mesh (no collectives) equals
    the single-device fused path exactly: same maps, same order."""
    from videorenderer.parallel.spatial import (make_spatial_frame_fn,
                                                shard_planes_rows)
    plan = plan_pipeline(Settings(use_dither=False,
                                  upscaling=Upscaling.LANCZOS3),
                         SourceDescriptor(format=fmt, width=64, height=48,
                                          matrix=CSP.BT_709),
                         OutputDescriptor(width=128, height=96, bits=8))
    planes = tuple(jnp.asarray(p) for p in _yuv_planes(fmt, 64, 48, seed=31))
    single = np.asarray(make_frame_fn(plan)(planes))
    mesh = Mesh(np.array(jax.devices()[:1]), ("spatial",))
    got = np.asarray(make_spatial_frame_fn(plan, mesh)(
        shard_planes_rows(mesh, planes)))
    np.testing.assert_array_equal(got, single)
