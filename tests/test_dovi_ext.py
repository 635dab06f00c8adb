"""ST 2094-10 extension-block resolution (DoVi L1/L2/L3/L6) vs the exact
CopySample semantics (Source/DX11VideoProcessor.cpp:2357-2500)."""

import numpy as np
import pytest

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.csputils import CSP, Primaries, TRC
from videorenderer.ops import dovi as dovi_ops
from videorenderer.ops.dovi_ext import (DoviExtensions, L1Extension,
                                            L2Extension, L3Extension,
                                            L6Extension, l1_nits,
                                            merge_hdr10, nits_to_pq,
                                            pq_to_nits,
                                            runtime_hdr_from_extensions,
                                            runtime_trims_from_extensions,
                                            select_l2_trims)
from videorenderer.pipeline import HDR10Metadata, plan_pipeline


def test_pq_nits_roundtrip():
    for nits in (0.005, 1.0, 100.0, 1000.0, 4000.0, 10000.0):
        assert pq_to_nits(nits_to_pq(nits)) == pytest.approx(nits, rel=1e-5)
    # 12-bit code 3079 is the canonical ~1000-nit point
    assert pq_to_nits(3079 / 4095.0) == pytest.approx(1000.0, rel=0.01)


def test_l1_nits_and_l3_offsets():
    ext = DoviExtensions(l1=L1Extension(min_pq=62, max_pq=3079, avg_pq=1229))
    mn, mx, av = l1_nits(ext)
    assert mn == int(pq_to_nits(62 / 4095.0))
    assert mx == int(pq_to_nits(3079 / 4095.0))
    assert av == int(pq_to_nits(1229 / 4095.0))
    # L3 shifts each by (offset - 2048) codes before conversion
    ext3 = DoviExtensions(l1=ext.l1,
                          l3=L3Extension(min_pq_offset=2048,
                                         max_pq_offset=2448,
                                         avg_pq_offset=1648))
    mn3, mx3, av3 = l1_nits(ext3)
    assert mn3 == mn
    assert mx3 == int(pq_to_nits((3079 + 400) / 4095.0))
    assert av3 == int(pq_to_nits((1229 - 400) / 4095.0))
    assert l1_nits(DoviExtensions()) is None


def _l2(target_nits, slope):
    return L2Extension(target_max_pq=int(round(nits_to_pq(target_nits)
                                               * 4095)),
                       trim_slope=slope)


def test_l2_scenario_a_interpolates():
    """Display between two targets: lerp by PQ position."""
    ext = DoviExtensions(l2=(_l2(100, 1800), _l2(1000, 2200)))
    t = select_l2_trims(ext, 600.0)
    lo_pq = ext.l2[0].target_max_pq / 4095.0
    up_pq = ext.l2[1].target_max_pq / 4095.0
    w = (nits_to_pq(600.0) - lo_pq) / (up_pq - lo_pq)
    expect = (1800 + (2200 - 1800) * w) / 4096.0 + 0.5
    assert t.l2_enabled
    assert t.trim_slope == pytest.approx(expect, abs=1e-6)
    # neutral fields stay neutral through the packing
    assert t.trim_offset == pytest.approx(0.0, abs=1e-6)
    assert t.trim_power == pytest.approx(1.0, abs=1e-6)
    assert t.chroma_weight == pytest.approx(0.0, abs=1e-6)
    assert t.saturation_gain == pytest.approx(0.0, abs=1e-6)


def test_l2_scenario_b_toward_neutral():
    """Display brighter than all targets: lerp toward 2048 at the master
    peak; at/above the master the trims are fully neutral."""
    ext = DoviExtensions(l2=(_l2(100, 1600),),
                         source_max_pq=int(round(nits_to_pq(4000.0) * 4095)))
    t_at_master = select_l2_trims(ext, 4000.0)
    assert t_at_master.trim_slope == pytest.approx(1.0, abs=1e-3)
    t_mid = select_l2_trims(ext, 600.0)
    assert 1600 / 4096.0 + 0.5 < t_mid.trim_slope < 1.0


def test_l2_scenario_c_clamps_to_dimmest():
    """Display dimmer than all targets: take the dimmest target's trims."""
    ext = DoviExtensions(l2=(_l2(600, 1700), _l2(1000, 2300)))
    t = select_l2_trims(ext, 100.0)
    assert t.trim_slope == pytest.approx(1700 / 4096.0 + 0.5, abs=1e-6)
    assert select_l2_trims(DoviExtensions(), 600.0) is None


def test_l6_fallback_merge():
    """L6 overrides mastering/CLL/FALL; otherwise ColorMetadata's source
    PQ range derives them (Render merge, DX11VideoProcessor.cpp:2645-2659)."""
    # no side-data HDR10, no L6: ColorMetadata-derived
    ext = DoviExtensions(source_max_pq=int(round(nits_to_pq(4000.0) * 4095)),
                         source_min_pq=int(round(nits_to_pq(0.005) * 4095)))
    h = merge_hdr10(None, ext)
    assert h.mastering_max_nits == pytest.approx(4000.0, rel=0.01)
    assert h.mastering_min_nits == pytest.approx(0.005, rel=0.05)
    # L6 overrides everything
    ext6 = DoviExtensions(l6=L6Extension(max_luminance=2000,
                                         min_luminance=10,  # 0.001 nits
                                         max_cll=1800, max_fall=300))
    h6 = merge_hdr10(HDR10Metadata(mastering_max_nits=1000.0, max_cll=900.0),
                     ext6)
    assert h6.mastering_max_nits == 2000.0
    assert h6.mastering_min_nits == pytest.approx(0.001)
    assert h6.max_cll == 1800.0
    assert h6.max_fall == 300.0
    # dovi max only raises, never lowers, the side-data mastering max
    h_keep = merge_hdr10(HDR10Metadata(mastering_max_nits=10000.0), ext)
    assert h_keep.mastering_max_nits == 10000.0


def _identity_meta():
    return dovi_ops.DoviMetadata(
        curves=(dovi_ops.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                    [1, -0.164553, -0.571353],
                                    [1, 1.8814, 0]]),
        ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
        rgb_to_lms_matrix=np.linalg.inv(dovi_ops.DOVI_LMS2RGB))


def _hdr_plan(ext, tm_type=5):
    from videorenderer.config import ToneMapType
    src = SourceDescriptor(format=ColorFormat.P010, width=32, height=16,
                           transfer=TRC.PQ, primaries=Primaries.BT_2020,
                           matrix=CSP.BT_2020_NC, dovi=_identity_meta(),
                           dovi_ext=ext)
    dst = OutputDescriptor(width=32, height=16, bits=10, hdr=True)
    st = Settings(convert_to_sdr=False, hdr_passthrough=True,
                  hdr_local_tone_mapping=True,
                  hdr_local_tone_mapping_type=ToneMapType(tm_type),
                  hdr_display_max_nits=600)
    return plan_pipeline(st, src, dst)


def test_plan_resolves_l1_params_and_type_upgrade():
    ext = DoviExtensions(l1=L1Extension(min_pq=62, max_pq=3079, avg_pq=1229),
                         l2=(_l2(600, 1900),))
    plan = _hdr_plan(ext, tm_type=5)
    mn, mx, av = l1_nits(ext)
    p = plan.tonemap_params
    assert plan.tonemap_type == 6      # BT.2390 upgrades to ST 2094-10
    assert p.mastering_max_nits == float(mx)
    assert p.max_cll == float(mx)      # maxCLL takes the L1 max
    assert p.max_fall == float(av)     # maxFALL takes the L1 avg
    assert p.display_max_nits == 600.0
    # L2 trims auto-derived from the extension set
    assert plan.dovi_trims is not None and plan.dovi_trims.l2_enabled
    # output HDR10 metadata carries the merged mastering data
    assert plan.output_hdr10 is not None


def test_plan_l6_fallback_without_l1():
    ext = DoviExtensions(l6=L6Extension(max_luminance=2000, min_luminance=50,
                                        max_cll=1700, max_fall=250))
    plan = _hdr_plan(ext, tm_type=5)
    assert plan.tonemap_type == 5      # no L1: no upgrade
    p = plan.tonemap_params
    assert p.mastering_max_nits == 2000.0
    assert p.max_cll == 1700.0
    assert p.max_fall == 250.0
    assert plan.output_hdr10.max_cll == 1700.0


def test_serving_no_retrace_across_scenes():
    """L1-only scene -> L1+L3 scene -> L6-fallback scene: one compiled
    program, per-scene runtime dicts, no retrace (VERDICT r1 item 4)."""
    import jax
    import jax.numpy as jnp
    from videorenderer.pipeline import make_serving_fn

    ext0 = DoviExtensions(l1=L1Extension(62, 3079, 1229), l2=(_l2(600, 1900),))
    plan = _hdr_plan(ext0, tm_type=5)
    traces = []

    def raw(planes, rt):
        traces.append(1)
        return make_serving_fn(plan)(planes, rt)

    fn = jax.jit(raw)
    y = np.full((16, 32), 600 << 6, np.uint16)
    u = np.full((8, 16), 512 << 6, np.uint16)
    v = np.full((8, 16), 512 << 6, np.uint16)
    meta = _identity_meta()
    curves = {k: jnp.asarray(vv)
              for k, vv in dovi_ops.pack_curves(meta).items()}

    scenes = [
        DoviExtensions(l1=L1Extension(62, 3079, 1229), l2=(_l2(600, 1900),)),
        DoviExtensions(l1=L1Extension(62, 3400, 1500),
                       l3=L3Extension(max_pq_offset=2248),
                       l2=(_l2(600, 2100),)),
        DoviExtensions(l6=L6Extension(max_luminance=2000, min_luminance=50,
                                      max_cll=1700, max_fall=250)),
    ]
    outs = []
    for ext in scenes:
        rt = {"dovi_curves": curves,
              "hdr": {k: jnp.asarray(vv) for k, vv in
                      runtime_hdr_from_extensions(ext, None, 600.0).items()}}
        trims = runtime_trims_from_extensions(ext, 600.0)
        if trims is not None:
            rt["l2_trims"] = {k: jnp.asarray(vv) for k, vv in trims.items()}
        else:
            # the compiled program includes the trim stage; neutral values
            # make it an identity (slope 1, offset 0, power 1, sat/chroma 0)
            rt["l2_trims"] = {k: jnp.asarray(vv, jnp.float32) for k, vv in
                              dict(chroma_weight=0.0, saturation_gain=0.0,
                                   trim_slope=1.0, trim_offset=0.0,
                                   trim_power=1.0).items()}
        outs.append(np.asarray(fn((y, u, v), rt)))
    assert len(traces) == 1
    assert not np.allclose(outs[0], outs[1])
    assert not np.allclose(outs[1], outs[2])
