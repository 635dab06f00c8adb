"""On-card checks of each path at small shapes: compile for the GPU, run,
and agree with the same program compiled for the CPU.

Skipped where JAX has no GPU.  ``python chip_smoke.py`` runs them on the card,
in its own process."""

import numpy as np
import jax
import pytest

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                           SourceDescriptor)
from videorenderer.config import ToneMapType, Upscaling
from videorenderer.csputils import CSP, Primaries, TRC
from videorenderer.pipeline import (HDR10Metadata, make_deint_fields_fn,
                                    make_frame_fn, make_serving_fn,
                                    plan_pipeline)

pytestmark = pytest.mark.gpu


def _planes(fmt, w, h, seed=0):
    rng = np.random.default_rng(seed)
    if fmt == ColorFormat.NV12:
        return (rng.integers(0, 256, (h, w), np.uint8),
                rng.integers(0, 256, (h // 2, w // 2), np.uint8),
                rng.integers(0, 256, (h // 2, w // 2), np.uint8))
    return (rng.integers(64, 941, (h, w), np.uint16) << 6,
            rng.integers(64, 961, (h // 2, w // 2), np.uint16) << 6,
            rng.integers(64, 961, (h // 2, w // 2), np.uint16) << 6)


def _on_cpu(fn, *args):
    cpu = jax.devices("cpu")[0]
    args = jax.device_put(args, cpu)
    with jax.default_device(cpu):
        return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(*args))


def _on_card(dev, fn, *args):
    out = jax.jit(fn)(*jax.device_put(args, dev))
    assert all(x.devices() == {dev} for x in jax.tree_util.tree_leaves(out))
    return jax.tree_util.tree_map(np.asarray, out)


def _close(got, ref, lsb):
    # one code at isolated dither thresholds: cuBLAS and the CPU sum the
    # float32 products in different orders
    d = np.abs(got.astype(np.float64) - ref.astype(np.float64))
    assert np.isfinite(got).all()
    assert d.max() <= 1.5 * lsb
    assert (d > 0.5 * lsb).mean() < 0.01


def test_fused_headline_chain(gpu_device):
    plan = plan_pipeline(
        Settings(upscaling=Upscaling.LANCZOS3, convert_to_sdr=True),
        SourceDescriptor(format=ColorFormat.P010, width=256, height=128,
                         matrix=CSP.BT_2020_NC, primaries=Primaries.BT_2020,
                         transfer=TRC.PQ, hdr10=HDR10Metadata()),
        OutputDescriptor(width=128, height=64, bits=10))
    fn = make_frame_fn(plan)
    planes = _planes(ColorFormat.P010, 256, 128)
    _close(_on_card(gpu_device, fn, planes), _on_cpu(fn, planes), 1 / 1023)


def test_jinc2_lowrank_chain(gpu_device):
    plan = plan_pipeline(
        Settings(upscaling=Upscaling.JINC2, use_dither=True),
        SourceDescriptor(format=ColorFormat.NV12, width=256, height=128,
                         matrix=CSP.BT_709),
        OutputDescriptor(width=320, height=288, bits=8))
    fn = make_frame_fn(plan)
    planes = _planes(ColorFormat.NV12, 256, 128)
    _close(_on_card(gpu_device, fn, planes), _on_cpu(fn, planes), 1 / 255)


def test_serving_rt_scalars(gpu_device):
    plan = plan_pipeline(
        Settings(convert_to_sdr=False, hdr_passthrough=True,
                 hdr_local_tone_mapping=True,
                 hdr_local_tone_mapping_type=ToneMapType.BT2390,
                 hdr_display_max_nits=600),
        SourceDescriptor(format=ColorFormat.P010, width=256, height=128,
                         matrix=CSP.BT_2020_NC, primaries=Primaries.BT_2020,
                         transfer=TRC.PQ, hdr10=HDR10Metadata()),
        OutputDescriptor(width=256, height=128, bits=10, hdr=True))
    fn = make_serving_fn(plan)
    rt = {"hdr": {"mastering_min_nits": 0.01, "mastering_max_nits": 2000.0,
                  "max_cll": 1500.0, "max_fall": 500.0,
                  "display_max_nits": 650.0}}
    planes = _planes(ColorFormat.P010, 256, 128)
    _close(_on_card(gpu_device, fn, planes, rt), _on_cpu(fn, planes, rt),
           1 / 1023)


def test_deint_fields(gpu_device):
    plan = plan_pipeline(
        Settings(convert_to_sdr=True, upscaling=Upscaling.LANCZOS3),
        SourceDescriptor(format=ColorFormat.P010, width=256, height=128,
                         matrix=CSP.BT_2020_NC, primaries=Primaries.BT_2020,
                         transfer=TRC.HLG, interlaced=True),
        OutputDescriptor(width=128, height=64, bits=8))
    fn = make_deint_fields_fn(plan)
    win = tuple(_planes(ColorFormat.P010, 256, 128, seed=s) for s in range(3))
    got = _on_card(gpu_device, fn, *win)
    ref = _on_cpu(fn, *win)
    for g, r in zip(got, ref):
        _close(g, r, 1 / 255)
