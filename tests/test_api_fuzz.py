"""API-level composition fuzz: rotation x flip x stereo x user shaders x
models x packed surface through VideoRenderer.

The invariant: for ANY composition, the packed-surface renderer's dwords
equal the XLA pack of the planar renderer's output — whether the pack ran
in the base program (geometry-only tail), deferred (float tails), or after model
hooks.  Catches ordering/geometry/packing drift across the feature
matrix."""

import dataclasses as dc

import numpy as np
import jax.numpy as jnp
import pytest

import jax

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.api import VideoRenderer
from videorenderer.config import SuperResolution
from videorenderer.csputils import CSP
from videorenderer.pipeline import _pack_surface_xla


def _planes(w, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8))


def test_api_composition_fuzz():
    from videorenderer.models import superres, videohdr

    sr_cfg = superres.SuperResConfig(channels=8, num_blocks=1, s2d=2)
    sr_params = superres.init_params(jax.random.PRNGKey(0), sr_cfg)
    vh_cfg = videohdr.VideoHDRConfig(channels=8)
    vh_params = videohdr.init_params(jax.random.PRNGKey(1), vh_cfg)

    rng = np.random.default_rng(77)
    for trial in range(12):
        w, h = 32, 16
        rotation = int(rng.choice([0, 90, 180, 270]))
        flip = bool(rng.integers(2))
        stereo = int(rng.integers(2))
        shader = bool(rng.integers(2))
        mode = int(rng.integers(4))  # 0 none, 1 sr, 2 videohdr, 3 both
        dither = bool(rng.integers(2))

        st = Settings(use_dither=dither)
        if mode == 1:
            st = dc.replace(st, vp_superres=SuperResolution.P1080)
            dst = OutputDescriptor(width=w * 2, height=h * 2, bits=8)
        elif mode == 2:
            st = dc.replace(st, vp_rtx_video_hdr=True)
            dst = OutputDescriptor(width=w, height=h, bits=10, hdr=True)
        elif mode == 3:   # upscale + inverse tone map in one chain
            st = dc.replace(st, vp_superres=SuperResolution.P1080,
                            vp_rtx_video_hdr=True)
            dst = OutputDescriptor(width=w * 2, height=h * 2, bits=10,
                                   hdr=True)
        else:
            dst = OutputDescriptor(width=48, height=24, bits=8)
        src = SourceDescriptor(format=ColorFormat.NV12, width=w, height=h,
                               matrix=CSP.BT_709)

        def build(packed):
            vr = VideoRenderer(st, pack_surface=packed)
            vr.open(src, dst)
            if mode == 1:
                vr.set_superres_params(sr_params, sr_cfg)
            elif mode == 2:
                vr.set_videohdr_params(vh_params, vh_cfg)
            if rotation:
                vr.flt_set("rotation", rotation)
            if flip:
                vr.flt_set("flip", True)
            if stereo:
                vr.flt_set("stereo3dTransform", 1)
            if shader:
                # clamp first: pipeline intermediates are unclamped (fp16
                # ring semantics) and a fractional pow of a negative is NaN
                vr.flt_set("cmd_addPostScaleShader",
                           lambda rgb: jnp.clip(rgb, 0.0, 1.0) ** 1.05)
            return vr

        tag = (trial, rotation, flip, stereo, shader, mode, dither)
        planes = _planes(w, h, seed=trial)
        planar = np.asarray(build(False).process_frame(planes))
        # the SURFACE never swaps: content rotates within the fixed
        # output rect (the reference's window does not rotate)
        assert planar.shape == (3, dst.height, dst.width), tag
        assert np.isfinite(planar).all(), tag

        packed = np.asarray(build(True).process_frame(planes))
        fmt = "rgb10a2" if dst.bits == 10 else "rgba8"
        want = np.asarray(_pack_surface_xla(planar, fmt))
        np.testing.assert_array_equal(packed, want, err_msg=str(tag))
