"""Dolby Vision serving session: per-scene RPU updates with zero retraces.

The reference re-uploads its DoVi dynamic cbuffers per sample
(Source/DX11VideoProcessor.cpp:990-1130) so the compiled shader never
changes mid-stream.  The analogue here: ONE jitted serving program whose
runtime inputs carry the curve values through both stages of the
split-fused pipeline.

Run:  python examples/dovi_serving.py   (GPU, or JAX_PLATFORMS=cpu)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time

import numpy as np
import jax
import jax.numpy as jnp

from videorenderer import (ColorFormat, OutputDescriptor, Settings,
                               SourceDescriptor)
from videorenderer.config import Upscaling
from videorenderer.csputils import CSP, Primaries, TRC
from videorenderer.ops import dovi as dovi_ops
from videorenderer.pipeline import (HDR10Metadata, make_serving_fn,
                                        plan_pipeline)


def main():
    # plan-time metadata fixes the curve STRUCTURE (piece counts, poly/MMR
    # kinds, MMR orders); scenes may change every coefficient value
    meta = dovi_ops.DoviMetadata(
        curves=(dovi_ops.identity_curve(),) * 3,
        ycc_to_rgb_matrix=np.array([[1, 0, 1.4746],
                                    [1, -0.164553, -0.571353],
                                    [1, 1.8814, 0]]),
        ycc_to_rgb_offset=np.array([0.0, 0.5, 0.5]),
        rgb_to_lms_matrix=np.linalg.inv(dovi_ops.DOVI_LMS2RGB))

    plan = plan_pipeline(
        Settings(convert_to_sdr=True, upscaling=Upscaling.CATMULL_ROM),
        SourceDescriptor(format=ColorFormat.P010, width=3840, height=2160,
                         transfer=TRC.PQ, primaries=Primaries.BT_2020,
                         matrix=CSP.BT_2020_NC, dovi=meta,
                         hdr10=HDR10Metadata()),
        OutputDescriptor(width=1920, height=1080, bits=10))
    fn = jax.jit(make_serving_fn(plan))

    rng = np.random.default_rng(0)
    batch = tuple(jnp.asarray(p) for p in (
        rng.integers(64, 941, (8, 2160, 3840), np.uint16) << 6,
        rng.integers(64, 961, (8, 1080, 1920), np.uint16) << 6,
        rng.integers(64, 961, (8, 1080, 1920), np.uint16) << 6))

    structure = dovi_ops.curve_structure(meta)
    for scene in range(3):
        # per-scene RPU: new coefficient values, same structure.  like=
        # raises if a scene's RPU changes the curve STRUCTURE (that needs
        # a re-plan — the "regenerate the shader" case)
        base = dovi_ops.pack_curves(meta, like=structure)
        curves = {k: jnp.asarray(v) * (1.0 - 0.02 * scene)
                  for k, v in base.items()}
        t0 = time.perf_counter()
        out = fn(batch, {"dovi_curves": curves})
        out.block_until_ready()
        print(f"scene {scene}: {out.shape} in "
              f"{time.perf_counter() - t0:.3f}s "
              f"({'compile+run' if scene == 0 else 'run only'})")


if __name__ == "__main__":
    main()
