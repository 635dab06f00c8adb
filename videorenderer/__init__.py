"""videorenderer — a video-processing framework with the capabilities of
MPC Video Renderer (Aleksoid1978/VideoRenderer), rebuilt from scratch on
JAX/XLA.

The reference is a Windows DirectShow renderer filter; this package rebuilds
its processing engine — format conversion, chroma upsampling, YUV->RGB,
deinterlacing, scaling, HDR tone mapping, gamut conversion, Dolby Vision
reshaping, dithering and subtitle/OSD composition — as pure, jit-compiled
functions over batched frame tensors that XLA compiles for the accelerator
(matmuls for resampling, fused elementwise chains, jax.sharding for
multi-device scale-out).
"""

from .config import (ChromaScaling, Deinterlacing, Downscaling, Settings,
                     SuperResolution, SwapEffect, TexFormat, ToneMapType,
                     Upscaling)
from .csputils import CSP, ChromaLocation, Levels, Primaries, TRC
from .formats import ColorFormat, PlanarFrame, get_format_info, unpack_frame
from .pipeline import (HDR10Metadata, OutputDescriptor, SourceDescriptor,
                       VideoProcessor, make_frame_fn, make_serving_fn,
                       plan_pipeline)

__version__ = "0.4.0"

from .api import VideoRenderer  # noqa: E402  (needs __version__ above)

__all__ = [
    "CSP", "ChromaLocation", "ChromaScaling", "ColorFormat", "Deinterlacing",
    "Downscaling", "HDR10Metadata", "Levels", "OutputDescriptor",
    "PlanarFrame", "Primaries", "Settings", "SourceDescriptor",
    "SuperResolution", "SwapEffect", "TRC", "TexFormat", "ToneMapType",
    "Upscaling", "VideoProcessor", "VideoRenderer", "get_format_info",
    "make_frame_fn", "make_serving_fn", "plan_pipeline", "unpack_frame",
]
