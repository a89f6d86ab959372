"""FAST-9/16 score map of a batch of images in one launch (port of
``repro.kernels.fast_detect.fast_score_map_pallas``, K11).

Per pixel: the 16 Bresenham circle taps minus the center, the max over
the 16 arc starts of (min over a 9-tap bright arc, -max over a dark
arc), kept where it is above the threshold and 0 elsewhere; taps past
the border replicate the edge pixel.  This is the dense FE's score
before NMS, and its plain version is the dense FE's
(``frontend_fused.fast_score_plain``).  The CUDA kernel is
``csrc/fast_detect.cu``; the wrapper picks the plain version only for a
CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontend_fused import fast_score_plain

KERNEL = _build.CudaKernel("fast_detect", "fast_score_map", "ppiiif")


def fast_score_map_cuda(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """Launch ``csrc/fast_detect.cu`` once over every image."""
    dev = _build.require_cuda(x)
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError("the FAST score map takes (B, H, W) float32 images")
    out = torch.empty_like(x)
    b, h, w = x.shape
    if out.numel():
        KERNEL(dev, x.data_ptr(), out.data_ptr(), b, h, w, float(threshold))
    return out


def fast_score_map(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """(B, H, W) float32 -> (B, H, W) float32 thresholded FAST-9/16
    score.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel."""
    fn = fast_score_plain if x.device.type == "cpu" else fast_score_map_cuda
    return fn(x, float(threshold))
