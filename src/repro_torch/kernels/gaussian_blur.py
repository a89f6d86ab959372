"""Separable 7x7 binomial blur of a batch of images in one launch (port
of ``repro.kernels.gaussian_blur.gaussian_blur7_pallas``, K12).

The horizontal pass [1, 4, 8, 10, 8, 4, 1], then the vertical one, each
summed tap by tap in order, over the norm 36^2: rounded half up with
``quantized``, else the plain quotient; taps past the border replicate
the edge pixel.  This is the dense FE's blur, and its plain version is
the dense FE's (``frontend_fused.blur_plain``).  The CUDA kernel is
``csrc/gaussian_blur.cu``; the wrapper picks the plain version only for
a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontend_fused import blur_plain

KERNEL = _build.CudaKernel("gaussian_blur", "gaussian_blur7", "ppiiii")


def gaussian_blur7_cuda(x: torch.Tensor, quantized: bool) -> torch.Tensor:
    """Launch ``csrc/gaussian_blur.cu`` once over every image."""
    dev = _build.require_cuda(x)
    if x.dtype != torch.float32 or x.dim() != 3:
        raise ValueError("the 7x7 blur takes (B, H, W) float32 images")
    out = torch.empty_like(x)
    b, h, w = x.shape
    if out.numel():
        KERNEL(dev, x.data_ptr(), out.data_ptr(), b, h, w,
               int(bool(quantized)))
    return out


def gaussian_blur7(x: torch.Tensor, quantized: bool = True) -> torch.Tensor:
    """(B, H, W) float32 -> (B, H, W) float32 7x7-Gaussian-smoothed
    images.  A CPU tensor runs the plain version; a CUDA tensor launches
    the kernel."""
    fn = blur_plain if x.device.type == "cpu" else gaussian_blur7_cuda
    return fn(x, bool(quantized))
