"""Rotated BRIEF descriptors (port of ``repro.core.brief``; paper Sec.
II-B2, III-C): the single-image view of the sparse FE's second half.

Descriptors are computed on the Gaussian-smoothed level image with the
paper's angle-binned steering: theta is quantized to 12 bins of 30
degrees and the rotated sampling pairs come from the ``STEER_LUT`` ROM.
Given the same theta, ``describe`` reproduces the fused sparse FE's
descriptors bit for bit.  Descriptors are (K, 8) int32 bit-views of the
uint32 words.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import ORBConfig
from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref


def describe(smoothed: torch.Tensor, xy: torch.Tensor,
             theta: torch.Tensor) -> torch.Tensor:
    """LUT-steered rBRIEF of one (H, W) smoothed image at (K, 2) int
    keypoints (clamped into it) with (K,) float32 theta -> (K, 8) int32,
    in plain PyTorch (no launch)."""
    return _ref.lut_descriptor(_ref.extract_patches(smoothed, xy),
                               _ref.theta_to_bin(theta))


def smooth(level_img: torch.Tensor, cfg: ORBConfig) -> torch.Tensor:
    """The paper's Image Smoothing module: the 7x7 Gaussian, ONE
    launch."""
    return ops.gaussian_blur7(level_img, quantized=cfg.quantized)
