"""Sparse FE over every keypoint of every camera x level in one launch
(port of ``repro.kernels.describe_fused.describe_fused_pyramid_pallas``).

Per keypoint: clamp it into its slab's true image, read the 31x31 raw
patch and compute the circular-mask moments (m10, m01) and theta =
atan2(m01, m10) (paper Eq. 1); quantize theta to one of 12 bins of 30
degrees; read that bin's ``STEER_LUT`` row and form the 256 tau bits
p(A) < p(B) on the 31x31 smoothed patch (paper Eqs. 2-3); pack bit i
into word i // 32.  The kernels read the LUT packed, each pair's two
indices in one word (``ref.steer_lut_packed``).

Inputs use the dense stage's flat slab layout (``SlabTable``): the raw
levels and their blur lie in two flat buffers of that layout.  The
keypoints are (B, Ktot, 2) int32 level coordinates, level-sorted along
Ktot; ``col_level`` (Ktot,) gives each column's level, so keypoint
(b, j) reads slab ``col_level[j] * B + b``.  The CUDA kernel is
``csrc/describe_fused.cu``; the plain version below is the same
function in PyTorch, and the wrapper picks it only for a CPU tensor.

``describe_fused`` is the per-level kernel (port of
``describe_fused_pallas``, K7; ``csrc/describe_level.cu``): the same
theta, moments and descriptor for (B, K) keypoints of B raw and
smoothed images of ONE level, one launch a level, for the per-level FE
schedule; it runs K2's keypoint body (``describe_common.cuh``'s
``describe_keypoint``).  ``orient_fused`` is the orientation-only
kernel (port of ``orient_fused_pallas``, K8; ``csrc/orient_fused.cu``):
the same moments and theta with no smoothed image and no descriptor.
The three plain versions share their patch reads and arithmetic.

Every kernel takes float32 or uint8 images (raw and smoothed of one
type).  uint8 is the paper's 8-bit datapath (the JAX package's integer
``_block_theta`` and ``_tap_sign_bits``): int32 moments, given out as
float32, theta = atan2 of those floats, and tau bits that compare the
integer taps.  Each kernel's uint8 variant is its template body
instantiated for ``uint8_t`` (C entry point ``<symbol>_u8``), counted
under the kernel's own counter.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontend_fused import SlabTable, slab_table
from repro_torch.kernels.ref import (INV_ANGLE_STEP, PATCH, RADIUS,
                                     clamped_index, lut_descriptor,
                                     patch_theta, patch_theta_int,
                                     steer_lut_packed, theta_to_bin)

PIXELS = (torch.float32, torch.uint8)
KERNEL = _build.CudaKernel("describe_fused", "describe_fused_pyramid",
                           "pppppppppiif", variants=("f32", "u8"))
ORIENT_KERNEL = _build.CudaKernel("orient_fused", "orient_fused", "ppppiiii",
                                  variants=("f32", "u8"))
LEVEL_KERNEL = _build.CudaKernel("describe_level", "describe_fused",
                                 "pppppppiiiif", variants=("f32", "u8"))


def _slab_patches(flat: torch.Tensor, slab: torch.Tensor, table, xy):
    """(B, K) slab ids + (B, K, 2) keypoints -> (B, K, 31, 31) patches
    of ``flat``, centers clamped into the slab, reads edge-clamped."""
    off, h, w = table[slab, 0], table[slab, 1], table[slab, 2]
    x = torch.minimum(xy[..., 0].long().clamp(min=0), w - 1)
    y = torch.minimum(xy[..., 1].long().clamp(min=0), h - 1)
    rows = clamped_index(y - RADIUS, PATCH, h)            # (B, K, 31)
    cols = clamped_index(x - RADIUS, PATCH, w)
    idx = (off[..., None, None] + rows[..., :, None] * w[..., None, None]
           + cols[..., None, :])
    return flat[idx]


def level_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(B, H, W) images + (B, K, 2) keypoints -> (B, K, 31, 31) patches,
    centers clamped into the image, reads edge-clamped."""
    b, h, w = img.shape
    slabs = slab_table([(h, w)], b, img.device)
    slab = torch.arange(b, device=xy.device)[:, None].expand(b, xy.shape[1])
    return _slab_patches(img.reshape(-1), slab, slabs.table, xy)


def _theta(raw_patches: torch.Tensor):
    """Raw patches -> (theta, float32 moments): int32 moments for uint8
    patches, float32 sums for float ones."""
    if raw_patches.dtype == torch.uint8:
        theta, mom = patch_theta_int(raw_patches)
        return theta, mom.float()
    return patch_theta(raw_patches)


def _describe_patches(raw_patches: torch.Tensor, sm_patches: torch.Tensor):
    """Raw and smoothed patches -> (theta, moments, desc): the sparse
    FE's arithmetic."""
    theta, mom = _theta(raw_patches)
    return theta, mom, lut_descriptor(sm_patches, theta_to_bin(theta))


def describe_fused_pyramid_plain(raw: torch.Tensor, smoothed: torch.Tensor,
                                 slabs: SlabTable, xy: torch.Tensor,
                                 col_level: torch.Tensor):
    """Plain PyTorch version of the sparse FE kernel.  Returns (theta
    (B, Ktot) f32, moments (B, Ktot, 2) f32, desc (B, Ktot, 8) int32)."""
    b = xy.shape[0]
    slab = (col_level.long()[None, :] * b
            + torch.arange(b, device=xy.device)[:, None])
    return _describe_patches(_slab_patches(raw, slab, slabs.table, xy),
                             _slab_patches(smoothed, slab, slabs.table, xy))


def describe_fused_pyramid_cuda(raw: torch.Tensor, smoothed: torch.Tensor,
                                slabs: SlabTable, xy: torch.Tensor,
                                col_level: torch.Tensor):
    """Launch ``csrc/describe_fused.cu`` once over every keypoint."""
    dev = _build.require_cuda(raw, smoothed, slabs.table, xy, col_level)
    if (raw.dtype not in PIXELS or smoothed.dtype != raw.dtype
            or xy.dtype != torch.int32 or col_level.dtype != torch.int32):
        raise ValueError("sparse FE takes float32 or uint8 slabs, both of "
                         "one type, and int32 keypoints and column levels")
    b, k = xy.shape[0], xy.shape[1]
    theta = torch.empty((b, k), dtype=torch.float32, device=dev)
    mom = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    desc = torch.empty((b, k, 8), dtype=torch.int32, device=dev)
    if b * k:
        KERNEL(dev, steer_lut_packed(str(dev)).data_ptr(), raw.data_ptr(),
               smoothed.data_ptr(), slabs.table.data_ptr(), xy.data_ptr(),
               col_level.data_ptr(), theta.data_ptr(), mom.data_ptr(),
               desc.data_ptr(), b, k, INV_ANGLE_STEP,
               variant=_build.variant_of(raw))
    return theta, mom, desc


def describe_fused_pyramid(raw: torch.Tensor, smoothed: torch.Tensor,
                           slabs: SlabTable, xy: torch.Tensor,
                           col_level: torch.Tensor):
    """Orientation, moments and rBRIEF for (B, Ktot) level-sorted
    keypoints.  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    fn = (describe_fused_pyramid_plain if raw.device.type == "cpu"
          else describe_fused_pyramid_cuda)
    return fn(raw, smoothed, slabs, xy, col_level)


def describe_fused_plain(raw: torch.Tensor, smoothed: torch.Tensor,
                         xy: torch.Tensor):
    """Plain PyTorch version of the per-level sparse FE kernel: K2's on a
    one-level slab table.  Returns (theta (B, K) f32, moments (B, K, 2)
    f32, desc (B, K, 8) int32)."""
    return _describe_patches(level_patches(raw, xy),
                             level_patches(smoothed, xy))


def _check_level(raw: torch.Tensor, xy: torch.Tensor, what: str):
    if raw.dtype not in PIXELS or xy.dtype != torch.int32:
        raise ValueError(f"{what} takes float32 or uint8 images and int32 "
                         "keypoints")
    b, h, w = raw.shape
    k = xy.shape[1]
    if xy.shape != (b, k, 2):
        raise ValueError(f"keypoints must be (B, K, 2), got {tuple(xy.shape)}")
    return b, k, h, w


def describe_fused_cuda(raw: torch.Tensor, smoothed: torch.Tensor,
                        xy: torch.Tensor):
    """Launch ``csrc/describe_level.cu`` once over every keypoint."""
    dev = _build.require_cuda(raw, smoothed, xy)
    b, k, h, w = _check_level(raw, xy, "per-level sparse FE")
    if smoothed.dtype != raw.dtype or smoothed.shape != raw.shape:
        raise ValueError("the smoothed image must be of the raw image's "
                         "dtype and shape")
    theta = torch.empty((b, k), dtype=torch.float32, device=dev)
    mom = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    desc = torch.empty((b, k, 8), dtype=torch.int32, device=dev)
    if b * k:
        LEVEL_KERNEL(dev, steer_lut_packed(str(dev)).data_ptr(),
                     raw.data_ptr(), smoothed.data_ptr(), xy.data_ptr(),
                     theta.data_ptr(), mom.data_ptr(), desc.data_ptr(), b,
                     k, h, w,
                     INV_ANGLE_STEP, variant=_build.variant_of(raw))
    return theta, mom, desc


def describe_fused(raw: torch.Tensor, smoothed: torch.Tensor,
                   xy: torch.Tensor):
    """raw, smoothed: (B, H, W) float32 or uint8 images of one level;
    xy: (B, K, 2) int32 keypoints, clamped into the image.  Returns (theta (B, K),
    moments (B, K, 2), desc (B, K, 8) int32).  A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel."""
    fn = describe_fused_plain if raw.device.type == "cpu" else describe_fused_cuda
    return fn(raw, smoothed, xy)


def orient_fused_plain(raw: torch.Tensor, xy: torch.Tensor):
    """Plain PyTorch version of the orientation-only kernel.  Returns
    (theta (B, K) f32, moments (B, K, 2) f32)."""
    return _theta(level_patches(raw, xy))


def orient_fused_cuda(raw: torch.Tensor, xy: torch.Tensor):
    """Launch ``csrc/orient_fused.cu`` once over every keypoint."""
    dev = _build.require_cuda(raw, xy)
    b, k, h, w = _check_level(raw, xy, "orientation")
    theta = torch.empty((b, k), dtype=torch.float32, device=dev)
    mom = torch.empty((b, k, 2), dtype=torch.float32, device=dev)
    if b * k:
        ORIENT_KERNEL(dev, raw.data_ptr(), xy.data_ptr(), theta.data_ptr(),
                      mom.data_ptr(), b, k, h, w,
                      variant=_build.variant_of(raw))
    return theta, mom


def orient_fused(raw: torch.Tensor, xy: torch.Tensor):
    """raw: (B, H, W) float32 or uint8 images; xy: (B, K, 2) int32
    keypoints, clamped into the image.  Returns (theta (B, K), moments
    (B, K, 2)).  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel."""
    fn = orient_fused_plain if raw.device.type == "cpu" else orient_fused_cuda
    return fn(raw, xy)
