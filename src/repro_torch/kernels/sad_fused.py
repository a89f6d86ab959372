"""The SAD-only Feature Matcher in one launch (port of
``repro.kernels.matcher_fused.sad_fused_pallas``, K5).

Per (pair, keypoint) with caller-given window centers: the
(window, window) left patch around the rounded (half to even), clamped
left center against the (window, window + 2R) right strip around the
rounded, clamped right center, edge-replicated, summed in int32 at each
of the 2R + 1 shifts (``ref.gather_patches`` + ``ref.sad_search``).

Returns the (P, K, 2R + 1) int32 SAD table; the caller takes the
argmin.  The CUDA kernel is ``csrc/sad_fused.cu``; the plain version
below is the same function in PyTorch, and the wrapper picks it only
for a CPU tensor.

The images are float32 or uint8 (the paper's 8-bit datapath; C entry
point ``sad_fused_u8``, the same template body, counted under the
kernel's own counter); the SAD is int32 either way.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gather_patches, sad_search

KERNEL = _build.CudaKernel("sad_fused", "sad_fused", "pppppiiiiii",
                           variants=("f32", "u8"))


def sad_fused_plain(img_l, img_r, xy_l, xy_r, *, sad_window: int = 11,
                    sad_range: int = 5):
    """Plain PyTorch version of the SAD-only kernel."""
    return torch.stack([
        sad_search(gather_patches(img_l[p], xy_l[p], sad_window, sad_window),
                   gather_patches(img_r[p], xy_r[p], sad_window,
                                  sad_window + 2 * sad_range))
        for p in range(xy_l.shape[0])])


def sad_fused_cuda(img_l, img_r, xy_l, xy_r, *, sad_window: int = 11,
                   sad_range: int = 5):
    """Launch ``csrc/sad_fused.cu`` once over every pair."""
    dev = _build.require_cuda(img_l, img_r, xy_l, xy_r)
    if (xy_l.dtype != torch.float32 or xy_r.dtype != torch.float32
            or img_l.dtype not in (torch.float32, torch.uint8)
            or img_r.dtype != img_l.dtype):
        raise ValueError("SAD-only kernel takes float32 or uint8 images of "
                         "one type and float32 centers")
    if img_l.shape != img_r.shape:
        raise ValueError("left and right images must share one shape")
    if sad_window > 15 or sad_range > 15:
        raise ValueError("the SAD-only kernel holds windows up to 15 px "
                         "and sweeps up to +-15 px")
    p, k = xy_l.shape[0], xy_l.shape[1]
    _, h, w = img_l.shape
    table = torch.empty((p, k, 2 * sad_range + 1), dtype=torch.int32,
                        device=dev)
    if p * k:
        KERNEL(dev, xy_l.data_ptr(), xy_r.data_ptr(), img_l.data_ptr(),
               img_r.data_ptr(), table.data_ptr(), p, k, h, w,
               int(sad_window), int(sad_range),
               variant=_build.variant_of(img_l))
    return table


def sad_fused(img_l, img_r, xy_l, xy_r, *, sad_window: int = 11,
              sad_range: int = 5):
    """img_*: (P, H, W) float32 or uint8 level-0 images; xy_*: (P, K, 2)
    float32 window centers.  A CPU tensor runs the plain version; a CUDA
    tensor launches the kernel."""
    fn = sad_fused_plain if xy_l.device.type == "cpu" else sad_fused_cuda
    return fn(img_l, img_r, xy_l, xy_r, sad_window=sad_window,
              sad_range=sad_range)
