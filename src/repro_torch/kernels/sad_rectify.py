"""SAD sweep of the unfused Feature Matcher schedule (port of
``repro.kernels.sad_rectify``, K10).

The paper's Correction and Disparity Computing module (Sec. III-D) on
caller-gathered windows: each (P, P) left patch against its
(P, P + 2R) right strip at every one of the 2R + 1 shifts, pixels
truncated to int32 first.  Returns the (K, 2R + 1) int32 SAD table; the
caller takes the first-occurrence argmin.  The CUDA kernel is
``csrc/sad_search.cu``; the plain version is ``ref.sad_search``, and the
wrapper picks it only for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

KERNEL = _build.CudaKernel("sad_search", "sad_search", "pppiii")
#: Largest window (px) and sweep half-range the kernel's shared buffers
#: hold (``matcher::MAXP``, ``matcher::MAXR`` in ``matcher_common.cuh``).
MAX_WINDOW = 15
MAX_RANGE = 15

sad_search_plain = ref.sad_search


def sad_search_cuda(left_patches: torch.Tensor,
                    right_strips: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/sad_search.cu`` once over the K window rows."""
    if (left_patches.dtype != torch.float32
            or right_strips.dtype != torch.float32):
        raise ValueError("the SAD sweep takes float32 patches and strips")
    k, p = left_patches.shape[0], left_patches.shape[1]
    width = right_strips.shape[-1]
    if (tuple(left_patches.shape) != (k, p, p)
            or tuple(right_strips.shape) != (k, p, width)
            or width < p or (width - p) % 2):
        raise ValueError(
            "the SAD sweep takes (K, P, P) patches and (K, P, P + 2R) "
            f"strips, got {tuple(left_patches.shape)} and "
            f"{tuple(right_strips.shape)}")
    sad_range = (width - p) // 2
    if p > MAX_WINDOW or sad_range > MAX_RANGE:
        raise ValueError(
            f"the SAD sweep holds windows up to {MAX_WINDOW} px and sweeps "
            f"up to +-{MAX_RANGE} px, got P={p}, R={sad_range}")
    dev = _build.require_cuda(left_patches, right_strips)
    table = torch.empty((k, 2 * sad_range + 1), dtype=torch.int32,
                        device=dev)
    if k:
        KERNEL(dev, left_patches.data_ptr(), right_strips.data_ptr(),
               table.data_ptr(), k, p, sad_range)
    return table


def sad_search(left_patches: torch.Tensor,
               right_strips: torch.Tensor) -> torch.Tensor:
    """left_patches: (K, P, P); right_strips: (K, P, P + 2R) float32.
    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel."""
    fn = (sad_search_plain if left_patches.device.type == "cpu"
          else sad_search_cuda)
    return fn(left_patches, right_strips)
