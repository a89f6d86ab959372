"""The match-only Feature Matcher in one launch (port of
``repro.kernels.matcher_fused.match_fused_pallas``, K4).

Per left feature of every batch row: the masked Hamming argmin over the
right features of its row (``hamming_match.masked_hamming``; ties go
to the lowest right index).  A batch row is a stereo pair for
``stereo_match``, one pair of a frame transition for ``temporal_match``
and the localization backend.

Returns (dist (B, K) int32 [``BIG`` when no candidate], idx (B, K)
int32 [-1]).  The CUDA kernel is ``csrc/match_fused.cu``; the plain
version is the single-pair matcher's (``hamming_match``) over the batch
axis, and the wrapper picks it only for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hamming_match import hamming_match_plain

KERNEL = _build.CudaKernel("match_fused", "match_fused", "ppppppiiiff")


#: Plain version of the match-only kernel: the single-pair Hamming
#: matcher's (K9's), which takes any leading batch axes.
match_fused_plain = hamming_match_plain


def match_fused_cuda(desc_l, meta_l, desc_r, meta_r, *, row_band: float,
                     max_disparity: float):
    """Launch ``csrc/match_fused.cu`` once over every batch row."""
    dev = _build.require_cuda(desc_l, meta_l, desc_r, meta_r)
    if (desc_l.dtype != torch.int32 or desc_r.dtype != torch.int32
            or meta_l.dtype != torch.float32
            or meta_r.dtype != torch.float32):
        raise ValueError("match-only kernel takes int32 descriptors and "
                         "float32 meta rows")
    b, k = desc_l.shape[0], desc_l.shape[1]
    m = desc_r.shape[1]
    dist = torch.empty((b, k), dtype=torch.int32, device=dev)
    idx = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b * k:
        KERNEL(dev, desc_l.data_ptr(), meta_l.data_ptr(), desc_r.data_ptr(),
               meta_r.data_ptr(), dist.data_ptr(), idx.data_ptr(), b, k, m,
               float(row_band), float(max_disparity))
    return dist, idx


def match_fused(desc_l, meta_l, desc_r, meta_r, *, row_band: float,
                max_disparity: float):
    """desc_*: (B, K, 8)/(B, M, 8) int32 bit-views; meta_*: (B, K, 4)/
    (B, M, 4) float32 rows of (x, y, level, valid).  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel."""
    fn = (match_fused_plain if desc_l.device.type == "cpu"
          else match_fused_cuda)
    return fn(desc_l, meta_l, desc_r, meta_r, row_band=row_band,
              max_disparity=max_disparity)
