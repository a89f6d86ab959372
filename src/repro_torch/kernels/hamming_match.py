"""The Feature Matcher's front half: masked Hamming distances and the
single-pair Hamming matcher of the unfused schedule (port of
``repro.kernels.hamming_match``, K9).

``masked_hamming`` is the Search Region Decision (epipolar row band,
disparity range, same pyramid level, both valid) fused with the 256-bit
Hamming distance as a ``BIG``-sentinel mask — the arithmetic every
matcher kernel runs per left/right feature pair.  ``hamming_match``
takes its argmin for ONE stereo pair in one launch: (dist (K,) int32
[``BIG`` when no candidate], idx (K,) int32 [-1]), ties to the lowest
right index.  The CUDA kernel is ``csrc/hamming_match.cu``; the plain
version below is the same function in PyTorch (any leading batch axes:
the match-only matcher's plain version is this one), and the wrapper
picks it only for a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

BIG = 1 << 20     # sentinel distance for masked-out pairs

KERNEL = _build.CudaKernel("hamming_match", "hamming_match", "ppppppiiff")


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of int32 bit-views -> int32 (SWAR in int64, so no sign
    or overflow question arises)."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def masked_hamming(dl: torch.Tensor, ml: torch.Tensor, dr: torch.Tensor,
                   mr: torch.Tensor, *, row_band: float,
                   max_disparity: float) -> torch.Tensor:
    """(..., K, 8) x (..., M, 8) int32 descriptor bit-views plus
    (x, y, level, valid) meta rows -> (..., K, M) int32 Hamming
    distances, ``BIG`` outside the search region."""
    dist = _popcount32(dl[..., :, None, :] ^ dr[..., None, :, :]).sum(
        dim=-1, dtype=torch.int32)
    dx = ml[..., :, None, 0] - mr[..., None, :, 0]          # x_L - x_R
    dy = (ml[..., :, None, 1] - mr[..., None, :, 1]).abs()
    same_level = ml[..., :, None, 2] == mr[..., None, :, 2]
    valid = (ml[..., :, None, 3] > 0.5) & (mr[..., None, :, 3] > 0.5)
    mask = ((dy <= row_band) & (dx >= 0.0) & (dx <= max_disparity)
            & same_level & valid)
    return torch.where(mask, dist, torch.full_like(dist, BIG))


def hamming_match_plain(desc_l, meta_l, desc_r, meta_r, *, row_band: float,
                        max_disparity: float):
    """Plain PyTorch masked Hamming argmin over (..., K, 8) x (..., M, 8):
    the first occurrence of the minimum, (``BIG``, -1) where no
    candidate survives (also when M is 0)."""
    dist_all = masked_hamming(desc_l, meta_l, desc_r, meta_r,
                              row_band=float(row_band),
                              max_disparity=float(max_disparity))
    if dist_all.shape[-1] == 0:
        best = torch.full(dist_all.shape[:-1], BIG, dtype=torch.int32,
                          device=dist_all.device)
        return best, torch.full_like(best, -1)
    best, arg = dist_all.min(dim=-1)      # first occurrence of the min
    return best, torch.where(best >= BIG, torch.full_like(best, -1),
                             arg.to(torch.int32))


def hamming_match_cuda(desc_l, meta_l, desc_r, meta_r, *, row_band: float,
                       max_disparity: float):
    """Launch ``csrc/hamming_match.cu`` once over the K left features."""
    dev = _build.require_cuda(desc_l, meta_l, desc_r, meta_r)
    if (desc_l.dtype != torch.int32 or desc_r.dtype != torch.int32
            or meta_l.dtype != torch.float32
            or meta_r.dtype != torch.float32):
        raise ValueError("the Hamming matcher takes int32 descriptors and "
                         "float32 meta rows")
    k, m = desc_l.shape[0], desc_r.shape[0]
    if (tuple(desc_l.shape) != (k, 8) or tuple(meta_l.shape) != (k, 4)
            or tuple(desc_r.shape) != (m, 8)
            or tuple(meta_r.shape) != (m, 4)):
        raise ValueError("the Hamming matcher takes (K, 8)/(M, 8) "
                         "descriptors and (K, 4)/(M, 4) meta rows of one "
                         "pair")
    dist = torch.empty(k, dtype=torch.int32, device=dev)
    idx = torch.empty(k, dtype=torch.int32, device=dev)
    if k:
        KERNEL(dev, desc_l.data_ptr(), meta_l.data_ptr(), desc_r.data_ptr(),
               meta_r.data_ptr(), dist.data_ptr(), idx.data_ptr(), k, m,
               float(row_band), float(max_disparity))
    return dist, idx


def hamming_match(desc_l, meta_l, desc_r, meta_r, *, row_band: float,
                  max_disparity: float):
    """desc_*: (K, 8)/(M, 8) int32 bit-views; meta_*: (K, 4)/(M, 4)
    float32 rows of (x, y, level, valid), one pair.  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel."""
    fn = (hamming_match_plain if desc_l.device.type == "cpu"
          else hamming_match_cuda)
    return fn(desc_l, meta_l, desc_r, meta_r, row_band=row_band,
              max_disparity=max_disparity)
