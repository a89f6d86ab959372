"""Masked Hamming distances of the Feature Matcher's front half (port
of the plain parts of ``repro.kernels.hamming_match``).

Search Region Decision (epipolar row band, disparity range, same
pyramid level, both valid) fused with the 256-bit Hamming distance as a
``BIG``-sentinel mask — the arithmetic the fused matcher kernel
(``matcher_fused``) runs per left/right feature pair.  The standalone
single-pair Hamming kernel of the JAX package is not ported yet.
"""

from __future__ import annotations

import torch

BIG = 1 << 20     # sentinel distance for masked-out pairs


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
