"""Static top-K corner selection between the dense and the sparse FE
stages (port of ``repro.core.fast.select_topk``)."""

from __future__ import annotations

import torch


def select_topk(score: torch.Tensor, k: int, border: int):
    """Top-K corners of (B, H, W) score maps.  Returns (xy (B, K, 2)
    int32, score (B, K), valid (B, K) bool).

    Ties go to the lowest flat index, as ``lax.top_k`` breaks them: a
    stable descending sort, not ``torch.topk`` (NMS'd scores and zero
    padding are full of ties)."""
    b, h, w = score.shape
    row = torch.arange(h, device=score.device)[:, None]
    col = torch.arange(w, device=score.device)[None, :]
    inside = ((row >= border) & (row < h - border)
              & (col >= border) & (col < w - border))
    masked = torch.where(inside, score, torch.zeros_like(score))
    vals, idx = torch.sort(masked.reshape(b, -1), dim=1, descending=True,
                           stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    ys = (idx // w).to(torch.int32)
    xs = (idx % w).to(torch.int32)
    return torch.stack([xs, ys], dim=-1), vals, vals > 0
