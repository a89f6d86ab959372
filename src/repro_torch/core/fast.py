"""Oriented FAST detection (port of ``repro.core.fast``; paper Sec.
II-B1, III-C): the static top-K corner selection between the dense and
the sparse FE stages, and the single-image detection API.

``detect`` is the paper's FE split into its modules: the standalone
FAST score map (K11), the ``nms3`` oracle, top-K, and the
orientation-only kernel (K8) — 2 launches.  Its score equals the fused
dense FE's and its theta the fused sparse FE's (shared device code), so
``detect`` and ``orb.extract_features`` cannot diverge.  The frame path
uses ``orb.extract_features_batched`` instead.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import ORBConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import nms3


def select_topk(score: torch.Tensor, k: int, border: int):
    """Top-K corners of (B, H, W) score maps (float32, or int16 on the
    uint8 datapath).  Returns (xy (B, K, 2) int32, score (B, K) of the
    map's dtype, valid (B, K) bool).

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


def orientations(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation theta = atan2(m01, m10) (paper
    Eq. 1) of (K, 2) int keypoints of one (H, W) image, clamped into
    it: the batch-of-one view of the orientation-only kernel, ONE
    launch (its uint8 variant, with int32 moments, for a uint8 image)."""
    theta, _, _ = ops.orient_describe_batched(img[None], None, xy[None])
    return theta[0]


def detect(level_img: torch.Tensor, cfg: ORBConfig, k: int):
    """Oriented FAST on one pyramid level, in 2 launches: the FAST score
    map (K11, on the level cast to float32 as the JAX package casts it)
    and orientation (K8, its uint8 variant for a uint8 level).  Returns
    (xy (K, 2) int32 level coords, score (K,), theta (K,), valid
    (K,))."""
    score = ops.fast_score_map(level_img, float(cfg.fast_threshold))
    if cfg.nms:
        score = nms3(score)
    xy, vals, valid = select_topk(score[None], k, cfg.border)
    theta = orientations(level_img, xy[0])
    return xy[0], vals[0], theta, valid[0]
