"""Feature matching — the paper's Feature Matcher block (port of the
fused path of ``repro.core.matching``).

``match_pair_fused`` runs Search Region Decision + Hamming Compare +
SAD Correction in ONE kernel launch per frame, batched over stereo
pairs (``ops.match_rectify_fused``), then applies the acceptance gates
and turns the rectified disparity into depth.
"""

from __future__ import annotations

import torch

from repro_torch.core.types import (CameraIntrinsics, DepthSet, FeatureSet,
                                    MatchSet, ORBConfig, StereoOutput)
from repro_torch.kernels import ops

#: Smallest disparity (px) accepted as a real stereo observation; it is
#: both the (strict) validity gate and the divisor guard of
#: ``_depth_set``, whose clamp only keeps masked-out lanes finite.
MIN_DISPARITY = 0.5


def _meta(feat: FeatureSet) -> torch.Tensor:
    """(..., K) FeatureSet -> (..., K, 4) float32 matcher meta rows of
    (x, y, level, valid)."""
    return torch.stack([feat.xy[..., 0], feat.xy[..., 1],
                        feat.level.float(), feat.valid.float()], dim=-1)


def _match_set(dist, idx, feat_l: FeatureSet, cfg: ORBConfig) -> MatchSet:
    """Acceptance gates + index resolution: a match is valid iff a
    candidate exists, it passes ``max_hamming`` and the left feature is
    real; invalid rows resolve to right index 0."""
    valid = (idx >= 0) & (dist <= cfg.max_hamming) & feat_l.valid
    return MatchSet(right_index=torch.where(valid, idx, torch.zeros_like(idx)),
                    distance=dist, valid=valid)


def _fx_baseline(intr, like: torch.Tensor) -> torch.Tensor:
    """Disparity -> depth scale as a float32 tensor on ``like``'s
    device: the shared ``CameraIntrinsics`` product (a Python float, as
    the JAX package computes it) or a per-pair ``fx * baseline``
    column for heterogeneous rigs."""
    if isinstance(intr, CameraIntrinsics):
        intr = float(intr.fx) * float(intr.baseline)
    return torch.as_tensor(intr, dtype=torch.float32, device=like.device)


def _depth_set(x_l, rxy, best, matches: MatchSet, cfg: ORBConfig,
               intr) -> DepthSet:
    """Disparity/depth from the SAD-argmin offset ``best`` (already
    minus sad_range) and the effective right coords ``rxy``.  The depth
    is tensor / tensor: a Python scalar over a tensor would be computed
    as a reciprocal times the scalar and round differently."""
    x_r_rect = rxy[..., 0] + best
    disparity = x_l - x_r_rect
    valid = matches.valid & (disparity > MIN_DISPARITY)
    depth = torch.where(
        valid, _fx_baseline(intr, disparity)
        / torch.clamp(disparity, min=MIN_DISPARITY),
        torch.zeros_like(disparity))
    xy_right = torch.stack([x_r_rect, rxy[..., 1]], dim=-1)
    return DepthSet(disparity=torch.where(valid, disparity,
                                          torch.zeros_like(disparity)),
                    depth=depth, xy_right=xy_right, valid=valid)


def mask_stereo_output(out: StereoOutput, mask_l, mask_r,
                       pair_mask) -> StereoOutput:
    """Graceful-degradation gate on a pair-batched ``StereoOutput``: AND
    every validity field with the (P,) liveness of each pair's left and
    right camera and of the pair.  Numeric fields are left as they are;
    all-true masks are identity."""
    ml = mask_l[..., None]
    mr = mask_r[..., None]
    mp = pair_mask[..., None]
    return StereoOutput(
        features_l=out.features_l._replace(valid=out.features_l.valid & ml),
        features_r=out.features_r._replace(valid=out.features_r.valid & mr),
        matches=out.matches._replace(valid=out.matches.valid & mp),
        depth=out.depth._replace(valid=out.depth.valid & mp),
    )


def match_pair_fused(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
                     feat_l: FeatureSet, feat_r: FeatureSet,
                     cfg: ORBConfig, intr):
    """The whole FM stage of a frame in ONE fused launch.  Every
    argument carries a leading (P,) stereo-pair axis; ``intr`` is a
    shared ``CameraIntrinsics`` or a (P, 1) ``fx * baseline`` column.
    Returns (MatchSet, DepthSet) with leading (P,) axes."""
    dist, idx, rxy, sad = ops.match_rectify_fused(
        feat_l.desc, _meta(feat_l), feat_r.desc, _meta(feat_r),
        imgs_l, imgs_r,
        row_band=float(cfg.row_band),
        max_disparity=float(cfg.max_disparity),
        max_hamming=int(cfg.max_hamming),
        sad_window=cfg.sad_window, sad_range=cfg.sad_range)
    matches = _match_set(dist, idx, feat_l, cfg)
    best = sad.float() - float(cfg.sad_range)
    depth = _depth_set(feat_l.xy[..., 0], rxy, best, matches, cfg, intr)
    return matches, depth


def _unfused(name: str, kernels: str):
    def entry(*args, **kwargs):
        raise NotImplementedError(
            f"{name}, the unfused oracle schedule ({kernels}), is not ported "
            "yet (ROADMAP A8)")
    entry.__name__ = name
    return entry


match_pair_unfused = _unfused("match_pair_unfused", "K9, K10")
stereo_match_unfused = _unfused("stereo_match_unfused", "K9")
sad_rectify_unfused = _unfused("sad_rectify_unfused", "K10")
