"""Feature matching — the paper's Feature Matcher block (port of
``repro.core.matching``).

``match_pair_fused`` runs Search Region Decision + Hamming Compare +
SAD Correction in ONE kernel launch per frame, batched over stereo
pairs (``ops.match_rectify_fused``), then applies the acceptance gates
and turns the rectified disparity into depth.

The pre-fusion schedule — the single-pair Hamming matcher
(``ops.hamming_match``), two plain window gathers and the SAD sweep
(``ops.sad_search``) — is ``match_pair_unfused`` (with
``stereo_match_unfused`` / ``sad_rectify_unfused``): 2 launches a pair,
the oracle the fused path is pinned against bit for bit.  The old
standalone entry points ``stereo_match`` / ``temporal_match`` /
``sad_rectify`` are deprecation shims over the session methods of the
same name (``pipeline.session_for``).
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.core.types import (CameraIntrinsics, DepthSet, FeatureSet,
                                    MatchSet, ORBConfig, StereoOutput)
from repro_torch.kernels import ops, ref

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
    column for heterogeneous rigs.  The product is filled in on the
    device: a scalar copied from the host would make the host wait for
    the stream on every frame."""
    if isinstance(intr, CameraIntrinsics):
        return torch.full((), float(intr.fx) * float(intr.baseline),
                          dtype=torch.float32, device=like.device)
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


def match_pair_unfused(img_l: torch.Tensor, img_r: torch.Tensor,
                       feat_l: FeatureSet, feat_r: FeatureSet,
                       cfg: ORBConfig, intr: CameraIntrinsics):
    """Pre-fusion FM schedule for ONE stereo pair (unbatched
    ``FeatureSet``s, (H, W) images): the single-pair Hamming matcher,
    the two window gathers and the SAD sweep, 2 launches.  Kept as the
    oracle ``match_pair_fused`` is pinned against bit for bit."""
    matches = stereo_match_unfused(feat_l, feat_r, cfg)
    depth = sad_rectify_unfused(img_l, img_r, feat_l, feat_r, matches,
                                cfg, intr)
    return matches, depth


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.{old} is deprecated; use {new} on a "
        "repro_torch.core.VisualSystem session (see "
        "repro_torch.core.frontend for the migration map)",
        DeprecationWarning, stacklevel=3)


def _shim_session(cfg: ORBConfig, intr: CameraIntrinsics | None,
                  device, n_cameras: int = 2,
                  schedule: str = "sequential"):
    from repro_torch.core import pipeline  # pipeline imports matching
    return pipeline.session_for(cfg, intr, n_cameras=n_cameras,
                                schedule=schedule, device=device)


def stereo_match(feat_l: FeatureSet, feat_r: FeatureSet, cfg: ORBConfig,
                 device="cuda") -> MatchSet:
    """DEPRECATED shim for ``VisualSystem.stereo_match``: best Hamming
    match in the strip-like search region (Sec. II-C1), through the
    match-only kernel (one launch)."""
    _deprecated("core.matching.stereo_match", "stereo_match")
    return _shim_session(cfg, None, device).stereo_match(feat_l, feat_r)


def stereo_match_unfused(feat_l: FeatureSet, feat_r: FeatureSet,
                         cfg: ORBConfig) -> MatchSet:
    """Pre-fusion stereo matcher: the single-pair Hamming matcher (one
    launch), then the acceptance gates — the oracle half of
    ``match_pair_unfused``."""
    dist, idx = ops.hamming_match(
        feat_l.desc, _meta(feat_l), feat_r.desc, _meta(feat_r),
        row_band=float(cfg.row_band),
        max_disparity=float(cfg.max_disparity))
    return _match_set(dist, idx, feat_l, cfg)


def _gather_patches(img: torch.Tensor, xy: torch.Tensor, ph: int, pw: int):
    """(ph, pw) windows centered at the rounded, clamped float centers
    ``xy`` (K, 2) of an (H, W) image, edge-replicated: the FM stage's
    patch-read semantics, plain PyTorch outside any kernel as in the
    JAX package (an alias of ``ref.gather_patches``)."""
    return ref.gather_patches(img, xy, ph, pw)


def sad_rectify(img_l, img_r, feat_l: FeatureSet, feat_r: FeatureSet,
                matches: MatchSet, cfg: ORBConfig, intr: CameraIntrinsics,
                device="cuda") -> DepthSet:
    """DEPRECATED shim for ``VisualSystem.sad_rectify``: SAD
    rectification + disparity/depth (Sec. II-C2, III-D) with in-kernel
    window reads (the SAD-only kernel, one launch)."""
    _deprecated("core.matching.sad_rectify", "sad_rectify")
    return _shim_session(cfg, intr, device).sad_rectify(
        img_l, img_r, feat_l, feat_r, matches)


def sad_rectify_unfused(img_l: torch.Tensor, img_r: torch.Tensor,
                        feat_l: FeatureSet, feat_r: FeatureSet,
                        matches: MatchSet, cfg: ORBConfig,
                        intr: CameraIntrinsics) -> DepthSet:
    """Pre-fusion SAD rectification: two ``_gather_patches`` gathers
    (the left windows, the right strips at the matched features)
    feeding the SAD sweep (one launch), then the first-occurrence
    argmin and disparity/depth — the oracle half of
    ``match_pair_unfused``."""
    p = cfg.sad_window
    r = cfg.sad_range
    xy_l = feat_l.xy
    xy_r = feat_r.xy[matches.right_index.long()]
    left_patches = _gather_patches(img_l, xy_l, p, p)
    right_strips = _gather_patches(img_r, xy_r, p, p + 2 * r)
    table = ops.sad_search(left_patches, right_strips)
    best = table.argmin(dim=1).float() - float(r)
    return _depth_set(xy_l[:, 0], xy_r, best, matches, cfg, intr)


def temporal_match(feat_a: FeatureSet, feat_b: FeatureSet, cfg: ORBConfig,
                   search_radius: float = 48.0,
                   search_radius_y: float | None = None,
                   device="cuda") -> MatchSet:
    """DEPRECATED shim for ``VisualSystem.temporal_match``:
    frame-to-frame matching for the VO backend through the match-only
    kernel (one launch) over a rectangular search region."""
    _deprecated("core.matching.temporal_match", "temporal_match")
    return _shim_session(cfg, None, device).temporal_match(
        feat_a, feat_b, search_radius=search_radius,
        search_radius_y=search_radius_y)
