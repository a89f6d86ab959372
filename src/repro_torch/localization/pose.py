"""Temporal-match ego-motion: batched robust Procrustes pose solve
(port of ``repro.localization.pose``).

A solve consumes the temporal correspondences between the previous
frame's rig-frame points and the current frame's and returns the
relative SE(3) motion as a ``PoseSet``.  It is a masked top-K
reweighting loop around the weighted Kabsch alignment
(``core.backend.kabsch``): each round keeps the ``keep_frac`` fraction
of correspondences with the smallest 3-D residual (a sort with +inf
fill) and re-solves, so metre-scale outliers cannot poison the least
squares.

Degeneracy is data, not control flow: fewer than
``MIN_CORRESPONDENCES`` usable matches, a collapsed point cloud or a
non-finite input yields EXACTLY identity + ``valid=False``, never NaN.
The solve is written batched over a leading axis (rigs, or frame
transitions of a sequence); ``temporal_correspondences`` is ONE
match-only kernel launch for every pair of every batch row.
"""

from __future__ import annotations

import torch

from repro_torch.core import backend
from repro_torch.core.types import (LocalizationState, ORBConfig, PoseSet,
                                    map_fields)
from repro_torch.kernels import ops

#: A rigid transform has 6 DoF; 3 point correspondences are the minimum
#: that determines it.  Below this the solve is identity + invalid.
MIN_CORRESPONDENCES = 3


def shift_x(meta: torch.Tensor, radius: float) -> torch.Tensor:
    """Matcher meta rows with ``radius`` added to x: a float32 tensor add
    of float32(radius), as XLA adds a Python float to a float32 array
    (the fill makes the constant on the tensor's device, with no copy
    from the host)."""
    x = meta[..., :1]
    return torch.cat([x + torch.full_like(x, float(radius)), meta[..., 1:]],
                     dim=-1)


def temporal_correspondences(prev: LocalizationState,
                             curr: LocalizationState, cfg: ORBConfig,
                             search_radius: float, search_radius_y: float):
    """Match prev -> curr left features and gather paired 3-D points.

    ``prev``/``curr`` carry FLAT (B, K, ...) axes where B folds every
    pair of every batch row, so all the temporal matching is ONE
    match-only launch.  The [0, max_disparity] window is reused as
    [-r, +r] by adding r to the previous x as a float32 tensor op (the
    same float32 sums the JAX package makes).  Returns ``(pts_prev,
    pts_curr, weights)``, each (B, K, ...): weights are 1.0 where the
    match passed the Hamming gate AND both ends carry a valid feature
    and depth, else 0.0."""
    dist, idx = ops.match_rectify_fused(
        prev.desc, shift_x(prev.meta, search_radius), curr.desc, curr.meta,
        row_band=float(search_radius_y),
        max_disparity=2.0 * float(search_radius))
    ok = (idx >= 0) & (dist <= cfg.max_hamming) & (prev.meta[..., 3] > 0.5)
    eff = torch.where(ok, idx, torch.zeros_like(idx)).long()
    pts_curr = torch.gather(curr.points, -2,
                            eff[..., None].expand(*eff.shape, 3))
    ok_curr = torch.gather(curr.valid, -1, eff)
    w = (ok & prev.valid & ok_curr).float()
    return prev.points, pts_curr, w


def keep_count(n: torch.Tensor, keep_frac: float,
               min_corr: int) -> torch.Tensor:
    """Support kept by a reweighting round: max(min_corr,
    ceil(keep_frac * n)) with the product in float32, as the JAX
    package's Python-float-times-int32 product is (in float64, 0.7 * n
    lands on another integer for some n)."""
    frac = torch.full(n.shape, keep_frac, dtype=torch.float32,
                      device=n.device)
    return torch.clamp(torch.ceil(frac * n.to(torch.float32)).to(
        torch.int32), min=min_corr)


def solve_pose_batched(pts_prev: torch.Tensor, pts_curr: torch.Tensor,
                       weights: torch.Tensor, *, iters: int = 3,
                       keep_frac: float = 0.7,
                       min_corr: int = MIN_CORRESPONDENCES) -> PoseSet:
    """Robust weighted Procrustes over a leading batch axis: (B, N, 3)
    x 2 + (B, N) 0/1 weights -> ``PoseSet`` with (B,) leading axes,
    ``p_curr = R @ p_prev + t``."""
    f32, dev = torch.float32, pts_prev.device
    w0 = weights.to(f32)
    # a non-finite correspondence never enters the solve
    finite = (torch.isfinite(pts_prev).all(dim=-1)
              & torch.isfinite(pts_curr).all(dim=-1))
    w0 = torch.where(finite, w0, torch.zeros_like(w0))
    n0 = (w0 > 0).sum(dim=-1, dtype=torch.int32)
    n_total = w0.shape[-1]

    w = w0
    for _ in range(iters):
        r_c, t_c = backend.kabsch(pts_prev, pts_curr, w)
        res = torch.linalg.vector_norm(
            pts_prev @ r_c.transpose(-1, -2) + t_c[..., None, :] - pts_curr,
            dim=-1)
        keep = keep_count((w > 0).sum(dim=-1, dtype=torch.int32),
                          keep_frac, min_corr)
        # masked top-K: threshold at the keep-th smallest residual of the
        # current support (sort with +inf fill), then re-gate the FULL
        # weight set so a point dropped early can re-enter
        filled = torch.where(w > 0, res, torch.full_like(res, float("inf")))
        pick = torch.clamp(keep - 1, 0, n_total - 1).long()[..., None]
        thr = torch.gather(torch.sort(filled, dim=-1).values, -1, pick)
        w = torch.where((res <= thr) & (w0 > 0), w0, torch.zeros_like(w0))
    r, t = backend.kabsch(pts_prev, pts_curr, w)
    inliers = (w > 0).sum(dim=-1, dtype=torch.int32)

    # Degeneracy gate: a collapsed support cloud (zero baseline puts
    # every point at the origin) has no orientation information.
    wn = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-6)
    centered = pts_prev - (wn[..., None] * pts_prev).sum(dim=-2,
                                                         keepdim=True)
    spread = (wn * (centered * centered).sum(dim=-1)).sum(dim=-1)
    ok = ((inliers >= min_corr) & (n0 >= min_corr) & (spread > 1e-8)
          & torch.isfinite(r).flatten(-2).all(dim=-1)
          & torch.isfinite(t).all(dim=-1))
    eye = torch.eye(3, dtype=f32, device=dev).expand_as(r)
    r = torch.where(ok[..., None, None], r, eye)
    t = torch.where(ok[..., None], t, torch.zeros_like(t))
    return PoseSet(rotation=r.to(f32), translation=t.to(f32),
                   inliers=inliers, valid=ok)


def solve_pose(pts_prev: torch.Tensor, pts_curr: torch.Tensor,
               weights: torch.Tensor, *, iters: int = 3,
               keep_frac: float = 0.7,
               min_corr: int = MIN_CORRESPONDENCES) -> PoseSet:
    """One rig: (N, 3) paired points + (N,) 0/1 weights -> ``PoseSet``
    (``solve_pose_batched`` on a batch of one)."""
    pose = solve_pose_batched(pts_prev[None], pts_curr[None], weights[None],
                              iters=iters, keep_frac=keep_frac,
                              min_corr=min_corr)
    return map_fields(lambda x: x[0], pose)
