"""Optimization backend: pose estimation from frontend output (port of
``repro.core.backend``).

The paper offloads the frontend and leaves the backend (SLAM / VIO /
Registration) to the CPU; to make localization end to end, and to
measure the Tab. I frontend/backend latency split, the JAX package
carries a compact stereo visual-odometry backend, ported here in plain
PyTorch (no kernel: the JAX package leaves it to XLA):

  stereo depth -> 3-D landmarks (``triangulate``) -> temporal descriptor
  matching (``VisualSystem.temporal_match``) -> weighted Kabsch
  (closed-form SE(3)) -> optional damped-Huber Gauss-Newton reprojection
  refinement -> trajectory integration.

``kabsch`` is batched over any leading axes: the session's robust pose
solve (``localization.pose``) runs it once for every rig or frame
transition of a call, on (B, 3, 3) cross-covariances, through
``torch.linalg.svd`` and ``torch.linalg.det``.  The rest takes the JAX
functions' shapes: one frame pair's (K, 3) points.

Parity with XLA: every division by a constant divides by a float32
tensor (torch turns a Python-scalar divisor into a reciprocal product,
which rounds differently); a non-finite input gives NaN where XLA does
and never raises (``kabsch`` decomposes zeros in place of a non-finite
matrix, the Gauss-Newton step solves with ``torch.linalg.solve_ex``,
which does not check for a singular system).  The Jacobian is
``torch.func.jacfwd``'s forward mode, as ``jax.jacfwd``'s.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.types import CameraIntrinsics, DepthSet, FeatureSet


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """float32(value) as a 0-d tensor on ``like``'s device (a fill, so no
    copy from the host)."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, as ``jnp.linalg.norm`` sums it:
    the square root of the sum of squares."""
    return torch.sqrt((x * x).sum(dim=-1))


def triangulate(feat_l: FeatureSet, depth: DepthSet,
                intr: CameraIntrinsics) -> torch.Tensor:
    """Back-project left features with stereo depth -> (K, 3) points."""
    xy, z = feat_l.xy, depth.depth
    x = (xy[..., 0] - _const(intr.cx, z)) / _const(intr.fx, z) * z
    y = (xy[..., 1] - _const(intr.cy, z)) / _const(intr.fy, z) * z
    return torch.stack([x, y, z], dim=-1)


def kabsch(pts_a: torch.Tensor, pts_b: torch.Tensor,
           weights: torch.Tensor):
    """Weighted closed-form rigid alignment: (R, t) minimizing
    sum_i w_i || R a_i + t - b_i ||^2.  pts: (..., K, 3); weights:
    (..., K).  Returns (R (..., 3, 3), t (..., 3)).

    As in the JAX package, the reflection fix is ``sign(det(V U^T))``,
    which is 0 for a singular cross-covariance (the caller's gates turn
    that pose invalid), and a non-finite point poisons the centroids
    even at weight 0 (0 * NaN) and gives a NaN rotation, which the
    caller's finiteness gate catches."""
    w = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-6)
    ca = (w[..., None] * pts_a).sum(dim=-2)
    cb = (w[..., None] * pts_b).sum(dim=-2)
    a0 = pts_a - ca[..., None, :]
    b0 = pts_b - cb[..., None, :]
    h = (w[..., None] * a0).transpose(-1, -2) @ b0          # (..., 3, 3)
    # torch's SVD refuses a non-finite matrix where XLA's returns NaN:
    # decompose zeros there and put the NaN back into R.
    finite = torch.isfinite(h).flatten(-2).all(dim=-1)[..., None, None]
    u, _, vt = torch.linalg.svd(torch.where(finite, h, torch.zeros_like(h)))
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(v @ ut))
    ones = torch.ones_like(d)
    s = torch.diag_embed(torch.stack([ones, ones, d], dim=-1))
    r = torch.where(finite, v @ s @ ut, torch.full_like(h, float("nan")))
    t = cb - (r @ ca[..., None])[..., 0]
    return r, t


def reprojection_residuals(r, t, pts_a, xy_b, intr: CameraIntrinsics):
    """(K, 2) pixel residuals of ``pts_a`` moved by (R, t) and projected
    through ``intr``, against ``xy_b``."""
    p = pts_a @ r.transpose(-1, -2) + t
    z = torch.clamp(p[..., 2], min=1e-3)
    u = intr.fx * p[..., 0] / z + intr.cx
    v = intr.fy * p[..., 1] / z + intr.cy
    return torch.stack([u - xy_b[..., 0], v - xy_b[..., 1]], dim=-1)


def _so3_exp(w: torch.Tensor) -> torch.Tensor:
    """(3,) rotation vector -> (3, 3) rotation.  The sinc form is finite
    and differentiable at w = 0, where Gauss-Newton linearizes (the
    naive norm form would give NaN derivatives there)."""
    theta2 = (w * w).sum()
    theta = torch.sqrt(theta2 + 1e-16)
    zero = torch.zeros_like(w[0])
    k = torch.stack([torch.stack([zero, -w[2], w[1]]),
                     torch.stack([w[2], zero, -w[0]]),
                     torch.stack([-w[1], w[0], zero])])
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / (theta2 + 1e-16)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * k + b * (k @ k)


def gauss_newton_refine(r, t, pts_a, xy_b, weights, intr: CameraIntrinsics,
                        iters: int = 8, huber_px: float = 5.0,
                        damping: float = 1e-2):
    """Damped (Levenberg) Gauss-Newton on reprojection error over se(3),
    with a Huber robust loss: a point's weight is scaled by
    min(1, c / |res|), so gross mismatches cannot explode the normal
    equations.  Each iteration linearizes at a zero update with the
    (2K, 6) forward-mode Jacobian and solves the damped 6 x 6 system."""
    eye6 = torch.eye(6, dtype=torch.float32, device=r.device)
    zero = torch.zeros(6, dtype=torch.float32, device=r.device)
    for _ in range(iters):
        norm = _norm(reprojection_residuals(r, t, pts_a, xy_b, intr))
        w_rob = weights * torch.clamp(
            torch.full_like(norm, huber_px) / torch.clamp(norm, min=1e-6),
            max=1.0)

        def flat_res(delta, r_c=r, t_c=t, w_c=w_rob):
            res = reprojection_residuals(_so3_exp(delta[:3]) @ r_c,
                                         t_c + delta[3:], pts_a, xy_b, intr)
            return (res * w_c[..., None]).reshape(-1)

        res0 = flat_res(zero)
        jac = torch.func.jacfwd(flat_res)(zero)             # (2K, 6)
        jtj = jac.T @ jac
        lm = jtj + damping * torch.diag(torch.diag(jtj)) + 1e-6 * eye6
        delta = -torch.linalg.solve_ex(lm, jac.T @ res0)[0]
        r, t = _so3_exp(delta[:3]) @ r, t + delta[3:]
    return r, t


class PoseEstimate(NamedTuple):
    rotation: torch.Tensor      # (3, 3)
    translation: torch.Tensor   # (3,)
    inliers: torch.Tensor       # scalar int32


def _masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x`` over ``mask`` (static shape: a sort with +inf
    fill, then element (n - 1) // 2 of the n masked values)."""
    n = mask.sum(dim=-1, dtype=torch.int32)
    filled = torch.where(mask, x, torch.full_like(x, float("inf")))
    s = torch.sort(filled, dim=-1).values
    mid = (torch.clamp(n - 1, min=0) // 2).long()
    return s.gather(-1, mid[..., None])[..., 0]


def estimate_relative_pose(pts_prev: torch.Tensor, pts_curr: torch.Tensor,
                           weights: torch.Tensor, xy_curr: torch.Tensor,
                           intr: CameraIntrinsics, refine: bool = True,
                           robust_iters: int = 3,
                           gate_scale: float = 4.0) -> PoseEstimate:
    """(R, t) mapping previous-frame points into the current frame.

    Robust cascade (descriptor mismatches and stereo depth quantization
    produce metre-scale 3-D outliers, so plain least squares would be
    poisoned):
      1. translation-first init: at VO frame rates R ~ I, so the per-axis
         masked median of the displacement field is a robust t;
      2. gate 3-D residuals at ``gate_scale`` x median, iterate Kabsch;
      3. gate reprojection residuals, damped Huber Gauss-Newton refine
         (``refine``; ``xy_curr`` is unused without it)."""
    zero = torch.zeros_like(weights)
    mask0 = weights > 0

    # 1. robust translation-only init (R = I)
    disp = pts_curr - pts_prev                                  # (K, 3)
    t0 = torch.stack([_masked_median(disp[:, i], mask0) for i in range(3)])
    res0 = _norm(disp - t0)
    med0 = _masked_median(res0, mask0)
    w = torch.where(res0 <= gate_scale * torch.clamp(med0, min=1e-2),
                    weights, zero)

    # 2. gated Kabsch rounds
    for _ in range(robust_iters):
        r_n, t_n = kabsch(pts_prev, pts_curr, w)
        res = _norm(pts_prev @ r_n.T + t_n - pts_curr)
        med = _masked_median(res, w > 0)
        w = torch.where(res <= gate_scale * torch.clamp(med, min=1e-3),
                        weights, zero)
    r, t = kabsch(pts_prev, pts_curr, w)
    if refine:
        # 3. gate reprojection residuals, then damped-Huber Gauss-Newton
        res = _norm(reprojection_residuals(r, t, pts_prev, xy_curr, intr))
        med = _masked_median(res, w > 0)
        w = torch.where(res <= gate_scale * torch.clamp(med, min=1.0), w,
                        zero)
        r, t = gauss_newton_refine(r, t, pts_prev, xy_curr, w, intr)
    return PoseEstimate(r, t, (w > 0).sum(dtype=torch.int32))


def integrate_trajectory(poses: list[PoseEstimate]) -> torch.Tensor:
    """Chain relative poses into world positions (T + 1, 3), origin
    start.  A relative pose maps previous-frame coordinates to the
    current frame's, so the camera position updates as
    p_w <- p_w - R_w t_rel with R_w <- R_w R_rel^-1 (standard VO
    composition)."""
    dev = poses[0].rotation.device if poses else torch.device("cpu")
    pos = [torch.zeros(3, dtype=torch.float32, device=dev)]
    r_w = torch.eye(3, dtype=torch.float32, device=dev)
    for p in poses:
        r_w = r_w @ p.rotation.T
        pos.append(pos[-1] - r_w @ p.translation)
    return torch.stack(pos)
