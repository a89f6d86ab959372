"""Closed-form rigid alignment for the localization backend (port of
``repro.core.backend.kabsch``; the Gauss-Newton refinement and
``estimate_relative_pose`` are not on the port's path yet).

``kabsch`` is batched over any leading axes: the robust pose solve runs
it once for every rig or frame transition of a call, on (B, 3, 3)
cross-covariances, through ``torch.linalg.svd`` and ``torch.linalg.det``
(the JAX package leaves the same 3 x 3 SVD to XLA; it is no TPU
kernel).
"""

from __future__ import annotations

import torch


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
