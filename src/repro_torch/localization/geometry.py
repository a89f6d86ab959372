"""Disparity -> depth -> rig-frame 3-D points (port of
``repro.localization.geometry``).

The frontend's ``DepthSet`` is per stereo pair in the pair's LEFT
camera frame; the pose solve wants ONE point cloud per rig.  Every
pair's left features are lifted through the pair's intrinsics and
rotated into the shared rig frame by ``RigConfig.pair_rotations`` (the
quad rig's back pair looks along -z).  Elementwise tensor code: no
kernel launch, any leading axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.rig import RigConfig


def backproject(xy: torch.Tensor, depth: torch.Tensor, fx, fy, cx,
                cy) -> torch.Tensor:
    """Pinhole back-projection: (..., K, 2) pixel coords + (..., K)
    depth -> (..., K, 3) camera-frame points.  The intrinsics are
    float32 tensors (a tensor divisor rounds as IEEE division; a Python
    scalar divisor would not, see ``kernels/ref.py``).  An invalid
    lane's depth is exactly 0, so its point is exactly the origin."""
    x = (xy[..., 0] - cx) / fx * depth
    y = (xy[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def rig_points(xy: torch.Tensor, depth: torch.Tensor,
               rig: RigConfig) -> torch.Tensor:
    """Per-pair left-feature coords (..., n_pairs, K, 2) + depths
    (..., n_pairs, K) -> (..., n_pairs, K, 3) points in the RIG frame:
    back-projected through each pair's left-camera intrinsics, then
    rotated by the pair's camera->rig rotation."""
    if xy.shape[-3] != rig.n_pairs:
        raise ValueError(
            f"rig_points: xy pair axis is {xy.shape[-3]} but the rig "
            f"has {rig.n_pairs} pairs")
    fx, fy, cx, cy, rot = _pair_constants(rig, xy.device)
    cam = backproject(xy, depth, fx, fy, cx, cy)
    return torch.einsum("pji,...pki->...pkj", rot, cam)


@functools.lru_cache(maxsize=16)
def _pair_constants(rig: RigConfig, device: torch.device):
    """Per-pair (n_pairs, 1) float32 fx, fy, cx, cy columns of the left
    cameras and the (n_pairs, 3, 3) camera->rig rotations, copied to
    ``device`` once per rig rather than on every frame."""
    intr = rig.pair_intrinsics
    cols = [torch.tensor([getattr(ic, name) for ic in intr],
                         dtype=torch.float32, device=device)[:, None]
            for name in ("fx", "fy", "cx", "cy")]
    rot = torch.from_numpy(rig.pair_rotation_array()).to(device)
    return (*cols, rot)


def gt_relative_pose(r_prev, t_prev, r_curr, t_curr):
    """Ground-truth relative pose between two rig poses (R: rig->world,
    t: world position), in the solver's convention
    ``p_curr = R_rel @ p_prev + t_rel``; numpy float64."""
    r_prev = np.asarray(r_prev, np.float64)
    r_curr = np.asarray(r_curr, np.float64)
    r_rel = r_curr.T @ r_prev
    t_rel = r_curr.T @ (np.asarray(t_prev, np.float64)
                        - np.asarray(t_curr, np.float64))
    return r_rel, t_rel
