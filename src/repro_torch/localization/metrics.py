"""Trajectory-error metrics against scene ground truth (host float64;
a copy of ``repro.localization.metrics``, which is numpy only).

The accuracy gates compare an estimated ``PoseSet`` sequence (from
``VisualSystem.run`` on a ``localize`` session, or a ``process_frame``
loop) against the ground-truth rig poses ``data.scenes.render_sequence``
returns.
All arithmetic here is NUMPY FLOAT64 ON HOST: the metric is the judge
of the f32/uint8 datapaths, so it must not share their rounding.

Conventions: an estimated ``PoseSet`` row t maps frame t-1 rig coords
into frame t (``p_t = R @ p_{t-1} + t_rel``); row 0 is the
identity/invalid first frame.  Ground-truth poses are ``(R, t)`` with R
rig->world and t the world position.  ATE is the RMSE of integrated
positions expressed in the start frame (both trajectories start at the
origin with identity heading, so no Umeyama alignment is needed); RPE
is the per-step RMSE of relative translation and rotation-angle error.
"""

from __future__ import annotations

import numpy as np


def _as_np(x) -> np.ndarray:
    if hasattr(x, "detach"):               # a torch tensor, on any device
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def integrate_relative(rotations, translations) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Chain relative poses into start-frame world poses.

    ``rotations`` (T, 3, 3) / ``translations`` (T, 3): row t is the
    t-1 -> t relative pose (row 0 is ignored — it has no predecessor).
    Returns (positions (T, 3), headings (T, 3, 3)): standard VO
    composition ``R_w <- R_w @ R_rel^T``, ``p <- p - R_w @ t_rel``.
    An invalid (identity) step simply freezes the trajectory — the
    honest failure mode the gates measure, never a crash."""
    rot = _as_np(rotations)
    tr = _as_np(translations)
    t_total = rot.shape[0]
    pos = np.zeros((t_total, 3))
    head = np.zeros((t_total, 3, 3))
    r_w = np.eye(3)
    head[0] = r_w
    for t in range(1, t_total):
        r_w = r_w @ rot[t].T
        pos[t] = pos[t - 1] - r_w @ tr[t]
        head[t] = r_w
    return pos, head


def gt_positions(poses) -> np.ndarray:
    """Ground-truth rig positions in the START frame: (T, 3) from the
    scenes [(R, t)] list — ``R_0^T (t_t - t_0)``."""
    r0 = _as_np(poses[0][0])
    t0 = _as_np(poses[0][1])
    return np.stack([r0.T @ (_as_np(t) - t0) for _, t in poses])


def gt_relative(poses) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth relative poses aligned with a ``PoseSet`` sequence:
    (T, 3, 3) rotations / (T, 3) translations with row 0 = identity."""
    t_total = len(poses)
    rot = np.zeros((t_total, 3, 3))
    tr = np.zeros((t_total, 3))
    rot[0] = np.eye(3)
    for t in range(1, t_total):
        r_prev, t_prev = poses[t - 1]
        r_curr, t_curr = poses[t]
        r_prev, r_curr = _as_np(r_prev), _as_np(r_curr)
        rot[t] = r_curr.T @ r_prev
        tr[t] = r_curr.T @ (_as_np(t_prev) - _as_np(t_curr))
    return rot, tr


def _rot_angle_deg(r: np.ndarray) -> float:
    c = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def trajectory_metrics(rotations, translations, gt_poses) -> dict:
    """ATE/RPE of one estimated relative-pose sequence vs ground truth.

    ``rotations``/``translations``: (T, 3, 3)/(T, 3) estimated relative
    poses (``PoseSet`` fields; tensors accepted — converted to
    float64 here); ``gt_poses``: the scenes [(R, t)] list, same T.
    Returns a dict of host floats:

      ate_rmse_m        RMSE of integrated-position error (metres)
      rpe_trans_rmse_m  per-step relative-translation RMSE (metres)
      rpe_rot_mean_deg  per-step relative-rotation error mean (degrees)
      travel_m          ground-truth path length (for error-per-metre)
    """
    rot = _as_np(rotations)
    tr = _as_np(translations)
    if rot.shape[0] != len(gt_poses):
        raise ValueError(
            f"trajectory_metrics: {rot.shape[0]} estimated poses vs "
            f"{len(gt_poses)} ground-truth poses")
    est_pos, _ = integrate_relative(rot, tr)
    ref_pos = gt_positions(gt_poses)
    ate = float(np.sqrt(np.mean(np.sum((est_pos - ref_pos) ** 2,
                                       axis=-1))))
    gt_rot, gt_tr = gt_relative(gt_poses)
    t_total = rot.shape[0]
    if t_total > 1:
        dt = tr[1:] - gt_tr[1:]
        rpe_t = float(np.sqrt(np.mean(np.sum(dt * dt, axis=-1))))
        rpe_r = float(np.mean([_rot_angle_deg(rot[t] @ gt_rot[t].T)
                               for t in range(1, t_total)]))
        travel = float(np.sum(np.linalg.norm(gt_tr[1:], axis=-1)))
    else:
        rpe_t, rpe_r, travel = 0.0, 0.0, 0.0
    return dict(ate_rmse_m=ate, rpe_trans_rmse_m=rpe_t,
                rpe_rot_mean_deg=rpe_r, travel_m=travel)
