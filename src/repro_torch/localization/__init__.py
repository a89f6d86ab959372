"""Localization backend: depth + ego-motion on top of the frontend
(port of ``repro.localization``).

  ``geometry``  disparity -> depth -> RIG-FRAME 3-D points (all stereo
                pairs fused through ``RigConfig.pair_rotations``; tensor
                code, no kernel launch);
  ``pose``      temporal-match ego-motion: ONE match-only launch for
                every pair of every batch row, then a batched robust
                Procrustes solve; degenerate inputs yield identity +
                ``valid=False``, never NaN;
  ``metrics``   ATE / RPE against ``data.scenes`` ground truth, host
                float64.

``VisualSystem`` (with ``PipelineConfig(localize=True)``) wires these
into ``process_frame``, ``process_fleet``, ``run`` and ``run_fleet``: a
localized frame, or fleet frame, costs 3 frontend launches + 1
temporal-match launch.  The helpers below convert between
outputs and the cross-frame ``LocalizationState``.
"""

from __future__ import annotations

import torch

from repro_torch.core import matching
from repro_torch.core.types import (LocalizationOutput, LocalizationState,
                                    PoseSet)
from repro_torch.localization import geometry, metrics, pose
from repro_torch.localization.geometry import rig_points
from repro_torch.localization.metrics import trajectory_metrics
from repro_torch.localization.pose import (MIN_CORRESPONDENCES, solve_pose,
                                           solve_pose_batched)

__all__ = [
    "geometry", "metrics", "pose",
    "rig_points", "trajectory_metrics",
    "MIN_CORRESPONDENCES", "solve_pose", "solve_pose_batched",
    "PoseSet", "LocalizationOutput", "LocalizationState",
    "state_from", "zero_state",
]


def state_from(out: LocalizationOutput) -> LocalizationState:
    """The cross-frame memory a ``LocalizationOutput`` leaves behind:
    its left descriptors + matcher meta, rig-frame points, and the
    combined feature-and-depth usability mask."""
    feat_l = out.stereo.features_l
    return LocalizationState(
        desc=feat_l.desc, meta=matching._meta(feat_l), points=out.points,
        valid=feat_l.valid & out.stereo.depth.valid)


def zero_state(n_pairs: int, k: int, n_rigs: int | None = None,
               device: str | torch.device = "cpu") -> LocalizationState:
    """An all-invalid previous-frame state (session start, or a rig
    never seen before): zeros with ``valid=False`` everywhere, with
    leading (n_pairs,) axes, or (n_rigs, n_pairs) for a fleet, so the
    first temporal solve degenerates to identity + ``valid=False``
    through the same code as any frame."""
    lead = (n_pairs,) if n_rigs is None else (n_rigs, n_pairs)

    def zeros(*tail, dtype=torch.float32):
        return torch.zeros(lead + (k,) + tail, dtype=dtype, device=device)

    return LocalizationState(desc=zeros(8, dtype=torch.int32), meta=zeros(4),
                             points=zeros(3), valid=zeros(dtype=torch.bool))
