"""Per-frame camera sync checks (port of the host-side numpy part of
``repro.core.sync``): the trigger spec and the desync measures the
session's desync policy reads."""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class TriggerConfig:
    n_cameras: int = 4
    camera_fps: float = 30.0
    imu_rate_hz: float = 200.0
    # Software-sync model: per-camera exposure/readout/OS jitter (s).
    sw_jitter_std: float = 4e-3
    t0: float = 0.0

    @property
    def frame_dt(self) -> float:
        return 1.0 / self.camera_fps

    @property
    def imu_per_frame(self) -> int:
        # static upper bound of IMU samples in one frame interval
        return int(math.ceil(np.float32(self.imu_rate_hz / self.camera_fps))) + 2


def frame_desync(timestamps) -> float:
    """One frame's inter-camera tag spread, in float64 on the host
    (epoch-scale stamps have 128 s float32 spacing)."""
    ts = np.asarray(timestamps, dtype=np.float64).reshape(-1)
    return float(np.max(ts) - np.min(ts))


def desync_camera_mask(timestamps, max_desync_s: float) -> np.ndarray:
    """Cameras of a desynced frame that are still usable: those whose
    tag lies within ``max_desync_s`` of the frame's MEDIAN tag."""
    ts = np.asarray(timestamps, dtype=np.float64).reshape(-1)
    return np.abs(ts - np.median(ts)) <= float(max_desync_s)
