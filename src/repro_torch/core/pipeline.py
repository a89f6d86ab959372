"""`VisualSystem` — the session API of the quad-camera visual frontend
(port of ``repro.core.pipeline``, main path).

A session is built once from a ``RigConfig`` (cameras, stereo pairs,
intrinsics, sync spec) and a ``PipelineConfig`` (ORB parameters), on a
device, and then streams frames:

    vs = VisualSystem(RigConfig.quad(intr), PipelineConfig(orb=ocfg))
    out = vs.process_frame(images)     # (n_cameras, H, W) -> (P,) axes

A frame costs exactly THREE kernel launches: one dense FE and one
sparse FE launch for every camera at every pyramid level, and one
fused matcher launch for every stereo pair.  PyTorch runs eagerly, so
the JAX session's jit cache has no counterpart here.

The session runs on ``device`` ("cuda" unless the caller asks for the
CPU); on the CPU every kernel runs its plain PyTorch version.  There
is no implementation switch and no fallback: a CUDA session launches
the hand-written kernels or raises.
"""

from __future__ import annotations

import collections
import dataclasses
import typing

import numpy as np
import torch

from repro_torch.core import matching, orb
from repro_torch.core import sync as sync_mod
from repro_torch.core.rig import DesyncError, RigConfig
from repro_torch.core.types import (FeatureSet, ORBConfig, StereoOutput,
                                    map_fields)

_SCHEDULES = ("sequential", "pipelined")
_PRECISIONS = ("f32", "uint8")


class DesyncDecision(typing.NamedTuple):
    """Outcome of the rig's desync policy for one frame's time tags:
    ``action`` is "ok", "raise", "drop_frame" or "degrade";
    ``camera_mask`` is the (n_cameras,) keep-mask of "degrade"."""

    desync: float
    action: str
    camera_mask: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """How frames are processed (the rig says WHAT is processed).

    The port runs the sequential schedule at the quantized float32
    precision.  ``precision="uint8"`` (ROADMAP A6), ``localize=True``
    (A7) and ``schedule="pipelined"`` (A5) are later slices and raise
    ``NotImplementedError``."""

    orb: ORBConfig = ORBConfig()
    schedule: str = "sequential"
    precision: str = "f32"
    localize: bool = False

    def __post_init__(self):
        if self.schedule not in _SCHEDULES:
            raise ValueError(
                f"schedule must be one of {_SCHEDULES}, "
                f"got {self.schedule!r}")
        if self.precision not in _PRECISIONS:
            raise ValueError(
                f"precision must be one of {_PRECISIONS}, "
                f"got {self.precision!r}")
        if self.schedule == "pipelined":
            raise NotImplementedError(
                "schedule='pipelined' is not ported yet (ROADMAP A5)")
        if self.precision == "uint8":
            raise NotImplementedError(
                "precision='uint8' is not ported yet (ROADMAP A6)")
        if self.localize:
            raise NotImplementedError(
                "localize=True is not ported yet (ROADMAP A7)")


class VisualSystem:
    """One configured rig + pipeline on one device.

    Validates frame shapes and dtypes eagerly with clear errors and
    applies the rig's sync policy to per-frame time tags
    (``desync_log`` / ``DesyncError``)."""

    def __init__(self, rig: RigConfig, pipe: PipelineConfig | None = None,
                 device: str | torch.device = "cuda") -> None:
        if not isinstance(rig, RigConfig):
            raise TypeError(f"rig must be a RigConfig, got {type(rig)!r}")
        self.rig = rig
        self.pipe = pipe if pipe is not None else PipelineConfig()
        if not isinstance(self.pipe, PipelineConfig):
            raise TypeError(
                f"pipe must be a PipelineConfig, got {type(self.pipe)!r}")
        self.device = torch.device(device)
        # Bounded health log: one spread per checked frame.
        self.desync_log: "collections.deque[float]" = collections.deque(
            maxlen=4096)
        self._li, self._ri = self._flat_pair_indices()
        self._intr = self._fm_intr()

    # -- shape / sync validation (eager) -----------------------------------

    def _check_images(self, images, what: str) -> None:
        shape = tuple(images.shape)
        if len(shape) != 3:
            raise ValueError(
                f"{what} expects a rank-3 array (n_cameras, H, W); got "
                f"shape {shape}")
        c, h, w = shape
        if c != self.rig.n_cameras:
            raise ValueError(
                f"{what}: camera axis is {c} but the rig has "
                f"{self.rig.n_cameras} cameras")
        cfg = self.pipe.orb
        if (h, w) != (cfg.height, cfg.width):
            raise ValueError(
                f"{what}: image shape ({h}, {w}) does not match "
                f"PipelineConfig.orb ({cfg.height}, {cfg.width})")
        self._check_dtype(images, what)

    def _check_dtype(self, images, what: str) -> None:
        """The float32 datapath takes float frames; an integer frame
        would otherwise run silently through the float kernels."""
        dtype = images.dtype
        floating = (dtype.is_floating_point if isinstance(dtype, torch.dtype)
                    else np.issubdtype(np.dtype(dtype), np.floating))
        if not floating:
            raise TypeError(
                f"{what}: images have dtype {dtype} but this session "
                "runs PipelineConfig(precision='f32') — pass float "
                "frames (e.g. images.astype(np.float32)); the uint8 "
                "datapath is not ported yet (ROADMAP A6)")

    def desync_decision(self, timestamps) -> DesyncDecision:
        """Apply the rig's sync + desync policies to one frame's camera
        time tags without raising; the spread is appended to
        ``desync_log``."""
        ts = np.asarray(timestamps, dtype=np.float64).reshape(-1)
        if ts.shape[0] != self.rig.n_cameras:
            raise ValueError(
                f"expected {self.rig.n_cameras} per-camera timestamps, "
                f"got {ts.shape[0]}")
        desync = sync_mod.frame_desync(ts)
        self.desync_log.append(desync)
        if desync <= self.rig.max_desync:
            return DesyncDecision(desync, "ok")
        policy = self.rig.desync_policy
        if policy is None:
            policy = ("raise" if self.rig.sync_policy == "hardware"
                      else "ok")
        if policy == "degrade":
            return DesyncDecision(
                desync, "degrade",
                sync_mod.desync_camera_mask(ts, self.rig.max_desync))
        return DesyncDecision(desync, policy)

    def _desync_error(self, desync: float) -> DesyncError:
        return DesyncError(
            f"{self.rig.sync_policy}-sync rig saw {desync:.3e}s "
            f"inter-camera desync (tolerance {self.rig.max_desync:.3e}s)"
            ": time tags must come from the unified trigger clock "
            "(paper Sec. III-A)")

    def _coerce_camera_mask(self, camera_mask, what: str):
        """Validate a caller's (n_cameras,) camera mask; np.bool_."""
        if camera_mask is None:
            return None
        if isinstance(camera_mask, torch.Tensor):
            camera_mask = camera_mask.cpu().numpy()
        mask = np.asarray(camera_mask, dtype=bool)
        if mask.shape != (self.rig.n_cameras,):
            raise ValueError(
                f"{what}: camera_mask shape {mask.shape} does not match "
                f"{(self.rig.n_cameras,)} (per-camera liveness)")
        return mask

    def _frame_desync_mask(self, timestamps, camera_mask):
        """Resolve one frame's desync policy into (dropped, camera_mask):
        raise raises, drop_frame -> (True, _), degrade ANDs the median-
        cluster keep-mask into the caller's liveness mask."""
        decision = self.desync_decision(timestamps)
        if decision.action == "raise":
            raise self._desync_error(decision.desync)
        if decision.action == "drop_frame":
            return True, camera_mask
        if decision.action == "degrade":
            keep = decision.camera_mask
            camera_mask = (keep if camera_mask is None
                           else camera_mask & keep)
        return False, camera_mask

    # -- engine -------------------------------------------------------------

    def _flat_pair_indices(self):
        """Left/right camera indices of every stereo pair in the camera
        batch (one rig: folding a fleet into the batch is ROADMAP A5)."""
        return (torch.as_tensor(self.rig.left_cams, device=self.device),
                torch.as_tensor(self.rig.right_cams, device=self.device))

    def _fm_intr(self):
        """The shared ``CameraIntrinsics`` of a homogeneous rig, else a
        (n_pairs, 1) float32 column of per-pair ``fx * baseline``."""
        if self.rig.homogeneous_intrinsics:
            return self.rig.intrinsics[0]
        fxb = np.asarray([float(ic.fx) * float(ic.baseline)
                          for ic in self.rig.pair_intrinsics], np.float32)
        return torch.as_tensor(fxb[:, None], device=self.device)

    def _fe_flat(self, images):
        """FE stage over the camera batch: ONE dense + ONE sparse launch
        for every camera at every pyramid level."""
        feats = orb.extract_features_batched(images, self.pipe.orb)
        feat_l = map_fields(lambda x: x[self._li], feats)
        feat_r = map_fields(lambda x: x[self._ri], feats)
        return images[self._li], images[self._ri], feat_l, feat_r

    def _fm_flat(self, carry) -> StereoOutput:
        """FM stage over the pair batch: ONE fused matcher launch."""
        imgs_l, imgs_r, feat_l, feat_r = carry
        matches, depth = matching.match_pair_fused(
            imgs_l, imgs_r, feat_l, feat_r, self.pipe.orb, self._intr)
        return StereoOutput(feat_l, feat_r, matches, depth)

    def _core_flat(self, flat, mask_flat=None) -> StereoOutput:
        """The 3-launch datapath with optional graceful degradation: a
        per-camera liveness mask zeroes dead slabs BEFORE the kernels
        and gates every validity field AFTER them; all-true masks are
        identity."""
        if mask_flat is not None:
            flat = torch.where(mask_flat[:, None, None], flat,
                               torch.zeros_like(flat))
        out = self._fm_flat(self._fe_flat(flat))
        if mask_flat is not None:
            ml, mr = mask_flat[self._li], mask_flat[self._ri]
            out = matching.mask_stereo_output(out, ml, mr, ml & mr)
        return out

    def _frame_core(self, images, camera_mask=None) -> StereoOutput:
        """(n_cameras, H, W) -> StereoOutput with (n_pairs,) axes."""
        mask = (None if camera_mask is None
                else torch.as_tensor(np.asarray(camera_mask, bool).reshape(-1),
                                     device=self.device))
        return self._core_flat(images, mask)

    def _to_device(self, images) -> torch.Tensor:
        if isinstance(images, torch.Tensor):
            return images.to(self.device, torch.float32).contiguous()
        return torch.as_tensor(np.asarray(images, np.float32),
                               device=self.device).contiguous()

    # -- entry points --------------------------------------------------------

    def process_frame(self, images, timestamps=None,
                      camera_mask=None) -> StereoOutput | None:
        """One rig frame: (n_cameras, H, W) float -> StereoOutput with
        leading (n_pairs,) axes, in exactly 3 kernel launches.

        ``timestamps`` ((n_cameras,) seconds) runs the rig's desync
        policy first: ``raise`` raises ``DesyncError``, ``drop_frame``
        returns None, ``degrade`` masks the offending cameras.
        ``camera_mask`` ((n_cameras,) bool) marks dead cameras: their
        slabs are zeroed before the kernels and every validity field
        they touch is gated off."""
        self._check_images(images, "process_frame")
        camera_mask = self._coerce_camera_mask(camera_mask, "process_frame")
        if timestamps is not None:
            dropped, camera_mask = self._frame_desync_mask(timestamps,
                                                           camera_mask)
            if dropped:
                return None
        return self._frame_core(self._to_device(images), camera_mask)

    def extract(self, images) -> FeatureSet:
        """FE only: (n_cameras, H, W) -> FeatureSet with a leading
        (n_cameras,) axis, in 2 launches."""
        self._check_images(images, "extract")
        return orb.extract_features_batched(self._to_device(images),
                                            self.pipe.orb)

    def process_fleet(self, *args, **kwargs):
        raise NotImplementedError(
            "process_fleet is not ported yet (ROADMAP A5)")

    def run(self, *args, **kwargs):
        raise NotImplementedError("run is not ported yet (ROADMAP A5)")
