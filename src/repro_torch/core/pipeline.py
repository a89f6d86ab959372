"""`VisualSystem` — the session API of the quad-camera visual frontend
(port of ``repro.core.pipeline``).

A session is built once from a ``RigConfig`` (cameras, stereo pairs,
intrinsics, sync spec) and a ``PipelineConfig`` (ORB parameters,
temporal match radii, localization on or off), on a device, and then
streams frames:

    vs = VisualSystem(RigConfig.quad(intr), PipelineConfig(orb=ocfg))
    out = vs.process_frame(images)     # (n_cameras, H, W) -> (P,) axes
    outs = vs.run(frames)              # (T, n_cameras, H, W) -> (T, P)

A frame costs exactly THREE kernel launches: one dense FE and one
sparse FE launch for every camera at every pyramid level, and one
fused matcher launch for every stereo pair.  With
``PipelineConfig(localize=True)`` a frame returns a
``LocalizationOutput`` (rig-frame points and the relative pose since the
previous frame) for ONE more launch, the match-only temporal matcher; a
localized ``run`` of T frames folds all T - 1 transitions into that one
launch (3T + 1 in all).  ``PipelineConfig(precision="uint8")`` runs the
paper's 8-bit datapath on uint8 frames in the same launches (each
kernel's uint8 variant), with the same outputs as the float32 path on
the same integer-valued frame.  PyTorch runs eagerly, so the JAX
session's jit cache has no counterpart here, and ``run`` is a Python
loop over frames where the JAX package scans.

The session runs on ``device`` ("cuda" unless the caller asks for the
CPU); on the CPU every kernel runs its plain PyTorch version.  There
is no implementation switch and no fallback: a CUDA session launches
the hand-written kernels or raises.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import typing

import numpy as np
import torch

from repro_torch import localization
from repro_torch.core import matching, orb
from repro_torch.core import sync as sync_mod
from repro_torch.core.rig import DesyncError, RigConfig
from repro_torch.core.types import (CameraIntrinsics, DepthSet, FeatureSet,
                                    LocalizationOutput, LocalizationState,
                                    MatchSet, ORBConfig, PoseSet,
                                    StereoOutput, combine_fields,
                                    map_fields)
from repro_torch.kernels import ops
from repro_torch.localization import pose as pose_solver

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

    The port runs the sequential schedule.  ``precision`` selects the
    image datapath: "f32" (default) takes float frames and keeps float32
    slabs; "uint8" is the paper's 8-bit datapath end to end — uint8
    frames and pyramid slabs, int32 accumulators, a uint8 blur, int16
    FAST scores and int32 moments in the kernels' uint8 variants — and
    needs ``ORBConfig.quantized``.  ``localize`` turns on the
    localization backend (``repro_torch.localization``):
    ``process_frame`` and ``run`` then return a ``LocalizationOutput``
    for one more launch a frame (one in all for ``run``).
    ``temporal_radius`` (x) and ``temporal_radius_y`` (y; None = the x
    radius) bound the frame-to-frame search window of ``temporal_match``
    and the backend.  ``schedule="pipelined"`` (ROADMAP A5) is a later
    slice and raises ``NotImplementedError``."""

    orb: ORBConfig = ORBConfig()
    schedule: str = "sequential"
    temporal_radius: float = 48.0
    temporal_radius_y: float | None = None
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
        if self.precision == "uint8" and not self.orb.quantized:
            raise ValueError(
                "precision='uint8' requires ORBConfig.quantized=True: "
                "the integer datapath IS the quantized fixed-point "
                "pipeline held in uint8 slabs (a float Gaussian is not "
                "representable in a uint8 level)")
        if self.schedule == "pipelined":
            raise NotImplementedError(
                "schedule='pipelined' is not ported yet (ROADMAP A5)")


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
        # the frames' and level-0 images' dtype on the session's datapath
        self._dtype = (torch.uint8 if self.pipe.precision == "uint8"
                       else torch.float32)
        # Bounded health log: one spread per checked frame.
        self.desync_log: "collections.deque[float]" = collections.deque(
            maxlen=4096)
        self._li, self._ri = self._flat_pair_indices()
        self._intr = self._fm_intr()
        # Localization memory: the previous processed frame's state,
        # written only when PipelineConfig.localize is on.  Callers that
        # keep their own state pass ``prev=`` instead.
        self._loc_state: LocalizationState | None = None

    # -- shape / sync validation (eager) -----------------------------------

    def _check_images(self, images, what: str,
                      sequence: bool = False) -> None:
        shape = tuple(images.shape)
        want_nd = 4 if sequence else 3
        if len(shape) != want_nd:
            raise ValueError(
                f"{what} expects a rank-{want_nd} array "
                f"({'T, ' if sequence else ''}n_cameras, H, W); got "
                f"shape {shape}")
        c, h, w = shape[-3:]
        if c != self.rig.n_cameras:
            raise ValueError(
                f"{what}: camera axis is {c} but the rig has "
                f"{self.rig.n_cameras} cameras")
        cfg = self.pipe.orb
        if (h, w) != (cfg.height, cfg.width):
            raise ValueError(
                f"{what}: image shape ({h}, {w}) does not match "
                f"PipelineConfig.orb ({cfg.height}, {cfg.width})")
        if sequence and shape[0] == 0:
            raise ValueError(
                f"{what}: empty sequence (T == 0); the "
                f"{self.pipe.schedule!r} schedule needs at least one "
                "frame")
        self._check_dtype(images, what)

    def _check_dtype(self, images, what: str) -> None:
        """Frames against the session's precision: a float frame in a
        uint8 session, or an integer frame in an f32 one, would
        otherwise run silently through the other datapath's kernels."""
        dtype = images.dtype
        if isinstance(dtype, torch.dtype):
            uint8, floating = dtype == torch.uint8, dtype.is_floating_point
        else:
            uint8 = np.dtype(dtype) == np.uint8
            floating = np.issubdtype(np.dtype(dtype), np.floating)
        if self.pipe.precision == "uint8":
            if not uint8:
                raise TypeError(
                    f"{what}: images have dtype {dtype} but this session "
                    "is configured with PipelineConfig(precision='uint8') "
                    "— the integer datapath needs uint8 frames.  Quantize "
                    "with np.round(np.clip(images, 0, 255)).astype("
                    "np.uint8) or build the session with precision='f32'.")
        elif not floating:
            raise TypeError(
                f"{what}: images have dtype {dtype} but this session is "
                "configured with PipelineConfig(precision='f32') — pass "
                "float frames (e.g. images.astype(np.float32)) or build "
                "the session with precision='uint8' to run the integer "
                "datapath.")

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

    def check_desync(self, timestamps) -> float:
        """Legacy strict form of ``desync_decision``: returns the tag
        spread (seconds, logged to ``desync_log``) and raises
        ``DesyncError`` when the rig's policy resolves to ``"raise"``."""
        decision = self.desync_decision(timestamps)
        if decision.action == "raise":
            raise self._desync_error(decision.desync)
        return decision.desync

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
        feats = orb.extract_features_batched(images, self.pipe.orb,
                                             precision=self.pipe.precision)
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
        """Images on the session's device, as float32, or as uint8 in a
        uint8 session (level 0 of its pyramid, and what its matchers
        read)."""
        if not isinstance(images, torch.Tensor):
            images = torch.as_tensor(np.asarray(images))
        return images.to(self.device, self._dtype).contiguous()

    def _on_device(self, tup):
        """A caller's output NamedTuple (features, matches, a state) on
        the session's device."""
        return map_fields(lambda x: torch.as_tensor(x).to(self.device), tup)

    def _run_core(self, frames) -> StereoOutput:
        """The sequential schedule: the 3-launch frame path over every
        frame in order (the JAX package's ``lax.scan``), stacked into
        (T, n_pairs, ...) outputs."""
        outs = [self._frame_core(frames[t]) for t in range(frames.shape[0])]
        return combine_fields(torch.stack, outs)

    # -- localization engine -------------------------------------------------

    def _temporal_radii(self) -> tuple[float, float]:
        rx = float(self.pipe.temporal_radius)
        ry = (rx if self.pipe.temporal_radius_y is None
              else float(self.pipe.temporal_radius_y))
        return rx, ry

    def _solve(self, prev: LocalizationState, curr: LocalizationState,
               n_rows: int) -> PoseSet:
        """ONE temporal-match launch over the flat (n_rows * n_pairs, K)
        states, then the robust solve batched over the n_rows rows
        (each row's pairs fused into one point cloud)."""
        p, k = self.rig.n_pairs, curr.valid.shape[-1]
        rx, ry = self._temporal_radii()
        pp, cp, w = pose_solver.temporal_correspondences(
            prev, curr, self.pipe.orb, rx, ry)
        return pose_solver.solve_pose_batched(
            pp.reshape(n_rows, p * k, 3), cp.reshape(n_rows, p * k, 3),
            w.reshape(n_rows, p * k))

    def _localize_frame(self, out: StereoOutput, prev: LocalizationState):
        """Backend stage of one frame: rig-frame points (no launch), ONE
        temporal-match launch and the robust solve.  Returns (points
        (P, K, 3), scalar PoseSet)."""
        pts = localization.rig_points(out.features_l.xy, out.depth.depth,
                                      self.rig)
        curr = localization.state_from(LocalizationOutput(out, pts, None))
        pose = self._solve(prev, curr, 1)
        return pts, map_fields(lambda x: x[0], pose)

    def _invalid_pose(self, n: int) -> PoseSet:
        return PoseSet(
            rotation=torch.eye(3, device=self.device).expand(n, 3, 3).clone(),
            translation=torch.zeros(n, 3, device=self.device),
            inliers=torch.zeros(n, dtype=torch.int32, device=self.device),
            valid=torch.zeros(n, dtype=torch.bool, device=self.device))

    def _run_loc(self, frames) -> LocalizationOutput:
        """Localized sequence: the frontend over every frame (3 launches
        each) plus ONE temporal-match launch for ALL T - 1 transitions
        (time folds into the matcher's batch axis), then the (T - 1)-way
        batched solve.  Pose row 0 is identity + invalid (no
        predecessor)."""
        outs = self._run_core(frames)
        t_total = frames.shape[0]
        pts = localization.rig_points(outs.features_l.xy, outs.depth.depth,
                                      self.rig)            # (T, P, K, 3)
        pose = self._invalid_pose(1)
        if t_total > 1:
            state = localization.state_from(
                LocalizationOutput(outs, pts, None))

            def flat(sl):
                return map_fields(
                    lambda x: x[sl].reshape((-1,) + x.shape[2:]), state)

            moved = self._solve(flat(slice(None, -1)), flat(slice(1, None)),
                                t_total - 1)
            pose = combine_fields(torch.cat, [pose, moved])
        return LocalizationOutput(outs, pts, pose)

    def _resolve_prev(self, prev, out: StereoOutput,
                      what: str) -> LocalizationState:
        """Previous-frame state for a localized frame: the caller's
        explicit ``prev`` (validated eagerly), else the session's stored
        state, else the all-invalid zero state (session start: the solve
        degenerates to identity + invalid)."""
        k = out.features_l.valid.shape[-1]
        if prev is None:
            prev = self._loc_state
        if prev is None:
            return localization.zero_state(self.rig.n_pairs, k,
                                           device=self.device)
        if not isinstance(prev, LocalizationState):
            raise TypeError(
                f"{what}: prev must be a LocalizationState "
                f"(see repro_torch.localization.state_from), got "
                f"{type(prev)!r}")
        want = (self.rig.n_pairs, k, 3)
        got = tuple(prev.points.shape)
        if got != want:
            raise ValueError(
                f"{what}: prev.points shape {got} does not match {want} "
                "— the state must come from the same rig layout and "
                "feature budget")
        return self._on_device(prev)

    def reset_localization(self) -> None:
        """Forget the cross-frame localization state: the next
        ``process_frame`` behaves like a session start (identity +
        invalid pose).  Call between unrelated sequences."""
        self._loc_state = None

    # -- entry points --------------------------------------------------------

    def process_frame(self, images, timestamps=None, camera_mask=None,
                      prev: LocalizationState | None = None
                      ) -> StereoOutput | LocalizationOutput | None:
        """One rig frame: (n_cameras, H, W) float (uint8 in a uint8
        session) -> StereoOutput with leading (n_pairs,) axes, in
        exactly 3 kernel launches.  With
        ``PipelineConfig.localize`` the return is a
        ``LocalizationOutput`` (adds rig-frame 3-D points and the
        relative pose since the previous processed frame) in 4
        launches; ``prev`` overrides the session-held previous-frame
        state (``repro_torch.localization.state_from``).

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
        out = self._frame_core(self._to_device(images), camera_mask)
        if not self.pipe.localize:
            return out
        prev_state = self._resolve_prev(prev, out, "process_frame")
        pts, pose = self._localize_frame(out, prev_state)
        lout = LocalizationOutput(out, pts, pose)
        self._loc_state = localization.state_from(lout)
        return lout

    def run(self, frames) -> StereoOutput | LocalizationOutput:
        """A frame sequence (T, n_cameras, H, W) -> StereoOutput with
        leading (T, n_pairs) axes, on the sequential schedule (3
        launches a frame).  With ``localize`` on: a
        ``LocalizationOutput`` whose pose rows are the per-step relative
        motion (row 0 identity + invalid), for one more launch in all;
        a sequence neither reads nor writes the ``process_frame``
        cross-call state."""
        self._check_images(frames, "run", sequence=True)
        frames = self._to_device(frames)
        if self.pipe.localize:
            return self._run_loc(frames)
        return self._run_core(frames)

    def extract(self, images) -> FeatureSet:
        """FE only: (n_cameras, H, W) -> FeatureSet with a leading
        (n_cameras,) axis, in 2 launches."""
        self._check_images(images, "extract")
        return orb.extract_features_batched(self._to_device(images),
                                            self.pipe.orb,
                                            precision=self.pipe.precision)

    def match_pair(self, img_l, img_r, feat_l: FeatureSet,
                   feat_r: FeatureSet) -> tuple[MatchSet, DepthSet]:
        """FM stage for ONE explicit stereo pair (a pair batch of one
        through the fused matcher, 1 launch): returns (MatchSet,
        DepthSet).  Depth uses the first pair's left-camera
        intrinsics."""
        fl, fr = self._on_device(feat_l), self._on_device(feat_r)
        il = self._to_device(img_l)[None]
        ir = self._to_device(img_r)[None]
        matches, depth = matching.match_pair_fused(
            il, ir, map_fields(lambda x: x[None], fl),
            map_fields(lambda x: x[None], fr), self.pipe.orb,
            self.rig.pair_intrinsics[0])
        return (map_fields(lambda x: x[0], matches),
                map_fields(lambda x: x[0], depth))

    def _match_only(self, feat_l: FeatureSet, meta_l: torch.Tensor,
                    feat_r: FeatureSet, row_band: float,
                    max_disparity: float) -> MatchSet:
        """One match-only launch for one explicit feature pair, then the
        acceptance gates."""
        dist, idx = ops.match_rectify_fused(
            feat_l.desc[None], meta_l[None], feat_r.desc[None],
            matching._meta(feat_r)[None], row_band=float(row_band),
            max_disparity=float(max_disparity))
        return matching._match_set(dist[0], idx[0], feat_l, self.pipe.orb)

    def stereo_match(self, feat_l: FeatureSet,
                     feat_r: FeatureSet) -> MatchSet:
        """Best Hamming match in the strip-like search region
        (Sec. II-C1) through the match-only kernel, 1 launch."""
        cfg = self.pipe.orb
        fl, fr = self._on_device(feat_l), self._on_device(feat_r)
        return self._match_only(fl, matching._meta(fl), fr, cfg.row_band,
                                cfg.max_disparity)

    def temporal_match(self, feat_a: FeatureSet, feat_b: FeatureSet,
                       search_radius: float | None = None,
                       search_radius_y: float | None = None) -> MatchSet:
        """Frame-to-frame matching for the VO backend (match-only
        kernel, 1 launch) over a rectangular +-radius window; radii
        default to ``PipelineConfig.temporal_radius`` /
        ``temporal_radius_y`` (y falls back to the x radius)."""
        rx = float(self.pipe.temporal_radius if search_radius is None
                   else search_radius)
        ry = search_radius_y
        if ry is None:
            ry = (rx if self.pipe.temporal_radius_y is None
                  else self.pipe.temporal_radius_y)
        fa, fb = self._on_device(feat_a), self._on_device(feat_b)
        # the [0, max_disparity] window becomes [-rx, +rx] by shifting
        # the left x, a float32 tensor add as in the JAX package
        return self._match_only(fa, pose_solver.shift_x(matching._meta(fa),
                                                        rx), fb, ry, 2.0 * rx)

    def sad_rectify(self, img_l, img_r, feat_l: FeatureSet,
                    feat_r: FeatureSet, matches: MatchSet) -> DepthSet:
        """SAD rectification + disparity/depth (Sec. II-C2, III-D) for
        one explicit pair and its matches, with in-kernel window reads
        (the SAD-only kernel, 1 launch).  Depth uses the first pair's
        left-camera intrinsics."""
        cfg = self.pipe.orb
        fl, fr = self._on_device(feat_l), self._on_device(feat_r)
        m = self._on_device(matches)
        xy_l = fl.xy
        xy_r = fr.xy[m.right_index.long()]
        table = ops.sad_patch_search(
            self._to_device(img_l)[None], self._to_device(img_r)[None],
            xy_l[None], xy_r[None], sad_window=cfg.sad_window,
            sad_range=cfg.sad_range)[0]
        best = table.argmin(dim=1).float() - float(cfg.sad_range)
        return matching._depth_set(xy_l[:, 0], xy_r, best, m, cfg,
                                   self.rig.pair_intrinsics[0])

    def process_fleet(self, *args, **kwargs):
        raise NotImplementedError(
            "process_fleet is not ported yet (ROADMAP A5)")

    def run_fleet(self, *args, **kwargs):
        raise NotImplementedError(
            "run_fleet is not ported yet (ROADMAP A5)")


def session_for(cfg: ORBConfig, intr: CameraIntrinsics | None,
                n_cameras: int = 2, schedule: str = "sequential",
                device: str | torch.device = "cuda") -> VisualSystem:
    """Session cache behind the legacy free-function shims: one
    ``VisualSystem`` per (ORBConfig, intrinsics, camera count, schedule,
    device), so repeated shim calls reuse one session as a held one
    would.  Cameras pair up in the legacy [L, R, L, R, ...] order."""
    return _session_for(cfg, intr, n_cameras, schedule,
                        str(torch.device(device)))


@functools.lru_cache(maxsize=128)
def _session_for(cfg, intr, n_cameras, schedule, device) -> VisualSystem:
    pairs = tuple((2 * i, 2 * i + 1) for i in range(n_cameras // 2))
    rig = RigConfig(n_cameras=n_cameras, pairs=pairs,
                    intrinsics=intr if intr is not None
                    else CameraIntrinsics())
    return VisualSystem(rig, PipelineConfig(orb=cfg, schedule=schedule),
                        device=device)
