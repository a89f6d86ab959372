"""`VisualSystem` — the session API of the quad-camera visual frontend
(port of ``repro.core.pipeline``).

A session is built once from a ``RigConfig`` (cameras, stereo pairs,
intrinsics, sync spec) and a ``PipelineConfig`` (ORB parameters,
temporal match radii, localization on or off), on a device, and then
streams frames:

    vs = VisualSystem(RigConfig.quad(intr), PipelineConfig(orb=ocfg))
    out = vs.process_frame(images)     # (n_cameras, H, W) -> (P,) axes
    outs = vs.run(frames)              # (T, n_cameras, H, W) -> (T, P)
    fout = vs.process_fleet(fleet)     # (n_rigs, n_cameras, H, W) -> (N, P)
    fseq = vs.run_fleet(fleet_frames)  # (T, n_rigs, n_cameras, H, W)

A frame costs exactly THREE kernel launches: one dense FE and one
sparse FE launch for every camera at every pyramid level, and one
fused matcher launch for every stereo pair.  A fleet frame folds its
rig axis into the same batch axes (one (n_rigs * n_cameras,) camera
batch, one (n_rigs * n_pairs,) pair batch), so it too is 3 launches,
and each rig's slice equals that rig's ``process_frame`` bit for bit.
With ``PipelineConfig(localize=True)`` a frame returns a
``LocalizationOutput`` (rig-frame points and the relative pose since the
previous frame) for ONE more launch, the match-only temporal matcher,
which a fleet frame shares across its rigs; a localized ``run`` or
``run_fleet`` of T steps folds all T - 1 transitions of every rig into
that one launch (3T + 1 in all).  ``PipelineConfig(precision="uint8")``
runs the paper's 8-bit datapath on uint8 frames in the same launches
(each kernel's uint8 variant), with the same outputs as the float32
path on the same integer-valued frame.  PyTorch runs eagerly, so the JAX
session's jit cache has no counterpart here, and ``run`` is a Python
loop over frames where the JAX package scans.  Under
``PipelineConfig(schedule="pipelined")`` ``run`` and ``run_fleet``
overlap FE(t) with FM(t - 1) (paper Fig. 4) on two CUDA streams, with
the same outputs and launches.

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

    ``schedule`` picks how ``run`` and ``run_fleet`` order a sequence's
    stages: "sequential" runs each frame's FE and FM in turn;
    "pipelined" is the paper's Fig. 4 frame multiplexing, FE(t)
    overlapping FM(t - 1), with FE and FM on two CUDA streams of the
    session's card (in one thread, in the same order, on the CPU).  The
    two give the same outputs bit for bit, at any ``precision`` and with
    ``localize`` on or off.  ``precision`` selects the image datapath: "f32" (default) takes
    float frames and keeps float32 slabs; "uint8" is the paper's 8-bit
    datapath end to end — uint8 frames and pyramid slabs, int32
    accumulators, a uint8 blur, int16 FAST scores and int32 moments in
    the kernels' uint8 variants — and needs ``ORBConfig.quantized``.
    ``localize`` turns on the localization backend
    (``repro_torch.localization``): ``process_frame``, ``process_fleet``,
    ``run`` and ``run_fleet`` then return a ``LocalizationOutput`` for
    one more launch a frame or fleet frame (one in all for a
    sequence).
    ``temporal_radius`` (x) and ``temporal_radius_y`` (y; None = the x
    radius) bound the frame-to-frame search window of ``temporal_match``
    and the backend."""

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
        # Pair indices and depth scales on the device, per fleet size.
        self._pair_cache: dict[int, tuple] = {}
        # Localization memory: the previous processed frame's state per
        # entry key ("frame" / ("fleet", n_rigs)), written only when
        # PipelineConfig.localize is on.  Callers that keep their own
        # state pass ``prev=`` instead.
        self._loc_state: dict = {}
        # The pipelined schedule's FE and FM side streams on a CUDA
        # device, made at its first use.
        self._streams: tuple | None = None
        # the session's device must exist: no silent CPU carry-on
        self._flat_pair_indices(1)

    # -- shape / sync validation (eager) -----------------------------------

    def _check_images(self, images, *, fleet: bool, sequence: bool,
                      what: str | None = None) -> None:
        want_nd = 3 + int(fleet) + int(sequence)
        shape = tuple(images.shape)
        if what is None:
            what = (("run_fleet" if sequence else "process_fleet") if fleet
                    else ("run" if sequence else "process_frame"))
        if len(shape) != want_nd:
            raise ValueError(
                f"{what} expects a rank-{want_nd} array "
                f"{'(T, ' if sequence else '('}"
                f"{'n_rigs, ' if fleet else ''}n_cameras, H, W); got "
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

    def _desync_error(self, desync: float, what: str = "") -> DesyncError:
        return DesyncError(
            f"{what}{self.rig.sync_policy}-sync rig saw {desync:.3e}s "
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

    def _coerce_camera_mask(self, camera_mask, n_rigs: int | None,
                            what: str):
        """Validate a caller's camera mask: (n_cameras,) bool for a
        frame, (n_rigs, n_cameras) for a fleet; returns np.bool_."""
        if camera_mask is None:
            return None
        if isinstance(camera_mask, torch.Tensor):
            camera_mask = camera_mask.cpu().numpy()
        mask = np.asarray(camera_mask, dtype=bool)
        want = ((self.rig.n_cameras,) if n_rigs is None
                else (n_rigs, self.rig.n_cameras))
        if mask.shape != want:
            raise ValueError(
                f"{what}: camera_mask shape {mask.shape} does not match "
                f"{want} (per-camera liveness"
                f"{'' if n_rigs is None else ' per rig'})")
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

    def _fleet_desync_mask(self, timestamps, camera_mask, n_rigs: int):
        """The desync policy rig by rig over (n_rigs, n_cameras) time
        tags: ``raise`` names the rig, ``drop_frame`` masks the whole
        rig (a fleet's shape is static: a rig cannot leave the batch),
        ``degrade`` ANDs its keep-mask into that rig's row."""
        ts = np.asarray(timestamps, dtype=np.float64)
        if ts.shape != (n_rigs, self.rig.n_cameras):
            raise ValueError(
                f"process_fleet: timestamps shape {ts.shape} does not "
                f"match ({n_rigs}, {self.rig.n_cameras})")
        rows = (np.ones((n_rigs, self.rig.n_cameras), dtype=bool)
                if camera_mask is None else camera_mask.copy())
        for r in range(n_rigs):
            try:
                dropped, row = self._frame_desync_mask(ts[r], rows[r])
            except DesyncError:
                raise self._desync_error(sync_mod.frame_desync(ts[r]),
                                         what=f"fleet rig {r}: ") from None
            rows[r] = False if dropped else row
        return rows

    def _coerce_fleet_images(self, images, what: str):
        """A fleet arrives as one stacked array or as a sequence of
        per-rig (n_cameras, H, W) frames.  Stacking needs one shape for
        every rig: mismatched rigs fail here with their shapes listed."""
        if isinstance(images, (list, tuple)) or (
                isinstance(images, np.ndarray) and images.dtype == object):
            shapes = [tuple(np.shape(x)) for x in images]
            if len(set(shapes)) > 1:
                raise ValueError(
                    f"{what}: rigs have mismatched frame shapes "
                    f"{shapes}; every rig in one fleet batch must share "
                    f"the same (n_cameras, H, W) = "
                    f"({self.rig.n_cameras}, {self.pipe.orb.height}, "
                    f"{self.pipe.orb.width}).  Rigs with different "
                    "camera counts need their own session (one "
                    "RigConfig per layout).")
            if images and all(isinstance(x, torch.Tensor) for x in images):
                return torch.stack(list(images))
            return np.stack([np.asarray(x) for x in images])
        return images

    # -- engine -------------------------------------------------------------

    def _pairs(self, n_rigs: int):
        """(left indices, right indices, FM intrinsics) of a batch of
        ``n_rigs`` rigs, built on the device once per fleet size."""
        if n_rigs not in self._pair_cache:
            c = self.rig.n_cameras
            offs = np.arange(n_rigs, dtype=np.int64)[:, None] * c
            left = offs + np.asarray(self.rig.left_cams, np.int64)[None]
            right = offs + np.asarray(self.rig.right_cams, np.int64)[None]
            if self.rig.homogeneous_intrinsics:
                intr = self.rig.intrinsics[0]
            else:
                fxb = np.asarray([float(ic.fx) * float(ic.baseline)
                                  for ic in self.rig.pair_intrinsics],
                                 np.float32)
                intr = torch.as_tensor(np.tile(fxb, n_rigs)[:, None],
                                       device=self.device)
            self._pair_cache[n_rigs] = (
                torch.as_tensor(left.reshape(-1), device=self.device),
                torch.as_tensor(right.reshape(-1), device=self.device),
                intr)
        return self._pair_cache[n_rigs]

    def _flat_pair_indices(self, n_rigs: int):
        """Left/right camera indices of every pair of every rig in the
        flat (n_rigs * n_cameras,) camera batch."""
        li, ri, _ = self._pairs(n_rigs)
        return li, ri

    def _fm_intr(self, n_rigs: int):
        """The shared ``CameraIntrinsics`` of a homogeneous rig, else an
        (n_rigs * n_pairs, 1) float32 column of per-pair
        ``fx * baseline``, the rig's column tiled across the fleet."""
        return self._pairs(n_rigs)[2]

    def _fe_flat(self, images, n_rigs: int):
        """FE stage over the flat camera batch: ONE dense + ONE sparse
        launch for every camera of every rig at every pyramid level."""
        feats = orb.extract_features_batched(images, self.pipe.orb,
                                             precision=self.pipe.precision)
        li, ri = self._flat_pair_indices(n_rigs)
        feat_l = map_fields(lambda x: x[li], feats)
        feat_r = map_fields(lambda x: x[ri], feats)
        return images[li], images[ri], feat_l, feat_r

    def _fm_flat(self, carry, n_rigs: int) -> StereoOutput:
        """FM stage over the flat pair batch: ONE fused matcher launch
        for every pair of every rig."""
        imgs_l, imgs_r, feat_l, feat_r = carry
        matches, depth = matching.match_pair_fused(
            imgs_l, imgs_r, feat_l, feat_r, self.pipe.orb,
            self._fm_intr(n_rigs))
        return StereoOutput(feat_l, feat_r, matches, depth)

    def _fe(self, images, n_rigs: int, mask_flat=None):
        """FE stage of a frame (n_cameras, H, W) or a fleet frame
        (n_rigs, n_cameras, H, W): the rig axis folds into the kernels'
        flat camera batch.  With graceful degradation a per-camera
        liveness mask zeroes dead slabs BEFORE the kernels."""
        flat = images.reshape((n_rigs * self.rig.n_cameras,)
                              + tuple(images.shape[-2:]))
        if mask_flat is not None:
            flat = torch.where(mask_flat[:, None, None], flat,
                               torch.zeros_like(flat))
        return self._fe_flat(flat, n_rigs)

    def _fm(self, carry, n_rigs: int, fleet: bool,
            mask_flat=None) -> StereoOutput:
        """FM stage of ``_fe``'s carry: the mask gates every validity
        field AFTER the kernels (all-true masks are identity), and a
        fleet's outputs unfold into (n_rigs, n_pairs, ...)."""
        out = self._fm_flat(carry, n_rigs)
        if mask_flat is not None:
            li, ri = self._flat_pair_indices(n_rigs)
            ml, mr = mask_flat[li], mask_flat[ri]
            out = matching.mask_stereo_output(out, ml, mr, ml & mr)
        if fleet:
            out = map_fields(
                lambda x: x.reshape((n_rigs, self.rig.n_pairs)
                                    + tuple(x.shape[1:])), out)
        return out

    def _mask_on_device(self, camera_mask):
        """A validated camera mask as a flat bool tensor on the device."""
        return (None if camera_mask is None
                else torch.as_tensor(np.asarray(camera_mask, bool).reshape(-1),
                                     device=self.device))

    def _frame_core(self, images, camera_mask=None) -> StereoOutput:
        """(n_cameras, H, W) -> StereoOutput with (n_pairs,) axes: a
        fleet of one through the same 3-launch datapath."""
        mask = self._mask_on_device(camera_mask)
        return self._fm(self._fe(images, 1, mask), 1, False, mask)

    def _fleet_core(self, images, camera_mask=None) -> StereoOutput:
        """(n_rigs, n_cameras, H, W) -> StereoOutput with
        (n_rigs, n_pairs) axes: the rig axis folds into the kernels'
        camera and pair batch axes, so the fleet frame is 3 launches,
        degraded or not (``camera_mask``: (n_rigs, n_cameras) bool)."""
        n = images.shape[0]
        mask = self._mask_on_device(camera_mask)
        return self._fm(self._fe(images, n, mask), n, True, mask)

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

    def _run_core(self, frames, fleet: bool) -> StereoOutput:
        """A sequence on the session's schedule, stacked into
        (T, [n_rigs,] n_pairs, ...) outputs.  The sequential schedule is
        the 3-launch frame (or fleet frame) path over every step in
        order (the JAX package's ``lax.scan``)."""
        n = int(frames.shape[1]) if fleet else 1

        def fe(frame):
            return self._fe(frame, n)

        def fm(carry):
            return self._fm(carry, n, fleet)

        if self.pipe.schedule == "pipelined":
            return self._run_pipelined(frames, fe, fm)
        outs = [fm(fe(frames[t])) for t in range(frames.shape[0])]
        return combine_fields(torch.stack, outs)

    def _side_streams(self):
        """The session's (FE, FM) side streams on its card, made at the
        first pipelined call; (None, None) on the CPU, where
        ``torch.cuda.stream(None)`` leaves the work in this thread."""
        if self.device.type != "cuda":
            return None, None
        if self._streams is None:
            self._streams = (torch.cuda.Stream(self.device),
                             torch.cuda.Stream(self.device))
        return self._streams

    def _run_pipelined(self, frames, fe, fm) -> StereoOutput:
        """Fig. 4 schedule (JAX ``_run_pipelined``): the prologue is
        FE(0), step t runs FM(t - 1) and then FE(t), and the drain is
        FM(T - 1), so the outputs cover all T frames aligned to
        ``frames``; T == 1 is prologue + drain.  The stages are the
        sequential schedule's on the same tensors, so the outputs equal
        its bit for bit, in the same 3T launches.

        On a CUDA session FE(t) runs on the FE side stream and overlaps
        FM(t - 1) on the FM side stream; on the CPU the same loop runs
        in one thread.  Every read across streams is ordered by
        ``wait_stream``, and every tensor made on one stream and read on
        another is marked with ``record_stream``, so that the caching
        allocator cannot hand its block to new work of its own stream
        while the other still reads it.  The prologue FE(0) runs on the
        current stream ``cur``: it builds the device tensors the path
        caches (pair indices, resize bands, slab tables, level columns)
        from cur's pool before either side stream reads them; the caches
        hold more entries than one call uses, so none is evicted and
        freed while a side stream reads it.  The outputs are made on the
        FM stream and marked for ``cur``, which waits for both side
        streams before returning."""
        t_total = int(frames.shape[0])
        fe_s, fm_s = self._side_streams()
        on_card = fe_s is not None
        cur = torch.cuda.current_stream(self.device) if on_card else None
        carry = fe(frames[0])
        made_on = cur
        if on_card:
            fe_s.wait_stream(cur)
            frames.record_stream(fe_s)
        steps = []
        for t in range(1, t_total + 1):
            if on_card:
                fm_s.wait_stream(made_on)
                _record_stream(carry, fm_s)
            with torch.cuda.stream(fm_s):
                steps.append(fm(carry))
            if t < t_total:
                with torch.cuda.stream(fe_s):
                    carry = fe(frames[t])
                made_on = fe_s
        with torch.cuda.stream(fm_s):
            outs = combine_fields(torch.stack, steps)
        if on_card:
            cur.wait_stream(fm_s)
            cur.wait_stream(fe_s)
            _record_stream(outs, cur)
        if outs.matches.valid.shape[0] != t_total:
            raise RuntimeError(
                f"pipelined schedule produced {outs.matches.valid.shape[0]}"
                f" outputs for {t_total} frames: the prologue/drain "
                "accounting is broken")
        return outs

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

    def _localize_fleet(self, out: StereoOutput, prev: LocalizationState):
        """Backend stage of a fleet frame, (n_rigs, n_pairs, ...) axes:
        rig-frame points (no launch), ONE temporal-match launch whose
        batch folds every pair of every rig, and the solve batched over
        the rigs.  Returns (points (n_rigs, P, K, 3), PoseSet with
        (n_rigs,) axes)."""
        n = out.features_l.valid.shape[0]
        pts = localization.rig_points(out.features_l.xy, out.depth.depth,
                                      self.rig)
        curr = localization.state_from(LocalizationOutput(out, pts, None))

        def flat(state):
            return map_fields(lambda x: x.reshape((-1,) + x.shape[2:]),
                              state)

        return pts, self._solve(flat(prev), flat(curr), n)

    def _localize_frame(self, out: StereoOutput, prev: LocalizationState):
        """Frame view of ``_localize_fleet``: (P,) axes in, points
        (P, K, 3) and a scalar PoseSet out."""
        pts, pose = self._localize_fleet(
            map_fields(lambda x: x[None], out),
            map_fields(lambda x: x[None], prev))
        return pts[0], map_fields(lambda x: x[0], pose)

    def _invalid_pose(self, lead: tuple) -> PoseSet:
        return PoseSet(
            rotation=torch.eye(3, device=self.device).expand(
                lead + (3, 3)).clone(),
            translation=torch.zeros(lead + (3,), device=self.device),
            inliers=torch.zeros(lead, dtype=torch.int32, device=self.device),
            valid=torch.zeros(lead, dtype=torch.bool, device=self.device))

    def _run_loc(self, frames, fleet: bool) -> LocalizationOutput:
        """Localized sequence: the frontend over every step (3 launches
        each) plus ONE temporal-match launch for ALL T - 1 transitions
        of every rig (time and rigs fold into the matcher's batch axis),
        then the (T - 1) * n_rigs-way batched solve.  Pose row 0 is
        identity + invalid (no predecessor)."""
        outs = self._run_core(frames, fleet)
        shaped = outs if fleet else map_fields(lambda x: x[:, None], outs)
        t_total, n = shaped.features_l.valid.shape[:2]
        pts = localization.rig_points(shaped.features_l.xy,
                                      shaped.depth.depth,
                                      self.rig)          # (T, n, P, K, 3)
        pose = self._invalid_pose((1, n))
        if t_total > 1:
            state = localization.state_from(
                LocalizationOutput(shaped, pts, None))

            def flat(sl):
                return map_fields(
                    lambda x: x[sl].reshape((-1,) + x.shape[3:]), state)

            moved = self._solve(flat(slice(None, -1)), flat(slice(1, None)),
                                (t_total - 1) * n)
            moved = map_fields(
                lambda x: x.reshape((t_total - 1, n) + x.shape[1:]), moved)
            pose = combine_fields(torch.cat, [pose, moved])
        if not fleet:
            pts = pts[:, 0]
            pose = map_fields(lambda x: x[:, 0], pose)
        return LocalizationOutput(outs, pts, pose)

    def _resolve_prev(self, prev, key, out: StereoOutput,
                      what: str) -> LocalizationState:
        """Previous-frame state for a localized entry: the caller's
        explicit ``prev`` (validated eagerly), else the session's stored
        state for this entry key, else the all-invalid zero state
        (session start: the solve degenerates to identity + invalid)."""
        k = out.features_l.valid.shape[-1]
        n_rigs = None if key == "frame" else key[1]
        if prev is None:
            prev = self._loc_state.get(key)
        if prev is None:
            return localization.zero_state(self.rig.n_pairs, k, n_rigs,
                                           device=self.device)
        if not isinstance(prev, LocalizationState):
            raise TypeError(
                f"{what}: prev must be a LocalizationState "
                f"(see repro_torch.localization.state_from), got "
                f"{type(prev)!r}")
        lead = ((self.rig.n_pairs,) if n_rigs is None
                else (n_rigs, self.rig.n_pairs))
        want = lead + (k, 3)
        got = tuple(prev.points.shape)
        if got != want:
            raise ValueError(
                f"{what}: prev.points shape {got} does not match {want} "
                "— the state must come from the same rig layout and "
                "feature budget (and, for fleets, the same n_rigs)")
        return self._on_device(prev)

    def reset_localization(self) -> None:
        """Forget all cross-frame localization state: the next
        ``process_frame`` / ``process_fleet`` behaves like a session
        start (identity + invalid pose).  Call between unrelated
        sequences."""
        self._loc_state.clear()

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
        self._check_images(images, fleet=False, sequence=False)
        camera_mask = self._coerce_camera_mask(camera_mask, None,
                                               "process_frame")
        if timestamps is not None:
            dropped, camera_mask = self._frame_desync_mask(timestamps,
                                                           camera_mask)
            if dropped:
                return None
        out = self._frame_core(self._to_device(images), camera_mask)
        if not self.pipe.localize:
            return out
        prev_state = self._resolve_prev(prev, "frame", out, "process_frame")
        pts, pose = self._localize_frame(out, prev_state)
        lout = LocalizationOutput(out, pts, pose)
        self._loc_state["frame"] = localization.state_from(lout)
        return lout

    def process_fleet(self, images, timestamps=None, camera_mask=None,
                      prev: LocalizationState | None = None
                      ) -> StereoOutput | LocalizationOutput:
        """One frame from every rig of a fleet: (n_rigs, n_cameras, H, W)
        -> StereoOutput with leading (n_rigs, n_pairs) axes, in exactly
        3 kernel launches for the whole fleet; each rig's slice equals
        that rig's ``process_frame`` bit for bit.  ``images`` may also
        be a sequence of per-rig (n_cameras, H, W) frames; mismatched
        per-rig shapes raise ``ValueError``.

        ``timestamps`` ((n_rigs, n_cameras)) applies the desync policy
        rig by rig: ``raise`` raises naming the rig, ``drop_frame``
        masks the whole rig, ``degrade`` masks its offending cameras.
        ``camera_mask`` ((n_rigs, n_cameras) bool) marks dead cameras;
        masked rigs degrade to their surviving pairs in the same 3
        launches.

        With ``PipelineConfig.localize`` the return is a
        ``LocalizationOutput`` with (n_rigs,) pose axes, for ONE more
        launch for the whole fleet; ``prev`` ((n_rigs, n_pairs, ...)
        ``LocalizationState``) overrides the session-held state of this
        fleet size."""
        images = self._coerce_fleet_images(images, "process_fleet")
        self._check_images(images, fleet=True, sequence=False)
        n_rigs = int(images.shape[0])
        camera_mask = self._coerce_camera_mask(camera_mask, n_rigs,
                                               "process_fleet")
        if timestamps is not None:
            camera_mask = self._fleet_desync_mask(timestamps, camera_mask,
                                                  n_rigs)
        out = self._fleet_core(self._to_device(images), camera_mask)
        if not self.pipe.localize:
            return out
        key = ("fleet", n_rigs)
        prev_state = self._resolve_prev(prev, key, out, "process_fleet")
        pts, pose = self._localize_fleet(out, prev_state)
        lout = LocalizationOutput(out, pts, pose)
        self._loc_state[key] = localization.state_from(lout)
        return lout

    def run(self, frames) -> StereoOutput | LocalizationOutput:
        """A frame sequence (T, n_cameras, H, W) -> StereoOutput with
        leading (T, n_pairs) axes, on the session's schedule (3
        launches a frame on either).  With ``localize`` on: a
        ``LocalizationOutput`` whose pose rows are the per-step relative
        motion (row 0 identity + invalid), for one more launch in all;
        a sequence neither reads nor writes the cross-call state of
        ``process_frame`` and ``process_fleet``."""
        self._check_images(frames, fleet=False, sequence=True)
        frames = self._to_device(frames)
        if self.pipe.localize:
            return self._run_loc(frames, False)
        return self._run_core(frames, False)

    def run_fleet(self, frames) -> StereoOutput | LocalizationOutput:
        """A fleet sequence (T, n_rigs, n_cameras, H, W) -> StereoOutput
        with leading (T, n_rigs, n_pairs) axes, 3 launches a step.  With
        ``localize`` on: a ``LocalizationOutput`` with (T, n_rigs) pose
        axes (row 0 identity + invalid) for one more launch in all
        (3T + 1); like ``run``, it keeps no cross-call state."""
        self._check_images(frames, fleet=True, sequence=True)
        frames = self._to_device(frames)
        if self.pipe.localize:
            return self._run_loc(frames, True)
        return self._run_core(frames, True)

    def extract(self, images) -> FeatureSet:
        """FE only: (n_cameras, H, W) -> FeatureSet with a leading
        (n_cameras,) axis, in 2 launches."""
        self._check_images(images, fleet=False, sequence=False,
                           what="extract")
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


def _record_stream(tup, stream) -> None:
    """``record_stream(stream)`` on every tensor of a (nested) tuple."""
    for x in tup:
        if isinstance(x, tuple):
            _record_stream(x, stream)
        else:
            x.record_stream(stream)


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
