"""``FleetService``: the never-crash streaming loop over a session (port
of ``repro.serving.service``).

One service owns one ``VisualSystem`` (one rig layout) plus a
``FrameQueue`` and a ``Supervisor``.  The contract is the robustness
inversion of the core API: ``process_frame`` RAISES on bad input so
callers can't miss it; the service CONVERTS every fault into
degradation, a drop, or quarantine and keeps serving —

  corrupted frames   eager finite-check per camera slab -> dead-camera
                     mask (the session then zeroes the slab);
  desync             the rig's ``desync_decision`` applied eagerly; a
                     policy that would raise becomes a dropped frame
                     (counted + health-reported, never an exception);
  dead cameras       capture mask -> masked fleet batch, surviving
                     stereo pairs still served in the 3-launch budget;
  stalled rigs       no frames -> no heartbeats -> supervisor timeout,
                     backoff restarts, quarantine when flapping.

All time is explicit (``submit``/``step`` take the caller's clock), so
``run_episode`` can drive a virtual clock and replay an injected-fault
episode bit-identically: its event log, counters and reports equal the
JAX service's under the same seeds.

The queue builds each batch on the session's device, each frame copied
once into its row; a served batch is the session's 3 launches (4
localized) and the service adds none, guarded or not.  The failover
layer (``serving.failover``: a ``DispatchGuard`` around each batch's
compute, a ``HostMap`` with ``host_down`` redistribution) and
crash-consistent snapshots (``serving.snapshot``: ``run_episode``'s
kill-and-recover) are optional and keep the same discipline.
"""

from __future__ import annotations

import collections
import time
import typing

import numpy as np
import torch

from repro_torch import localization
from repro_torch.core.pipeline import VisualSystem
from repro_torch.core.types import (LocalizationOutput, StereoOutput,
                                    combine_fields, map_fields)
from repro_torch.distributed import compression
from repro_torch.kernels.hamming_match import BIG as NO_MATCH_DIST
from repro_torch.serving import snapshot
from repro_torch.serving.failover import (DispatchEvent, DispatchGuard,
                                          HostEvent, HostMap)
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.queue import FrameQueue, QueueConfig
from repro_torch.serving.supervisor import Supervisor, SupervisorConfig


class RigReport(typing.NamedTuple):
    """One served (or dropped) rig frame.  ``output`` is the rig's
    ``StereoOutput`` slice (leading (n_pairs,) axes) for served frames
    — a ``LocalizationOutput`` slice (with 3-D points + pose) when the
    session localizes — None for drops; ``status`` is ``"ok"``,
    ``"degraded"``, or one of the ``"dropped_*"`` reasons."""

    rig_id: typing.Any
    t: float                    # service-step time the frame was served
    t_arrival: float            # when the frame arrived (the stable key
    status: str                 # for cross-episode output comparison)
    camera_mask: np.ndarray | None
    output: typing.Any
    late: bool = False


class FleetService:
    def __init__(self, vs: VisualSystem,
                 queue_cfg: QueueConfig | None = None,
                 sup_cfg: SupervisorConfig | None = None,
                 restart_cb=None,
                 guard: DispatchGuard | None = None,
                 host_map: HostMap | None = None) -> None:
        self.vs = vs
        # The queue buffers frames in the session's datapath dtype — a
        # uint8-precision session keeps the whole intake path 8-bit —
        # and uploads each batch to the session's device.
        self._frame_dtype = (np.uint8 if vs.pipe.precision == "uint8"
                             else np.float32)
        self.queue = FrameQueue(vs.rig,
                                (vs.pipe.orb.height, vs.pipe.orb.width),
                                queue_cfg, dtype=self._frame_dtype,
                                device=vs.device)
        self.supervisor = Supervisor(sup_cfg, restart_cb)
        # Optional failover layer: a DispatchGuard turns stuck/throwing
        # dispatches into counted retries/drops; a HostMap places rigs
        # on host fault domains so ``host_down`` can redistribute.
        self.guard = guard
        self.host_map = host_map
        self._dispatch_injector: FaultInjector | None = None
        self.events: list = []
        self.counters = collections.Counter()
        # Per-rig cross-frame localization memory (LocalizationState),
        # keyed by rig_id.  The queue re-buckets rigs freely between
        # batches, so the service — not the session — owns this state
        # and hands each batch an explicitly assembled ``prev``.
        self._loc_state: dict = {}

    # -- intake ------------------------------------------------------------

    def submit(self, rig_id, images, t_arrival: float, timestamps=None,
               camera_mask=None) -> str:
        """Accept one rig frame into the queue, running fault detection
        eagerly.  Returns the intake status (``"queued"`` /
        ``"queued_degraded"`` / ``"dropped_*"``); never raises on frame
        CONTENT (shape/layout errors still raise — those are caller
        bugs, not sensor faults)."""
        now = float(t_arrival)
        self.supervisor.register(rig_id, now)
        if self.host_map is not None:
            self.host_map.assign(rig_id)
        self.counters["frames_in"] += 1
        if self.supervisor.health(rig_id) is not None \
                and self.supervisor.health(rig_id).value == "quarantined":
            self.counters["dropped_quarantined"] += 1
            return "dropped_quarantined"

        arr = np.asarray(images)
        mask = (np.ones(self.vs.rig.n_cameras, dtype=bool)
                if camera_mask is None
                else np.asarray(camera_mask, dtype=bool).reshape(-1))
        if self._frame_dtype == np.uint8 and arr.dtype == np.uint8:
            # Integer fast path: a uint8 slab into a uint8 session is
            # already finite and quantized, so it is queued as it is,
            # with no copy.
            im = arr
        else:
            im = np.asarray(arr, dtype=np.float32)
            # Corruption: a NaN/inf slab with a healthy capture mask —
            # catch it here so garbage never reaches the kernels.
            finite = np.isfinite(im).all(axis=tuple(range(1, im.ndim)))
            if not finite.all():
                self.counters["corrupt_cameras"] += int((~finite & mask).sum())
                mask &= finite
            if self._frame_dtype == np.uint8:
                # Quantize at ingest (round/clip, as the f32 path's
                # quantized pyramid); NaNs were masked above.
                im = np.round(np.clip(np.nan_to_num(im), 0.0, 255.0)) \
                    .astype(np.uint8)
        if timestamps is not None:
            decision = self.vs.desync_decision(timestamps)
            if decision.action in ("raise", "drop_frame"):
                # Never-crash discipline: a raise-policy desync becomes
                # a counted drop; the rig stays alive but degraded.
                self.counters["dropped_desync"] += 1
                self.supervisor.heartbeat(rig_id, now, degraded=True)
                return "dropped_desync"
            if decision.action == "degrade":
                self.counters["desync_degraded"] += 1
                mask &= decision.camera_mask
        if not mask.any():
            self.counters["dropped_dead"] += 1
            self.supervisor.heartbeat(rig_id, now, degraded=True)
            return "dropped_dead"

        degraded = not mask.all()
        self.supervisor.heartbeat(rig_id, now, degraded=degraded)
        self.queue.put(rig_id, im, now, camera_mask=mask)
        self.counters["queued"] += 1
        return "queued_degraded" if degraded else "queued"

    # -- serving -----------------------------------------------------------

    def _assemble_prev(self, batch):
        """Stack each batch row's previous-frame ``LocalizationState``
        on the session's device (the all-invalid ``zero_state`` for
        first-seen rigs and padding rows, so they localize to identity +
        ``valid=False`` through the same code).

        A backlogged rig can appear TWICE in one batch (its frames are
        oldest-first).  The batch is one call, so the second frame
        cannot chain on the first's not-yet-computed state; giving it
        the same stored state would silently solve a double-length
        step.  Instead only the FIRST occurrence chains; later ones get
        ``zero_state`` and honestly report identity + ``valid=False``
        (the stored state still advances to the newest frame, so the
        next batch chains from there)."""
        zero = localization.zero_state(self.vs.rig.n_pairs,
                                       self.vs.pipe.orb.max_features,
                                       device=self.vs.device)
        n_slots = batch.images.shape[0]
        rows, seen = [], set()
        for b in range(n_slots):
            if b >= len(batch.rig_ids):
                rows.append(zero)                      # padding row
                continue
            rid = batch.rig_ids[b]
            rows.append(zero if rid in seen
                        else self._loc_state.get(rid, zero))
            seen.add(rid)
        return combine_fields(torch.stack, rows)

    def step(self, now: float, force: bool = False) -> list[RigReport]:
        """One service tick: advance the watchdog, then serve at most
        one bucketed fleet batch (3 kernel launches regardless of how
        many rigs are real, padded, or degraded — plus 1 localization
        launch when the session localizes)."""
        new_events = self.supervisor.poll(now)
        self.events.extend(new_events)
        # A restarted rig's frame stream has a gap: its stashed state
        # is stale, and a pose solved against it would be finite but
        # meaningless.  Drop it — the next served frame then reports
        # the honest identity + valid=False.
        for ev in new_events:
            if ev.kind in ("restart", "quarantine"):
                self._loc_state.pop(ev.rig_id, None)
        batch = self.queue.next_batch(now, force=force)
        if batch is None:
            return []
        localize = self.vs.pipe.localize

        def _compute():
            if localize:
                out = self.vs.process_fleet(batch.images,
                                            camera_mask=batch.camera_mask,
                                            prev=self._assemble_prev(batch))
                return out, localization.state_from(out)
            return self.vs.process_fleet(batch.images,
                                         camera_mask=batch.camera_mask), None

        if self.guard is not None:
            out, state = self._guarded(_compute, now)
            if out is None:
                # Budget exhausted: the batch is dropped (counted per
                # rig frame, health degraded) but the loop keeps
                # serving — same never-crash discipline as intake.
                for rig_id in batch.rig_ids:
                    self.counters["dropped_dispatch"] += 1
                    self.supervisor.heartbeat(rig_id, now, degraded=True)
                return []
        else:
            out, state = _compute()
        self.counters["batches"] += 1
        self.counters["padded_rows"] += len(batch.rig_mask) - batch.n_real
        reports = []
        for b, rig_id in enumerate(batch.rig_ids):
            mask = batch.camera_mask[b]
            if localize:
                self._loc_state[rig_id] = map_fields(lambda x: x[b], state)
            reports.append(RigReport(
                rig_id=rig_id, t=float(now),
                t_arrival=batch.t_arrivals[b],
                status="ok" if mask.all() else "degraded",
                camera_mask=mask,
                output=map_fields(lambda x: x[b], out),
                late=bool(batch.late[b])))
            self.counters["frames_out"] += 1
            self.counters["late_frames"] += int(batch.late[b])
        return reports

    def _guarded(self, compute, now: float):
        """Run one batch compute under the ``DispatchGuard``: stalls and
        exceptions become counted events + deterministic-backoff retries,
        and an exhausted budget returns ``(None, None)`` instead of
        raising.  The dispatch ordinal keys the injector window AND the
        backoff stream, and lives in ``counters`` so it survives a
        snapshot/restore (a restored service does not replay old
        ordinals)."""
        dispatch = int(self.counters["dispatches"])
        self.counters["dispatches"] += 1
        inj = self._dispatch_injector
        inject = (None if inj is None
                  else lambda attempt: inj.dispatch_fault(dispatch, attempt))
        outcome = self.guard.run(dispatch, compute, inject=inject)
        for fault in outcome.faults:
            kind = "dispatch_stalls" if fault == "stall" \
                else "dispatch_errors"
            self.counters[kind] += 1
        if outcome.faults:
            self.counters["dispatch_retries"] += outcome.attempts - 1
            self.events.append(DispatchEvent(
                "dispatch_recovered" if outcome.ok else "dispatch_drop",
                float(now), dispatch, outcome.attempts, outcome.faults,
                outcome.backoff_s))
        if not outcome.ok:
            return None, None
        return outcome.value

    # -- failover ----------------------------------------------------------

    def host_down(self, host, now: float) -> HostEvent:
        """A host fault domain died: redistribute its rigs over the
        survivors (``HostMap.host_down``) and gap their pose chains —
        migration is a stream gap exactly like a restart, so a moved
        rig's next frame reports identity + ``valid=False`` rather than
        chaining across the outage.  Supervisor state is untouched: the
        rigs themselves are healthy, they just live somewhere else now."""
        if self.host_map is None:
            raise ValueError(
                "FleetService.host_down needs a HostMap (pass host_map= "
                "at construction)")
        moved = self.host_map.host_down(host)
        for rig_id, _ in moved:
            self._loc_state.pop(rig_id, None)
        self.counters["host_down_events"] += 1
        self.counters["rigs_redistributed"] += len(moved)
        event = HostEvent("host_down", float(now), host, moved)
        self.events.append(event)
        return event

    def status(self, now: float) -> dict:
        """Structured service snapshot: supervisor report + queue depth
        + intake/serve counters (queue-side drop/lateness tallies are
        mirrored into ``counters`` so one dict answers "what did we
        lose"), plus host placement when a ``HostMap`` is attached."""
        out = {
            "supervisor": self.supervisor.status_report(now),
            "queue": {"pending": self.queue.pending(),
                      "oldest_wait_s": self.queue.oldest_wait(now),
                      "dropped_overflow": self.queue.dropped_overflow},
            "counters": {**dict(self.counters),
                         "dropped_overflow": self.queue.dropped_overflow},
        }
        if self.host_map is not None:
            out["hosts"] = self.host_map.status()
        return out


def wire_encode(output) -> dict:
    """Serialize one served output into the fleet uplink wire format
    (``repro_torch.distributed.compression``): descriptors as lossless
    uint8 bytes, match index/distance as uint16 with a no-match
    sentinel, float fields (xy, score, theta, disparity, depth) as
    int8 + scale with bounded error, validity as packed bits.  A
    ``LocalizationOutput`` also ships its rig-frame 3-D points and pose
    losslessly.  The payload tensors stay on the output's device; use
    ``compression.wire_bytes`` on the result for the payload size."""
    if isinstance(output, LocalizationOutput):
        wire = wire_encode(output.stereo)
        wire["points"] = compression.encode_points(output.points)
        wire["pose"] = compression.encode_pose(output.pose)
        return wire
    return dict(
        features_l=compression.encode_features(output.features_l),
        features_r=compression.encode_features(output.features_r),
        matches=compression.encode_matches(output.matches),
        depth=compression.encode_depth(output.depth))


def wire_decode(wire: dict):
    """Inverse of ``wire_encode``.  Descriptors, match indices and
    distances (the kernels' no-candidate distance restored), validity
    masks, and — when present — 3-D points and pose round-trip
    bit-exact; quantized float fields come back within the int8 + scale
    bound.  Returns a ``LocalizationOutput`` when the wire dict carries
    a pose, else a ``StereoOutput``."""
    stereo = StereoOutput(
        features_l=compression.decode_features(wire["features_l"]),
        features_r=compression.decode_features(wire["features_r"]),
        matches=compression.decode_matches(
            wire["matches"], no_match_distance=NO_MATCH_DIST),
        depth=compression.decode_depth(wire["depth"]))
    if "pose" in wire:
        return LocalizationOutput(
            stereo=stereo,
            points=compression.decode_points(wire["points"]),
            pose=compression.decode_pose(wire["pose"]))
    return stereo


class EpisodeResult(typing.NamedTuple):
    reports: list        # every RigReport, in service order
    events: list         # Supervisor/Dispatch/Host events, in order
    status: dict         # final FleetService.status snapshot
    recovery: dict | None = None   # kill-and-recover timing (crash_at)


def run_episode(service: FleetService, frames, dt: float = 1.0 / 30.0,
                t0: float = 0.0, rig_ids: typing.Sequence | None = None,
                injector: FaultInjector | None = None,
                settle_steps: int = 4,
                snapshot_dir: str | None = None, snapshot_keep: int = 3,
                crash_at: int | None = None,
                restore=None) -> EpisodeResult:
    """Drive a deterministic streaming episode on a virtual clock.

    ``frames``: (T, n_rigs, n_cameras, H, W).  Frame t of rig r nominally
    arrives at ``t0 + t * dt`` with trigger tags equal to the arrival
    time; the optional ``injector`` perturbs images/tags/arrival or
    withholds delivery per its specs (and its host-level specs fire
    here: ``host_down`` at its start frame, dispatch faults through the
    service's guard).  After the T arrival ticks, ``settle_steps`` extra
    force-flushed ticks let watchdog timeouts, backoff restarts and the
    final partial batch play out.

    Kill-and-recover: with ``snapshot_dir`` set, every tick ends in a
    crash-consistent ``serving.snapshot`` save (keeping the newest
    ``snapshot_keep`` steps); with ``crash_at=t`` the service object is
    DESTROYED after tick ``t`` and replaced by ``restore()`` (a zero-arg
    factory building a fresh, cold ``FleetService``) restored from the
    newest verifiable snapshot — through any ``corrupt_snapshot``
    tearing the injector dictates.  The episode then simply continues;
    ``result.recovery`` reports the restored step and the recovery wall
    clock.
    """
    if crash_at is not None and (restore is None or snapshot_dir is None):
        raise ValueError("crash_at requires restore= and snapshot_dir=")
    frames = np.asarray(frames)
    t_total, n_rigs = frames.shape[0], frames.shape[1]
    n_cameras = frames.shape[2]
    if rig_ids is None:
        rig_ids = tuple(range(n_rigs))
    service._dispatch_injector = injector
    reports: list[RigReport] = []
    pre_crash_events: list = []
    recovery = None
    for t in range(t_total):
        now = t0 + t * dt
        if injector is not None:
            for host in injector.hosts_down_at(t):
                service.host_down(host, now)
        for r in range(n_rigs):
            ts = np.full(n_cameras, now, dtype=np.float64)
            if injector is None:
                service.submit(rig_ids[r], frames[t, r], now, timestamps=ts)
                continue
            inj = injector.apply(rig_ids[r], t, frames[t, r], ts, now)
            if not inj.delivered:
                continue
            service.submit(rig_ids[r], inj.images, inj.t_arrival,
                           timestamps=inj.timestamps,
                           camera_mask=inj.camera_mask)
        reports.extend(service.step(now + 0.5 * dt))
        if snapshot_dir is not None:
            snapshot.save(service, snapshot_dir, step=t, keep=snapshot_keep)
        if crash_at is not None and t == crash_at:
            pre_crash_events = list(service.events)
            torn = (injector.snapshot_corruption(t)
                    if injector is not None else None)
            if torn is not None:
                snapshot.corrupt_newest(snapshot_dir, torn["leaf_index"],
                                        torn["keep_fraction"])
            wall = time.perf_counter()
            service = restore()
            restored_step = snapshot.restore(service, snapshot_dir)
            wall = time.perf_counter() - wall
            service._dispatch_injector = injector
            recovery = {
                "crash_at": int(t),
                "restored_step": restored_step,
                "recovery_wall_s": float(wall),
                "snapshot_fallback": bool(restored_step is not None
                                          and restored_step < t),
            }
    for k in range(settle_steps):
        now = t0 + (t_total + k) * dt
        reports.extend(service.step(now, force=True))
    final = t0 + (t_total + settle_steps) * dt
    return EpisodeResult(reports, pre_crash_events + list(service.events),
                         service.status(final), recovery)
