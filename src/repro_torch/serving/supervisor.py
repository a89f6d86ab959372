"""Watchdog supervision: per-rig health, restarts, quarantine (port of
``repro.serving.supervisor``: numpy only, its code unchanged).

A production fleet loses rigs in two ways the batch math cannot see:
a rig stops SENDING (wedged camera firmware, dead link — detected here via
heartbeat timeout) or keeps sending but degraded (dead camera, desync —
reported by the service via ``heartbeat(degraded=True)``).  The
supervisor runs the classic process-watchdog loop over both signals:

    HEALTHY <-> DEGRADED --timeout--> RESTARTING --budget--> QUARANTINED
        ^________________heartbeat________|  ^-- reinstate --'

Restarts back off exponentially with DETERMINISTIC per-(rig, attempt)
jitter (seeded — two supervisors with the same seed schedule identical
restart times, so fault-injection episodes are bit-reproducible), and a
rig that needs more than ``restart_budget`` restarts within
``flap_window_s`` is quarantined instead of flapping forever.

All time is an explicit ``now`` argument — no wall-clock reads — so the
state machine is a pure function of its inputs.
"""

from __future__ import annotations

import dataclasses
import enum
import typing
import zlib

import numpy as np


class RigHealth(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"        # serving, but with masked cameras/frames
    RESTARTING = "restarting"    # not serving; restart scheduled or issued
    QUARANTINED = "quarantined"  # flapped past the budget; manual reinstate


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    heartbeat_timeout_s: float = 0.5
    backoff_base_s: float = 0.1
    backoff_factor: float = 2.0
    backoff_max_s: float = 5.0
    backoff_jitter: float = 0.25   # +- fraction of the deterministic delay
    restart_budget: int = 3        # restarts inside flap_window_s before
    flap_window_s: float = 60.0    # ... the rig is quarantined
    seed: int = 0

    def __post_init__(self):
        if self.heartbeat_timeout_s <= 0:
            raise ValueError("heartbeat_timeout_s must be > 0")
        if self.backoff_base_s <= 0 or self.backoff_factor < 1:
            raise ValueError("backoff_base_s > 0 and backoff_factor >= 1 "
                             "required")
        if not (0 <= self.backoff_jitter < 1):
            raise ValueError("backoff_jitter must be in [0, 1)")
        if self.restart_budget < 1:
            raise ValueError("restart_budget must be >= 1")


class SupervisorEvent(typing.NamedTuple):
    """One observable transition from ``poll``: ``kind`` is
    ``"timeout"`` (heartbeat lapsed; restart scheduled at ``at``),
    ``"restart"`` (restart issued now) or ``"quarantine"``."""

    rig_id: typing.Any
    kind: str
    now: float
    at: float | None = None      # scheduled restart time for "timeout"
    attempt: int | None = None


@dataclasses.dataclass
class _RigState:
    health: RigHealth
    last_heartbeat: float
    restart_at: float | None = None     # scheduled; None while waiting
    restart_times: list = dataclasses.field(default_factory=list)
    restarts_total: int = 0
    degraded_frames: int = 0
    frames: int = 0


class Supervisor:
    """Heartbeat-driven health tracking for a set of rigs.

    ``restart_cb(rig_id)``, when given, is invoked from ``poll`` at the
    moment a scheduled restart fires — the hook a real deployment points
    at its camera-firmware relaunch (and fault-injection tests point at
    ``FaultInjector.clear_rig`` so a restart actually heals the rig).
    """

    def __init__(self, cfg: SupervisorConfig | None = None,
                 restart_cb=None) -> None:
        self.cfg = cfg if cfg is not None else SupervisorConfig()
        self.restart_cb = restart_cb
        self._rigs: dict = {}

    # -- intake ------------------------------------------------------------

    def register(self, rig_id, now: float) -> None:
        if rig_id not in self._rigs:
            self._rigs[rig_id] = _RigState(RigHealth.HEALTHY, float(now))

    def heartbeat(self, rig_id, now: float, degraded: bool = False) -> None:
        """A sign of life from a rig (the service calls this on every
        accepted frame).  Revives a RESTARTING rig; never un-quarantines
        (that requires an explicit ``reinstate``)."""
        self.register(rig_id, now)
        st = self._rigs[rig_id]
        st.frames += 1
        st.degraded_frames += int(degraded)
        if st.health is RigHealth.QUARANTINED:
            return
        st.last_heartbeat = float(now)
        st.restart_at = None
        st.health = RigHealth.DEGRADED if degraded else RigHealth.HEALTHY

    def is_serving(self, rig_id) -> bool:
        st = self._rigs.get(rig_id)
        return st is not None and st.health in (RigHealth.HEALTHY,
                                                RigHealth.DEGRADED)

    def health(self, rig_id) -> RigHealth | None:
        st = self._rigs.get(rig_id)
        return None if st is None else st.health

    # -- watchdog ----------------------------------------------------------

    def _backoff(self, rig_id, attempt: int) -> float:
        """Deterministic exponential backoff with seeded jitter: the
        delay before restart ``attempt`` (1-based) of ``rig_id``.  The
        jitter stream is keyed on (seed, rig, attempt) so it decorrelates
        rigs (no restart stampede) yet replays exactly under one seed."""
        cfg = self.cfg
        delay = min(cfg.backoff_base_s * cfg.backoff_factor ** (attempt - 1),
                    cfg.backoff_max_s)
        key = [cfg.seed & 0xFFFFFFFF,
               zlib.crc32(repr(rig_id).encode()) & 0xFFFFFFFF,
               attempt]
        u = np.random.RandomState(key).uniform(-1.0, 1.0)
        return float(delay * (1.0 + cfg.backoff_jitter * u))

    def poll(self, now: float) -> list[SupervisorEvent]:
        """Advance the watchdog to ``now``; returns the transitions that
        fired.  Call at every service step (idempotent between state
        changes)."""
        now = float(now)
        events: list[SupervisorEvent] = []
        for rig_id, st in self._rigs.items():
            if st.health is RigHealth.QUARANTINED:
                continue
            if st.health is RigHealth.RESTARTING and st.restart_at is not None:
                if now >= st.restart_at:
                    st.restart_at = None
                    st.restarts_total += 1
                    # fresh timeout window to come back up in; if no
                    # heartbeat arrives, the lapse below schedules the
                    # next (further backed-off) attempt.
                    st.last_heartbeat = now
                    events.append(SupervisorEvent(
                        rig_id, "restart", now,
                        attempt=len(st.restart_times)))
                    if self.restart_cb is not None:
                        self.restart_cb(rig_id)
                continue
            if now - st.last_heartbeat <= self.cfg.heartbeat_timeout_s:
                continue
            # Heartbeat lapsed (serving rig wedged, or a restarted rig
            # that never came back): schedule the next restart, or
            # quarantine once the budget inside the flap window is spent.
            window = self.cfg.flap_window_s
            st.restart_times = [t for t in st.restart_times
                                if now - t <= window]
            if len(st.restart_times) >= self.cfg.restart_budget:
                st.health = RigHealth.QUARANTINED
                st.restart_at = None
                events.append(SupervisorEvent(rig_id, "quarantine", now))
                continue
            st.restart_times.append(now)
            attempt = len(st.restart_times)
            st.restart_at = now + self._backoff(rig_id, attempt)
            st.health = RigHealth.RESTARTING
            events.append(SupervisorEvent(rig_id, "timeout", now,
                                          at=st.restart_at, attempt=attempt))
        return events

    def reinstate(self, rig_id, now: float) -> None:
        """Manually lift a quarantine: the rig re-enters RESTARTING with
        a cleared flap history and an immediate restart."""
        st = self._rigs[rig_id]
        st.health = RigHealth.RESTARTING
        st.restart_times = []
        st.restart_at = float(now)

    # -- snapshot ----------------------------------------------------------

    def export_state(self) -> list:
        """The full per-rig ledger as plain JSON-able records (rig ids
        left as-is; a snapshot store tags them for JSON).  This is
        the state a host crash must NOT launder: restart times, flap
        budgets and quarantine flags all survive a snapshot/restore
        round trip bit-for-bit."""
        return [
            {"rig_id": rig_id,
             "health": st.health.value,
             "last_heartbeat": st.last_heartbeat,
             "restart_at": st.restart_at,
             "restart_times": list(st.restart_times),
             "restarts_total": st.restarts_total,
             "degraded_frames": st.degraded_frames,
             "frames": st.frames}
            for rig_id, st in self._rigs.items()]

    def restore_state(self, records: list) -> None:
        """Inverse of ``export_state``: replace the ledger wholesale.
        A quarantined rig stays quarantined, a rig mid-backoff keeps its
        scheduled ``restart_at`` and its in-window restart history — the
        watchdog resumes exactly where the dead host left off."""
        self._rigs = {}
        for rec in records:
            self._rigs[rec["rig_id"]] = _RigState(
                health=RigHealth(rec["health"]),
                last_heartbeat=float(rec["last_heartbeat"]),
                restart_at=(None if rec["restart_at"] is None
                            else float(rec["restart_at"])),
                restart_times=[float(t) for t in rec["restart_times"]],
                restarts_total=int(rec["restarts_total"]),
                degraded_frames=int(rec["degraded_frames"]),
                frames=int(rec["frames"]))

    # -- reporting ---------------------------------------------------------

    def status_report(self, now: float) -> dict:
        """Structured health snapshot: per-rig state + fleet counts."""
        rigs = {}
        counts = {h.value: 0 for h in RigHealth}
        for rig_id, st in sorted(self._rigs.items(), key=lambda kv: repr(kv[0])):
            counts[st.health.value] += 1
            rigs[rig_id] = {
                "health": st.health.value,
                "since_heartbeat_s": round(float(now) - st.last_heartbeat, 6),
                "restart_at": st.restart_at,
                "restarts_total": st.restarts_total,
                "restarts_in_window": len(st.restart_times),
                "frames": st.frames,
                "degraded_frames": st.degraded_frames,
            }
        return {"now": float(now), "counts": counts, "rigs": rigs}
