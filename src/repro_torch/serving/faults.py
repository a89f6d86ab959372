"""Deterministic fault injection for the streaming fleet service (port
of ``repro.serving.faults``: numpy only, its code unchanged).

Every failure mode the service claims to survive gets a reproducible
trigger: a ``FaultSpec`` names a rig, a frame window and a fault kind,
and ``FaultInjector.apply`` perturbs that rig's frames accordingly —
pure function of (specs, seed, rig, frame index), no wall clock, no
global RNG — so an episode replays bit-identically and tests can pin
healthy-rig outputs bit-exact against a no-fault run.

Fault kinds (who detects them is part of the contract):

  ``dead_camera``    slab zeroed AND reported dead in the capture layer's
                     ``camera_mask`` (camera firmware knows its camera
                     died) -> core degrades to surviving pairs.
  ``corrupt_frame``  slab filled with NaN, mask says HEALTHY — the
                     service's finite-check must catch it.
  ``stalled_rig``    the frame is never delivered -> the supervisor's
                     heartbeat timeout must catch it.
  ``desync``         one camera's trigger tag drifts by ``magnitude``
                     seconds -> the rig's desync policy must catch it.
  ``arrival_jitter`` delivery time skews (deterministic per-frame
                     half-normal, scale ``magnitude``) -> exercises
                     queue deadlines/bucketing, not a fault per se.

Host-level faults (the failure domain is the serving host, not a rig;
all still pure functions of (spec, seed, frame)); ``run_episode`` and
the service's ``DispatchGuard``, ``HostMap`` and snapshots act on them:

  ``host_down``        ``rig`` names the HOST fault domain; fires once
                       at ``start`` -> ``FleetService.host_down``
                       redistributes its rigs over the survivors.
  ``stuck_dispatch``   the guarded ``step`` compute stalls past the
                       ``DispatchGuard`` timeout for the first
                       ``int(magnitude)`` attempts of every dispatch
                       in the window -> counted stall + retry, never a
                       wedged loop.
  ``dispatch_error``   same windowing, but the compute raises ->
                       counted error + deterministic backoff retry.
  ``corrupt_snapshot`` the newest service snapshot is torn
                       (deterministically truncated) before a
                       kill-and-recover restore -> the restore must
                       fall back to the previous step, never crash.
"""

from __future__ import annotations

import dataclasses
import typing
import zlib

import numpy as np

_KINDS = ("dead_camera", "corrupt_frame", "stalled_rig", "desync",
          "arrival_jitter",
          "host_down", "stuck_dispatch", "dispatch_error",
          "corrupt_snapshot")

# Kinds that perturb one rig's frames in `apply` (vs the host-level
# kinds queried by the service/episode loop directly).
_FRAME_KINDS = ("dead_camera", "corrupt_frame", "stalled_rig", "desync",
                "arrival_jitter")
_DISPATCH_KINDS = ("stuck_dispatch", "dispatch_error")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: ``kind`` applied to ``rig`` for frame indices in
    [``start``, ``stop``) (``stop=None`` = forever).  ``camera`` selects
    the slab for dead_camera/corrupt_frame/desync; ``magnitude`` is the
    desync offset / jitter scale in seconds — or, for the dispatch
    kinds, the number of consecutive failing attempts per dispatch.

    For ``host_down`` the ``rig`` field names the HOST fault domain
    (``launch.mesh.host_fault_domains`` id); for the dispatch and
    snapshot kinds ``rig`` is unused (the fault hits the whole host)."""

    kind: str
    rig: typing.Any = None
    start: int = 0
    stop: int | None = None
    camera: int = 0
    magnitude: float = 1.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, "
                             f"got {self.kind!r}")
        if self.stop is not None and self.stop <= self.start:
            raise ValueError(f"empty fault window [{self.start}, {self.stop})")
        if self.kind in _FRAME_KINDS + ("host_down",) and self.rig is None:
            raise ValueError(
                f"{self.kind!r} needs a target: rig id for frame faults, "
                "host domain id for host_down")

    def active(self, frame_index: int) -> bool:
        return (frame_index >= self.start
                and (self.stop is None or frame_index < self.stop))


class InjectedFrame(typing.NamedTuple):
    """``apply``'s output: the (possibly perturbed) frame plus what the
    CAPTURE layer would know.  ``camera_mask`` only reflects faults
    camera firmware reports (dead_camera) — corruption and desync must be
    caught downstream.  ``delivered=False`` means the frame never
    reaches the service (stall)."""

    images: np.ndarray
    timestamps: np.ndarray
    t_arrival: float
    delivered: bool
    camera_mask: np.ndarray
    faults: tuple[str, ...]


class FaultInjector:
    """Applies the active subset of ``specs`` to each (rig, frame).

    ``clear_rig`` disables every spec targeting a rig — the restart
    hook: point ``Supervisor.restart_cb`` here and a watchdog restart
    actually heals the fault, closing the detect -> restart -> recover
    loop deterministically."""

    def __init__(self, specs: typing.Sequence[FaultSpec],
                 seed: int = 0) -> None:
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._disabled: set[int] = set()

    def clear_rig(self, rig_id) -> int:
        """Disable all specs for ``rig_id``; returns how many."""
        hit = [i for i, s in enumerate(self.specs)
               if s.rig == rig_id and i not in self._disabled]
        self._disabled.update(hit)
        return len(hit)

    def active_faults(self, rig_id, frame_index: int) -> tuple[str, ...]:
        return tuple(s.kind for i, s in enumerate(self.specs)
                     if i not in self._disabled and s.rig == rig_id
                     and s.active(frame_index))

    def _rng(self, rig_id, frame_index: int) -> np.random.RandomState:
        key = [self.seed & 0xFFFFFFFF,
               zlib.crc32(repr(rig_id).encode()) & 0xFFFFFFFF,
               int(frame_index)]
        return np.random.RandomState(key)

    def apply(self, rig_id, frame_index: int, images, timestamps,
              t_arrival: float) -> InjectedFrame:
        im = np.array(images, dtype=np.float32, copy=True)
        ts = np.array(timestamps, dtype=np.float64, copy=True).reshape(-1)
        mask = np.ones(im.shape[0], dtype=bool)
        t = float(t_arrival)
        delivered = True
        applied: list[str] = []
        for i, s in enumerate(self.specs):
            if i in self._disabled or s.kind not in _FRAME_KINDS \
                    or s.rig != rig_id or not s.active(frame_index):
                continue
            applied.append(s.kind)
            if s.kind == "dead_camera":
                im[s.camera] = 0.0
                mask[s.camera] = False
            elif s.kind == "corrupt_frame":
                im[s.camera] = np.nan
            elif s.kind == "stalled_rig":
                delivered = False
            elif s.kind == "desync":
                ts[s.camera] += s.magnitude
            elif s.kind == "arrival_jitter":
                t += abs(self._rng(rig_id, frame_index)
                         .normal(0.0, s.magnitude))
        return InjectedFrame(im, ts, t, delivered, mask, tuple(applied))

    # -- host-level faults (queried, not applied to frames) ----------------

    def hosts_down_at(self, frame_index: int) -> tuple:
        """Host fault domains whose ``host_down`` spec STARTS at this
        frame — a host dies once, so the event fires exactly at
        ``start`` (the window end is irrelevant)."""
        return tuple(s.rig for i, s in enumerate(self.specs)
                     if i not in self._disabled and s.kind == "host_down"
                     and s.start == frame_index)

    def dispatch_fault(self, dispatch_index: int, attempt: int
                       ) -> str | None:
        """What the guarded dispatch sees on ``attempt`` (1-based) of
        dispatch ordinal ``dispatch_index``: ``"stall"``, ``"error"``
        or None.  A spec fails the first ``int(magnitude)`` attempts of
        every dispatch in its window, so retries deterministically
        recover when the guard's budget exceeds the fault's depth —
        pure function of (specs, frame, attempt), no RNG needed."""
        for i, s in enumerate(self.specs):
            if i in self._disabled or s.kind not in _DISPATCH_KINDS \
                    or not s.active(dispatch_index):
                continue
            if attempt <= max(1, int(s.magnitude)):
                return "stall" if s.kind == "stuck_dispatch" else "error"
        return None

    def snapshot_corruption(self, frame_index: int) -> dict | None:
        """Deterministic torn-snapshot parameters for a crash at
        ``frame_index`` (None when no ``corrupt_snapshot`` spec is
        active): which leaf file to tear and how much of it to keep,
        drawn from the same seeded (spec, frame) stream as every other
        fault."""
        for i, s in enumerate(self.specs):
            if i in self._disabled or s.kind != "corrupt_snapshot" \
                    or not s.active(frame_index):
                continue
            rng = self._rng("snapshot", frame_index)
            return {"leaf_index": int(rng.randint(0, 1 << 30)),
                    "keep_fraction": float(0.1 + 0.7 * rng.uniform())}
        return None
