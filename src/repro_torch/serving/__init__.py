"""Streaming fleet service over the `VisualSystem` session (port of
``repro.serving``).

The session answers "process THIS fleet frame in 3 launches";
production traffic is rigs arriving asynchronously, stalling,
desyncing and losing cameras.  This package is the robustness layer
between the two:

  ``queue``       host-side frame queue coalescing async rig arrivals
                  into BUCKETED fleet batches (a fixed small set of
                  fleet sizes; padding rigs masked out) with per-rig
                  deadlines, each batch built on the session's device
                  (every frame copied once into its row).
  ``supervisor``  watchdog: per-rig health state machine (HEALTHY ->
                  DEGRADED -> RESTARTING -> QUARANTINED), heartbeat
                  timeouts, deterministic exponential backoff + jitter,
                  bounded restart budget, structured status report.
  ``faults``      deterministic fault-injection harness (dead cameras,
                  stalled rigs, corrupted frames, trigger desync,
                  arrival jitter, and the host-level kinds) so every
                  failure mode has a reproducible test.
  ``failover``    host-level failure domain: ``HostMap`` placing rigs
                  on host fault domains with deterministic
                  redistribution on ``host_down``, and ``DispatchGuard``
                  converting stuck/throwing dispatches into counted,
                  deterministically backed-off retries.
  ``snapshot``    crash-consistent service snapshots (versioned +
                  checksummed over ``repro_torch.checkpoint``): a fresh
                  service restored from the newest verifiable snapshot
                  serves healthy rigs bit-exactly; torn snapshots fall
                  back a step instead of crashing.
  ``service``     ``FleetService``: ties them to a ``VisualSystem`` —
                  submit/step API, never-crash discipline (faults
                  become degradation or quarantine, not exceptions),
                  the ``run_episode`` loop (with kill-and-recover), and
                  ``wire_encode`` / ``wire_decode`` over
                  ``repro_torch.distributed.compression``.

All time is explicit (every entry point takes ``now``): tests and the
fault harness drive a virtual clock, so restart/backoff behaviour is
bit-reproducible under a fixed seed, and an episode's events and
counters equal the JAX service's.  The one wall-clock exception is the
``DispatchGuard`` timeout — a stuck dispatch does not consult a virtual
clock.
"""

from repro_torch.serving import snapshot
from repro_torch.serving.failover import (DispatchEvent, DispatchGuard,
                                          DispatchGuardConfig, DispatchOutcome,
                                          HostEvent, HostMap,
                                          InjectedDispatchError)
from repro_torch.serving.faults import FaultInjector, FaultSpec, InjectedFrame
from repro_torch.serving.queue import FleetBatch, FrameQueue, QueueConfig
from repro_torch.serving.service import (EpisodeResult, FleetService,
                                         RigReport, run_episode, wire_decode,
                                         wire_encode)
from repro_torch.serving.supervisor import (RigHealth, Supervisor,
                                            SupervisorConfig, SupervisorEvent)

__all__ = [
    "DispatchEvent", "DispatchGuard", "DispatchGuardConfig",
    "DispatchOutcome", "HostEvent", "HostMap", "InjectedDispatchError",
    "FaultInjector", "FaultSpec", "InjectedFrame",
    "FleetBatch", "FrameQueue", "QueueConfig",
    "EpisodeResult", "FleetService", "RigReport", "run_episode",
    "wire_decode", "wire_encode",
    "RigHealth", "Supervisor", "SupervisorConfig", "SupervisorEvent",
    "snapshot",
]
