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
                  arrival jitter) so every failure mode has a
                  reproducible test.
  ``service``     ``FleetService``: ties them to a ``VisualSystem`` —
                  submit/step API, never-crash discipline (faults
                  become degradation or quarantine, not exceptions),
                  the ``run_episode`` loop, and ``wire_encode`` /
                  ``wire_decode`` over ``repro_torch.distributed.
                  compression``.

All time is explicit (every entry point takes ``now``): tests and the
fault harness drive a virtual clock, so restart/backoff behaviour is
bit-reproducible under a fixed seed, and an episode's events and
counters equal the JAX service's.  The failover layer (``failover``:
host map and dispatch guard) and crash-consistent snapshots
(``snapshot`` over a checkpoint store) are ROADMAP A10b.
"""

from repro_torch.serving.faults import FaultInjector, FaultSpec, InjectedFrame
from repro_torch.serving.queue import FleetBatch, FrameQueue, QueueConfig
from repro_torch.serving.service import (EpisodeResult, FleetService,
                                         RigReport, run_episode, wire_decode,
                                         wire_encode)
from repro_torch.serving.supervisor import (RigHealth, Supervisor,
                                            SupervisorConfig, SupervisorEvent)

__all__ = [
    "FaultInjector", "FaultSpec", "InjectedFrame",
    "FleetBatch", "FrameQueue", "QueueConfig",
    "EpisodeResult", "FleetService", "RigReport", "run_episode",
    "wire_decode", "wire_encode",
    "RigHealth", "Supervisor", "SupervisorConfig", "SupervisorEvent",
]
