"""Multi-host failover primitives: rig placement and guarded dispatch
(port of ``repro.serving.failover``).

The supervisor makes the RIG the failure domain (watchdog, quarantine);
one level up, the serving HOST itself fails — taking every rig it
serves, their pose chains and its dispatch loop with it.  This module
holds the two host-level pieces that are independent of the
``FleetService`` wiring:

  ``HostMap``        rigs -> host fault domains (deterministic
                     least-loaded placement over the domain ids from
                     ``launch.mesh.host_fault_domains``); ``host_down``
                     redistributes the casualties over the survivors.
  ``DispatchGuard``  wraps the service's per-batch compute in a
                     wall-clock watchdog thread + bounded retries with
                     the Supervisor's deterministic seeded backoff
                     (``RandomState([seed, crc32(key), attempt])``), so
                     a stuck or throwing dispatch becomes a counted,
                     reported event instead of a wedged ``step`` loop.

The guard's worker thread runs in a copy of the caller's contextvars
context (so a ``launch_audit()`` scope of the caller counts the guarded
launches) and on the caller's current CUDA device and stream (PyTorch's
current stream is per thread, and every kernel launches on it), so a
guarded step issues its kernels where an unguarded one does.  The guard
adds no synchronization: it times the dispatch, as the JAX guard does.

Crash-consistent snapshots (the third piece) live in
``repro_torch.serving.snapshot``; ``FleetService`` ties all three
together.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import threading
import typing
import zlib

import numpy as np
import torch

__all__ = ["DispatchGuard", "DispatchGuardConfig", "DispatchOutcome",
           "DispatchEvent", "HostEvent", "HostMap",
           "InjectedDispatchError"]


# ---------------------------------------------------------------------------
# Rig placement over host fault domains

class HostEvent(typing.NamedTuple):
    """One observable host-level transition (``FleetService.events``
    carries these next to the per-rig ``SupervisorEvent``s):
    ``kind="host_down"`` with the lost domain and the (rig, new_host)
    moves the redistribution made."""

    kind: str
    now: float
    host: typing.Any
    moved: tuple = ()


class HostMap:
    """Assignment of rigs to host fault domains.

    Placement is deterministic least-loaded (ties broken by the hosts'
    given order), so two coordinators with the same arrival order hold
    identical maps — the same discipline as every other seeded piece of
    the serving layer.  ``host_down`` removes a domain and re-places its
    rigs over the survivors (stable ``repr`` order), returning the moves
    so the service can gap their pose chains and count the event.
    """

    def __init__(self, hosts: typing.Sequence,
                 assignment: dict | None = None) -> None:
        hosts = list(hosts)
        if not hosts:
            raise ValueError("HostMap needs at least one host domain")
        if len(set(hosts)) != len(hosts):
            raise ValueError(f"duplicate host domains: {hosts}")
        self.hosts: list = hosts
        self.down: list = []
        self._assignment: dict = {}
        for rig, host in (assignment or {}).items():
            if host not in hosts:
                raise ValueError(
                    f"rig {rig!r} assigned to unknown host {host!r}")
            self._assignment[rig] = host

    @classmethod
    def from_mesh(cls, mesh, axis: str = "data") -> "HostMap":
        """One fault domain per index of a device mesh's ``axis``.  The
        port has no device mesh yet: build the map from
        ``launch.mesh.host_fault_domains`` of the axis sizes instead."""
        raise NotImplementedError(
            "HostMap.from_mesh needs a device mesh, which is multi-GPU rig "
            "sharding (ROADMAP A12); use "
            "HostMap(host_fault_domains(sizes, axis))")

    # -- placement ---------------------------------------------------------

    def load(self) -> dict:
        out = {h: 0 for h in self.hosts}
        for host in self._assignment.values():
            if host in out:     # mid-redistribution, casualties still
                out[host] += 1  # point at the dead host — weightless
        return out

    def _least_loaded(self):
        load = self.load()
        return min(self.hosts, key=lambda h: (load[h],
                                              self.hosts.index(h)))

    def assign(self, rig_id):
        """The rig's host, placing it least-loaded on first sight."""
        host = self._assignment.get(rig_id)
        if host is None:
            host = self._least_loaded()
            self._assignment[rig_id] = host
        return host

    def host_of(self, rig_id):
        return self._assignment.get(rig_id)

    def rigs_on(self, host) -> tuple:
        return tuple(sorted((r for r, h in self._assignment.items()
                             if h == host), key=repr))

    # -- failure -----------------------------------------------------------

    def host_down(self, host) -> tuple:
        """Remove ``host`` and redistribute its rigs least-loaded over
        the survivors.  Returns ``((rig, new_host), ...)`` in stable
        order.  Losing the LAST host is a fleet-wide outage, not a
        redistribution — that raises."""
        if host not in self.hosts:
            raise ValueError(f"host {host!r} is not an active domain "
                             f"(active: {self.hosts}, down: {self.down})")
        if len(self.hosts) == 1:
            raise ValueError(
                f"host {host!r} is the last surviving domain — "
                "redistribution target set is empty (fleet-wide outage)")
        casualties = self.rigs_on(host)
        self.hosts.remove(host)
        self.down.append(host)
        moved = []
        for rig in casualties:
            new = self._least_loaded()
            self._assignment[rig] = new
            moved.append((rig, new))
        return tuple(moved)

    # -- snapshot ----------------------------------------------------------

    def export_state(self) -> dict:
        """Plain-python placement state (ids left as-is; the snapshot
        layer tags them for JSON)."""
        return {"hosts": list(self.hosts), "down": list(self.down),
                "assignment": [[r, h] for r, h
                               in self._assignment.items()]}

    def restore_state(self, state: dict) -> None:
        self.hosts = list(state["hosts"])
        self.down = list(state["down"])
        self._assignment = {r: h for r, h in state["assignment"]}

    def status(self) -> dict:
        return {"hosts": list(self.hosts), "down": list(self.down),
                "load": self.load()}


# ---------------------------------------------------------------------------
# Guarded dispatch

class InjectedDispatchError(RuntimeError):
    """What a ``dispatch_error`` fault spec raises inside the guarded
    compute — a stand-in for the real failure zoo (out of memory, device
    resets, driver faults)."""


class _Stalled(Exception):
    """Internal: the watchdog thread outlived its timeout."""


@dataclasses.dataclass(frozen=True)
class DispatchGuardConfig:
    """``timeout_s`` is WALL clock (the one place the serving layer
    reads it: a stuck dispatch does not consult our virtual clock);
    generous by default because the first call may build the kernels.
    Retry backoff reuses the Supervisor's deterministic seeded-jitter
    idiom and is REPORTED, not slept — the service loop owns pacing,
    the guard owns the schedule."""

    timeout_s: float = 60.0
    max_attempts: int = 2
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_max_s: float = 1.0
    backoff_jitter: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if self.timeout_s <= 0:
            raise ValueError("timeout_s must be > 0")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_base_s <= 0 or self.backoff_factor < 1:
            raise ValueError("backoff_base_s > 0 and backoff_factor >= 1 "
                             "required")
        if not (0 <= self.backoff_jitter < 1):
            raise ValueError("backoff_jitter must be in [0, 1)")


class DispatchOutcome(typing.NamedTuple):
    """``ok`` with the computed ``value``, or exhausted after
    ``attempts`` tries; ``faults`` records each failed attempt
    (``"stall"`` / ``"error:<Type>"``) and ``backoff_s`` the
    deterministic delays scheduled between attempts."""

    ok: bool
    value: typing.Any
    attempts: int
    faults: tuple[str, ...]
    backoff_s: tuple[float, ...]


class DispatchEvent(typing.NamedTuple):
    """Emitted into ``FleetService.events`` whenever a guarded dispatch
    saw at least one fault: ``kind`` is ``"dispatch_recovered"`` (a
    retry succeeded) or ``"dispatch_drop"`` (budget exhausted, batch
    dropped)."""

    kind: str
    now: float
    dispatch: int
    attempts: int
    faults: tuple[str, ...]
    backoff_s: tuple[float, ...]


def _caller_stream():
    """The calling thread's current CUDA stream, or None when CUDA was
    never initialized in this process (then no thread has set one)."""
    if not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_stream()


class DispatchGuard:
    """Timeout + bounded-retry wrapper for one dispatch callable.

    Each attempt runs in a daemon watchdog thread joined with
    ``timeout_s``; a thread that outlives the join is counted a stall
    and ABANDONED (its eventual result, if any, is discarded — a truly
    stuck dispatch never returns, and a merely-slow one must not race a
    retry).  Exceptions propagate out of the thread and are counted.
    ``inject`` (from ``FaultInjector.dispatch_fault``) lets episodes
    deterministically fault attempts: ``"error"`` raises
    ``InjectedDispatchError`` before the compute, ``"stall"`` simulates
    the timeout without calling the compute or burning wall clock (so
    an injected stall cannot leave a concurrent compute racing the
    retry, and episode tests stay fast under generous real timeouts).
    """

    def __init__(self, cfg: DispatchGuardConfig | None = None) -> None:
        self.cfg = cfg if cfg is not None else DispatchGuardConfig()

    def backoff(self, key, attempt: int) -> float:
        """Deterministic delay before retry ``attempt`` (1-based count
        of FAILED attempts) of dispatch ``key`` — the Supervisor's
        ``RandomState([seed, crc32, attempt])`` idiom, so replays
        schedule identically and concurrent hosts decorrelate."""
        cfg = self.cfg
        delay = min(cfg.backoff_base_s * cfg.backoff_factor ** (attempt - 1),
                    cfg.backoff_max_s)
        u = np.random.RandomState(
            [cfg.seed & 0xFFFFFFFF,
             zlib.crc32(repr(key).encode()) & 0xFFFFFFFF,
             attempt]).uniform(-1.0, 1.0)
        return float(delay * (1.0 + cfg.backoff_jitter * u))

    def _attempt(self, fn, mode: str | None, stream):
        if mode == "error":
            raise InjectedDispatchError("injected dispatch_error")
        if mode == "stall":
            # Simulated timeout: fn is never called and no wall clock
            # is burned — an injected stall must neither slow the test
            # down by timeout_s nor leave an abandoned compute racing
            # the retry.  Genuine stalls take the thread path below.
            raise _Stalled
        box: dict = {}

        def worker():
            try:
                # The caller's device and stream: the worker's own
                # current stream would be the default one.
                with (contextlib.nullcontext() if stream is None
                      else torch.cuda.stream(stream)):
                    box["value"] = fn()
            except BaseException as e:      # noqa: BLE001 — reported below
                box["error"] = e

        # A fresh Thread starts with an EMPTY contextvars context, so an
        # ambient ``launch_audit()`` scope (and any other contextvar the
        # caller holds) would not see launches dispatched inside the
        # guarded compute.  Run the worker inside a copy of the caller's
        # context: LaunchAudit objects are shared by reference, so counts
        # land in the caller's audit even though the context is a copy.
        ctx = contextvars.copy_context()
        t = threading.Thread(target=lambda: ctx.run(worker), daemon=True,
                             name="repro-dispatch-guard")
        t.start()
        t.join(self.cfg.timeout_s)
        if t.is_alive():
            raise _Stalled
        if "error" in box:
            raise box["error"]
        return box["value"]

    def run(self, key, fn, inject=None) -> DispatchOutcome:
        faults: list[str] = []
        delays: list[float] = []
        stream = _caller_stream()
        for attempt in range(1, self.cfg.max_attempts + 1):
            mode = inject(attempt) if inject is not None else None
            try:
                value = self._attempt(fn, mode, stream)
                return DispatchOutcome(True, value, attempt,
                                       tuple(faults), tuple(delays))
            except _Stalled:
                faults.append("stall")
            except Exception as e:          # noqa: BLE001 — the guard's job
                faults.append(f"error:{type(e).__name__}")
            if attempt < self.cfg.max_attempts:
                delays.append(self.backoff(key, attempt))
        return DispatchOutcome(False, None, self.cfg.max_attempts,
                               tuple(faults), tuple(delays))
