"""The failover layer and crash-consistent snapshots
(``repro_torch.serving.failover``, ``serving.snapshot``,
``checkpoint.store``, ``launch.mesh``) against the JAX package's
(``impl="ref"``) on the CPU, on ``tests/test_failover.py``'s fixture:
the rendered fleet at 48 x 64, 3 rigs, T = 4, 16 features on one level,
a degrade desync policy, the frames rounded to integers (the sessions
and helpers of ``test_torch_serving.py``).

* Every episode of ``tests/test_failover.py`` (kill and recover, a torn
  snapshot, host down, a dispatch error retried, a stuck dispatch
  dropped, the mixed replay) on both packages: equal event logs,
  counters, status reports, recovery records (less the wall clock) and
  report metadata; outputs by ``parity.py``'s rule (poses within 1e-4).
  The port's own properties as the JAX tests state them: healthy rigs
  bit-equal across a crash except the restored rig's first pose,
  pending frames served, recovered dispatches bit-equal to an unguarded
  run, every frame served after a host is lost.
* ``HostMap`` placements and moves, ``DispatchGuard.backoff`` (20 keys x
  4 attempts) and ``host_fault_domains`` (against an ``AbstractMesh``)
  equal to JAX's.
* Snapshots: the same episode step written by both packages has equal
  manifests and indexes and leaves equal in dtype and bytes (leaf file
  names come from a salted ``hash``, so they agree within one process
  only); a localized state's points within 2 ulp of the jitted JAX
  graph's, as in ``test_torch_serving.py``, and, given JAX's states, the
  port writes JAX's bytes.  A snapshot written by the JAX service
  restores into a port service, which then serves as after its own
  restore.
* The store cases of ``tests/test_checkpoint_store.py`` that need no
  ``restore`` or ``ml_dtypes``, on the port's store and across stores.
* The guard runs its compute in the caller's contextvars context, so a
  caller's ``launch_audit()`` is on the worker's audit stack (no launch
  is counted on the CPU; the card test counts them).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import checkpoint as jcheckpoint
from repro import serving as jserving
from repro.launch import mesh as jmesh
from repro.serving import snapshot as jsnapshot
from repro_torch import checkpoint, serving
from repro_torch.kernels import _build
from repro_torch.launch import host_fault_domains
from repro_torch.serving import snapshot

from parity import np_of, ulp_diff
from test_torch_serving import (DT, N_RIGS, QUEUE, SUP, T, _assert_like_jax,
                                _assert_same, _fleet, _meta, _sessions)

SETTLE = 6
CRASH_AT = 1
GUARD = dict(timeout_s=60.0, max_attempts=2, backoff_base_s=DT,
             backoff_max_s=4 * DT, seed=0)


def _service(pkg, mode, guard=False, hosts=None, **sup_kw):
    """A service of ``pkg`` over the shared session of ``mode``, with
    ``tests/test_failover.py``'s guard and a host map over ``hosts``."""
    vs = _sessions(mode)[0 if pkg is jserving else 1]
    return pkg.FleetService(
        vs, pkg.QueueConfig(**QUEUE), pkg.SupervisorConfig(**{**SUP, **sup_kw}),
        guard=(pkg.DispatchGuard(pkg.DispatchGuardConfig(**GUARD))
               if guard else None),
        host_map=None if hosts is None else pkg.HostMap(hosts))


# (mode, guard, hosts, specs, injector seed, crash_at)
EPISODES = {
    "base_f32": ("f32", False, None, None, 0, None),
    "base_localized": ("localized", False, None, None, 0, None),
    "kill_recover": ("localized", False, None, None, 0, CRASH_AT),
    "corrupt_snapshot": ("f32", False, None,
                         [dict(kind="corrupt_snapshot", start=CRASH_AT)], 11,
                         CRASH_AT),
    "host_down": ("localized", False, ("host0", "host1"),
                  [dict(kind="host_down", rig="host0", start=2)], 0, None),
    "dispatch_error": ("f32", True, None,
                       [dict(kind="dispatch_error", start=1, stop=3,
                             magnitude=1)], 0, None),
    "stuck_dispatch": ("f32", True, None,
                       [dict(kind="stuck_dispatch", start=1, stop=2,
                             magnitude=2)], 0, None),
    "replay_mix": ("f32", True, ("host0", "host1"),
                   [dict(kind="host_down", rig="host0", start=2),
                    dict(kind="dispatch_error", start=1, stop=2,
                         magnitude=1)], 9, 2),
}
_CACHE: dict = {}


def _run(pkg, case: str, snap_dir: str | None):
    mode, guard, hosts, specs, seed, crash_at = EPISODES[case]
    inj = (None if specs is None else
           pkg.FaultInjector([pkg.FaultSpec(**s) for s in specs], seed=seed))
    svc = _service(pkg, mode, guard, hosts)
    res = pkg.run_episode(
        svc, _fleet()[0], dt=DT, injector=inj, settle_steps=SETTLE,
        snapshot_dir=snap_dir, crash_at=crash_at,
        restore=(None if crash_at is None
                 else lambda: _service(pkg, mode, guard, hosts)))
    return res, svc


def _episodes(case: str, tmp_path_factory):
    """(JAX result, port result, port service) of ``case``, each package
    snapshotting every tick into its own directory, cached per case."""
    if case not in _CACHE:
        root = tmp_path_factory.mktemp(case)
        jres, _ = _run(jserving, case, str(root / "jax"))
        tres, svc = _run(serving, case, str(root / "port"))
        _CACHE[case] = (jres, tres, svc, root)
    return _CACHE[case]


def _by_key(result, rig_id):
    return {round(r.t_arrival, 9): r for r in result.reports
            if r.rig_id == rig_id and r.output is not None}


def _no_wall(recovery):
    return None if recovery is None else \
        {k: v for k, v in recovery.items() if k != "recovery_wall_s"}


@pytest.mark.parametrize("case", list(EPISODES))
def test_episode_equals_jax(case, tmp_path_factory):
    jres, tres, svc, _ = _episodes(case, tmp_path_factory)
    assert [tuple(e) for e in tres.events] == [tuple(e) for e in jres.events]
    assert tres.status == jres.status
    assert _no_wall(tres.recovery) == _no_wall(jres.recovery)
    assert [_meta(r) for r in tres.reports] == [_meta(r) for r in jres.reports]
    scale = svc.vs.pipe.orb.scale_factor
    for jr, tr in zip(jres.reports, tres.reports):
        if tr.output is not None:
            _assert_like_jax(jr.output, tr.output, scale)
    assert any(r.output is not None for r in tres.reports)


def test_kill_and_recover_bit_exact(tmp_path_factory):
    """Snapshot every tick, destroy the service after tick CRASH_AT,
    restore a fresh one, continue: every rig's stereo outputs and points
    are bit-equal to the uninterrupted run; its pose is identity with
    ``valid=False`` at the first frame the restored service serves and
    bit-equal again afterwards."""
    base = _episodes("base_localized", tmp_path_factory)[1]
    crashed = _episodes("kill_recover", tmp_path_factory)[1]
    assert crashed.recovery["restored_step"] == CRASH_AT
    assert not crashed.recovery["snapshot_fallback"]
    crash_time = CRASH_AT * DT + 0.5 * DT + 1e-9
    reestablished = False
    for rig in range(N_RIGS):
        want, got = _by_key(base, rig), _by_key(crashed, rig)
        assert set(want) == set(got), f"rig {rig} served different frames"
        post = sorted(k for k in got if got[k].t > crash_time)
        assert post, f"rig {rig} never served after the crash"
        for key in want:
            g, w = got[key].output, want[key].output
            _assert_same(g.stereo, w.stereo, f"rig {rig} stereo")
            assert torch.equal(g.points, w.points)
            if key == post[0]:
                assert not bool(g.pose.valid.any())
                assert torch.equal(g.pose.rotation, torch.eye(3))
                assert not bool(g.pose.translation.any())
            else:
                _assert_same(g.pose, w.pose, f"rig {rig} pose")
        reestablished |= any(bool(got[k].output.pose.valid.any())
                             for k in post[1:])
    assert reestablished, "no rig re-established its pose chain"


def test_kill_and_recover_preserves_pending_frames(tmp_path):
    """A frame accepted by ``submit`` but not yet served survives the
    crash, on the port and from a JAX snapshot: restored fresh, it is
    served bit-equal to the uninterrupted service's."""
    frames, _ = _fleet()
    svc, jsvc = _service(serving, "f32"), _service(jserving, "f32")
    for s in (svc, jsvc):
        s.submit(0, frames[0, 0], 0.0)
        s.submit(1, frames[0, 1], 0.001)
        assert s.queue.pending() == 2
    snapshot.save(svc, str(tmp_path / "port"), step=0)
    jsnapshot.save(jsvc, str(tmp_path / "jax"), step=0)
    want = svc.step(1.0, force=True)
    assert [r.rig_id for r in want] == [0, 1]
    for d in ("port", "jax"):
        fresh = _service(serving, "f32")
        assert snapshot.restore(fresh, str(tmp_path / d)) == 0
        assert fresh.queue.pending() == 2
        got = fresh.step(1.0, force=True)
        assert [_meta(r) for r in got] == [_meta(r) for r in want]
        for a, b in zip(got, want):
            _assert_same(a.output, b.output, d)


def test_quarantine_survives_restore(tmp_path):
    """Quarantine state, the restart ledger and the counters ride the
    snapshot, as in JAX; the restored service keeps enforcing the
    quarantine."""
    frames, _ = _fleet()
    states = []
    for pkg in (serving, jserving):
        svc = _service(pkg, "f32", restart_budget=1)
        svc.submit(1, frames[0, 1], 0.0)
        svc.step(0.0, force=True)
        now, t = 0.0, 1
        while svc.supervisor.health(1).value != "quarantined":
            assert t < 200, "rig 1 never quarantined"
            now = t * DT
            svc.step(now, force=True)
            t += 1
        states.append((svc, now))
    (svc, now), (jsvc, jnow) = states
    assert now == jnow and svc.supervisor.export_state() == \
        jsvc.supervisor.export_state()
    snapshot.save(svc, str(tmp_path), step=42)
    fresh = _service(serving, "f32", restart_budget=1)
    assert snapshot.restore(fresh, str(tmp_path)) == 42
    assert fresh.supervisor.health(1) is serving.RigHealth.QUARANTINED
    assert fresh.supervisor.export_state() == svc.supervisor.export_state()
    assert dict(fresh.counters) == dict(svc.counters)
    assert fresh.submit(1, frames[1, 1], now + DT) == "dropped_quarantined"


def test_corrupt_snapshot_falls_back_a_step(tmp_path_factory):
    result = _episodes("corrupt_snapshot", tmp_path_factory)[1]
    assert result.recovery["restored_step"] == CRASH_AT - 1
    assert result.recovery["snapshot_fallback"]
    assert result.recovery["recovery_wall_s"] >= 0.0
    assert any(r.t_arrival > CRASH_AT * DT for r in result.reports)


def test_snapshot_layout_mismatch_raises(tmp_path):
    frames, _ = _fleet()
    svc = _service(serving, "f32")
    svc.submit(0, frames[0, 0], 0.0)
    snapshot.save(svc, str(tmp_path), step=0)
    for pkg, snap in ((serving, snapshot), (jserving, jsnapshot)):
        with pytest.raises(ValueError, match="layout"):
            snap.restore(_service(pkg, "localized"), str(tmp_path))


def test_restore_with_no_snapshot_is_cold_start(tmp_path):
    assert snapshot.restore(_service(serving, "f32"), str(tmp_path)) is None


def test_crash_at_needs_restore_and_snapshot_dir():
    for kw in (dict(crash_at=1), dict(crash_at=1, snapshot_dir="x"),
               dict(crash_at=1, restore=lambda: None)):
        for pkg in (serving, jserving):
            with pytest.raises(ValueError, match="crash_at requires"):
                pkg.run_episode(_service(pkg, "f32"), _fleet()[0], **kw)


# -- HostMap, host_fault_domains ----------------------------------------------

def _host_script(pkg):
    """One scripted sequence: placements, a sticky re-assign, two hosts
    down, the last one refused, a state round trip."""
    hm = pkg.HostMap(["h0", "h1", "h2"])
    log = [[hm.assign(r) for r in range(6)], hm.assign(0), hm.load(),
           hm.rigs_on("h1"), hm.host_of(4)]
    log.append(hm.host_down("h1"))
    log += [list(hm.down), hm.load(), hm.status()]
    hm.assign("late")
    log.append(hm.host_down("h0"))
    for bad in ("h1", "h2"):
        with pytest.raises(ValueError) as err:
            hm.host_down(bad)
        log.append(str(err.value))
    fresh = pkg.HostMap(["h0", "h1", "h2"])
    fresh.restore_state(hm.export_state())
    log += [hm.export_state(), fresh.export_state(), fresh.status()]
    for bad in ([], ["h0", "h0"]):
        with pytest.raises(ValueError) as err:
            pkg.HostMap(bad)
        log.append(str(err.value))
    with pytest.raises(ValueError) as err:
        pkg.HostMap(["h0"], assignment={0: "nope"})
    log.append(str(err.value))
    return log


def test_host_map_equals_jax():
    log = _host_script(serving)
    assert log == _host_script(jserving)
    assert log[0] == ["h0", "h1", "h2", "h0", "h1", "h2"]
    assert log[5] == ((1, "h0"), (4, "h2"))
    assert "not an active domain" in log[10]
    assert "last surviving" in log[11]


@pytest.mark.parametrize("sizes", [{"data": 4, "model": 1},
                                   {"data": 1, "model": 2},
                                   {"pod": 2, "data": 3, "model": 1}])
def test_host_fault_domains_equal_jax(sizes):
    mesh = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    for axis in list(sizes) + ["nope"]:
        if axis == "nope":
            with pytest.raises(ValueError) as want:
                jmesh.host_fault_domains(mesh, axis)
            with pytest.raises(ValueError) as got:
                host_fault_domains(sizes, axis)
            assert str(got.value) == str(want.value)
            continue
        assert host_fault_domains(sizes, axis) == \
            jmesh.host_fault_domains(mesh, axis)
    hm = serving.HostMap(host_fault_domains(sizes, "model"))
    assert hm.hosts == [f"host{i}" for i in range(sizes["model"])]
    with pytest.raises(NotImplementedError, match="A12"):
        serving.HostMap.from_mesh(mesh)


def test_host_down_episode_serves_every_frame(tmp_path_factory):
    """host0 dies at frame 2: one event, the moved rigs' first frame
    after it does not chain, every rig still serves every frame."""
    result = _episodes("host_down", tmp_path_factory)[1]
    host_evs = [e for e in result.events
                if getattr(e, "kind", None) == "host_down"]
    assert len(host_evs) == 1 and host_evs[0].host == "host0"
    moved = [r for r, _ in host_evs[0].moved]
    assert moved
    assert result.status["hosts"]["down"] == ["host0"]
    assert result.status["hosts"]["hosts"] == ["host1"]
    assert result.status["counters"]["rigs_redistributed"] == len(moved)
    for rig in range(N_RIGS):
        assert len(_by_key(result, rig)) == T
    for rig in moved:
        got = _by_key(result, rig)
        post = sorted(k for k in got if got[k].t > host_evs[0].now)
        assert not bool(got[post[0]].output.pose.valid.any())


def test_host_down_without_host_map_raises():
    with pytest.raises(ValueError, match="HostMap"):
        _service(serving, "f32").host_down("host0", 0.0)


# -- the dispatch guard --------------------------------------------------------

def test_dispatch_error_retries_and_recovers(tmp_path_factory):
    base = _episodes("base_f32", tmp_path_factory)[1]
    result, svc = _episodes("dispatch_error", tmp_path_factory)[1:3]
    assert svc.counters["dispatch_errors"] == 2
    assert svc.counters["dispatch_retries"] == 2
    assert svc.counters["dropped_dispatch"] == 0
    recovered = [e for e in result.events
                 if getattr(e, "kind", None) == "dispatch_recovered"]
    assert len(recovered) == 2
    assert all(e.faults == ("error:InjectedDispatchError",)
               for e in recovered)
    for rig in range(N_RIGS):
        want, got = _by_key(base, rig), _by_key(result, rig)
        assert set(want) == set(got)
        for key in want:
            _assert_same(got[key].output, want[key].output, f"rig {rig}")


def test_stuck_dispatch_exhausts_budget_and_drops(tmp_path_factory):
    result, svc = _episodes("stuck_dispatch", tmp_path_factory)[1:3]
    assert svc.counters["dispatch_stalls"] == 2
    drops = [e for e in result.events
             if getattr(e, "kind", None) == "dispatch_drop"]
    assert len(drops) == 1 and drops[0].faults == ("stall", "stall")
    assert svc.counters["dropped_dispatch"] > 0
    assert result.status["counters"]["dropped_dispatch"] == \
        svc.counters["dropped_dispatch"]
    assert any(r.t_arrival > 1 * DT for r in result.reports)


def test_guard_times_out_a_genuinely_stuck_compute():
    release = threading.Event()
    g = serving.DispatchGuard(serving.DispatchGuardConfig(timeout_s=0.05,
                                                          max_attempts=2))
    t0 = time.perf_counter()
    out = g.run("stuck", lambda: release.wait(5.0))
    release.set()
    assert time.perf_counter() - t0 < 2.0
    assert not out.ok and out.faults == ("stall", "stall")
    assert out.backoff_s == (g.backoff("stuck", 1),)
    out = g.run("fine", lambda: 7)
    assert out.ok and out.value == 7 and out.faults == ()

    def boom():
        raise KeyError("x")

    out = g.run("boom", boom)
    assert not out.ok and out.faults == ("error:KeyError",) * 2


def test_guard_backoff_equals_jax():
    keys = [0, 1, 7, 2**40, -3, "batch-7", "", ("h", 1), (0, "x"), 3.5,
            None, "host0", 123456789, "dispatch", (1, 2, 3), "ä", 2**31,
            True, "x" * 50, (("a",), 2)]
    assert len(keys) == 20
    for seed in (0, 9, 2**33 + 5):
        cfg = dict(GUARD, seed=seed, backoff_max_s=0.2)
        g = serving.DispatchGuard(serving.DispatchGuardConfig(**cfg))
        jg = jserving.DispatchGuard(jserving.DispatchGuardConfig(**cfg))
        for key in keys:
            got = [g.backoff(key, a) for a in range(1, 5)]
            assert got == [jg.backoff(key, a) for a in range(1, 5)]
            assert all(0.0 < d <= 0.2 * 1.25 for d in got)
    assert g.backoff(0, 1) != g.backoff(1, 1)
    for bad in (dict(timeout_s=0), dict(max_attempts=0),
                dict(backoff_factor=0.5), dict(backoff_jitter=1.0)):
        for pkg in (serving, jserving):
            with pytest.raises(ValueError):
                pkg.DispatchGuardConfig(**bad)


def test_failover_episode_replays_bit_identically(tmp_path_factory,
                                                  tmp_path):
    first = _episodes("replay_mix", tmp_path_factory)[1]
    again, _ = _run(serving, "replay_mix", str(tmp_path))
    assert [_meta(r) for r in again.reports] == \
        [_meta(r) for r in first.reports]
    assert again.events == first.events
    assert again.recovery["restored_step"] == first.recovery["restored_step"]
    for a, b in zip(again.reports, first.reports):
        if b.output is not None:
            _assert_same(a.output, b.output, "replay")


def test_guarded_compute_sees_the_callers_launch_audit():
    """The worker thread runs in a copy of the caller's context, so the
    caller's ``launch_audit()`` is on its audit stack (a launch there
    counts into it); without the copy the stack would be empty."""
    guard = serving.DispatchGuard(serving.DispatchGuardConfig(timeout_s=30.0))
    with _build.launch_audit() as outer, _build.launch_audit() as inner:
        outcome = guard.run("audit-ctx", _build._AUDIT_STACK.get)
    assert outcome.ok and outcome.value == (outer, inner)
    bare = []
    t = threading.Thread(target=lambda: bare.append(_build._AUDIT_STACK.get()))
    t.start()
    t.join(10.0)
    assert bare == [()]


# -- snapshots against JAX's -----------------------------------------------------

def _steps(root):
    return checkpoint.list_steps(str(root))


def _read(root, step):
    d = os.path.join(str(root), f"step_{step:08d}")
    with open(os.path.join(d, "index.json")) as f:
        index = json.load(f)
    flat = checkpoint.load_flat(str(root), step)
    return index, json.loads(bytes(flat["meta"]).decode()), flat


def _read_or_torn(root, step):
    try:
        return _read(root, step)
    except ValueError:          # a truncated .npy or JSON file
        return None


@pytest.mark.parametrize("case", ["replay_mix", "corrupt_snapshot",
                                  "dispatch_error", "kill_recover"])
def test_snapshots_equal_jax(case, tmp_path_factory):
    """Every step both packages kept: equal indexes (file names too, in
    one process), manifests and leaves; a localized state's points
    within 2 ulp (their CRCs then differ), the other leaves in dtype
    and bytes.  A step torn by the injector is torn in both."""
    _, _, svc, root = _episodes(case, tmp_path_factory)
    steps = _steps(root / "port")
    assert steps and steps == _steps(root / "jax")
    assert steps == jcheckpoint.list_steps(str(root / "jax"))
    n_points = n_torn = 0
    for step in steps:
        got = _read_or_torn(root / "port", step)
        want = _read_or_torn(root / "jax", step)
        if want is None:
            assert got is None
            n_torn += 1
            continue
        (index, meta, flat), (jindex, jmeta, jflat) = got, want
        assert index == jindex
        points = {4 * r + 2 for r in range(len(meta["loc_rigs"]))}
        n_points += len(points)
        crcs, jcrcs = meta.pop("leaf_crcs"), jmeta.pop("leaf_crcs")
        assert meta == jmeta
        for i, (c, jc) in enumerate(zip(crcs, jcrcs, strict=True)):
            a, b = flat[f"leaves§{i}"], jflat[f"leaves§{i}"]
            assert a.dtype == b.dtype and a.shape == b.shape
            if i in points:
                assert ulp_diff(a, b).max(initial=0) <= 2
            else:
                assert a.tobytes() == b.tobytes() and c == jc
    assert (n_points > 0) == svc.vs.pipe.localize
    assert n_torn == (case == "corrupt_snapshot")


def test_snapshot_of_jax_state_is_jax_bytes(tmp_path_factory, tmp_path):
    """Given the JAX service's localization states (through
    ``convert.localization_state_from_reference``), the port's snapshot
    of the same instant is the JAX snapshot byte for byte: desc as
    uint32 words, the manifest's JSON, every leaf and CRC."""
    from repro_torch import convert
    frames, _ = _fleet()
    svc, jsvc = _service(serving, "localized"), _service(jserving,
                                                         "localized")
    for t in range(2):
        for s in (svc, jsvc):
            for r in range(N_RIGS):
                s.submit(r, frames[t, r], t * DT)
            s.step(t * DT + 0.5 * DT)
    for s in (svc, jsvc):
        s.submit(2, frames[2, 2], 2 * DT)
    svc._loc_state = {
        rid: convert.localization_state_from_reference(
            {k: np.asarray(v) for k, v in st._asdict().items()})
        for rid, st in jsvc._loc_state.items()}
    snapshot.save(svc, str(tmp_path / "port"), step=3)
    jsnapshot.save(jsvc, str(tmp_path / "jax"), step=3)
    index, meta, flat = _read(tmp_path / "port", 3)
    jindex, jmeta, jflat = _read(tmp_path / "jax", 3)
    assert index == jindex and meta == jmeta
    assert len(meta["loc_rigs"]) == N_RIGS and meta["pending"]
    assert meta["n_leaves"] == 4 * N_RIGS + 2 * len(meta["pending"])
    for key in jflat:
        assert flat[key].dtype == jflat[key].dtype
        assert flat[key].tobytes() == jflat[key].tobytes(), key
    assert flat["leaves§0"].dtype == np.uint32


def test_jax_snapshot_restores_into_the_port(tmp_path_factory, tmp_path):
    """The JAX service runs ticks 0..CRASH_AT and snapshots each; a
    fresh port service restored from its newest step serves the rest as
    the port's own kill-and-recover episode does: equal events, status
    and reports, outputs bit-equal."""
    crashed = _episodes("kill_recover", tmp_path_factory)[1]
    frames, _ = _fleet()

    def tick(svc, t):
        now = t * DT
        for r in range(N_RIGS):
            svc.submit(r, frames[t, r], now,
                       timestamps=np.full(4, now, dtype=np.float64))
        return svc.step(now + 0.5 * DT)

    jsvc = _service(jserving, "localized")
    pre = []
    for t in range(CRASH_AT + 1):
        pre += tick(jsvc, t)
        jsnapshot.save(jsvc, str(tmp_path), step=t)
    svc = _service(serving, "localized")
    assert snapshot.restore(svc, str(tmp_path)) == CRASH_AT
    for rid, st in svc._loc_state.items():
        assert st.desc.dtype == torch.int32 and not bool(st.valid.any())
        assert torch.equal(st.desc, torch.from_numpy(
            np.asarray(jsvc._loc_state[rid].desc).view(np.int32)))
    post = []
    for t in range(CRASH_AT + 1, T):
        post += tick(svc, t)
    for k in range(SETTLE):
        post += svc.step((T + k) * DT, force=True)
    got = crashed.reports[len(pre):]
    assert [_meta(r) for r in pre] == \
        [_meta(r) for r in crashed.reports[:len(pre)]]
    assert [_meta(r) for r in post] == [_meta(r) for r in got]
    for a, b in zip(post, got):
        _assert_same(a.output, b.output, "restored from JAX")
    assert svc.status((T + SETTLE) * DT) == crashed.status
    assert [tuple(e) for e in svc.events] == \
        [tuple(e) for e in crashed.events[len(crashed.events)
                                          - len(svc.events):]]


# -- the checkpoint store ------------------------------------------------------

def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(4, 3).astype(np.float32),
            "b": rng.randn(3).astype(np.float32),
            "stack": [rng.randint(0, 9, (2, 2)) for _ in range(2)],
            "none": None, "pair": (np.uint8(3), np.zeros(0, np.int16))}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_round_trip_across_stores(writer, tmp_path):
    """A step written by either store reads back in both with the same
    keys, indexes (file names too, in one process) and leaf bytes."""
    tree = _tree()
    (checkpoint if writer == "port" else jcheckpoint).save(
        str(tmp_path / writer), 7, tree)
    other = "jax" if writer == "port" else "port"
    (jcheckpoint if writer == "port" else checkpoint).save(
        str(tmp_path / other), 7, tree)
    flat = checkpoint.load_flat(str(tmp_path / writer), 7)
    jflat = jcheckpoint.load_flat(str(tmp_path / writer), 7)
    assert set(flat) == set(jflat) == {"w", "b", "stack§0", "stack§1",
                                       "pair§0", "pair§1"}
    for key in flat:
        assert flat[key].dtype == jflat[key].dtype
        assert flat[key].tobytes() == jflat[key].tobytes()
    np.testing.assert_array_equal(flat["stack§1"], tree["stack"][1])
    idx = [json.loads((tmp_path / d / "step_00000007" / "index.json")
                      .read_text()) for d in ("port", "jax")]
    assert idx[0] == idx[1]


def test_tmp_dir_from_crashed_save_is_invisible(tmp_path):
    checkpoint.save(str(tmp_path), 1, _tree(1))
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "index.json").write_text("{}")
    assert checkpoint.list_steps(str(tmp_path)) == [1]
    assert checkpoint.latest_step(str(tmp_path)) == 1
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None


def test_step_without_index_is_invisible_and_gc_keeps_newest(tmp_path):
    for step in range(1, 6):
        checkpoint.save(str(tmp_path), step, _tree(step), keep=3)
    assert checkpoint.list_steps(str(tmp_path)) == [3, 4, 5]
    os.remove(tmp_path / "step_00000005" / "index.json")
    assert checkpoint.list_steps(str(tmp_path)) == [3, 4]


def test_load_flat_torn_file_and_bfloat16_raise(tmp_path):
    tree = _tree(3)
    checkpoint.save(str(tmp_path), 5, tree)
    d = tmp_path / "step_00000005"
    index = json.loads((d / "index.json").read_text())
    path = d / index["leaves"]["w"]["file"]
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(ValueError):
        checkpoint.load_flat(str(tmp_path), 5)
    checkpoint.save(str(tmp_path), 6, tree)
    d = tmp_path / "step_00000006"
    index = json.loads((d / "index.json").read_text())
    index["leaves"]["b"]["dtype"] = "bfloat16"
    (d / "index.json").write_text(json.dumps(index))
    with pytest.raises(ValueError, match="ml_dtypes"):
        checkpoint.load_flat(str(tmp_path), 6)


def _snap(root, step, leaf, crc_of=None):
    meta = {"version": snapshot.SNAPSHOT_VERSION, "n_leaves": 1,
            "leaf_crcs": [snapshot._crc(leaf if crc_of is None else crc_of)]}
    arr = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    checkpoint.save(str(root), step, {"meta": arr, "leaves": [leaf]})


def test_snapshot_load_falls_back_past_torn_step(tmp_path):
    for step, fill in ((1, 11), (2, 22)):
        _snap(tmp_path, step, np.full((8, 8), fill, np.int32))
    for snap in (snapshot, jsnapshot):
        step, _, leaves = snap.load(str(tmp_path))
        assert step == 2 and leaves[0][0, 0] == 22
    assert snapshot.corrupt_newest(str(tmp_path), leaf_index=0,
                                   keep_fraction=0.3) is not None
    for snap in (snapshot, jsnapshot):
        step, _, leaves = snap.load(str(tmp_path))
        assert step == 1 and leaves[0][0, 0] == 11
    assert snapshot.corrupt_newest(str(tmp_path / "empty"), 0, 0.5) is None


def test_snapshot_load_detects_bit_flip_via_crc(tmp_path):
    leaf = np.arange(16, dtype=np.int32).reshape(4, 4)
    _snap(tmp_path, 1, leaf)
    _snap(tmp_path, 2, leaf + 1, crc_of=leaf)
    for snap in (snapshot, jsnapshot):
        step, _, leaves = snap.load(str(tmp_path))
        assert step == 1
        np.testing.assert_array_equal(leaves[0], leaf)


@pytest.mark.parametrize("ident", [0, 7, -2, "rig-a", "", "7"])
def test_snapshot_ids_equal_jax(ident):
    enc = snapshot._encode_id(ident)
    assert enc == jsnapshot._encode_id(ident)
    back = snapshot._decode_id(json.loads(json.dumps(enc)))
    assert back == ident and type(back) is type(ident)
    assert back == jsnapshot._decode_id(json.loads(json.dumps(enc)))


@pytest.mark.parametrize("ident", [True, 1.5, ("h", 1), None])
def test_snapshot_ids_refuse_what_json_launders(ident):
    for snap in (snapshot, jsnapshot):
        with pytest.raises(TypeError, match="int or str"):
            snap._encode_id(ident)


def test_snapshot_crc_equals_jax():
    for arr in (np.arange(6, dtype=np.int32).reshape(2, 3),
                np_of(torch.arange(6, dtype=torch.int32)).view(np.uint32),
                np.zeros((0, 4), bool), np.float32(2.5)):
        assert snapshot._crc(arr) == jsnapshot._crc(arr)
    a = np.arange(6, dtype=np.int32)
    assert snapshot._crc(a.reshape(2, 3)) != snapshot._crc(a.reshape(3, 2))
    assert snapshot._crc(a) != snapshot._crc(a.view(np.uint32))
