"""The serving tier (``repro_torch.serving``) against the JAX package's
(``impl="ref"``) on the CPU, on ``tests/test_serving_faults.py``'s
fixture: the rendered fleet at 48 x 64, 3 rigs, T = 4, 16 features on
one level, a degrade desync policy.

* ``FrameQueue`` and ``Supervisor`` driven by one scripted sequence:
  equal batches, events, backoffs, ``export_state`` records and status
  reports.  ``FaultInjector.apply`` for every frame kind and the
  host-level queries: equal results.  ``submit``'s intake decisions
  (corrupt, desync, dead, quarantined, overflow, the uint8 paths).
* ``run_episode`` with no fault and with each frame-fault kind (a stall
  with the restart hook, a stall flapping into quarantine), f32, uint8
  and localized: equal event logs, counters, status reports and report
  metadata.  The virtual clock and the seeded numpy generators are the
  same Python and numpy expressions in both packages, so these are
  equal, not close.

Outputs are held three ways:

* against the JAX service's report for the same rig frame, by
  ``parity.py``'s rule (``assert_stereo_parity``), as
  ``test_torch_fleet.py`` holds ``process_fleet``: on integer-valued
  frames (the fixture's frames rounded; they are not integer-valued,
  and under ``jax.jit`` XLA contracts the float blur into FMAs).  With
  one pyramid level there is no resize, so every row is strict.  Poses
  of a localized episode: ``valid`` and inliers equal, rotation and
  translation within 1e-4 (the card-against-CPU pose tolerance).  The
  fleet tests hold 1e-5 on 48 features; here a solve has 7 or 8
  inliers of 16 features on a 48 x 64 frame, and the two packages'
  3 x 3 SVDs (another LAPACK call, sums in another order) differ by up
  to 1.4e-5 on such a pose.  Points within 2 ulp of the jitted JAX
  graph's;
* bit-equal to the port's own ``process_frame`` of the batch row the
  report came from (the same session; poses within 1e-4: a batched SVD
  against one of a single row);
* healthy rigs' full-mask frames bit-equal across the fault and
  no-fault episodes (their stereo outputs and points: a pose depends on
  the batching, which a fault changes), and a whole episode bit-equal
  on replay.

The padding row of a bucketed batch (every camera masked) is held to
JAX's.  The failover layer and snapshots are ``test_torch_failover.py``'s.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import localization as jloc
from repro import serving as jserving
from repro.core import ORBConfig as JORBConfig
from repro.core import PipelineConfig as JPipelineConfig
from repro.core import RigConfig as JRigConfig
from repro.core import VisualSystem as JVisualSystem
from repro.core.types import CameraIntrinsics as JCameraIntrinsics
from repro.data import scenes as jscenes
from repro_torch import localization, serving
from repro_torch.core import ORBConfig, PipelineConfig, RigConfig, VisualSystem
from repro_torch.core.types import LocalizationOutput, map_fields
from repro_torch.data import scenes

from parity import assert_stereo_parity, np_of, ulp_diff

H, W = 48, 64
DT = 1.0 / 30.0
N_RIGS, T = 3, 4
K = 16
POSE_ATOL = 1e-4
NO_DIFF = [np.zeros((0, 2), int)] * 4
SUP = dict(heartbeat_timeout_s=2.5 * DT, backoff_base_s=DT,
           backoff_max_s=4 * DT, restart_budget=2, flap_window_s=1.0, seed=0)
QUEUE = dict(bucket_sizes=(1, 2, 4), deadline_s=DT)
MODES = {"f32": {}, "uint8": {"precision": "uint8"},
         "localized": {"localize": True}}


@functools.lru_cache(maxsize=1)
def _fleet():
    """The fixture's (T, 3, 4, 48, 64) frames rounded to integers, and
    the intrinsics."""
    seq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=H, width=W, n_points=40, seed=3, baseline=0.3), T, N_RIGS)
    frames = np.round(seq.frames)
    frames.setflags(write=False)
    return frames, seq.intrinsics


@functools.lru_cache(maxsize=3)
def _sessions(mode: str):
    """(JAX session, port session) of one mode, shared by the episodes
    (the service passes ``prev`` itself, so no session state carries)."""
    _, intr = _fleet()
    ocfg = dict(height=H, width=W, max_features=K, n_levels=1,
                max_disparity=24)
    rig = dict(desync_policy="degrade", max_desync=1e-3)
    jvs = JVisualSystem(
        JRigConfig.quad(JCameraIntrinsics(**dataclasses.asdict(intr)), **rig),
        JPipelineConfig(orb=JORBConfig(**ocfg), impl="ref", **MODES[mode]))
    tvs = VisualSystem(RigConfig.quad(intr, **rig),
                       PipelineConfig(orb=ORBConfig(**ocfg), **MODES[mode]),
                       device="cpu")
    return jvs, tvs


# (specs as FaultSpec kwargs, injector seed, restart hook, settle steps,
#  supervisor overrides, the rigs whose frames the specs touch)
CASES = {
    "none": ([], 0, False, 6, {}, ()),
    "dead_camera": ([dict(kind="dead_camera", rig=1, camera=3)],
                    0, False, 6, {}, (1,)),
    "corrupt_frame": ([dict(kind="corrupt_frame", rig=0, start=1, stop=3,
                            camera=0)], 0, False, 6, {}, (0,)),
    "desync": ([dict(kind="desync", rig=2, camera=1, magnitude=0.5)],
               0, False, 6, {}, (2,)),
    "stall_restart": ([dict(kind="stalled_rig", rig=1, start=1)],
                      0, True, 2, {}, (1,)),
    "flap_quarantine": ([dict(kind="stalled_rig", rig=1, start=1)],
                        0, False, 40, {"restart_budget": 2}, (1,)),
    "arrival_jitter": ([dict(kind="arrival_jitter", rig=r,
                             magnitude=0.3 * DT) for r in range(N_RIGS)],
                       5, False, 6, {}, (0, 1, 2)),
    "replay_mix": ([dict(kind="dead_camera", rig=1, camera=3),
                    dict(kind="stalled_rig", rig=2, start=2),
                    dict(kind="arrival_jitter", rig=0, magnitude=0.2 * DT)],
                   9, True, 6, {}, (0, 1, 2)),
}


def _run(pkg, vs, case: str, spy=None):
    """One episode of ``case`` on package ``pkg`` (``serving`` or the
    JAX one) over session ``vs``; ``spy(service)`` may wrap the
    service's methods before the run."""
    specs, seed, restart, settle, sup_kw, _ = CASES[case]
    inj = pkg.FaultInjector([pkg.FaultSpec(**s) for s in specs], seed=seed)
    svc = pkg.FleetService(vs, pkg.QueueConfig(**QUEUE),
                           pkg.SupervisorConfig(**{**SUP, **sup_kw}),
                           inj.clear_rig if restart else None)
    if spy is not None:
        spy(svc)
    res = pkg.run_episode(svc, _fleet()[0], dt=DT, injector=inj,
                          settle_steps=settle)
    return res, svc


def _spy_batches(svc):
    """Record each batch the service serves, with its assembled
    ``prev`` when it localizes: [(batch, prev or None)]."""
    seen = []
    next_batch, assemble = svc.queue.next_batch, svc._assemble_prev

    def record_batch(now, force=False):
        batch = next_batch(now, force=force)
        if batch is not None:
            seen.append([batch, None])
        return batch

    def record_prev(batch):
        prev = assemble(batch)
        seen[-1][1] = prev
        return prev

    svc.queue.next_batch = record_batch
    svc._assemble_prev = record_prev
    svc.seen = seen


@functools.lru_cache(maxsize=32)
def _episodes(mode: str, case: str):
    """(JAX result, port result, port service) of one case, cached so
    the fault cases compare with the same no-fault run."""
    jvs, tvs = _sessions(mode)
    jres, _ = _run(jserving, jvs, case)
    tres, svc = _run(serving, tvs, case, spy=_spy_batches)
    return jres, tres, svc


def _meta(report):
    return (report.rig_id, report.t, report.t_arrival, report.status,
            None if report.camera_mask is None
            else report.camera_mask.tolist(), report.output is None,
            report.late)


def _assert_same(got, want, what=""):
    """Every tensor of two (nested) output tuples bit-equal."""
    for name, x, y in zip(getattr(got, "_fields", range(len(got))), got,
                          want):
        if isinstance(x, tuple):
            _assert_same(x, y, f"{what}.{name}")
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}.{name}"


def _assert_pose_close(got, want):
    np.testing.assert_array_equal(np_of(got.valid), np_of(want.valid))
    np.testing.assert_array_equal(np_of(got.inliers), np_of(want.inliers))
    for name in ("rotation", "translation"):
        a, b = np_of(getattr(got, name)), np_of(getattr(want, name))
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=0, atol=POSE_ATOL,
                                   err_msg=name)


def _stereo(out):
    return out.stereo if isinstance(out, LocalizationOutput) else out


def _assert_like_jax(jout, tout, scale):
    """A port report's output against the JAX one by the parity rule."""
    jst = jout.stereo if hasattr(jout, "stereo") else jout
    assert_stereo_parity(jst, _stereo(tout), K, scale, (0, 2), (1, 3),
                         NO_DIFF, True, None, None)
    if isinstance(tout, LocalizationOutput):
        assert ulp_diff(np.asarray(jout.points),
                        np_of(tout.points)).max(initial=0) <= 2
        _assert_pose_close(tout.pose, jout.pose)


def _assert_like_frames(svc, reports):
    """Every report bit-equal to the port's ``process_frame`` of the
    batch row it came from (pose within 1e-4 of it)."""
    by_key = {(r.rig_id, r.t_arrival): r for r in reports}
    checked = 0
    for batch, prev in svc.seen:
        for b, rig_id in enumerate(batch.rig_ids):
            rep = by_key[(rig_id, batch.t_arrivals[b])]
            row_prev = (None if prev is None
                        else map_fields(lambda x: x[b], prev))
            want = svc.vs.process_frame(batch.images[b],
                                        camera_mask=batch.camera_mask[b],
                                        prev=row_prev)
            _assert_same(_stereo(rep.output), _stereo(want), "stereo")
            if isinstance(want, LocalizationOutput):
                assert torch.equal(rep.output.points, want.points)
                _assert_pose_close(rep.output.pose, want.pose)
            checked += 1
    assert checked == len(reports) > 0


def _outputs_by_key(result, rig_id):
    return {round(r.t_arrival, 9): r.output for r in result.reports
            if r.rig_id == rig_id and r.output is not None
            and r.camera_mask.all()}


@pytest.mark.parametrize("case", [c for c in CASES if c != "replay_mix"])
@pytest.mark.parametrize("mode", list(MODES))
def test_episode_equals_jax(mode, case):
    jres, tres, svc = _episodes(mode, case)
    # the event log, counters, status report and report metadata: equal
    assert [tuple(e) for e in tres.events] == [tuple(e) for e in jres.events]
    assert tres.status == jres.status
    assert [_meta(r) for r in tres.reports] == [_meta(r) for r in jres.reports]
    # outputs: JAX's by the parity rule, the port's own frames bit-equal
    scale = svc.vs.pipe.orb.scale_factor
    for jr, tr in zip(jres.reports, tres.reports):
        _assert_like_jax(jr.output, tr.output, scale)
    _assert_like_frames(svc, tres.reports)
    # healthy rigs bit-equal to the no-fault episode's
    healthy = [r for r in range(N_RIGS) if r not in CASES[case][-1]]
    if case != "none" and healthy:
        base = _episodes(mode, "none")[1]
        checked = 0
        for rig in healthy:
            want, got = _outputs_by_key(base, rig), _outputs_by_key(tres, rig)
            for key in set(want) & set(got):
                # a pose depends on which frame the rig chained from
                # (the batching), the frame's own outputs do not
                _assert_same(_stereo(got[key]), _stereo(want[key]),
                             f"rig {rig}")
                if mode == "localized":
                    assert torch.equal(got[key].points, want[key].points)
                checked += 1
        assert checked > 0
    kinds = {(e.rig_id, e.kind) for e in tres.events}
    if case == "stall_restart":
        assert {(1, "timeout"), (1, "restart")} <= kinds
    if case == "flap_quarantine":
        assert (1, "quarantine") in kinds
        assert svc.supervisor.health(1) is serving.RigHealth.QUARANTINED
    if case == "none":
        assert {r.status for r in tres.reports} == {"ok"}
        assert tres.status["counters"]["frames_out"] == N_RIGS * T


@pytest.mark.parametrize("mode", list(MODES))
def test_episode_replay_is_bit_identical(mode):
    jres, first, _ = _episodes(mode, "replay_mix")
    again, _ = _run(serving, _sessions(mode)[1], "replay_mix")
    assert [_meta(r) for r in again.reports] == \
        [_meta(r) for r in first.reports] == [_meta(r) for r in jres.reports]
    assert again.events == first.events
    assert [tuple(e) for e in first.events] == [tuple(e) for e in jres.events]
    for a, b in zip(again.reports, first.reports):
        _assert_same(a.output, b.output, "replay")


@pytest.mark.parametrize("mode", list(MODES))
def test_padding_row_equals_jax(mode):
    """3 rigs in a bucket of 4: the padding row (zero images, every
    camera masked) is finite, has nothing valid, and equals JAX's; a
    localized batch chains on the previous batch's state."""
    frames, _ = _fleet()
    jvs, tvs = _sessions(mode)
    dtype = np.uint8 if mode == "uint8" else np.float32
    q = serving.FrameQueue(tvs.rig, (H, W), serving.QueueConfig(**QUEUE),
                           dtype=dtype, device=tvs.device)
    kw, jkw = {}, {}
    for t in range(2):
        for r in range(N_RIGS):
            q.put(r, frames[t, r], float(t))
        batch = q.next_batch(t + 1.0)
        if mode == "localized":
            kw = {"prev": (localization.zero_state(2, K, 4) if t == 0
                           else localization.state_from(got))}
            jkw = {"prev": (jloc.zero_state(2, K, 4) if t == 0
                            else jloc.state_from(want))}
        got = tvs.process_fleet(batch.images, camera_mask=batch.camera_mask,
                                **kw)
        want = jvs.process_fleet(jnp.asarray(batch.images.numpy()),
                                 camera_mask=jnp.asarray(batch.camera_mask),
                                 **jkw)
    assert tuple(batch.images.shape) == (4, 4, H, W)
    assert batch.images.dtype == (torch.uint8 if mode == "uint8"
                                  else torch.float32)
    assert batch.rig_mask.tolist() == [True] * 3 + [False]
    for b in range(4):
        _assert_like_jax(jax.tree.map(lambda x: x[b], want),
                         map_fields(lambda x: x[b], got),
                         tvs.pipe.orb.scale_factor)
    pad = _stereo(map_fields(lambda x: x[3], got))
    for grp in (pad.features_l, pad.features_r, pad.matches, pad.depth):
        assert not bool(grp.valid.any())
    assert bool(torch.isfinite(pad.depth.depth).all())
    if mode == "localized":
        assert not bool(got.pose.valid[3])


# -- the parts: queue, supervisor, injector, intake ---------------------------

def _frame(seed):
    return np.random.RandomState(seed).randint(
        0, 256, (4, H, W)).astype(np.float32)


def _assert_same_batch(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got.images.numpy(), np.asarray(want.images))
    assert got.images.dtype == {np.dtype(np.float32): torch.float32,
                                np.dtype(np.uint8): torch.uint8}[
        np.asarray(want.images).dtype]
    for name in ("camera_mask", "rig_mask", "late"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.rig_ids, got.t_arrivals, got.t_oldest, got.n_real) == \
        (want.rig_ids, want.t_arrivals, want.t_oldest, want.n_real)


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_queue_script_equals_jax(dtype):
    """One scripted sequence of puts, drains and a snapshot round trip
    through both queues: equal batches, pending counts and drops."""
    rig = RigConfig.quad(_fleet()[1])
    jrig = JRigConfig.quad(JCameraIntrinsics(
        **dataclasses.asdict(_fleet()[1])))
    cfg = dict(bucket_sizes=(4, 1, 2), deadline_s=0.1, max_pending_per_rig=2)
    q = serving.FrameQueue(rig, (H, W), serving.QueueConfig(**cfg),
                           dtype=dtype, device="cpu")
    jq = jserving.FrameQueue(jrig, (H, W), jserving.QueueConfig(**cfg),
                             dtype=dtype)
    assert q.cfg.bucket_sizes == jq.cfg.bucket_sizes == (1, 2, 4)
    mask = np.array([True, False, True, True])
    script = [("put", "a", 0, 0.0, None), ("put", "b", 1, 0.01, mask),
              ("next", 0.05, False), ("put", ("c", 2), 2, 0.02, None),
              ("next", 0.2, False), ("put", "a", 3, 1.0, None),
              ("put", "a", 4, 1.01, None), ("put", "a", 5, 1.02, mask),
              ("put", 7, 6, 1.03, None), ("put", 8, 7, 1.04, None),
              ("put", 9, 8, 1.05, None), ("snapshot",),
              ("next", 1.06, False), ("next", 1.07, False),
              ("next", 1.3, True), ("next", 1.4, True)]
    for step in script:
        if step[0] == "put":
            _, rid, seed, t, m = step
            q.put(rid, _frame(seed), t, camera_mask=m)
            jq.put(rid, _frame(seed), t, camera_mask=m)
        elif step[0] == "snapshot":
            items, jitems = q.export_pending(), jq.export_pending()
            assert [(p.rig_id, p.t_arrival, p.camera_mask.tolist())
                    for p in items] == \
                [(p.rig_id, p.t_arrival, p.camera_mask.tolist())
                 for p in jitems]
            q.restore_pending(items, q.dropped_overflow)
        else:
            _, now, force = step
            assert q.ready(now) == jq.ready(now)
            assert q.oldest_wait(now) == jq.oldest_wait(now)
            _assert_same_batch(q.next_batch(now, force=force),
                               jq.next_batch(now, force=force))
        assert q.pending() == jq.pending()
        assert q.dropped_overflow == jq.dropped_overflow
    assert q.dropped_overflow == 1
    with pytest.raises(ValueError, match=r"\(4, 48, 64\)"):
        q.put("a", np.zeros((4, H, W + 1), np.float32), 0.0)
    with pytest.raises(ValueError, match="camera_mask"):
        q.put("a", _frame(0), 0.0, camera_mask=np.ones(3, bool))
    with pytest.raises(ValueError, match="duplicates"):
        serving.QueueConfig(bucket_sizes=(2, 2))


def test_supervisor_script_equals_jax():
    """One scripted sequence of heartbeats, polls, a reinstate and a
    state round trip through both supervisors: equal events, health,
    ``export_state`` records and status reports."""
    cfg = dict(heartbeat_timeout_s=1.0, backoff_base_s=1.0,
               backoff_factor=2.0, backoff_max_s=8.0, backoff_jitter=0.25,
               restart_budget=2, flap_window_s=100.0, seed=7)
    restarted, jrestarted = [], []
    s = serving.Supervisor(serving.SupervisorConfig(**cfg), restarted.append)
    js = jserving.Supervisor(jserving.SupervisorConfig(**cfg),
                             jrestarted.append)
    rigs = ("r", 3, ("host", 1))
    for rid in rigs:
        s.register(rid, 0.0)
        js.register(rid, 0.0)
    for step in range(60):
        now = step * 0.25
        if step % 2 == 0:
            s.heartbeat("r", now, degraded=step % 6 == 0)
            js.heartbeat("r", now, degraded=step % 6 == 0)
        if step == 30:
            s.heartbeat(3, now)
            js.heartbeat(3, now)
        if step == 50:
            s.reinstate(("host", 1), now)
            js.reinstate(("host", 1), now)
        assert [tuple(e) for e in s.poll(now)] == \
            [tuple(e) for e in js.poll(now)]
        for rid in rigs:
            assert s.health(rid).value == js.health(rid).value
            assert s.is_serving(rid) == js.is_serving(rid)
        assert s.status_report(now) == js.status_report(now)
    assert restarted == jrestarted and restarted
    assert s.export_state() == js.export_state()
    fresh = serving.Supervisor(serving.SupervisorConfig(**cfg))
    fresh.restore_state(s.export_state())
    assert fresh.export_state() == s.export_state()
    assert fresh.status_report(20.0) == js.status_report(20.0)


@pytest.mark.parametrize("rig_id", ["rig-a", 0, ("host", 2)])
def test_backoff_equals_jax(rig_id):
    for seed in (0, 7, 2**33 + 5):
        cfg = dict(backoff_base_s=0.1, backoff_factor=2.0,
                   backoff_max_s=5.0, backoff_jitter=0.25, seed=seed)
        s = serving.Supervisor(serving.SupervisorConfig(**cfg))
        js = jserving.Supervisor(jserving.SupervisorConfig(**cfg))
        assert [s._backoff(rig_id, a) for a in range(1, 9)] == \
            [js._backoff(rig_id, a) for a in range(1, 9)]


FRAME_SPECS = {
    "dead_camera": dict(kind="dead_camera", rig=1, start=1, stop=3,
                        camera=2),
    "corrupt_frame": dict(kind="corrupt_frame", rig=1, camera=3),
    "stalled_rig": dict(kind="stalled_rig", rig=1, start=2),
    "desync": dict(kind="desync", rig=1, camera=0, magnitude=0.004),
    "arrival_jitter": dict(kind="arrival_jitter", rig=1, magnitude=0.01),
}


@pytest.mark.parametrize("kind", list(FRAME_SPECS))
def test_injector_apply_equals_jax(kind):
    specs = [FRAME_SPECS[kind], dict(kind="arrival_jitter", rig=0,
                                     magnitude=0.02)]
    inj = serving.FaultInjector([serving.FaultSpec(**s) for s in specs],
                                seed=11)
    jinj = jserving.FaultInjector([jserving.FaultSpec(**s) for s in specs],
                                  seed=11)
    frames, _ = _fleet()
    for t in range(T):
        for rig in range(N_RIGS):
            ts = np.full(4, t * DT)
            got = inj.apply(rig, t, frames[t, rig], ts, t * DT)
            want = jinj.apply(rig, t, frames[t, rig], ts, t * DT)
            assert got.images.tobytes() == want.images.tobytes()
            assert got.images.dtype == want.images.dtype
            assert got.timestamps.tobytes() == want.timestamps.tobytes()
            assert (got.t_arrival, got.delivered, got.faults) == \
                (want.t_arrival, want.delivered, want.faults)
            np.testing.assert_array_equal(got.camera_mask, want.camera_mask)
            assert inj.active_faults(rig, t) == jinj.active_faults(rig, t)
    assert inj.clear_rig(1) == jinj.clear_rig(1) == 1
    assert inj.apply(1, 2, frames[2, 1], np.zeros(4), 0.0).faults == ()


def test_injector_host_level_queries_equal_jax():
    specs = [dict(kind="host_down", rig="h0", start=2),
             dict(kind="stuck_dispatch", start=1, stop=3, magnitude=2),
             dict(kind="dispatch_error", start=4),
             dict(kind="corrupt_snapshot", start=3, stop=5)]
    inj = serving.FaultInjector([serving.FaultSpec(**s) for s in specs],
                                seed=3)
    jinj = jserving.FaultInjector([jserving.FaultSpec(**s) for s in specs],
                                  seed=3)
    for t in range(7):
        assert inj.hosts_down_at(t) == jinj.hosts_down_at(t)
        assert inj.snapshot_corruption(t) == jinj.snapshot_corruption(t)
        for attempt in (1, 2, 3):
            assert inj.dispatch_fault(t, attempt) == \
                jinj.dispatch_fault(t, attempt)
    for bad, match in ((dict(kind="nope"), "kind must be one of"),
                       (dict(kind="desync"), "needs a target"),
                       (dict(kind="desync", rig=0, start=3, stop=3),
                        "empty fault window")):
        with pytest.raises(ValueError, match=match):
            serving.FaultSpec(**bad)
        with pytest.raises(ValueError, match=match):
            jserving.FaultSpec(**bad)


def _intake_services(mode, **rig_kw):
    _, intr = _fleet()
    ocfg = dict(height=H, width=W, max_features=8, n_levels=1,
                max_disparity=16)
    qc = dict(bucket_sizes=(1, 2, 4), deadline_s=0.01)
    pipe = MODES[mode]
    jvs = JVisualSystem(
        JRigConfig.quad(JCameraIntrinsics(**dataclasses.asdict(intr)),
                        **rig_kw),
        JPipelineConfig(orb=JORBConfig(**ocfg), impl="ref", **pipe))
    tvs = VisualSystem(RigConfig.quad(intr, **rig_kw),
                       PipelineConfig(orb=ORBConfig(**ocfg), **pipe),
                       device="cpu")
    return (serving.FleetService(tvs, serving.QueueConfig(**qc)),
            jserving.FleetService(jvs, jserving.QueueConfig(**qc)))


@pytest.mark.parametrize("mode", ["f32", "uint8"])
@pytest.mark.parametrize("rig_kw", [
    dict(sync_policy="hardware"),
    dict(desync_policy="degrade", max_desync=1e-3)])
def test_submit_intake_equals_jax(mode, rig_kw):
    """Corrupt slabs, desync (raise policy -> a counted drop; degrade ->
    a mask), all-dead frames, a quarantined rig, overflow, and uint8
    slabs: the same intake status, counters, health and queued frames."""
    svc, jsvc = _intake_services(mode, **rig_kw)
    nan1 = _frame(1)
    nan1[2] = np.nan
    script = [("a", _frame(0), 0.0, None, None),
              ("a", nan1, 0.1, None, None),
              ("b", _frame(2), 0.2, [0.2, 0.2, 0.2, 5.0], None),
              ("c", np.full((4, H, W), np.nan, np.float32), 0.3, None, None),
              ("d", _frame(3), 0.4, None, [True, False, True, True]),
              ("a", _frame(4), 0.5, None, None),
              ("e", _frame(5).astype(np.uint8), 0.6, None, None),
              ("e", np.clip(_frame(6) + 0.4, 0, 255), 0.7, None, None)]
    svc.supervisor.register("q", 0.0)
    jsvc.supervisor.register("q", 0.0)
    svc.supervisor._rigs["q"].health = serving.RigHealth.QUARANTINED
    jsvc.supervisor._rigs["q"].health = jserving.RigHealth.QUARANTINED
    script.append(("q", _frame(7), 0.8, None, None))
    for rid, im, t, ts, mask in script:
        if mode == "f32" and im.dtype == np.uint8:
            im = im.astype(np.float32)
        assert svc.submit(rid, im, t, timestamps=ts, camera_mask=mask) == \
            jsvc.submit(rid, im, t, timestamps=ts, camera_mask=mask)
        if mode == "uint8" and im.dtype == np.uint8 and \
                svc.queue.pending():
            assert np.shares_memory(svc.queue.export_pending()[-1].images, im)
    assert svc.status(1.0) == jsvc.status(1.0)
    for p, jp in zip(svc.queue.export_pending(), jsvc.queue.export_pending()):
        assert (p.rig_id, p.t_arrival) == (jp.rig_id, jp.t_arrival)
        assert p.images.dtype == jp.images.dtype
        np.testing.assert_array_equal(p.images, jp.images)
        np.testing.assert_array_equal(p.camera_mask, jp.camera_mask)
    _assert_same_batch(svc.queue.next_batch(1.0, force=True),
                       jsvc.queue.next_batch(1.0, force=True))


def test_localized_quarantine_drops_pose_state():
    """``tests/test_serving_faults.py``'s drive: rig 1 goes silent while
    0 and 2 keep streaming, until the watchdog quarantines it.  Its pose
    state is dropped, the others keep theirs, every pose is finite, and
    the events and reports equal the JAX service's."""
    frames, _ = _fleet()
    results = []
    for pkg, vs in ((serving, _sessions("localized")[1]),
                    (jserving, _sessions("localized")[0])):
        svc = pkg.FleetService(vs, pkg.QueueConfig(**QUEUE),
                               pkg.SupervisorConfig(**SUP))
        now = 0.0
        for rig in range(N_RIGS):
            svc.submit(rig, frames[0, rig], now)
        reports = svc.step(now, force=True)
        assert set(svc._loc_state) == {0, 1, 2}
        t = 1
        while (1, "quarantine") not in [(e.rig_id, e.kind)
                                        for e in svc.events]:
            assert t < 200, "rig 1 never quarantined"
            now = t * DT
            for rig in (0, 2):
                svc.submit(rig, frames[t % T, rig], now)
            reports += svc.step(now, force=True)
            t += 1
        assert svc.supervisor.health(1).value == "quarantined"
        assert 1 not in svc._loc_state
        assert {0, 2} <= set(svc._loc_state)
        results.append((svc, reports))
    (svc, reports), (jsvc, jreports) = results
    assert [tuple(e) for e in svc.events] == [tuple(e) for e in jsvc.events]
    assert [_meta(r) for r in reports] == [_meta(r) for r in jreports]
    assert svc.status(1.0) == jsvc.status(1.0)
    for r, jr in zip(reports, jreports):
        _assert_like_jax(jr.output, r.output, svc.vs.pipe.orb.scale_factor)
    assert any(bool(r.output.pose.valid) for r in reports)


# -- without a host map ----------------------------------------------------------

def test_host_down_without_a_host_map_raises_as_jax():
    """Without a host map ``host_down`` raises JAX's ``ValueError``, so
    a host-down spec in an episode fails as it does in JAX (with one,
    ``test_torch_failover.py``)."""
    jvs, tvs = _sessions("f32")
    svc = serving.FleetService(tvs)
    jsvc = jserving.FleetService(jvs)
    for s in (svc, jsvc):
        with pytest.raises(ValueError, match="needs a HostMap"):
            s.host_down("h0", 0.0)
    specs = [dict(kind="host_down", rig="h0", start=1)]
    for pkg, s in ((serving, svc), (jserving, jsvc)):
        inj = pkg.FaultInjector([pkg.FaultSpec(**x) for x in specs])
        with pytest.raises(ValueError, match="needs a HostMap"):
            pkg.run_episode(s, _fleet()[0], dt=DT, injector=inj)
    assert svc.status(1.0) == jsvc.status(1.0)


def test_fixture_frames_equal_jax():
    seq = jscenes.render_fleet_sequence(jscenes.SceneConfig(
        height=H, width=W, n_points=40, seed=3, baseline=0.3),
        n_frames=T, n_rigs=N_RIGS)
    np.testing.assert_array_equal(np.round(np.asarray(seq[0])), _fleet()[0])
