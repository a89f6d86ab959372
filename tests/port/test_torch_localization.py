"""The localized path: ``repro_torch.localization`` and the localized
session (``process_frame`` with ``localize=True``, ``run``) plus the
matcher entry points, against the JAX package (``impl="ref"``) on the
CPU, at the JAX tests' geometry: 96x128, T = 4, K = 96, baseline 0.5 m,
0.25 m lateral steps.

Tolerances, and why:

* render_sequence frames and poses, backprojection, the quad rig's
  points (its rotations hold only 0 and +-1), the temporal match
  (dist, idx, weights), keep counts, metrics on the same poses, the
  matcher entry points, and every frontend field of a localized frame
  but theta: bit-equal — the same arithmetic in the same order.
* theta on these float frames: within 2.5e-4 rad (the moment sums run
  in another order, ``parity.py``; the difference is printed, and the
  steering bins, hence the descriptors, all agree).
* points of a whole run: within 1 ulp (XLA's fused graph rounds the
  back-projection differently from its own eager ops; the count is
  printed).
* poses: ``valid`` and ``inliers`` equal; rotation and translation
  within 1e-5 of JAX's (the 3 x 3 SVD runs in another LAPACK call and
  the sums in another order; the differences are printed).
* ATE / RPE: under the JAX tests' limits (0.4 m, 0.25 m, 1.0 deg).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import localization as jloc
from repro.core import ORBConfig as JORBConfig
from repro.core import PipelineConfig as JPipelineConfig
from repro.core import RigConfig as JRigConfig
from repro.core import VisualSystem as JVisualSystem
from repro.core import backend as jbackend
from repro.core import types as jtypes
from repro.data import scenes as jscenes
from repro.kernels import ops as jops
from repro.localization import geometry as jgeometry
from repro.localization import metrics as jmetrics
from repro.localization import pose as jpose
from repro_torch import convert, localization
from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                              VisualSystem, backend)
from repro_torch.core.types import (CameraIntrinsics, FeatureSet,
                                    LocalizationOutput, map_fields)
from repro_torch.data import scenes
from repro_torch.kernels import ops
from repro_torch.localization import geometry, metrics, pose

from parity import desc_u32, np_of, ulp_diff

H, W, T, K = 96, 128, 4, 96
OCFG = dict(height=H, width=W, max_features=K, fast_threshold=15)
POSE_ATOL = 1e-5


@functools.lru_cache(maxsize=1)
def _scene():
    cfg = scenes.SceneConfig(height=H, width=W, baseline=0.5, seed=1)
    return scenes.render_sequence(cfg, T, step_t=(0.25, 0.0, 0.1),
                                  yaw_per_frame=0.0)


def _jintr(intr):
    return jtypes.CameraIntrinsics(**dataclasses.asdict(intr))


def _port_session(intr=None, localize=True):
    intr = _scene().intrinsics if intr is None else intr
    return VisualSystem(RigConfig.quad(intr),
                        PipelineConfig(orb=ORBConfig(**OCFG),
                                       localize=localize), device="cpu")


def _jax_session(intr=None, localize=True):
    intr = _scene().intrinsics if intr is None else intr
    return JVisualSystem(JRigConfig.quad(_jintr(intr)),
                         JPipelineConfig(orb=JORBConfig(**OCFG), impl="ref",
                                         localize=localize))


@functools.lru_cache(maxsize=1)
def _jax_run():
    return _jax_session().run(jnp.asarray(_scene().frames))


@functools.lru_cache(maxsize=1)
def _port_run():
    return _port_session().run(_scene().frames)


def _assert_pose_close(got, want, exact_valid=True):
    np.testing.assert_array_equal(np_of(got.valid), np.asarray(want.valid))
    if exact_valid:
        np.testing.assert_array_equal(np_of(got.inliers),
                                      np.asarray(want.inliers))
    np.testing.assert_allclose(np_of(got.rotation), np.asarray(want.rotation),
                               rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(np_of(got.translation),
                               np.asarray(want.translation), rtol=0,
                               atol=POSE_ATOL)


# -- data and geometry --------------------------------------------------------

@pytest.mark.parametrize("twist", [
    dict(step_t=(0.25, 0.0, 0.1), yaw_per_frame=0.0), dict()],
    ids=["test_geometry", "default_twist"])
def test_render_sequence_matches_jax(twist):
    cfg = dict(height=H, width=W, baseline=0.5, seed=1)
    want = jscenes.render_sequence(jscenes.SceneConfig(**cfg), 3, **twist)
    got = scenes.render_sequence(scenes.SceneConfig(**cfg), 3, **twist)
    np.testing.assert_array_equal(got.frames, np.asarray(want.frames))
    for (rg, tg), (rw, tw) in zip(got.poses, want.poses):
        np.testing.assert_array_equal(rg, np.asarray(rw))
        np.testing.assert_array_equal(tg, np.asarray(tw))
    assert got.intrinsics == scenes.default_intrinsics(
        scenes.SceneConfig(**cfg))


def test_backproject_and_rig_points_match_jax():
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, W, (3, 2, K, 2)).astype(np.float32)
    z = rng.uniform(0, 10, (3, 2, K)).astype(np.float32)
    z[z < 2] = 0.0                                 # invalid lanes
    intr = CameraIntrinsics(fx=92.16, fy=92.16, cx=64.0, cy=48.0)
    want = jgeometry.rig_points(jnp.asarray(xy), jnp.asarray(z),
                                JRigConfig.quad(_jintr(intr)))
    got = geometry.rig_points(torch.from_numpy(xy), torch.from_numpy(z),
                              RigConfig.quad(intr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[z == 0] == 0).all()
    # the back pair looks along -z; a wrong pair axis is refused
    pts = geometry.rig_points(torch.tensor([[[100.0, 50.0]]] * 2),
                              torch.tensor([[2.0], [2.0]]),
                              RigConfig.quad(CameraIntrinsics(
                                  fx=100.0, fy=100.0, cx=0.0, cy=0.0)))
    np.testing.assert_allclose(pts[0, 0].numpy(), [2.0, 1.0, 2.0])
    np.testing.assert_allclose(pts[1, 0].numpy(), [-2.0, 1.0, -2.0])
    with pytest.raises(ValueError, match="pair axis"):
        geometry.rig_points(torch.zeros(3, 4, 2), torch.zeros(3, 4),
                            RigConfig.quad())


# -- the robust solve ----------------------------------------------------------

def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _motion_case(seed, n=64, n_out=16):
    """A known motion with 1 mm noise and ``n_out`` metre-scale
    outliers.  Without the noise the inliers' residuals are all a few
    ulp, and which of them pass the keep threshold is decided by those
    ulp: the inlier count can then differ between the packages, though
    the pose does not."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    r, t = _rot_y(0.05), np.asarray([0.3, -0.1, 0.2], np.float32)
    curr = pts @ r.T + t + rng.normal(0.0, 1e-3, (n, 3))
    out = rng.choice(n, n_out, replace=False)
    curr[out] += rng.uniform(2.0, 5.0, (n_out, 3)).astype(np.float32)
    w = (rng.rand(n) < 0.9).astype(np.float32)
    return pts, curr.astype(np.float32), w, r, t


def test_kabsch_matches_jax_batched():
    cases = [_motion_case(s, n_out=0) for s in range(3)]
    pa = np.stack([c[0] for c in cases])
    pb = np.stack([c[1] for c in cases])
    w = np.stack([c[2] for c in cases])
    r, t = backend.kabsch(torch.from_numpy(pa), torch.from_numpy(pb),
                          torch.from_numpy(w))
    for b in range(3):
        rj, tj = jbackend.kabsch(jnp.asarray(pa[b]), jnp.asarray(pb[b]),
                                 jnp.asarray(w[b]))
        np.testing.assert_allclose(r[b].numpy(), np.asarray(rj), rtol=0,
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(t[b].numpy(), np.asarray(tj), rtol=0,
                                   atol=POSE_ATOL)
        np.testing.assert_allclose(r[b].numpy(), cases[b][3], atol=1e-3)


@pytest.mark.parametrize("keep_frac,f64_differs",
                         [(0.7, 0), (0.6, 1359), (0.3, 677)])
def test_keep_count_is_float32_like_jax(keep_frac, f64_differs):
    """A float64 product lands on another integer for some n at 0.6
    and 0.3; at the default 0.7 it happens to agree."""
    n = np.arange(0, 20001, dtype=np.int32)
    want = jnp.maximum(jnp.int32(3),
                       jnp.ceil(keep_frac * jnp.asarray(n)).astype(jnp.int32))
    got = pose.keep_count(torch.from_numpy(n), keep_frac, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    f64 = np.maximum(3, np.ceil(keep_frac * n.astype(np.float64)))
    assert int((f64 != np.asarray(want)).sum()) == f64_differs


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_pose_recovers_known_motion_like_jax(seed):
    pts, curr, w, r, t = _motion_case(seed)
    want = jpose.solve_pose(jnp.asarray(pts), jnp.asarray(curr),
                            jnp.asarray(w))
    got = pose.solve_pose(torch.from_numpy(pts), torch.from_numpy(curr),
                          torch.from_numpy(w))
    _assert_pose_close(got, want)
    assert bool(got.valid) and int(got.inliers) >= pose.MIN_CORRESPONDENCES
    np.testing.assert_allclose(got.rotation.numpy(), r, atol=1e-3)
    np.testing.assert_allclose(got.translation.numpy(), t, atol=1e-2)


def test_solve_pose_degenerate_inputs_never_nan():
    rng = np.random.RandomState(1)
    pts = rng.uniform(-4.0, 4.0, (16, 3)).astype(np.float32)
    bad = pts.copy()
    bad[:8] = np.nan
    nan = np.full((16, 3), np.nan, np.float32)
    cases = {
        "all_invalid": (pts, pts, np.zeros(16, np.float32)),
        "two_points": (pts, pts, np.asarray([1.0, 1.0] + [0.0] * 14,
                                            np.float32)),
        "collapsed": (np.zeros((16, 3), np.float32),
                      np.zeros((16, 3), np.float32), np.ones(16, np.float32)),
        "some_nan": (bad, bad, np.ones(16, np.float32)),
        "all_nan": (nan, nan, np.ones(16, np.float32)),
    }
    eye = np.eye(3, dtype=np.float32)
    for name, (a, b, w) in cases.items():
        got = pose.solve_pose(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(w))
        want = jpose.solve_pose(jnp.asarray(a), jnp.asarray(b),
                                jnp.asarray(w))
        assert bool(got.valid) == bool(want.valid), name
        assert np.isfinite(got.rotation.numpy()).all(), name
        assert np.isfinite(got.translation.numpy()).all(), name
        if not bool(want.valid):
            np.testing.assert_array_equal(got.rotation.numpy(), eye, name)
            np.testing.assert_array_equal(got.translation.numpy(), 0.0, name)


def test_solve_pose_batched_matches_loop():
    rng = np.random.RandomState(2)
    pts = rng.uniform(-4.0, 4.0, (3, 24, 3)).astype(np.float32)
    curr = pts + np.asarray([0.1, 0.0, -0.2], np.float32)
    w = np.ones((3, 24), np.float32)
    w[2, 2:] = 0.0                                  # one degenerate row
    batched = pose.solve_pose_batched(torch.from_numpy(pts),
                                      torch.from_numpy(curr),
                                      torch.from_numpy(w))
    assert batched.valid.tolist() == [True, True, False]
    for b in range(3):
        single = pose.solve_pose(torch.from_numpy(pts[b]),
                                 torch.from_numpy(curr[b]),
                                 torch.from_numpy(w[b]))
        for x, y in zip(single, map_fields(lambda x: x[b], batched)):
            assert torch.equal(x, y)


# -- state and metrics ---------------------------------------------------------

def test_zero_state_and_state_from_match_jax():
    jz, tz = jloc.zero_state(2, K), localization.zero_state(2, K)
    for name in jz._fields:
        a, b = np.asarray(getattr(jz, name)), np_of(getattr(tz, name))
        assert a.shape == b.shape and not b.any(), name
    assert tz.desc.dtype == torch.int32 and tz.valid.dtype == torch.bool
    jr, tr = _jax_run(), _port_run()
    frame = 2
    js = jloc.state_from(jloc.LocalizationOutput(
        *[map_fields(lambda x: x[frame], f) if isinstance(f, tuple)
          else f[frame] for f in jr]))
    ts = localization.state_from(map_fields(lambda x: x[frame], tr))
    np.testing.assert_array_equal(desc_u32(ts.desc), np.asarray(js.desc))
    np.testing.assert_array_equal(ts.meta.numpy(), np.asarray(js.meta))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))
    assert ulp_diff(ts.points.numpy(), np.asarray(js.points)).max() <= 1
    # the converter carries a JAX state across unchanged
    conv = convert.localization_state_from_reference(
        {k: np.asarray(v) for k, v in js._asdict().items()})
    np.testing.assert_array_equal(desc_u32(conv.desc), np.asarray(js.desc))
    for name in ("meta", "points", "valid"):
        np.testing.assert_array_equal(np_of(getattr(conv, name)),
                                      np.asarray(getattr(js, name)))


def test_trajectory_metrics_match_jax():
    rng = np.random.RandomState(3)
    poses = _scene().poses
    rot = np.stack([_rot_y(a) for a in rng.uniform(-0.02, 0.02, T)])
    tr = rng.uniform(-0.3, 0.3, (T, 3)).astype(np.float32)
    want = jmetrics.trajectory_metrics(jnp.asarray(rot), jnp.asarray(tr),
                                       poses)
    got = metrics.trajectory_metrics(torch.from_numpy(rot),
                                     torch.from_numpy(tr), poses)
    assert got == want
    with pytest.raises(ValueError):
        metrics.trajectory_metrics(rot[:2], tr[:2], poses)
    for (r0, t0), (r1, t1) in zip(poses[:-1], poses[1:]):
        for a, b in zip(geometry.gt_relative_pose(r0, t0, r1, t1),
                        jgeometry.gt_relative_pose(r0, t0, r1, t1)):
            np.testing.assert_array_equal(a, np.asarray(b))


# -- the localized session -----------------------------------------------------

def test_localized_run_matches_jax():
    jr, tr = _jax_run(), _port_run()
    assert isinstance(tr, LocalizationOutput)
    assert tuple(tr.points.shape) == (T, 2, K, 3)
    assert tuple(tr.pose.rotation.shape) == (T, 3, 3)
    for grp in ("features_l", "features_r", "matches", "depth"):
        for name in getattr(jr, grp)._fields:
            a = np.asarray(getattr(getattr(jr, grp), name))
            b = np_of(getattr(getattr(tr, grp), name))
            if name == "theta":
                # float frames: the moment sums run in another order
                # (parity.py); no bin flips, so descriptors are equal
                assert np.abs(a - b).max() <= 2.5e-4
            elif name == "desc":
                np.testing.assert_array_equal(desc_u32(b), a)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{grp}.{name}")
    assert ulp_diff(tr.points.numpy(), np.asarray(jr.points)).max() <= 1

    # the temporal match of the T - 1 transitions, as the run folds it
    def flat(state, sl):
        return map_fields(lambda x: x[sl].reshape((-1,) + x.shape[2:]),
                          state)
    jstate = jtypes.LocalizationState(
        desc=jr.features_l.desc, meta=jnp.stack(
            [jr.features_l.xy[..., 0], jr.features_l.xy[..., 1],
             jr.features_l.level.astype(jnp.float32),
             jr.features_l.valid.astype(jnp.float32)], -1),
        points=jr.points, valid=jr.features_l.valid & jr.depth.valid)
    tstate = localization.state_from(tr)
    jw = jpose.temporal_correspondences(
        flat(jstate, slice(None, -1)), flat(jstate, slice(1, None)),
        JORBConfig(**OCFG), 48.0, 48.0, impl="ref")
    tw = pose.temporal_correspondences(
        flat(tstate, slice(None, -1)), flat(tstate, slice(1, None)),
        ORBConfig(**OCFG), 48.0, 48.0)
    np.testing.assert_array_equal(tw[2].numpy(), np.asarray(jw[2]))
    assert tw[2].sum() > 3 * 8
    assert ulp_diff(tw[1].numpy(), np.asarray(jw[1])).max() <= 1
    meta_j = flat(jstate, slice(None, -1)).meta.at[..., 0].add(48.0)
    want = jops.match_rectify_fused(
        flat(jstate, slice(None, -1)).desc, meta_j,
        flat(jstate, slice(1, None)).desc, flat(jstate, slice(1, None)).meta,
        row_band=48.0, max_disparity=96.0, impl="ref")
    got = ops.match_rectify_fused(
        flat(tstate, slice(None, -1)).desc,
        pose.shift_x(flat(tstate, slice(None, -1)).meta, 48.0),
        flat(tstate, slice(1, None)).desc, flat(tstate, slice(1, None)).meta,
        row_band=48.0, max_disparity=96.0)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    _assert_pose_close(tr.pose, jr.pose)
    pts_ulp = ulp_diff(tr.points.numpy(), np.asarray(jr.points))
    print(f"pose differences: rotation "
          f"{np.abs(tr.pose.rotation.numpy() - np.asarray(jr.pose.rotation)).max():.3g}, "
          f"translation {np.abs(tr.pose.translation.numpy() - np.asarray(jr.pose.translation)).max():.3g}; "
          f"points at 1 ulp: {int((pts_ulp > 0).sum())} of {pts_ulp.size}; "
          f"theta: {np.abs(np_of(tr.features_l.theta) - np.asarray(jr.features_l.theta)).max():.3g} rad")
    assert tr.pose.valid.tolist() == [False] + [True] * (T - 1)
    np.testing.assert_array_equal(tr.pose.rotation[0].numpy(), np.eye(3))
    m = metrics.trajectory_metrics(tr.pose.rotation, tr.pose.translation,
                                   _scene().poses)
    assert m["travel_m"] > 0.5
    assert m["ate_rmse_m"] <= 0.4, m
    assert m["rpe_trans_rmse_m"] <= 0.25, m
    assert m["rpe_rot_mean_deg"] <= 1.0, m


def test_unlocalized_run_stacks_frames():
    vs = _port_session(localize=False)
    out = vs.run(_scene().frames[:2])
    one = vs.process_frame(_scene().frames[1])
    assert tuple(out.matches.valid.shape) == (2, 2, K)
    for x, y in zip(map_fields(lambda x: x[1], out).depth, one.depth):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="empty sequence"):
        vs.run(np.zeros((0, 4, H, W), np.float32))
    with pytest.raises(ValueError, match="rank-4"):
        vs.run(_scene().frames[0])


def test_process_frame_loop_matches_run():
    vs = _port_session()
    run = _port_run()
    outs = [vs.process_frame(_scene().frames[t]) for t in range(T)]
    for t, out in enumerate(outs):
        assert isinstance(out, LocalizationOutput)
        assert torch.equal(out.points, run.points[t])
        for x, y in zip(out.pose, map_fields(lambda x: x[t], run.pose)):
            assert torch.equal(x, y)


def test_explicit_prev_overrides_session_state():
    """An explicit ``prev`` replaces the session's state: a zero state
    gives an invalid pose, and the JAX session's own frame-0 state,
    carried across by ``convert``, gives the JAX session's pose."""
    frames = _scene().frames
    jvs = _jax_session()
    j0 = jvs.process_frame(jnp.asarray(frames[0]))
    j1 = jvs.process_frame(jnp.asarray(frames[1]))
    vs = _port_session()
    vs.process_frame(frames[0])
    t1 = vs.process_frame(frames[1])
    _assert_pose_close(t1.pose, j1.pose)
    vs.reset_localization()
    zero = localization.zero_state(vs.rig.n_pairs, K)
    assert not bool(vs.process_frame(frames[1], prev=zero).pose.valid)
    prev = convert.localization_state_from_reference(
        {k: np.asarray(v) for k, v in jloc.state_from(j0)._asdict().items()})
    again = vs.process_frame(frames[1], prev=prev)
    _assert_pose_close(again.pose, j1.pose)


def test_prev_validation_errors_match_jax():
    frames = _scene().frames
    jvs, vs = _jax_session(), _port_session()
    for jprev, tprev, err, msg in (
            (np.zeros(3), np.zeros(3), TypeError, "LocalizationState"),
            (jloc.zero_state(2, K + 1), localization.zero_state(2, K + 1),
             ValueError, "prev.points")):
        with pytest.raises(err, match=msg) as jerr:
            jvs.process_frame(jnp.asarray(frames[0]), prev=jprev)
        with pytest.raises(err, match=msg) as terr:
            vs.process_frame(frames[0], prev=tprev)
        assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]


def test_zero_baseline_rig_invalid_not_nan():
    intr = dataclasses.replace(_scene().intrinsics, baseline=0.0)
    vs = _port_session(intr)
    for t in range(2):
        out = vs.process_frame(_scene().frames[t])
        assert np.isfinite(out.pose.rotation.numpy()).all()
        assert np.isfinite(out.pose.translation.numpy()).all()
        assert not bool(out.pose.valid)
        np.testing.assert_array_equal(out.points.numpy(), 0.0)


# -- the matcher entry points ----------------------------------------------------

def _jfeat(f: FeatureSet):
    return jtypes.FeatureSet(*[jnp.asarray(desc_u32(x)) if n == "desc"
                               else jnp.asarray(np_of(x))
                               for n, x in zip(f._fields, f)])


def test_session_entry_points_match_jax():
    """stereo_match, temporal_match (with and without explicit radii),
    sad_rectify and match_pair on the same features in both packages:
    every field bit-equal."""
    frames = _scene().frames
    vs, jvs = _port_session(localize=False), _jax_session(localize=False)
    f0, f1 = vs.extract(frames[0]), vs.extract(frames[1])
    fl, fr = (map_fields(lambda x: x[c], f0) for c in (0, 1))
    fl1 = map_fields(lambda x: x[0], f1)

    def same(got, want):
        for name, a, b in zip(want._fields, want, got):
            np.testing.assert_array_equal(np_of(b), np.asarray(a),
                                          err_msg=name)

    m = vs.stereo_match(fl, fr)
    same(m, jvs.stereo_match(_jfeat(fl), _jfeat(fr)))
    assert m.valid.sum() > 5
    for radii in ((), (20.3,), (20.3, 4.7)):
        tm = vs.temporal_match(fl, fl1, *radii)
        same(tm, jvs.temporal_match(_jfeat(fl), _jfeat(fl1), *radii))
    assert tm.valid.sum() > 5
    jm = jtypes.MatchSet(*[jnp.asarray(np_of(x)) for x in m])
    img_l, img_r = frames[0][0], frames[0][1]
    same(vs.sad_rectify(img_l, img_r, fl, fr, m),
         jvs.sad_rectify(jnp.asarray(img_l), jnp.asarray(img_r), _jfeat(fl),
                         _jfeat(fr), jm))
    tmp, tdp = vs.match_pair(img_l, img_r, fl, fr)
    jmp, jdp = jvs.match_pair(jnp.asarray(img_l), jnp.asarray(img_r),
                              _jfeat(fl), _jfeat(fr))
    same(tmp, jmp)
    same(tdp, jdp)
    assert tdp.valid.sum() > 5
    # on the CPU every kernel runs its plain version: no launch
    with ops.launch_audit() as audit:
        vs.stereo_match(fl, fr)
    assert audit.count == 0
