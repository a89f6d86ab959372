"""The stereo visual-odometry backend (``repro_torch.core.backend``):
each function against its JAX counterpart (``repro.core.backend``) on
the same numpy inputs made from a seed, the behaviour cases of the JAX
package's ``tests/test_backend.py``, the quad-fused visual odometry of
its ``tests/test_system.py`` on a CPU session of the port, and the
``core`` exports (``backend``, ``pattern``).  Tolerances in
``parity.py``: triangulation and the masked median bit-equal,
residuals within ``RESIDUAL_RTOL`` of the projected coordinates,
``_so3_exp`` within ``SO3_ATOL``, refined and robust poses within
``VO_POSE_ATOL`` with equal inlier counts, trajectories within
``TRAJECTORY_ATOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as jbackend
from repro.core import pattern as jpattern
from repro.core.types import CameraIntrinsics as JCameraIntrinsics
from repro.core.types import DepthSet as JDepthSet
from repro.core.types import FeatureSet as JFeatureSet
import repro_torch.core
from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                              VisualSystem, backend)
from repro_torch.core import pattern
from repro_torch.core.types import (CameraIntrinsics, DepthSet, FeatureSet,
                                    map_fields)
from repro_torch.data import scenes
from repro_torch.kernels import pattern as kpattern

from parity import (RESIDUAL_RTOL, SO3_ATOL, TRAJECTORY_ATOL, VO_POSE_ATOL,
                    np_of)

INTR = dict(fx=300.0, fy=300.0, cx=160.0, cy=120.0)
FLIP = np.asarray([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]],
                  np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _random_rt(rng, angle=0.1, scale=0.5):
    """A rotation of ``angle`` rad about a random axis and a translation,
    float32 (the JAX test's construction)."""
    w = rng.normal(size=3)
    w = angle * w / np.linalg.norm(w)
    theta = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    r = (np.eye(3) + np.sin(theta) / theta * k
         + (1 - np.cos(theta)) / theta ** 2 * (k @ k))
    return r.astype(np.float32), (scale * rng.normal(size=3)).astype(
        np.float32)


def _vo_problem(seed, k=48, n_out=8, noise_px=0.5):
    """Points ahead of a camera moved by a small (R, t), their noisy
    projections in the current frame, current-frame points with gross
    3-D outliers on the first ``n_out``, and 0/1 weights with the last
    4 off: (pts_prev, pts_curr, weights, xy_curr, R, t)."""
    rng = np.random.RandomState(seed)
    r, t = _random_rt(rng, angle=0.05, scale=0.2)
    pts = np.stack([rng.uniform(-1, 1, k), rng.uniform(-1, 1, k),
                    rng.uniform(3, 8, k)], 1).astype(np.float32)
    cur = (pts @ r.T + t).astype(np.float32)
    xy = np.stack([INTR["fx"] * cur[:, 0] / cur[:, 2] + INTR["cx"],
                   INTR["fy"] * cur[:, 1] / cur[:, 2] + INTR["cy"]], 1)
    xy = (xy + rng.normal(0, noise_px, xy.shape)).astype(np.float32)
    cur[:n_out] += rng.uniform(2, 4, (n_out, 3)).astype(np.float32)
    w = np.ones(k, np.float32)
    w[-4:] = 0.0
    return pts, cur, w, xy, r, t


def _assert_pose_close(got, want):
    np.testing.assert_allclose(np_of(got[0]), np.asarray(want[0]), rtol=0,
                               atol=VO_POSE_ATOL)
    np.testing.assert_allclose(np_of(got[1]), np.asarray(want[1]), rtol=0,
                               atol=VO_POSE_ATOL)


# -- each function against JAX --------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_triangulate_matches_jax(seed):
    rng = np.random.RandomState(seed)
    k = 64
    xy = np.stack([rng.uniform(0, 320, k), rng.uniform(0, 240, k)],
                  1).astype(np.float32)
    z = rng.uniform(0.5, 30, k).astype(np.float32)
    z[rng.rand(k) < 0.3] = 0.0                  # invalid lanes: depth 0
    zi = np.zeros(k, np.int32)
    zf = np.zeros(k, np.float32)
    valid = z > 0
    jf = JFeatureSet(_j(xy), _j(zi), _j(zf), _j(zf),
                     _j(np.zeros((k, 8), np.uint32)), _j(valid))
    tf = FeatureSet(_t(xy), _t(zi), _t(zf), _t(zf),
                    _t(np.zeros((k, 8), np.int32)), _t(valid))
    jd = JDepthSet(_j(zf), _j(z), _j(xy), _j(valid))
    td = DepthSet(_t(zf), _t(z), _t(xy), _t(valid))
    want = jbackend.triangulate(jf, jd, JCameraIntrinsics(**INTR))
    got = backend.triangulate(tf, td, CameraIntrinsics(**INTR))
    assert got.dtype == torch.float32 and tuple(got.shape) == (k, 3)
    np.testing.assert_array_equal(np_of(got), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_reprojection_residuals_match_jax(seed):
    pts, _, _, xy, r, t = _vo_problem(seed)
    want = np.asarray(jbackend.reprojection_residuals(
        _j(r), _j(t), _j(pts), _j(xy), JCameraIntrinsics(**INTR)))
    got = np_of(backend.reprojection_residuals(
        _t(r), _t(t), _t(pts), _t(xy), CameraIntrinsics(**INTR)))
    # held on the projected coordinates (residual + xy), see parity.py
    np.testing.assert_allclose(got + xy, want + xy, rtol=RESIDUAL_RTOL,
                               atol=0)


@pytest.mark.parametrize("w", [[0.0, 0.0, 0.0], [1e-9, -2e-9, 0.0],
                               [0.03, -0.02, 0.05], [0.4, 1.1, -0.7]])
def test_so3_exp_matches_jax(w):
    w = np.asarray(w, np.float32)
    want = np.asarray(jbackend._so3_exp(_j(w)))
    got = np_of(backend._so3_exp(_t(w)))
    np.testing.assert_allclose(got, want, rtol=0, atol=SO3_ATOL)


@pytest.mark.parametrize("case", ["random", "none", "all", "one", "ties"])
def test_masked_median_matches_jax(case):
    rng = np.random.RandomState(3)
    x = rng.normal(size=41).astype(np.float32)
    mask = {"random": rng.rand(41) > 0.4, "none": np.zeros(41, bool),
            "all": np.ones(41, bool), "one": np.arange(41) == 7,
            "ties": np.ones(41, bool)}[case]
    if case == "ties":
        x = np.round(x).astype(np.float32)
    want = np.asarray(jbackend._masked_median(_j(x), _j(mask)))
    got = np_of(backend._masked_median(_t(x), _t(mask)))
    np.testing.assert_array_equal(got, want)


def test_gauss_newton_matches_jax_and_reduces_error():
    """The JAX test's case (a perturbed start, noise-free projections):
    the port lands within the tolerance of JAX's refinement and cuts
    the RMS reprojection error below 2% of the start's."""
    rng = np.random.RandomState(2)
    r_true, t_true = _random_rt(rng, angle=0.05, scale=0.2)
    pts = np.stack([rng.uniform(-1, 1, 40), rng.uniform(-1, 1, 40),
                    rng.uniform(3, 8, 40)], axis=1).astype(np.float32)
    cam = pts @ r_true.T + t_true
    xy = np.stack([INTR["fx"] * cam[:, 0] / cam[:, 2] + INTR["cx"],
                   INTR["fy"] * cam[:, 1] / cam[:, 2] + INTR["cy"]],
                  axis=1).astype(np.float32)
    r0, t0 = _random_rt(rng, angle=0.03, scale=0.1)
    r0, t0 = (r0 @ r_true).astype(np.float32), t_true + t0
    w = np.ones(40, np.float32)
    want = jbackend.gauss_newton_refine(_j(r0), _j(t0), _j(pts), _j(xy),
                                        _j(w), JCameraIntrinsics(**INTR))
    intr = CameraIntrinsics(**INTR)
    got = backend.gauss_newton_refine(_t(r0), _t(t0), _t(pts), _t(xy),
                                      _t(w), intr)
    _assert_pose_close(got, want)

    def err(r, t):
        res = backend.reprojection_residuals(r, t, _t(pts), _t(xy), intr)
        return float(torch.sqrt((res ** 2).mean()))

    assert err(*got) < 0.02 * err(_t(r0), _t(t0))


@pytest.mark.parametrize("mode,refine,iters", [
    ("slam", True, 3), ("vio", False, 1), ("registration", True, 6)])
@pytest.mark.parametrize("seed", [0, 5])
def test_estimate_relative_pose_matches_jax(mode, refine, iters, seed):
    """The three backend modes of the paper's Tab. I split
    (``benchmarks/run.py``'s ``table1_latency_split``) on points with
    gross outliers: R and t within the tolerance of JAX's, the inlier
    counts equal, and the motion recovered."""
    pts, cur, w, xy, r, t = _vo_problem(seed)
    want = jbackend.estimate_relative_pose(
        _j(pts), _j(cur), _j(w), _j(xy), JCameraIntrinsics(**INTR),
        refine=refine, robust_iters=iters)
    got = backend.estimate_relative_pose(
        _t(pts), _t(cur), _t(w), _t(xy), CameraIntrinsics(**INTR),
        refine=refine, robust_iters=iters)
    assert isinstance(got, backend.PoseEstimate)
    assert got.inliers.dtype == torch.int32
    assert int(got.inliers) == int(want.inliers)
    _assert_pose_close(got, want)
    np.testing.assert_allclose(np_of(got.rotation), r, atol=2e-2)
    np.testing.assert_allclose(np_of(got.translation), t, atol=5e-2)


def test_integrate_trajectory_matches_jax():
    rng = np.random.RandomState(4)
    steps = [_random_rt(rng, angle=0.1, scale=0.3) for _ in range(6)]
    want = jbackend.integrate_trajectory(
        [jbackend.PoseEstimate(_j(r), _j(t), jnp.asarray(10))
         for r, t in steps])
    got = backend.integrate_trajectory(
        [backend.PoseEstimate(_t(r), _t(t), torch.tensor(10))
         for r, t in steps])
    assert tuple(got.shape) == (7, 3)
    np.testing.assert_allclose(np_of(got), np.asarray(want), rtol=0,
                               atol=TRAJECTORY_ATOL)


def test_non_finite_and_degenerate_inputs_give_jax_values_without_raising():
    """A NaN point gives a NaN refined rotation on both sides, with no
    error (``torch.linalg.solve`` would raise where XLA's solve returns
    NaN); all-zero weights (J^T J = 0, held regular only by the 1e-6 I
    term) give JAX's values."""
    pts, _, _, xy, r, t = _vo_problem(1)
    w = np.ones(len(pts), np.float32)
    intr, jintr = CameraIntrinsics(**INTR), JCameraIntrinsics(**INTR)
    bad = pts.copy()
    bad[0, 0] = np.nan
    want = jbackend.gauss_newton_refine(_j(r), _j(t), _j(bad), _j(xy),
                                        _j(w), jintr)
    got = backend.gauss_newton_refine(_t(r), _t(t), _t(bad), _t(xy), _t(w),
                                      intr)
    assert np.isnan(np.asarray(want[0])).all()
    assert torch.isnan(got[0]).all()
    zero = np.zeros_like(w)
    want = jbackend.gauss_newton_refine(_j(r), _j(t), _j(pts), _j(xy),
                                        _j(zero), jintr)
    got = backend.gauss_newton_refine(_t(r), _t(t), _t(pts), _t(xy),
                                      _t(zero), intr)
    _assert_pose_close(got, want)


# -- the JAX package's behaviour cases -----------------------------------------

def test_kabsch_recovers_exact_transform():
    rng = np.random.RandomState(0)
    r_true, t_true = _random_rt(rng)
    pts = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    r, t = backend.kabsch(_t(pts), _t(pts @ r_true.T + t_true),
                          torch.ones(50))
    np.testing.assert_allclose(np_of(r), r_true, atol=1e-5)
    np.testing.assert_allclose(np_of(t), t_true, atol=1e-5)


def test_kabsch_weights_ignore_outliers():
    rng = np.random.RandomState(1)
    r_true, t_true = _random_rt(rng)
    pts = rng.uniform(-2, 2, (60, 3)).astype(np.float32)
    pts_b = (pts @ r_true.T + t_true).astype(np.float32)
    pts_b[:10] += rng.uniform(5, 9, (10, 3)).astype(np.float32)
    w = np.ones(60, np.float32)
    w[:10] = 0.0
    r, t = backend.kabsch(_t(pts), _t(pts_b), _t(w))
    np.testing.assert_allclose(np_of(r), r_true, atol=1e-5)
    np.testing.assert_allclose(np_of(t), t_true, atol=1e-5)


def test_so3_exp_zero_is_identity_and_differentiable():
    zero = torch.zeros(3)
    np.testing.assert_allclose(np_of(backend._so3_exp(zero)), np.eye(3),
                               atol=1e-6)
    jac = torch.func.jacfwd(backend._so3_exp)(zero)
    assert tuple(jac.shape) == (3, 3, 3)
    assert bool(torch.isfinite(jac).all())
    want = jax.jacfwd(jbackend._so3_exp)(jnp.zeros(3))
    np.testing.assert_allclose(np_of(jac), np.asarray(want), atol=SO3_ATOL)


def test_trajectory_integration_straight_line():
    poses = [backend.PoseEstimate(torch.eye(3),
                                  torch.tensor([0.0, 0.0, -0.1]),
                                  torch.tensor(10, dtype=torch.int32))
             for _ in range(5)]
    traj = np_of(backend.integrate_trajectory(poses))
    np.testing.assert_allclose(traj[-1], [0, 0, 0.5], atol=1e-6)
    np.testing.assert_array_equal(np_of(backend.integrate_trajectory([])),
                                  np.zeros((1, 3), np.float32))


# -- the quad-fused visual odometry on the port's session ------------------------

def _stereo_frame(vs, img_l, img_r):
    out = vs.process_frame(np.stack([img_l, img_r]))
    return map_fields(lambda x: x[0], out)


def _run_vo(frames, ocfg, intr):
    """``tests/test_system.py``'s quad-camera VO on a 2-camera CPU
    session: both stereo pairs of every frame, the back pair's points
    rotated into the rig frame, one flat-weighted solve a transition."""
    vs = VisualSystem(RigConfig.stereo(intr), PipelineConfig(orb=ocfg),
                      device="cpu")
    fronts = [_stereo_frame(vs, f[0], f[1]) for f in frames]
    backs = [_stereo_frame(vs, f[2], f[3]) for f in frames]
    poses = []
    for t in range(len(frames) - 1):
        pts, pts_n, w = [], [], []
        for seq, rot in ((fronts, np.eye(3, dtype=np.float32)),
                         (backs, FLIP)):
            prev, curr = seq[t], seq[t + 1]
            tm = vs.temporal_match(prev.features_l, curr.features_l)
            idx = tm.right_index.long()
            w.append((tm.valid & prev.depth.valid
                      & curr.depth.valid[idx]).float())
            rot = _t(rot).T
            pts.append(backend.triangulate(prev.features_l, prev.depth,
                                           intr) @ rot)
            pts_n.append(backend.triangulate(curr.features_l, curr.depth,
                                             intr)[idx] @ rot)
        poses.append(backend.estimate_relative_pose(
            torch.cat(pts), torch.cat(pts_n), torch.cat(w), xy_curr=None,
            intr=intr, refine=False))
    return poses


def test_quad_fused_vo_recovers_motion():
    """``tests/test_system.py``'s end-to-end case: a wide baseline at
    160 x 240, lateral-dominant motion; every transition keeps 8 inliers
    and the integrated trajectory ends within 30% of the travel."""
    cfg = scenes.SceneConfig(height=160, width=240, n_points=200, seed=7,
                             baseline=0.5)
    seq = scenes.render_sequence(cfg, 4, step_t=(0.25, 0.0, 0.1),
                                 yaw_per_frame=0.0)
    ocfg = ORBConfig(height=160, width=240, max_features=256, n_levels=1,
                     max_disparity=96)
    poses = _run_vo(seq.frames, ocfg, seq.intrinsics)
    assert all(int(p.inliers) >= 8 for p in poses)
    traj = np_of(backend.integrate_trajectory(poses))
    true_final = np.asarray(seq.poses[-1][1])
    err = np.linalg.norm(traj[-1] - true_final)
    assert err < 0.3 * np.linalg.norm(true_final), (traj[-1], true_final)


# -- exports -------------------------------------------------------------------

def test_core_exports_backend_and_pattern():
    assert repro_torch.core.backend is backend
    assert "backend" in repro_torch.core.__all__
    for name in ("ANGLE_BIN_STEP", "N_ANGLE_BINS", "N_PAIRS", "PATCH_RADIUS",
                 "PATTERN", "PATTERN_A", "PATTERN_B", "PATTERN_RADIUS",
                 "PATTERN_SIGMA", "STEER_LUT", "rotated_pattern"):
        assert getattr(pattern, name) is getattr(kpattern, name), name
        if name != "rotated_pattern":
            np.testing.assert_array_equal(np.asarray(getattr(pattern, name)),
                                          np.asarray(getattr(jpattern, name)))
    np.testing.assert_array_equal(pattern.rotated_pattern(0.7),
                                  jpattern.rotated_pattern(0.7))
