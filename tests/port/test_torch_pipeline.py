"""The port's slice as a whole: ``VisualSystem.process_frame`` and the
stage chain against the JAX package's session (``impl="ref"``), plus
the session's camera-mask, desync-policy, validation and later-slice
contracts (the fleet entry points are ``test_torch_fleet.py``'s).  All
on the CPU, where every kernel runs its plain version, at 96x128 with
64 features over two levels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pyramid as jpyramid
from repro.core import rig as jrig
from repro.core import types as jtypes
from repro.core.fast import select_topk as jselect_topk
from repro.core.pipeline import PipelineConfig as JPipelineConfig
from repro.core.pipeline import VisualSystem as JVisualSystem
from repro_torch.core import (DesyncError, ORBConfig, PipelineConfig,
                              RigConfig, VisualSystem, fast, matching, orb,
                              pyramid)
from repro_torch.core.types import CameraIntrinsics, map_fields
from repro_torch.kernels import ops
from repro_torch.kernels.ref import extract_patches, moment_grids

from parity import assert_stereo_parity, np_of, scene_frames

H, W = 96, 128
OCFG = dict(height=H, width=W, max_features=64, max_disparity=64)


def _jintr(intr):
    return jtypes.CameraIntrinsics(fx=intr.fx, fy=intr.fy, cx=intr.cx,
                                   cy=intr.cy, baseline=intr.baseline)


@pytest.fixture(scope="module")
def jax_session():
    _, intr = scene_frames()
    return JVisualSystem(jrig.RigConfig.quad(_jintr(intr)),
                         JPipelineConfig(orb=jtypes.ORBConfig(**OCFG),
                                         impl="ref"))


def _port_session(**rig_kwargs):
    _, intr = scene_frames()
    return VisualSystem(RigConfig.quad(intr, **rig_kwargs),
                        PipelineConfig(orb=ORBConfig(**OCFG)), device="cpu")


def _frame(integer: bool):
    frame, _ = scene_frames()
    return np.round(frame) if integer else frame.copy()


def _moment_inputs(out, levels, cfg):
    """Per side: (P, K, 2) moment abs-sums and moments of the port's
    raw patches at each feature (for the float-frame theta bound)."""
    xg, yg = moment_grids()
    sums, moms = {}, {}
    for side, cams in (("features_l", (0, 2)), ("features_r", (1, 3))):
        f = getattr(out, side)
        s_all, m_all = [], []
        for p, cam in enumerate(cams):
            lvl = f.level[p].numpy()
            xy = np.round(f.xy[p].numpy()
                          / (cfg.scale_factor ** lvl)[:, None]).astype(int)
            s_p, m_p = [], []
            for i in range(len(lvl)):
                patch = extract_patches(levels[lvl[i]][cam],
                                        torch.from_numpy(xy[i:i + 1]))
                s_p.append([float((patch * xg).abs().sum()),
                            float((patch * yg).abs().sum())])
                m_p.append([float((patch * xg).sum()),
                            float((patch * yg).sum())])
            s_all.append(s_p)
            m_all.append(m_p)
        sums[side], moms[side] = np.asarray(s_all), np.asarray(m_all)
    return sums, moms


@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_process_frame_matches_jax(jax_session, integer):
    frame = _frame(integer)
    jo = jax_session.process_frame(jnp.asarray(frame))
    vs = _port_session()
    to = vs.process_frame(frame)
    cfg = vs.pipe.orb
    jlv = jpyramid.build_pyramid_batched(jnp.asarray(frame),
                                         jtypes.ORBConfig(**OCFG))
    tlv = pyramid.build_pyramid_batched(torch.from_numpy(frame), cfg)
    diff = np.asarray(jlv[1]) != tlv[1].numpy()
    lvl1_diff = [np.argwhere(diff[c]) for c in range(4)]
    print(f"level-1 pixels that differ: {int(diff.sum())}")
    sums, moms = _moment_inputs(to, tlv, cfg)
    n_edge = assert_stereo_parity(jo, to, cfg.features_per_level()[0],
                                  cfg.scale_factor, (0, 2), (1, 3),
                                  lvl1_diff, integer, sums, moms)
    print(f"descriptors at a bin edge: {n_edge}")
    assert min(np_of(to.depth.valid).sum(-1)) > 0


def test_stage_chain_on_jax_levels_matches_jax(jax_session):
    """The port's FE and FM stages fed the JAX package's own pyramid
    levels, on integer-valued frames: every field bit-equal, theta
    within 1 ulp (atan2)."""
    frame = _frame(True)
    jo = jax_session.process_frame(jnp.asarray(frame))
    cfg = ORBConfig(**OCFG)
    jlv = jpyramid.build_pyramid_batched(jnp.asarray(frame),
                                         jtypes.ORBConfig(**OCFG))
    levels = [torch.from_numpy(np.asarray(l).copy()) for l in jlv]
    feats = orb.features_from_levels(levels, cfg)
    fl = map_fields(lambda x: x[[0, 2]], feats)
    fr = map_fields(lambda x: x[[1, 3]], feats)
    _, intr = scene_frames()
    m, d = matching.match_pair_fused(levels[0][[0, 2]], levels[0][[1, 3]],
                                     fl, fr, cfg, intr)
    from repro_torch.core.types import StereoOutput
    to = StereoOutput(fl, fr, m, d)
    no_diff = [np.zeros((0, 2), int)] * 4
    n_edge = assert_stereo_parity(jo, to, cfg.features_per_level()[0],
                                  cfg.scale_factor, (0, 2), (1, 3), no_diff,
                                  True, None, None)
    print(f"descriptors at a bin edge: {n_edge}")


def test_camera_mask_identity_and_gating(jax_session):
    frame = _frame(True)
    vs = _port_session()
    full = vs.process_frame(frame)
    ones = vs.process_frame(frame, camera_mask=np.ones(4, bool))
    for a, b in zip(map_fields(lambda x: x, full), ones):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    mask = np.array([True, True, True, False])
    to = vs.process_frame(frame, camera_mask=mask)
    jo = jax_session.process_frame(jnp.asarray(frame),
                                   camera_mask=jnp.asarray(mask))
    for grp in ("features_l", "features_r", "matches", "depth"):
        np.testing.assert_array_equal(
            np_of(getattr(to, grp).valid), np.asarray(getattr(jo, grp).valid))
    assert not np_of(to.matches.valid)[1].any()
    assert not np_of(to.features_r.valid)[1].any()
    # the live pair is untouched by the dead camera
    for x, y in zip(to.depth, full.depth):
        assert torch.equal(x[0], y[0])


@pytest.mark.parametrize("rig_kwargs,ts,expect", [
    (dict(), [0.0, 0.0, 0.0, 0.0], "ok"),
    (dict(), [0.0, 0.0, 0.0, 1e-3], "raise"),
    (dict(sync_policy="software"), [0.0, 0.0, 0.0, 1e-3], "ok"),
    (dict(desync_policy="drop_frame", max_desync=1e-4),
     [0.0, 0.0, 0.0, 1e-3], "drop_frame"),
    (dict(desync_policy="degrade", max_desync=1e-4),
     [0.0, 0.0, 0.0, 1e-3], "degrade"),
    (dict(sync_policy="software", desync_policy="raise"),
     [1.75e9, 1.75e9, 1.75e9 + 2e-3, 1.75e9], "raise"),
])
def test_desync_policy_decisions_match_jax(rig_kwargs, ts, expect):
    _, intr = scene_frames()
    jvs = JVisualSystem(jrig.RigConfig.quad(_jintr(intr), **rig_kwargs),
                        JPipelineConfig(orb=jtypes.ORBConfig(**OCFG),
                                        impl="ref"))
    vs = _port_session(**rig_kwargs)
    jd, td = jvs.desync_decision(ts), vs.desync_decision(ts)
    assert (td.action, td.desync) == (jd.action, jd.desync) \
        and td.action == expect
    if jd.camera_mask is None:
        assert td.camera_mask is None
    else:
        np.testing.assert_array_equal(td.camera_mask, jd.camera_mask)
    assert list(vs.desync_log) == [jd.desync]


def test_process_frame_applies_the_desync_policy():
    frame = _frame(False)
    late = [0.0, 0.0, 0.0, 1e-3]
    with pytest.raises(DesyncError):
        _port_session().process_frame(frame, timestamps=late)
    assert _port_session(desync_policy="drop_frame").process_frame(
        frame, timestamps=late) is None
    out = _port_session(desync_policy="degrade").process_frame(
        frame, timestamps=late)
    assert np_of(out.matches.valid)[0].any()
    assert not np_of(out.matches.valid)[1].any()


@pytest.mark.parametrize("images,err", [
    (np.zeros((4, H, W, 1), np.float32), ValueError),
    (np.zeros((3, H, W), np.float32), ValueError),
    (np.zeros((4, H + 1, W), np.float32), ValueError),
    (np.zeros((4, H, W), np.uint8), TypeError),
    (np.zeros((4, H, W), np.int32), TypeError),
])
def test_eager_shape_and_dtype_errors_match_jax(jax_session, images, err):
    with pytest.raises(err):
        jax_session.process_frame(images)
    with pytest.raises(err):
        _port_session().process_frame(images)
    with pytest.raises(ValueError):
        _port_session().process_frame(_frame(False),
                                      camera_mask=np.ones(3, bool))


def test_later_slices_run_and_equal_their_reference():
    """The later slices, ported since, run.  The pipelined schedule
    (A5) constructs, and its ``run`` and ``run_fleet`` equal the
    sequential schedule's bit for bit; the fleet entry points run, and a
    fleet of one equals the frame on both entries; ``precision="uint8"``
    (A6) constructs, and its frame equals the f32 session's on the same
    integer-valued frame."""
    vs = _port_session()
    frame = _frame(True)
    piped = VisualSystem(vs.rig, PipelineConfig(orb=ORBConfig(**OCFG),
                                                schedule="pipelined"),
                         device="cpu")
    seq = np.stack([frame, np.roll(frame, 2, axis=-1)])
    for entry, xs in (("run", seq), ("run_fleet", seq[:, None])):
        got, want = getattr(piped, entry)(xs), getattr(vs, entry)(xs)
        for grp_got, grp_want in zip(got, want):
            for x, y in zip(grp_got, grp_want):
                assert x.dtype == y.dtype and torch.equal(x, y)
    one = vs.process_frame(frame)
    fleet = vs.process_fleet(frame[None])
    seq = vs.run_fleet(frame[None, None])
    for grp_one, grp_fleet, grp_seq in zip(one, fleet, seq):
        for x, y, z in zip(grp_one, grp_fleet, grp_seq):
            assert torch.equal(x, y[0]) and torch.equal(x, z[0, 0])
    with pytest.raises(ValueError):
        PipelineConfig(precision="f16")
    u8 = VisualSystem(vs.rig, PipelineConfig(orb=ORBConfig(**OCFG),
                                             precision="uint8"),
                      device="cpu")
    frame = _frame(True)
    got = u8.process_frame(frame.astype(np.uint8))
    want = vs.process_frame(frame)
    for grp_got, grp_want in zip(got, want):
        for x, y in zip(grp_got, grp_want):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert min(np_of(got.depth.valid).sum(-1)) > 0


def test_sessions_default_to_the_card():
    rig = RigConfig.quad(CameraIntrinsics())
    assert VisualSystem.__init__.__defaults__[-1] == "cuda"
    if not torch.cuda.is_available():
        # no silent CPU carry-on: a session on a missing card fails
        with pytest.raises((RuntimeError, AssertionError)):
            VisualSystem(rig)


def test_extract_and_launch_audit_on_cpu():
    vs = _port_session()
    with ops.launch_audit() as audit:
        feats = vs.extract(_frame(False))
    assert audit.count == 0          # plain versions launch nothing
    assert tuple(feats.desc.shape) == (4, 64, 8)
    assert feats.desc.dtype == torch.int32


def test_select_topk_breaks_ties_like_lax_top_k():
    rng = np.random.RandomState(5)
    score = rng.randint(0, 4, (3, 40, 50)).astype(np.float32)
    score[1] = 0.0                              # nothing but ties
    for b in range(3):
        jxy, jv, jvalid = jselect_topk(jnp.asarray(score[b]), 64, 4)
        txy, tv, tvalid = fast.select_topk(torch.from_numpy(score[b:b + 1]),
                                           64, 4)
        np.testing.assert_array_equal(txy[0].numpy(), np.asarray(jxy))
        np.testing.assert_array_equal(tv[0].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tvalid[0].numpy(), np.asarray(jvalid))


def test_heterogeneous_intrinsics_depth_matches_jax():
    """Per-pair ``fx * baseline`` (a heterogeneous rig) reaches depth as
    the JAX package computes it: a float32 column, divided tensor by
    tensor."""
    frame = _frame(True)
    _, intr = scene_frames()
    cams = [intr, intr,
            CameraIntrinsics(fx=intr.fx * 1.1, fy=intr.fy, cx=intr.cx,
                             cy=intr.cy, baseline=0.25), intr]
    jrig_ = jrig.RigConfig(n_cameras=4, pairs=((0, 1), (2, 3)),
                           intrinsics=tuple(_jintr(c) for c in cams))
    jo = JVisualSystem(jrig_, JPipelineConfig(
        orb=jtypes.ORBConfig(**OCFG), impl="ref")).process_frame(
            jnp.asarray(frame))
    vs = VisualSystem(RigConfig(n_cameras=4, pairs=((0, 1), (2, 3)),
                                intrinsics=tuple(cams)),
                      PipelineConfig(orb=ORBConfig(**OCFG)), device="cpu")
    assert not vs.rig.homogeneous_intrinsics
    to = vs.process_frame(frame)
    cfg = vs.pipe.orb
    jlv = jpyramid.build_pyramid_batched(jnp.asarray(frame),
                                         jtypes.ORBConfig(**OCFG))
    tlv = pyramid.build_pyramid_batched(torch.from_numpy(frame), cfg)
    diff = np.asarray(jlv[1]) != tlv[1].numpy()
    assert_stereo_parity(jo, to, cfg.features_per_level()[0],
                         cfg.scale_factor, (0, 2), (1, 3),
                         [np.argwhere(diff[c]) for c in range(4)], True,
                         None, None)
    k0 = cfg.features_per_level()[0]
    valid = np_of(to.depth.valid)[1, :k0]
    assert valid.any()
    np.testing.assert_array_equal(np_of(to.depth.depth)[1, :k0][valid],
                                  np.asarray(jo.depth.depth)[1, :k0][valid])
