"""The port's constants, configs and ROM against the JAX package's, and
the configuration carry-over of ``repro_torch.convert``."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import rig as jrig
from repro.core import sync as jsync
from repro.core import types as jtypes
from repro.core.matching import MIN_DISPARITY as J_MIN_DISPARITY
from repro.kernels import hamming_match as jhm
from repro.kernels import pattern as jpattern
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import matching, rig, sync, types
from repro_torch.kernels import hamming_match, pattern, ref


def test_steer_lut_equal():
    assert pattern.STEER_LUT.shape == (12, 256, 2)
    np.testing.assert_array_equal(pattern.STEER_LUT, jpattern.STEER_LUT)
    np.testing.assert_array_equal(convert.steer_lut(), jpattern.STEER_LUT)
    np.testing.assert_array_equal(pattern.PATTERN, jpattern.PATTERN)


def test_ref_constants_equal():
    assert ref.CIRCLE16 == jref.CIRCLE16
    assert ref.ARC_LEN == jref.ARC_LEN
    np.testing.assert_array_equal(ref.GAUSS7_WEIGHTS_INT,
                                  jref.GAUSS7_WEIGHTS_INT)
    assert ref.GAUSS7_NORM == jref.GAUSS7_NORM
    assert (ref.PATCH, ref.RADIUS) == (jref.PATCH, jref.RADIUS)
    assert ref.INV_ANGLE_STEP == float(np.float32(jref._INV_ANGLE_STEP))
    assert hamming_match.BIG == jhm.BIG == jref.MATCH_BIG
    assert matching.MIN_DISPARITY == J_MIN_DISPARITY
    for thr in (20, 20.0, 19.5, 0.25):
        assert ref.int_threshold(thr) == jref.int_threshold(thr)


@pytest.mark.parametrize("kwargs", [
    {}, dict(height=96, width=128, max_features=64, max_disparity=64),
    dict(height=240, width=320, n_levels=3, scale_factor=1.3,
         max_features=500, quantized=False, nms=False),
])
def test_orb_config_carry_over(kwargs):
    jcfg = jtypes.ORBConfig(**kwargs)
    tcfg = convert.orb_config_from_reference(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert [tcfg.level_shape(l) for l in range(4)] == \
        [jcfg.level_shape(l) for l in range(4)]
    assert tcfg.features_per_level() == jcfg.features_per_level()


def test_intrinsics_carry_over():
    j = jtypes.CameraIntrinsics(fx=500.0, fy=501.0, cx=320.0, cy=240.0,
                                baseline=0.2)
    t = convert.intrinsics_from_reference(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.scaled(0.5)) == \
        dataclasses.asdict(j.scaled(0.5))


@pytest.mark.parametrize("make", [
    lambda m: m.RigConfig.quad(),
    lambda m: m.RigConfig.stereo(sync_policy="software", max_desync=1e-3),
    lambda m: m.RigConfig(
        n_cameras=3, pairs=((0, 1),), desync_policy="degrade",
        max_desync=2e-3,
        intrinsics=(m.CameraIntrinsics(fx=400.0), m.CameraIntrinsics(),
                    m.CameraIntrinsics(baseline=0.3))),
], ids=["quad", "stereo_software", "mono_plus_pair"])
def test_rig_config_carry_over(make):
    jr = make(SimpleNamespace(RigConfig=jrig.RigConfig,
                              CameraIntrinsics=jtypes.CameraIntrinsics))
    tr = convert.rig_config_from_reference(dataclasses.asdict(jr))
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert (tr.n_pairs, tr.left_cams, tr.right_cams) == \
        (jr.n_pairs, jr.left_cams, jr.right_cams)
    assert tr.homogeneous_intrinsics == jr.homogeneous_intrinsics
    assert [dataclasses.asdict(i) for i in tr.pair_intrinsics] == \
        [dataclasses.asdict(i) for i in jr.pair_intrinsics]
    np.testing.assert_array_equal(tr.pair_rotation_array(),
                                  jr.pair_rotation_array())
    mask = np.arange(jr.n_cameras) % 2 == 0
    np.testing.assert_array_equal(tr.pair_mask(mask), jr.pair_mask(mask))
    with pytest.raises(ValueError):
        tr.pair_mask(np.ones(jr.n_cameras + 1, bool))


@pytest.mark.parametrize("bad", [
    dict(n_cameras=0), dict(pairs=((0, 0),)), dict(pairs=((0, 9),)),
    dict(sync_policy="gps"), dict(desync_policy="ignore"),
    dict(max_desync=-1.0), dict(pairs=()),
])
def test_rig_config_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        jrig.RigConfig(**bad)
    with pytest.raises(ValueError):
        rig.RigConfig(**bad)


def test_trigger_config_and_desync_helpers():
    for fps, rate in ((30.0, 200.0), (40.0, 200.0), (25.0, 1000.0)):
        j = jsync.TriggerConfig(camera_fps=fps, imu_rate_hz=rate)
        t = sync.TriggerConfig(camera_fps=fps, imu_rate_hz=rate)
        assert (t.imu_per_frame, t.frame_dt) == (j.imu_per_frame, j.frame_dt)
    ts = np.array([1.75e9, 1.75e9 + 1e-3, 1.75e9, 1.75e9 + 0.5])
    assert sync.frame_desync(ts) == jsync.frame_desync(ts)
    np.testing.assert_array_equal(sync.desync_camera_mask(ts, 2e-3),
                                  jsync.desync_camera_mask(ts, 2e-3))


def test_types_have_the_jax_fields():
    for name in ("FeatureSet", "MatchSet", "DepthSet", "StereoOutput"):
        assert getattr(types, name)._fields == getattr(jtypes, name)._fields
