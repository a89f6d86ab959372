"""Fleet frames: ``VisualSystem.process_fleet`` and ``run_fleet`` (the rig
axis folded into the kernels' batch axes), fleet localization, the
uint8 fleet, ``localization.zero_state(..., n_rigs)`` and
``data.scenes.render_fleet_sequence``, on the CPU (every kernel runs
its plain version), at 64 x 96 and 59 x 85 with 48 features over two
levels and at most 3 rigs.

Each fleet output is held two ways:

* against the port's own per-rig loop of ``process_frame`` on the same
  device: bit-equal in every field (one code path, so no tolerance),
  masked or not, in f32 and in uint8;
* against the JAX package's session (``impl="ref"``) on the same seeded
  numpy frames, by ``parity.py``'s rules: on integer-valued frames, with
  the port fed the JAX pyramid's levels (``parity.feed_jax_pyramid``),
  every field bit-equal but theta (within 1 ulp: XLA's atan2 against
  torch's) and descriptors at a steering-bin edge
  (``assert_stereo_parity``).

Poses come from a batched 3 x 3 SVD, so a fleet's poses are held to the
pose tests' tolerances: within 1e-5 of the per-rig loop's and of JAX's
(rotation and translation), ``valid`` and the inlier counts equal.
Points are bit-equal to the loop's and to JAX's ``rig_points`` run
eagerly; the JAX session's own points come out of its jitted graph,
which rounds the back-projection differently, and are held within 2
ulp (``test_torch_localization.py`` saw 1 ulp on a frame's run)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import localization as jloc
from repro.core.pipeline import PipelineConfig as JPipelineConfig
from repro.core.pipeline import VisualSystem as JVisualSystem
from repro.core.rig import DesyncError as JDesyncError
from repro.core.rig import RigConfig as JRigConfig
from repro.core.types import CameraIntrinsics as JCameraIntrinsics
from repro.core.types import ORBConfig as JORBConfig
from repro.data import scenes as jscenes
from repro.localization import geometry as jgeometry
from repro_torch import convert, localization
from repro_torch.core import (DesyncError, ORBConfig, PipelineConfig,
                              RigConfig, VisualSystem)
from repro_torch.core.types import (CameraIntrinsics, LocalizationOutput,
                                    map_fields)
from repro_torch.data import scenes
from repro_torch.kernels import ops

from parity import (assert_stereo_parity, desc_u32, feed_jax_pyramid, np_of,
                    ulp_diff)

H, W = 64, 96
OCFG = dict(height=H, width=W, max_features=48, max_disparity=48)
LOC_OCFG = dict(height=H, width=W, max_features=48, fast_threshold=15)
POSE_ATOL = 1e-5
NO_DIFF = [np.zeros((0, 2), int)] * 4


def _jintr(intr):
    return JCameraIntrinsics(**dataclasses.asdict(intr))


@functools.lru_cache(maxsize=4)
def _fleet(h=H, w=W, n_rigs=3, n_frames=1):
    """(T, n_rigs, 4, h, w) float32 frames of the rendered fleet and
    their intrinsics."""
    seq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=h, width=w, n_points=300, baseline=0.3), n_frames, n_rigs)
    seq.frames.setflags(write=False)
    return seq.frames, seq.intrinsics


@functools.lru_cache(maxsize=1)
def _loc_fleet():
    """The localization tests' motion (0.25 m lateral steps, no yaw,
    baseline 0.5 m) as a 2-rig fleet of 3 steps, rounded to integers."""
    seq = scenes.render_fleet_sequence(
        scenes.SceneConfig(height=H, width=W, baseline=0.5, seed=1), 3, 2,
        step_t=(0.25, 0.0, 0.1), yaw_per_frame=0.0)
    frames = np.round(seq.frames)
    frames.setflags(write=False)
    return frames, seq.intrinsics


def _session(intr, h=H, w=W, rig=None, **pipe):
    ocfg = dict(OCFG, height=h, width=w)
    rig = RigConfig.quad(intr) if rig is None else rig
    return VisualSystem(rig, PipelineConfig(orb=ORBConfig(**ocfg), **pipe),
                        device="cpu")


def _jax_session(intr, h=H, w=W, **pipe):
    ocfg = dict(OCFG, height=h, width=w)
    return JVisualSystem(JRigConfig.quad(_jintr(intr)),
                         JPipelineConfig(orb=JORBConfig(**ocfg), impl="ref",
                                         **pipe))


def _loc_session(intr):
    return VisualSystem(RigConfig.quad(intr),
                        PipelineConfig(orb=ORBConfig(**LOC_OCFG),
                                       localize=True), device="cpu")


def _rig(out, r):
    return map_fields(lambda x: x[r], out)


def jax_rig(out, r):
    return jax.tree.map(lambda x: x[r], out)


def _assert_same(got, want, what=""):
    """Every tensor of two (nested) output tuples bit-equal, dtypes too."""
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
        np.testing.assert_allclose(np_of(getattr(got, name)),
                                   np_of(getattr(want, name)), rtol=0,
                                   atol=POSE_ATOL, err_msg=name)


# -- the fleet frame -----------------------------------------------------------

@pytest.mark.parametrize("h,w", [(H, W), (59, 85)])
def test_process_fleet_equals_the_rig_loop_and_jax(monkeypatch, h, w):
    frames, intr = _fleet(h, w)
    vs = _session(intr, h, w)
    for fleet in (frames[0], np.round(frames[0])):
        out = vs.process_fleet(fleet)
        assert tuple(out.features_l.desc.shape) == (3, 2, 48, 8)
        for r in range(3):
            _assert_same(_rig(out, r), vs.process_frame(fleet[r]), f"rig {r}")
    integer = np.round(frames[0])
    jo = _jax_session(intr, h, w).process_fleet(jnp.asarray(integer))
    feed_jax_pyramid(monkeypatch, JORBConfig(**dict(OCFG, height=h,
                                                    width=w)))
    to = vs.process_fleet(integer)
    k0 = vs.pipe.orb.features_per_level()[0]
    for r in range(3):
        n_edge = assert_stereo_parity(
            jax_rig(jo, r), _rig(to, r), k0, vs.pipe.orb.scale_factor,
            (0, 2), (1, 3), NO_DIFF, True, None, None)
        print(f"rig {r}: descriptors at a bin edge: {n_edge}")
    assert np_of(to.depth.valid).sum(-1).min() > 0


def test_run_fleet_stacks_process_fleet_steps():
    frames, intr = _fleet(n_rigs=2, n_frames=3)
    vs = _session(intr)
    got = vs.run_fleet(frames)
    assert tuple(got.matches.valid.shape) == (3, 2, 2, 48)
    for t in range(3):
        _assert_same(map_fields(lambda x: x[t], got),
                     vs.process_fleet(frames[t]), f"step {t}")
    with pytest.raises(ValueError, match="empty sequence"):
        vs.run_fleet(frames[:0])
    with pytest.raises(ValueError, match="rank-5"):
        vs.run_fleet(frames[0])


def test_list_input_equals_stacked_input():
    frames, intr = _fleet()
    vs = _session(intr)
    want = vs.process_fleet(frames[0])
    _assert_same(vs.process_fleet(list(frames[0])), want, "numpy list")
    _assert_same(vs.process_fleet(tuple(torch.from_numpy(f.copy())
                                        for f in frames[0])), want,
                 "tensor tuple")


def test_masked_fleet_equals_masked_frames_and_jax(monkeypatch):
    """Rig 1's back pair dead, rig 2 all dead: the per-rig masked frames
    bit for bit (the dead rig's outputs finite, nothing valid), and the
    JAX masked fleet by the parity rule."""
    frames, intr = _fleet()
    integer = np.round(frames[0])
    mask = np.array([[True] * 4, [True, True, False, False], [False] * 4])
    vs = _session(intr)
    out = vs.process_fleet(integer, camera_mask=mask)
    for r in range(3):
        _assert_same(_rig(out, r),
                     vs.process_frame(integer[r], camera_mask=mask[r]),
                     f"rig {r}")
    _assert_same(vs.process_fleet(integer, camera_mask=np.ones((3, 4), bool)),
                 vs.process_fleet(integer), "all-true mask")
    for grp in ("features_l", "features_r", "matches", "depth"):
        assert not np_of(getattr(out, grp).valid)[2].any(), grp
        assert not np_of(getattr(out, grp).valid)[1, 1].any(), grp
    for t in (out.features_l.xy, out.features_l.theta, out.depth.depth,
              out.depth.disparity, out.depth.xy_right):
        assert torch.isfinite(t).all()
    jo = _jax_session(intr).process_fleet(jnp.asarray(integer),
                                          camera_mask=jnp.asarray(mask))
    feed_jax_pyramid(monkeypatch, JORBConfig(**OCFG))
    to = vs.process_fleet(integer, camera_mask=mask)
    k0 = vs.pipe.orb.features_per_level()[0]
    for r in range(3):
        assert_stereo_parity(jax_rig(jo, r), _rig(to, r), k0,
                             vs.pipe.orb.scale_factor, (0, 2), (1, 3),
                             NO_DIFF, True, None, None)
    for grp in ("features_l", "features_r", "matches", "depth"):
        np.testing.assert_array_equal(np_of(getattr(to, grp).valid),
                                      np.asarray(getattr(jo, grp).valid))


def test_timestamp_policies_per_rig():
    frames, intr = _fleet(n_rigs=2)
    fleet = np.round(frames[0])
    late = np.array([[0.0] * 4, [0.0, 0.0, 0.0, 1e-3]])
    # raise names the rig, as the JAX session's message does
    with pytest.raises(DesyncError, match="fleet rig 1") as terr:
        _session(intr).process_fleet(fleet, timestamps=late)
    with pytest.raises(JDesyncError, match="fleet rig 1") as jerr:
        _jax_session(intr).process_fleet(jnp.asarray(fleet),
                                         timestamps=late)
    assert str(terr.value) == str(jerr.value)
    # drop_frame masks the whole rig
    drop = _session(intr, rig=RigConfig.quad(intr, desync_policy="drop_frame",
                                             max_desync=1e-4))
    got = drop.process_fleet(fleet, timestamps=late)
    dead = np.array([[True] * 4, [False] * 4])
    _assert_same(got, drop.process_fleet(fleet, camera_mask=dead), "drop")
    assert list(drop.desync_log) == [0.0, 1e-3]
    # degrade ANDs its keep-mask into the caller's mask
    deg = _session(intr, rig=RigConfig.quad(intr, desync_policy="degrade",
                                            max_desync=1e-4))
    caller = np.array([[True, True, False, True], [True] * 4])
    got = deg.process_fleet(fleet, timestamps=late, camera_mask=caller)
    want = np.array([[True, True, False, True], [True, True, True, False]])
    _assert_same(got, deg.process_fleet(fleet, camera_mask=want), "degrade")
    assert np_of(got.matches.valid)[1, 0].any()
    assert not np_of(got.matches.valid)[:, 1].any()


@pytest.mark.parametrize("case", ["mask", "mismatched", "timestamps",
                                  "rank", "cameras"])
def test_fleet_shape_errors_match_jax(case):
    frames, intr = _fleet(n_rigs=2)
    fleet = frames[0]
    calls = {
        "mask": lambda m: m.process_fleet(
            fleet, camera_mask=np.ones((3, 4), bool)),
        "mismatched": lambda m: m.process_fleet(
            [fleet[0], fleet[1][:2]]),
        "timestamps": lambda m: m.process_fleet(
            fleet, timestamps=np.zeros((2, 3))),
        "rank": lambda m: m.process_fleet(fleet[0]),
        "cameras": lambda m: m.process_fleet(fleet[:, :3]),
    }
    with pytest.raises(ValueError) as jerr:
        calls[case](_jax_session(intr))
    with pytest.raises(ValueError) as terr:
        calls[case](_session(intr))
    assert str(terr.value).split(";")[0] == str(jerr.value).split(";")[0]
    if case == "mismatched":
        assert "(4, 64, 96), (2, 64, 96)" in str(terr.value)


def test_heterogeneous_intrinsics_fleet():
    """A rig with per-camera intrinsics tiles its (n_pairs,) column of
    fx * baseline across the fleet (as the JAX session's ``_fm_intr``
    does), and each rig's depth equals its frame's."""
    frames, intr = _fleet(n_rigs=2)
    cams = [intr, intr,
            CameraIntrinsics(fx=intr.fx * 1.1, fy=intr.fy, cx=intr.cx,
                             cy=intr.cy, baseline=0.25), intr]
    rig = RigConfig(n_cameras=4, pairs=((0, 1), (2, 3)),
                    intrinsics=tuple(cams))
    jrig = JRigConfig(n_cameras=4, pairs=((0, 1), (2, 3)),
                      intrinsics=tuple(_jintr(c) for c in cams))
    jvs = JVisualSystem(jrig, JPipelineConfig(orb=JORBConfig(**OCFG),
                                              impl="ref"))
    vs = _session(intr, rig=rig)
    assert not vs.rig.homogeneous_intrinsics
    np.testing.assert_array_equal(vs._fm_intr(2).numpy(),
                                  np.asarray(jvs._fm_intr(2)))
    for li, jli in zip(vs._flat_pair_indices(3), jvs._flat_pair_indices(3)):
        np.testing.assert_array_equal(li.numpy(), np.asarray(jli))
    fleet = np.round(frames[0])
    out = vs.process_fleet(fleet)
    for r in range(2):
        _assert_same(_rig(out, r), vs.process_frame(fleet[r]), f"rig {r}")
    assert np_of(out.depth.valid)[:, 1].any()


# -- the uint8 fleet -------------------------------------------------------------

def test_uint8_fleet_equals_f32_fleet():
    frames, intr = _fleet(n_rigs=2, n_frames=2)
    fleet = np.round(frames)
    u8 = _session(intr, precision="uint8")
    f32 = _session(intr)
    _assert_same(u8.process_fleet(fleet[0].astype(np.uint8)),
                 f32.process_fleet(fleet[0]), "process_fleet")
    _assert_same(u8.run_fleet(fleet.astype(np.uint8)),
                 f32.run_fleet(fleet), "run_fleet")


@pytest.mark.parametrize("entry", ["process_fleet", "run_fleet"])
def test_fleet_dtype_errors_name_the_precision(entry):
    _, intr = _fleet()
    lead = (1, 2) if entry == "run_fleet" else (2,)
    f32 = np.zeros(lead + (4, H, W), np.float32)
    u8 = np.zeros(lead + (4, H, W), np.uint8)
    vs_u, vs_f = _session(intr, precision="uint8"), _session(intr)
    with pytest.raises(TypeError, match="precision='uint8'"):
        getattr(vs_u, entry)(f32)
    with pytest.raises(TypeError, match="precision='f32'"):
        getattr(vs_f, entry)(u8)
    tensor = torch.from_numpy(f32)
    with pytest.raises(TypeError, match="precision='uint8'"):
        getattr(vs_u, entry)(list(tensor) if entry == "process_fleet"
                             else tensor)
    assert getattr(vs_u, entry)(u8) is not None


# -- fleet localization ----------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _jax_loc():
    """The JAX session's localized fleet: two ``process_fleet`` steps
    (with the state after step 0) and a ``run_fleet``, on the JAX
    pyramid the port is fed."""
    frames, intr = _loc_fleet()
    jvs = JVisualSystem(JRigConfig.quad(_jintr(intr)),
                        JPipelineConfig(orb=JORBConfig(**LOC_OCFG),
                                        impl="ref", localize=True))
    steps = [jvs.process_fleet(jnp.asarray(frames[t])) for t in range(2)]
    return steps, jloc.state_from(steps[0]), jvs.run_fleet(
        jnp.asarray(frames))


def _assert_points(jo, to, intr):
    """The port's fleet points bit-equal to JAX's ``rig_points`` run
    eagerly on the port's features and depths; against the JAX
    session's own points (its jitted graph rounds the back-projection
    differently), within 2 ulp wherever the two depths agree."""
    eager = jgeometry.rig_points(jnp.asarray(np_of(to.features_l.xy)),
                                 jnp.asarray(np_of(to.depth.depth)),
                                 JRigConfig.quad(_jintr(intr)))
    np.testing.assert_array_equal(np_of(to.points), np.asarray(eager))
    same = np_of(to.depth.depth) == np.asarray(jo.depth.depth)
    ulp = ulp_diff(np_of(to.points), np.asarray(jo.points))[same]
    print(f"points off JAX's jitted ones: {int((ulp > 0).sum())} of "
          f"{ulp.size} coordinates, at most {ulp.max(initial=0)} ulp")
    assert ulp.max(initial=0) <= 2


def _assert_frontend_parity(jo, to, cfg):
    k0 = cfg.features_per_level()[0]
    for r in range(jo.stereo.matches.valid.shape[0]):
        assert_stereo_parity(jax_rig(jo.stereo, r), _rig(to.stereo, r), k0,
                             cfg.scale_factor, (0, 2), (1, 3), NO_DIFF,
                             True, None, None)


def test_localized_process_fleet_matches_loop_and_jax(monkeypatch):
    frames, intr = _loc_fleet()
    vs = _loc_session(intr)
    loop = [_loc_session(intr) for _ in range(2)]
    for t in range(2):
        with ops.launch_audit() as audit:
            got = vs.process_fleet(frames[t])
        assert audit.count == 0               # plain versions on the CPU
        assert isinstance(got, LocalizationOutput)
        assert tuple(got.points.shape) == (2, 2, 48, 3)
        for r in range(2):
            want = loop[r].process_frame(frames[t, r])
            _assert_same(_rig(got.stereo, r), want.stereo, f"{t}/{r}")
            assert torch.equal(got.points[r], want.points)
            _assert_pose_close(_rig(got.pose, r), want.pose)
    assert got.pose.valid.tolist() == [True, True]
    steps, _, _ = _jax_loc()
    feed_jax_pyramid(monkeypatch, JORBConfig(**LOC_OCFG))
    vs.reset_localization()
    for t in range(2):
        to = vs.process_fleet(frames[t])
        _assert_frontend_parity(steps[t], to, vs.pipe.orb)
        _assert_points(steps[t], to, intr)
        _assert_pose_close(to.pose, steps[t].pose)


def test_localized_run_fleet_matches_process_fleet_and_jax(monkeypatch):
    frames, intr = _loc_fleet()
    vs = _loc_session(intr)
    with ops.launch_audit() as audit:
        run = vs.run_fleet(frames)
    assert audit.count == 0
    assert tuple(run.pose.rotation.shape) == (3, 2, 3, 3)
    assert run.pose.valid.tolist() == [[False, False], [True, True],
                                       [True, True]]
    assert vs._loc_state == {}          # run_fleet keeps no state
    for t in range(3):
        step = vs.process_fleet(frames[t])
        _assert_same(map_fields(lambda x: x[t], run.stereo), step.stereo,
                     f"step {t}")
        assert torch.equal(run.points[t], step.points)
        _assert_pose_close(map_fields(lambda x: x[t], run.pose), step.pose)
    _, _, jrun = _jax_loc()
    feed_jax_pyramid(monkeypatch, JORBConfig(**LOC_OCFG))
    to = vs.run_fleet(frames)
    for t in range(3):
        _assert_frontend_parity(jax_rig(jrun, t), _rig(to, t), vs.pipe.orb)
    _assert_points(jrun, to, intr)
    _assert_pose_close(to.pose, jrun.pose)


def test_jax_fleet_state_as_prev(monkeypatch):
    """A JAX fleet state carried across by ``convert`` and passed as
    ``prev`` gives the JAX session's next pose."""
    frames, intr = _loc_fleet()
    steps, state, _ = _jax_loc()
    prev = convert.localization_state_from_reference(
        {k: np.asarray(v) for k, v in state._asdict().items()})
    assert tuple(prev.points.shape) == (2, 2, 48, 3)
    np.testing.assert_array_equal(desc_u32(prev.desc), np.asarray(state.desc))
    feed_jax_pyramid(monkeypatch, JORBConfig(**LOC_OCFG))
    vs = _loc_session(intr)
    got = vs.process_fleet(frames[1], prev=prev)
    _assert_pose_close(got.pose, steps[1].pose)
    # the stored state is the port's own: the next step chains from it
    assert torch.equal(vs._loc_state[("fleet", 2)].points, got.points)


def test_zero_state_keyed_state_and_reset():
    frames, intr = _loc_fleet()
    for n_rigs in (None, 3):
        jz = jloc.zero_state(2, 48, n_rigs)
        tz = localization.zero_state(2, 48, n_rigs)
        for name in jz._fields:
            a, b = np.asarray(getattr(jz, name)), np_of(getattr(tz, name))
            assert a.shape == b.shape and not b.any(), name
    vs = _loc_session(intr)
    # a frame and a fleet in one session keep their own previous state
    vs.process_fleet(frames[0])
    vs.process_frame(frames[0, 1])
    fleet = vs.process_fleet(frames[1])
    frame = vs.process_frame(frames[1, 1])
    assert set(vs._loc_state) == {"frame", ("fleet", 2)}
    assert bool(frame.pose.valid) and fleet.pose.valid.all()
    _assert_pose_close(_rig(fleet.pose, 1), frame.pose)
    vs.reset_localization()
    assert vs._loc_state == {}
    again = vs.process_fleet(frames[1])
    assert not again.pose.valid.any()
    np.testing.assert_array_equal(again.pose.rotation.numpy(),
                                  np.broadcast_to(np.eye(3), (2, 3, 3)))
    zero = localization.zero_state(2, 48, 2)
    assert not vs.process_fleet(frames[2], prev=zero).pose.valid.any()


def test_fleet_prev_validation_matches_jax():
    frames, intr = _loc_fleet()
    jvs = JVisualSystem(JRigConfig.quad(_jintr(intr)),
                        JPipelineConfig(orb=JORBConfig(**LOC_OCFG),
                                        impl="ref", localize=True))
    vs = _loc_session(intr)
    with pytest.raises(ValueError, match="n_rigs") as jerr:
        jvs.process_fleet(jnp.asarray(frames[0]),
                          prev=jloc.zero_state(2, 48, 3))
    with pytest.raises(ValueError, match="n_rigs") as terr:
        vs.process_fleet(frames[0], prev=localization.zero_state(2, 48, 3))
    assert str(terr.value) == str(jerr.value)


# -- data, conversion, limits ------------------------------------------------------

def test_render_fleet_sequence_matches_jax():
    cfg = dict(height=H, width=W, baseline=0.5, seed=1)
    want = jscenes.render_fleet_sequence(jscenes.SceneConfig(**cfg), 2, 3)
    got = scenes.render_fleet_sequence(scenes.SceneConfig(**cfg), 2, 3)
    assert got.frames.shape == (2, 3, 4, H, W)
    np.testing.assert_array_equal(got.frames, np.asarray(want.frames))
    assert got.intrinsics == scenes.default_intrinsics(
        scenes.SceneConfig(**cfg))
    for rg, rw in zip(got.poses, want.poses):
        for (a, b), (c, d) in zip(rg, rw):
            np.testing.assert_array_equal(a, np.asarray(c))
            np.testing.assert_array_equal(b, np.asarray(d))
    np.testing.assert_array_equal(got.frames[1, 0], got.frames[0, 1])
    with pytest.raises(ValueError, match="n_rigs"):
        scenes.render_fleet_sequence(scenes.SceneConfig(**cfg), 2, 0)


def test_rig_shard_axis_names_roadmap_a12():
    d = dataclasses.asdict(JPipelineConfig(orb=JORBConfig(**OCFG),
                                           rig_shard_axis="data"))
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        convert.pipeline_config_from_reference(d)
    d["rig_shard_axis"] = None
    assert convert.pipeline_config_from_reference(d) == PipelineConfig(
        orb=ORBConfig(**OCFG))


@pytest.mark.parametrize("hw", [(H, W), (720, 1280)])
def test_pyramid_levels_do_not_depend_on_the_batch(hw):
    """A rig's frame and the same rig inside a fleet build their levels
    in batches of 4 and 4 * n_rigs images: each image's levels are the
    same bits in a batch of 1, 4 or 8 (the resize sums each output
    alone, in one fixed order)."""
    from repro_torch.core import pyramid
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.random((8, *hw)) * 255).astype(np.float32))
    cfg = ORBConfig(height=hw[0], width=hw[1])
    whole = pyramid.build_pyramid_batched(x, cfg)
    for n in (1, 4):
        for lo in range(0, 8, n):
            part = pyramid.build_pyramid_batched(x[lo:lo + n], cfg)
            for a, b in zip(part, whole):
                assert torch.equal(a, b[lo:lo + n])
