"""The legacy free-function API: the deprecation shims of
``core.matching`` (``stereo_match``, ``sad_rectify``,
``temporal_match``) and ``core.frontend`` (``extract_pair``,
``match_pair``, ``process_stereo_frame``, ``process_quad_frame``,
``run_sequence``, ``run_sequence_pipelined``), ``pipeline.session_for``,
``VisualSystem.check_desync`` and ``frontend.pipeline_schedule``,
against the JAX package's on the CPU (``device="cpu"``; JAX
``impl="ref"``), at 64 x 96 with a one-level pyramid.

The matcher shims take the same features on both sides and are
bit-equal.  The frame shims run the whole frontend on integer-valued
frames: keypoints, scores, flags, matches and depths bit-equal, theta
within 1 ulp and descriptors equal wherever the steering bins agree
(``parity.assert_stereo_parity``; one level, so no pyramid rule).
The JAX shims warn with ``repro.``-prefixed messages, which
``pytest.ini`` turns into errors, so each JAX shim call sits inside
``pytest.warns``."""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontend as jfrontend
from repro.core import matching as jmatching
from repro.core import rig as jrig
from repro.core import types as jtypes
from repro.core.pipeline import PipelineConfig as JPipelineConfig
from repro.core.pipeline import VisualSystem as JVisualSystem
from repro_torch.core import (DesyncError, ORBConfig, PipelineConfig,
                              RigConfig, VisualSystem, frontend, matching,
                              pipeline)
from repro_torch.core.types import map_fields

from parity import (assert_sparse_parity, assert_stereo_parity, desc_u32,
                    np_of, scene_frames)

H, W = 64, 96
CFG = dict(height=H, width=W, max_features=32, n_levels=1, max_disparity=48)
NO_DIFF = [np.zeros((0, 2), int)] * 4
PORT_WARNING = r"^repro_torch\.core\.(matching|frontend)\.\w+ is deprecated"
JAX_WARNING = r"^repro\."


def _jintr(intr):
    return jtypes.CameraIntrinsics(fx=intr.fx, fy=intr.fy, cx=intr.cx,
                                   cy=intr.cy, baseline=intr.baseline)


@functools.lru_cache(maxsize=None)
def _inputs():
    """Integer-valued frames (the rendered quad frame and a shifted
    copy), the intrinsics, and the port's features of both frames from
    a CPU session (pair 0's left/right, and frame 1's left)."""
    frame, intr = scene_frames(H, W, 200, 0.3)
    frame = np.round(frame)
    frames = np.stack([frame, np.roll(frame, 3, axis=-1)])
    vs = VisualSystem(RigConfig.quad(intr),
                      PipelineConfig(orb=ORBConfig(**CFG)), device="cpu")
    f0, f1 = vs.extract(frames[0]), vs.extract(frames[1])
    fl, fr, fl1 = (map_fields(lambda x: x[c], f) for f, c in
                   ((f0, 0), (f0, 1), (f1, 0)))
    return frames, intr, fl, fr, fl1, vs.stereo_match(fl, fr)


def _jfeat(f):
    return jtypes.FeatureSet(*[jnp.asarray(desc_u32(x)) if n == "desc"
                               else jnp.asarray(np_of(x))
                               for n, x in zip(f._fields, f)])


def _port_calls():
    """Each shim's call on the port (device="cpu")."""
    frames, intr, fl, fr, fl1, m = _inputs()
    cfg = ORBConfig(**CFG)
    f, il, ir = frames[0], frames[0][0], frames[0][1]
    return {
        "stereo_match": lambda: matching.stereo_match(fl, fr, cfg, "cpu"),
        "sad_rectify": lambda: matching.sad_rectify(il, ir, fl, fr, m, cfg,
                                                    intr, device="cpu"),
        "temporal_match": lambda: matching.temporal_match(
            fl, fl1, cfg, 20.3, 4.7, device="cpu"),
        "extract_pair": lambda: frontend.extract_pair(il, ir, cfg, "cpu"),
        "match_pair": lambda: frontend.match_pair(il, ir, fl, fr, cfg, intr,
                                                  device="cpu"),
        "process_stereo_frame": lambda: frontend.process_stereo_frame(
            il, ir, cfg, intr, device="cpu"),
        "process_quad_frame": lambda: frontend.process_quad_frame(
            f, cfg, intr, device="cpu"),
        "run_sequence": lambda: frontend.run_sequence(frames, cfg, intr,
                                                      device="cpu"),
    }


def _session_calls():
    """The session method each shim delegates to, on a session of its
    own (the bit-exactness the shims promise)."""
    frames, intr, fl, fr, fl1, m = _inputs()
    cfg = ORBConfig(**CFG)

    def vs(n):
        return VisualSystem(RigConfig(n_cameras=n,
                                      pairs=((0, 1), (2, 3))[:n // 2],
                                      intrinsics=intr),
                            PipelineConfig(orb=cfg), device="cpu")

    f, il, ir = frames[0], frames[0][0], frames[0][1]
    return {
        "stereo_match": lambda: vs(2).stereo_match(fl, fr),
        "sad_rectify": lambda: vs(2).sad_rectify(il, ir, fl, fr, m),
        "temporal_match": lambda: vs(2).temporal_match(fl, fl1, 20.3, 4.7),
        "extract_pair": lambda: tuple(
            map_fields(lambda x: x[c], vs(2).extract(f[:2])) for c in (0, 1)),
        "match_pair": lambda: vs(2).match_pair(il, ir, fl, fr),
        "process_stereo_frame": lambda: map_fields(
            lambda x: x[0], vs(2).process_frame(f[:2])),
        "process_quad_frame": lambda: vs(4).process_frame(f),
        "run_sequence": lambda: vs(4).run(frames),
    }


def _np_tree(t, fn=np.asarray):
    """A (nested) output tuple with ``fn`` applied to every array."""
    items = [_np_tree(x, fn) if isinstance(x, tuple) else fn(x) for x in t]
    return type(t)(*items) if hasattr(t, "_fields") else tuple(items)


@pytest.fixture(scope="module")
def jax_shims():
    """Every JAX shim's output on the same inputs, as numpy trees."""
    frames, intr, fl, fr, fl1, m = _inputs()
    cfg, jintr = jtypes.ORBConfig(**CFG), _jintr(intr)
    jfl, jfr, jfl1 = _jfeat(fl), _jfeat(fr), _jfeat(fl1)
    jm = jtypes.MatchSet(*[jnp.asarray(np_of(x)) for x in m])
    f = jnp.asarray(frames[0])
    calls = {
        "stereo_match": lambda: jmatching.stereo_match(jfl, jfr, cfg, "ref"),
        "sad_rectify": lambda: jmatching.sad_rectify(
            f[0], f[1], jfl, jfr, jm, cfg, jintr, impl="ref"),
        "temporal_match": lambda: jmatching.temporal_match(
            jfl, jfl1, cfg, 20.3, 4.7, impl="ref"),
        "extract_pair": lambda: jfrontend.extract_pair(f[0], f[1], cfg,
                                                       "ref"),
        "match_pair": lambda: jfrontend.match_pair(f[0], f[1], jfl, jfr, cfg,
                                                   jintr, impl="ref"),
        "process_stereo_frame": lambda: jfrontend.process_stereo_frame(
            f[0], f[1], cfg, jintr, impl="ref"),
        "process_quad_frame": lambda: jfrontend.process_quad_frame(
            f, cfg, jintr, impl="ref"),
        "run_sequence": lambda: jfrontend.run_sequence(
            jnp.asarray(frames), cfg, jintr, impl="ref"),
    }
    out = {}
    for name, call in calls.items():
        with pytest.warns(DeprecationWarning, match=JAX_WARNING):
            out[name] = _np_tree(call())
    return out


SHIMS = ["stereo_match", "sad_rectify", "temporal_match", "extract_pair",
         "match_pair", "process_stereo_frame", "process_quad_frame",
         "run_sequence"]


def _assert_equal(got, want, what):
    for a, b in zip(_np_tree(got, np_of), want):
        if isinstance(b, tuple):
            _assert_equal(a, b, what)
        else:
            np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name", SHIMS)
def test_shim_warns_and_delegates_to_the_session(name):
    with pytest.warns(DeprecationWarning, match=PORT_WARNING) as rec:
        got = _port_calls()[name]()
    assert any(name in str(w.message) for w in rec)
    _assert_equal(got, _np_tree(_session_calls()[name](), np_of), name)


def test_run_sequence_pipelined_warns_and_equals_run_sequence():
    """The pipelined shim warns, runs the "pipelined" session of
    ``session_for`` and equals the sequential shim bit for bit."""
    frames, intr, *_ = _inputs()
    cfg = ORBConfig(**CFG)
    with pytest.warns(DeprecationWarning, match=PORT_WARNING):
        got = frontend.run_sequence_pipelined(frames, cfg, intr,
                                              device="cpu")
    with pytest.warns(DeprecationWarning, match=PORT_WARNING):
        want = frontend.run_sequence(frames, cfg, intr, device="cpu")
    assert pipeline.session_for(cfg, intr, 4, "pipelined",
                                "cpu").pipe.schedule == "pipelined"
    assert got.matches.valid.shape[0] == frames.shape[0]
    _assert_equal(got, _np_tree(want, np_of),
                  "pipelined shim vs run_sequence")


def _features_parity(want, got):
    """One camera's FeatureSet under the sparse-FE rule (integer frames:
    no moments in a FeatureSet, so those are zeros on both sides)."""
    for name in ("xy", "level", "score", "valid"):
        np.testing.assert_array_equal(np_of(getattr(got, name)),
                                      getattr(want, name), err_msg=name)
    zeros = np.zeros(want.theta.shape + (2,), np.float32)
    return assert_sparse_parity(want.theta, zeros, want.desc,
                                np_of(got.theta), zeros, np_of(got.desc),
                                None, integer=True)


@pytest.mark.parametrize("name", SHIMS)
def test_shim_matches_the_jax_shim(jax_shims, name):
    with pytest.warns(DeprecationWarning, match=PORT_WARNING):
        got = _port_calls()[name]()
    want = jax_shims[name]
    k0 = ORBConfig(**CFG).features_per_level()[0]
    if name == "extract_pair":
        for w, g in zip(want, got):
            _features_parity(w, g)
    elif name == "process_stereo_frame":
        assert_stereo_parity(_np_tree(want, lambda x: np.asarray(x)[None]),
                             map_fields(lambda x: x[None], got), k0, 1.0,
                             (0,), (1,), NO_DIFF, True, None, None)
    elif name == "process_quad_frame":
        assert_stereo_parity(want, got, k0, 1.0, (0, 2), (1, 3), NO_DIFF,
                             True, None, None)
    elif name == "run_sequence":
        for t in range(2):
            assert_stereo_parity(_np_tree(want, lambda x: x[t]),
                                 map_fields(lambda x: x[t], got), k0, 1.0,
                                 (0, 2), (1, 3), NO_DIFF, True, None, None)
    else:
        _assert_equal(got, want, name)
    if name in ("process_quad_frame", "run_sequence"):
        assert np_of(got.depth.valid).sum() > 0


def test_session_for_caches_one_session_per_configuration():
    _, intr, *_ = _inputs()
    cfg = ORBConfig(**CFG)
    vs = pipeline.session_for(cfg, intr, 4, device="cpu")
    assert vs is pipeline.session_for(cfg, intr, 4, device=torch.device("cpu"))
    assert vs is matching._shim_session(cfg, intr, "cpu", 4)
    assert vs.rig.pairs == ((0, 1), (2, 3)) and vs.device.type == "cpu"
    assert vs.pipe.orb == cfg and vs.pipe.schedule == "sequential"
    two = pipeline.session_for(cfg, None, device="cpu")
    assert two is not vs and two.rig.pairs == ((0, 1),)
    assert pipeline.session_for(cfg, intr, 2, device="cpu") is not two


@pytest.mark.parametrize("rig_kwargs,ts", [
    (dict(), [0.0, 0.0, 0.0, 0.0]),
    (dict(), [0.0, 0.0, 0.0, 1e-3]),
    (dict(max_desync=2e-3), [0.0, 0.0, 0.0, 1e-3]),
    (dict(sync_policy="software"), [0.0, 0.0, 0.0, 1e-3]),
], ids=["in_sync", "hardware_beyond", "hardware_within", "software"])
def test_check_desync_matches_jax(rig_kwargs, ts):
    """The strict legacy form: a hardware rig beyond ``max_desync``
    raises ``DesyncError``; otherwise the spread returns (and is
    logged)."""
    _, intr, *_ = _inputs()
    jvs = JVisualSystem(jrig.RigConfig.quad(_jintr(intr), **rig_kwargs),
                        JPipelineConfig(orb=jtypes.ORBConfig(**CFG),
                                        impl="ref"))
    vs = VisualSystem(RigConfig.quad(intr, **rig_kwargs),
                      PipelineConfig(orb=ORBConfig(**CFG)), device="cpu")
    try:
        want = jvs.check_desync(ts)
    except jrig.DesyncError:
        with pytest.raises(DesyncError, match="desync"):
            vs.check_desync(ts)
        assert rig_kwargs == {} and max(ts) > 0
    else:
        assert vs.check_desync(ts) == want
    assert list(vs.desync_log) == list(jvs.desync_log)


@pytest.mark.parametrize("n_frames,t_fe,t_fm", [
    (1, 2.0, 3.0), (5, 1.5, 4.0), (4, 3.0, 1.0)])
def test_pipeline_schedule_matches_jax(n_frames, t_fe, t_fm):
    assert (frontend.pipeline_schedule(n_frames, t_fe, t_fm)
            == jfrontend.pipeline_schedule(n_frames, t_fe, t_fm))


@pytest.mark.parametrize("entry", ["process_frame", "run", "extract",
                                   "match_pair", "stereo_match",
                                   "temporal_match", "sad_rectify",
                                   "match_pair_unfused"])
def test_session_and_engine_route_through_no_shim(entry):
    """No port internal goes through a deprecated shim: the session's
    entry points and the unfused engine warn nothing."""
    frames, intr, fl, fr, fl1, m = _inputs()
    cfg = ORBConfig(**CFG)
    vs = VisualSystem(RigConfig.quad(intr), PipelineConfig(orb=cfg),
                      device="cpu")
    il, ir = (torch.from_numpy(frames[0][c].copy()) for c in (0, 1))
    call = {
        "process_frame": lambda: vs.process_frame(frames[0]),
        "run": lambda: vs.run(frames),
        "extract": lambda: vs.extract(frames[0]),
        "match_pair": lambda: vs.match_pair(il, ir, fl, fr),
        "stereo_match": lambda: vs.stereo_match(fl, fr),
        "temporal_match": lambda: vs.temporal_match(fl, fl1),
        "sad_rectify": lambda: vs.sad_rectify(il, ir, fl, fr, m),
        "match_pair_unfused": lambda: matching.match_pair_unfused(
            il, ir, fl, fr, cfg, intr),
    }[entry]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        call()
    assert not [w for w in caught
                if issubclass(w.category, DeprecationWarning)]


def test_split_cameras_matches_jax():
    """[L, R, L, R] camera batch -> (left, right) pair batches."""
    frames, intr, *_ = _inputs()
    vs = VisualSystem(RigConfig.quad(intr),
                      PipelineConfig(orb=ORBConfig(**CFG)), device="cpu")
    feats = vs.extract(frames[0])
    got = frontend._split_cameras(feats, 2)
    want = jfrontend._split_cameras(_jfeat(feats), 2)
    for g, w in zip(got, want):
        for name, a, b in zip(g._fields, g, w):
            np.testing.assert_array_equal(
                desc_u32(a) if name == "desc" else np_of(a), np.asarray(b),
                err_msg=name)
        assert tuple(g.valid.shape) == (2, feats.valid.shape[-1])
