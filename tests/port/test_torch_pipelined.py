"""The pipelined schedule (``PipelineConfig(schedule="pipelined")``, the
paper's Fig. 4: FE(t) overlapping FM(t - 1)) on the CPU, where it runs
the JAX package's order (prologue FE(0), steps FM(t - 1) then FE(t),
drain FM(T - 1)) in one thread; on a card it runs FE and FM on two
streams (``test_torch_cuda.py``, ``chip_smoke.py``).

Held two ways:

* against the port's own sequential schedule: every field bit-equal,
  dtypes too (the same stages on the same tensors), at T = 1 and 3, on
  the quad rig and a 2-rig fleet, f32, uint8 and localized;
* against the JAX package's pipelined session (``impl="ref"``) on the
  inputs of its own pipelined tests (``tests/test_frontend.py``,
  ``tests/test_visual_system.py``, ``tests/test_shims.py``), rounded to
  integer values, by the rule of the port's sequential parity tests:
  ``parity.assert_stereo_parity`` (theta within 1 ulp, descriptors at a
  steering-bin edge exempt), with the port fed the JAX pyramid's levels
  on a 2-level pyramid (``parity.feed_jax_pyramid``).

T == 0 raises ``ValueError`` "empty sequence" on both schedules and
through the legacy shim, as in the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontend as jfrontend
from repro.core.pipeline import PipelineConfig as JPipelineConfig
from repro.core.pipeline import VisualSystem as JVisualSystem
from repro.core.rig import RigConfig as JRigConfig
from repro.core.types import CameraIntrinsics as JCameraIntrinsics
from repro.core.types import ORBConfig as JORBConfig
from repro_torch import convert
from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                              VisualSystem, frontend)
from repro_torch.core.types import (CameraIntrinsics, LocalizationOutput,
                                    map_fields)
from repro_torch.data import scenes
from repro_torch.kernels import ops

from parity import assert_stereo_parity, feed_jax_pyramid

H, W = 64, 96
OCFG = dict(height=H, width=W, max_features=48, max_disparity=48)
NO_DIFF = [np.zeros((0, 2), int)] * 4
PORT_WARNING = r"^repro_torch\.core\.frontend\.run_sequence_pipelined"


def _fleet():
    """(3, 2, 4, 64, 96) integer-valued frames of a rendered 2-rig fleet
    and their intrinsics."""
    seq = scenes.render_fleet_sequence(scenes.SceneConfig(
        height=H, width=W, n_points=300, baseline=0.3), 3, 2)
    return np.round(seq.frames), seq.intrinsics


def _assert_same(got, want, what=""):
    """Every tensor of two (nested) output tuples bit-equal, dtypes too."""
    assert type(got) is type(want), what
    for name, x, y in zip(getattr(got, "_fields", range(len(got))), got,
                          want):
        if isinstance(x, tuple):
            _assert_same(x, y, f"{what}.{name}")
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), f"{what}.{name}"


def _jintr(intr):
    return JCameraIntrinsics(**dataclasses.asdict(intr))


def _imgs(seed, *shape):
    """The JAX session tests' random integer-valued frames."""
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.float32)


# -- against the port's sequential schedule -------------------------------------

@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("fleet", [False, True], ids=["quad", "fleet"])
@pytest.mark.parametrize("precision,localize", [
    ("f32", False), ("uint8", False), ("f32", True), ("uint8", True)])
def test_pipelined_equals_sequential(precision, localize, fleet, t):
    frames, intr = _fleet()
    frames = frames[:t] if fleet else frames[:t, 0]
    if precision == "uint8":
        frames = frames.astype(np.uint8)
    sessions = [VisualSystem(
        RigConfig.quad(intr),
        PipelineConfig(orb=ORBConfig(**OCFG), schedule=s,
                       precision=precision, localize=localize),
        device="cpu") for s in ("sequential", "pipelined")]
    entry = "run_fleet" if fleet else "run"
    want = getattr(sessions[0], entry)(frames)
    with ops.launch_audit() as audit:
        got = getattr(sessions[1], entry)(frames)
    assert audit.count == 0                   # plain versions on the CPU
    lead = (t, 2, 2) if fleet else (t, 2)
    stereo = got.stereo if localize else got
    assert isinstance(got, LocalizationOutput) == localize
    assert tuple(stereo.matches.valid.shape) == lead + (48,)
    _assert_same(got, want, f"{entry} {precision}")
    assert sessions[1]._loc_state == {}       # a sequence keeps no state


def test_pipelined_schedule_takes_the_cpu_path_without_streams():
    frames, intr = _fleet()
    vs = VisualSystem(RigConfig.quad(intr),
                      PipelineConfig(orb=ORBConfig(**OCFG),
                                     schedule="pipelined"), device="cpu")
    vs.run(frames[:2, 0])
    assert vs._streams is None


def test_pipelined_config_constructs_with_every_option():
    for precision in ("f32", "uint8"):
        for localize in (False, True):
            cfg = PipelineConfig(orb=ORBConfig(**OCFG), schedule="pipelined",
                                 precision=precision, localize=localize)
            assert cfg.schedule == "pipelined"
    with pytest.raises(ValueError, match="schedule"):
        PipelineConfig(schedule="multiplexed")


# -- against the JAX package's pipelined schedule ---------------------------------

@pytest.mark.parametrize("t", [1, 3])
def test_pipelined_run_matches_jax(t):
    """``tests/test_frontend.py``'s pipelined sequence (96 x 128, a
    1-level pyramid, 48 features), rounded to integer values."""
    scene = scenes.SceneConfig(height=96, width=128, n_points=60, seed=4)
    seq = scenes.render_sequence(scene, t)
    frames = np.round(seq.frames)
    ocfg = dict(height=96, width=128, max_features=48, n_levels=1,
                max_disparity=48)
    jvs = JVisualSystem(JRigConfig.quad(_jintr(seq.intrinsics)),
                        JPipelineConfig(orb=JORBConfig(**ocfg), impl="ref",
                                        schedule="pipelined"))
    vs = VisualSystem(RigConfig.quad(seq.intrinsics),
                      PipelineConfig(orb=ORBConfig(**ocfg),
                                     schedule="pipelined"), device="cpu")
    jo, to = jvs.run(jnp.asarray(frames)), vs.run(frames)
    assert to.matches.valid.shape[0] == t
    for s in range(t):
        assert_stereo_parity(jax.tree.map(lambda x: x[s], jo),
                             map_fields(lambda x: x[s], to), 48,
                             vs.pipe.orb.scale_factor,
                             (0, 2), (1, 3), NO_DIFF, True, None, None)
    assert int(to.depth.valid.sum()) > 0


def test_pipelined_run_fleet_matches_jax(monkeypatch):
    """``tests/test_visual_system.py``'s pipelined fleet (3 steps of 2
    rigs of random integer frames at 64 x 96, 16 features over 2
    levels), the port fed the JAX pyramid's levels."""
    frames = _imgs(8, 3, 2, 4, 64, 96)
    ocfg = dict(height=64, width=96, max_features=16, n_levels=2,
                max_disparity=32)
    intr = CameraIntrinsics(cx=48.0, cy=32.0)
    jvs = JVisualSystem(JRigConfig.quad(_jintr(intr)),
                        JPipelineConfig(orb=JORBConfig(**ocfg), impl="ref",
                                        schedule="pipelined"))
    vs = VisualSystem(RigConfig.quad(intr),
                      PipelineConfig(orb=ORBConfig(**ocfg),
                                     schedule="pipelined"), device="cpu")
    jo = jvs.run_fleet(jnp.asarray(frames))
    feed_jax_pyramid(monkeypatch, JORBConfig(**ocfg))
    to = vs.run_fleet(frames)
    assert tuple(to.matches.valid.shape) == (3, 2, 2, 16)
    k0 = vs.pipe.orb.features_per_level()[0]
    for s in range(3):
        for r in range(2):
            assert_stereo_parity(jax.tree.map(lambda x: x[s, r], jo),
                                 map_fields(lambda x: x[s, r], to), k0,
                                 vs.pipe.orb.scale_factor, (0, 2), (1, 3),
                                 NO_DIFF, True, None, None)


@pytest.mark.parametrize("t", [1, 3])
def test_run_sequence_pipelined_shim_matches_jax(monkeypatch, t):
    """``tests/test_shims.py``'s legacy pipelined shim (random integer
    frames at 64 x 96, 16 features over 2 levels): it warns, equals the
    port's sequential shim, and matches the JAX shim."""
    frames = _imgs(3 if t == 3 else 4, t, 4, 64, 96)
    kw = dict(height=64, width=96, max_features=16, n_levels=2,
              max_disparity=32)
    intr = CameraIntrinsics(cx=48.0, cy=32.0)
    with pytest.warns(DeprecationWarning, match=r"^repro\."):
        jo = jfrontend.run_sequence_pipelined(
            jnp.asarray(frames), JORBConfig(**kw), _jintr(intr), impl="ref")
    feed_jax_pyramid(monkeypatch, JORBConfig(**kw))
    cfg = ORBConfig(**kw)
    with pytest.warns(DeprecationWarning, match=PORT_WARNING):
        to = frontend.run_sequence_pipelined(frames, cfg, intr, device="cpu")
    with pytest.warns(DeprecationWarning):
        seq = frontend.run_sequence(frames, cfg, intr, device="cpu")
    _assert_same(to, seq, "pipelined shim vs sequential shim")
    assert to.matches.valid.shape[0] == t
    k0 = cfg.features_per_level()[0]
    for s in range(t):
        assert_stereo_parity(jax.tree.map(lambda x: x[s], jo),
                             map_fields(lambda x: x[s], to), k0,
                             cfg.scale_factor, (0, 2), (1, 3), NO_DIFF, True,
                             None, None)


@pytest.mark.parametrize("schedule", ["sequential", "pipelined"])
def test_empty_sequence_raises_on_both_schedules(schedule):
    frames, intr = _fleet()
    vs = VisualSystem(RigConfig.quad(intr),
                      PipelineConfig(orb=ORBConfig(**OCFG),
                                     schedule=schedule), device="cpu")
    jvs = JVisualSystem(JRigConfig.quad(_jintr(intr)),
                        JPipelineConfig(orb=JORBConfig(**OCFG), impl="ref",
                                        schedule=schedule))
    for session, xs in ((vs, frames), (jvs, jnp.asarray(frames))):
        with pytest.raises(ValueError, match="empty sequence"):
            session.run(xs[:0, 0])
        with pytest.raises(ValueError, match="empty sequence"):
            session.run_fleet(xs[:0])


def test_run_sequence_pipelined_shim_rejects_an_empty_sequence():
    frames, intr = _fleet()
    with pytest.warns(DeprecationWarning, match=PORT_WARNING), \
            pytest.raises(ValueError, match="empty sequence"):
        frontend.run_sequence_pipelined(frames[:0, 0], ORBConfig(**OCFG),
                                        intr, device="cpu")


def test_pipeline_config_from_reference_takes_pipelined():
    ref = JPipelineConfig(orb=JORBConfig(**OCFG), schedule="pipelined",
                          localize=True, impl="ref")
    got = convert.pipeline_config_from_reference(dataclasses.asdict(ref))
    assert got == PipelineConfig(orb=ORBConfig(**OCFG), schedule="pipelined",
                                 localize=True)
    d = dataclasses.asdict(ref)
    d["rig_shard_axis"] = "rigs"
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        convert.pipeline_config_from_reference(d)
