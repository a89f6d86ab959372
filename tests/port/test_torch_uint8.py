"""The uint8 datapath — ``PipelineConfig(precision="uint8")``, the
paper's 8-bit word length (Sec. III) — against the JAX package's
(``impl="ref"``) on identical inputs made with numpy from a seed, and
against the port's own float32 path on the same integer-valued input.

* the integer oracles of ``kernels.ref`` against their JAX twins on
  seeded uint8 images;
* the plain versions of the kernels with a uint8 variant (K1-K3, K5-K8)
  on uint8 input against the same plain versions on its float copy;
* ``build_pyramid_batched(precision="uint8")`` against the port's
  quantized float32 pyramid and the JAX package's uint8 pyramid;
* ``process_frame`` in a uint8 session against the JAX uint8 session and
  the port's f32 session, a localized uint8 ``run`` (T = 4) against both,
  and ``extract_features_per_level`` against ``extract_features_batched``;
* the error contracts of the JAX package's ``tests/test_precision.py``
  (config validation, dtype validation in both directions).

Against the JAX package the port runs on the JAX pyramid's levels
(``parity.feed_jax_pyramid``, as in ``test_torch_per_level.py``), so
every row of every level is compared.

Tolerances are ``parity.py``'s.  Blurs, scores, moments, keypoints,
levels, valid flags, matches, disparity and depth are bit-equal (integer
arithmetic, or the same float arithmetic on the same values).  Theta is
within 1 ulp of the JAX package's (XLA's atan2 against torch's, on the
same exact moments) and bit-equal to the port's float32 path (the same
atan2 on the same floats); descriptors equal wherever the steering bins
agree.  Poses within 1e-5, the pose tests' ``POSE_ATOL``.  The pyramid
against the JAX one: level 0 equal, resized levels within one grey
level on at most 0.1% of their pixels."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pyramid as jpyramid
from repro.core.pipeline import PipelineConfig as JPipelineConfig
from repro.core.pipeline import VisualSystem as JVisualSystem
from repro.core.rig import RigConfig as JRigConfig
from repro.core.types import CameraIntrinsics as JCameraIntrinsics
from repro.core.types import ORBConfig as JORBConfig
from repro.kernels import ref as jref
from repro_torch import convert
from repro_torch.core import (ORBConfig, PipelineConfig, RigConfig,
                              VisualSystem, extract_features_batched,
                              extract_features_per_level, pyramid)
from repro_torch.core.types import CameraIntrinsics
from repro_torch.data import scenes
from repro_torch.kernels import (describe_fused, frontend_fused,
                                 matcher_fused, ops, ref, sad_fused)
from repro_torch.kernels.ref import PATCH

from parity import (assert_sparse_parity, assert_stereo_parity, desc_u32,
                    feed_jax_pyramid, matcher_case, np_of, scene_frames)

H, W = 96, 128
OCFG = dict(height=H, width=W, max_features=64, max_disparity=64)
POSE_ATOL = 1e-5


def _u8(seed, shape):
    """Seeded uint8 images with corners: uniform noise under bright and
    dark squares."""
    rng = np.random.default_rng(seed)
    img = rng.integers(40, 90, shape).astype(np.uint8)
    for idx in np.ndindex(*shape[:-2]):
        for _ in range(shape[-2] * shape[-1] // 120):
            y = rng.integers(2, shape[-2] - 6)
            x = rng.integers(2, shape[-1] - 6)
            img[idx][y:y + 4, x:x + 4] = rng.integers(0, 256)
    return img


def _jintr(intr):
    return JCameraIntrinsics(**dataclasses.asdict(intr))


# -- the integer oracles against their JAX twins -----------------------------

def _keypoints(seed, k, h, w):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(-6, w + 6, k), rng.integers(-6, h + 6, k)],
                    -1).astype(np.int32)


def _oracle_case(name):
    img = _u8(1, (64, 96))
    t = torch.from_numpy(img)
    j = jnp.asarray(img)
    if name == "int_threshold":
        return ([ref.int_threshold(v) for v in (19.5, 20.0, -0.5)],
                [jref.int_threshold(v) for v in (19.5, 20.0, -0.5)])
    if name == "fast_score_map_int":
        return ref.fast_score_map_int(t, 20.0), jref.fast_score_map_int(j, 20.0)
    if name == "gaussian_blur7_u8":
        return ref.gaussian_blur7_u8(t), jref.gaussian_blur7_u8(j)
    if name.startswith("fast_blur_nms_int"):
        nms = name.endswith("nms")
        return (ref.fast_blur_nms_int(t, 19.5, nms=nms),
                jref.fast_blur_nms_int(j, 19.5, nms=nms))
    if name == "moment_grids_int":
        return ref.moment_grids_int(), jref.moment_grids_int()
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "int_threshold", "fast_score_map_int", "gaussian_blur7_u8",
    "fast_blur_nms_int-nms", "fast_blur_nms_int-raw", "moment_grids_int"])
def test_integer_oracle_matches_jax(name):
    got, want = _oracle_case(name)
    if isinstance(got, list):
        assert got == want
        return
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert np_of(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(np_of(g), np.asarray(w))


def test_patch_theta_int_matches_jax():
    patches = _u8(2, (48, PATCH, PATCH))
    theta, mom = ref.patch_theta_int(torch.from_numpy(patches))
    jtheta, jmom = jref.patch_theta_int(jnp.asarray(patches))
    assert mom.dtype == torch.int32
    np.testing.assert_array_equal(mom.numpy(), np.asarray(jmom))
    assert_sparse_parity(np.asarray(jtheta), np.asarray(jmom),
                         np.zeros((48, 8), np.uint32), theta, mom,
                         np.zeros((48, 8), np.int32), None, integer=True)


def test_orient_describe_int_matches_jax():
    raw = _u8(3, (64, 96))
    sm = np_of(ref.gaussian_blur7_u8(torch.from_numpy(raw)))
    xy = _keypoints(4, 40, 64, 96)
    theta, mom, desc = describe_fused.describe_fused_plain(
        torch.from_numpy(raw)[None], torch.from_numpy(sm)[None],
        torch.from_numpy(xy)[None])
    want = jref.orient_describe_int(jnp.asarray(raw), jnp.asarray(sm),
                                    jnp.asarray(xy))
    assert mom.dtype == torch.float32
    assert_sparse_parity(*[np.asarray(w) for w in want], theta[0], mom[0],
                         desc[0], None, integer=True)


# -- the plain versions: uint8 input against its float copy -------------------

def _levels_u8(b=2):
    """A 3-level uint8 pyramid of seeded images (37 x 53, not a
    multiple of a tile) as the port builds it."""
    cfg = ORBConfig(height=37, width=53, n_levels=3, max_features=48)
    return pyramid.build_pyramid_batched(torch.from_numpy(_u8(5, (b, 37, 53))),
                                         cfg, precision="uint8")


def _plain_case(name):
    """(uint8 call, float32 call) of one plain version, each a function
    of the pixel dtype."""
    levels = _levels_u8()
    kw = dict(threshold=20.0, nms=True, quantized=True)
    if name in ("K1", "K2"):
        def run(dt):
            lv = [l.to(dt) for l in levels]
            flat, slabs = ops.flat_levels(lv), ops._slabs_of(lv)
            dense = frontend_fused.frontend_fused_pyramid_plain(flat, slabs,
                                                                **kw)
            if name == "K1":
                return dense
            xy = torch.from_numpy(np.concatenate(
                [_keypoints(6 + l, 2 * 20, *lv[l].shape[1:]).reshape(2, 20, 2)
                 for l in range(3)], 1))
            col = ops._col_levels((20, 20, 20), "cpu")
            return describe_fused.describe_fused_pyramid_plain(
                flat, dense[0], slabs, xy, col)
        return run
    if name in ("K6", "K7", "K8"):
        def run(dt):
            lv = levels[0].to(dt)
            xy = torch.from_numpy(_keypoints(9, 2 * 30, 37, 53)
                                  .reshape(2, 30, 2))
            blur, score = frontend_fused.frontend_fused_plain(lv, **kw)
            if name == "K6":
                return blur, score
            if name == "K7":
                return describe_fused.describe_fused_plain(lv, blur, xy)
            return describe_fused.orient_fused_plain(lv, xy)
        return run
    dl, ml, dr, mr, il, ir = matcher_case(7)
    il, ir = np.round(il).astype(np.uint8), np.round(ir).astype(np.uint8)
    args = [torch.from_numpy(a) for a in (dl.view(np.int32), ml,
                                          dr.view(np.int32), mr)]

    def run(dt):
        img_l, img_r = (torch.from_numpy(x).to(dt) for x in (il, ir))
        if name == "K3":
            return matcher_fused.match_rectify_fused_plain(
                *args, img_l, img_r, row_band=2.0, max_disparity=24.0,
                max_hamming=64)
        k = args[1].shape[1]
        return (sad_fused.sad_fused_plain(img_l, img_r, args[1][..., :2],
                                          args[3][:, :k, :2]),)
    return run


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K5", "K6", "K7", "K8"])
def test_plain_uint8_equals_plain_float(name):
    """Value for value, every output; blur and score in uint8 and
    int16, theta and moments in float32 (theta the same atan2 on the
    same exact moments), descriptors and matcher outputs int32."""
    run = _plain_case(name)
    got, want = run(torch.uint8), run(torch.float32)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if name in ("K1", "K6"):
            assert g.dtype in (torch.uint8, torch.int16)
        else:
            assert g.dtype == w.dtype
        assert torch.equal(g.to(w.dtype), w)
    if name in ("K1", "K6"):
        assert int((got[1] > 0).sum()) > 0       # corners were found


def test_uint8_without_quantized_blur_is_an_error():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    for call in (
            lambda: frontend_fused.out_dtypes(x, quantized=False),
            lambda: frontend_fused.frontend_fused(x, threshold=20.0,
                                                  quantized=False),
            lambda: ops.fast_blur_nms_pyramid([x], 20.0, quantized=False)):
        with pytest.raises(ValueError, match="quantized=True"):
            call()


# -- the pyramid ---------------------------------------------------------------

def test_pyramid_uint8_equals_quantized_f32_and_jax():
    frames = _u8(8, (4, H, W))
    jcfg = JORBConfig(height=H, width=W, n_levels=3)
    cfg = ORBConfig(height=H, width=W, n_levels=3)
    got = pyramid.build_pyramid_batched(torch.from_numpy(frames), cfg,
                                        precision="uint8")
    f32 = pyramid.build_pyramid_batched(torch.from_numpy(frames).float(),
                                        cfg)
    jlv = jpyramid.build_pyramid_batched(jnp.asarray(frames), jcfg,
                                         precision="uint8")
    assert ops.flat_levels(got).data_ptr() == got[0].data_ptr()
    for lvl, (g, f, j) in enumerate(zip(got, f32, jlv)):
        assert g.dtype == torch.uint8
        assert torch.equal(g.float(), f)
        d = np.abs(g.numpy().astype(np.int32) - np.asarray(j, np.int32))
        if lvl == 0:
            assert not d.any()
        assert d.max() <= 1 and int((d > 0).sum()) * 1000 <= d.size
    single = pyramid.build_pyramid(torch.from_numpy(frames[0]), cfg,
                                   precision="uint8")
    for s, g in zip(single, got):
        assert torch.equal(s, g[0])


# -- the slice: the uint8 session against JAX and against the f32 session ----

@functools.lru_cache(maxsize=1)
def _jax_frame():
    frame, intr = scene_frames()
    frame = np.round(frame).astype(np.uint8)
    jvs = JVisualSystem(JRigConfig.quad(_jintr(intr)),
                        JPipelineConfig(orb=JORBConfig(**OCFG), impl="ref",
                                        precision="uint8"))
    return frame, jvs.process_frame(jnp.asarray(frame))


def test_process_frame_matches_jax_and_the_f32_session(monkeypatch):
    frame, jo = _jax_frame()
    _, intr = scene_frames()
    rig = RigConfig.quad(intr)
    u8 = VisualSystem(rig, PipelineConfig(orb=ORBConfig(**OCFG),
                                          precision="uint8"), device="cpu")
    f32 = VisualSystem(rig, PipelineConfig(orb=ORBConfig(**OCFG)),
                       device="cpu")
    own = u8.process_frame(frame)
    want = f32.process_frame(frame.astype(np.float32))
    for grp_got, grp_want in zip(own, want):
        for x, y in zip(grp_got, grp_want):
            assert x.dtype == y.dtype and torch.equal(x, y)
    feed_jax_pyramid(monkeypatch, JORBConfig(**OCFG))
    to = u8.process_frame(frame)
    no_diff = [np.zeros((0, 2), int)] * 4
    cfg = u8.pipe.orb
    n_edge = assert_stereo_parity(jo, to, cfg.features_per_level()[0],
                                  cfg.scale_factor, (0, 2), (1, 3), no_diff,
                                  True, None, None)
    print(f"descriptors at a bin edge: {n_edge}")
    if n_edge == 0:
        for grp in ("matches", "depth"):
            for name in getattr(jo, grp)._fields:
                np.testing.assert_array_equal(
                    np_of(getattr(getattr(to, grp), name)),
                    np.asarray(getattr(getattr(jo, grp), name)),
                    err_msg=f"{grp}.{name}")
    assert min(np_of(to.depth.valid).sum(-1)) > 0


SEQ_OCFG = dict(height=H, width=W, max_features=64, fast_threshold=15)


@functools.lru_cache(maxsize=1)
def _sequence():
    seq = scenes.render_sequence(scenes.SceneConfig(
        height=H, width=W, baseline=0.5, seed=1), 4,
        step_t=(0.25, 0.0, 0.1), yaw_per_frame=0.0)
    return np.round(seq.frames).astype(np.uint8), seq.intrinsics


def test_localized_run_matches_jax_and_the_f32_run(monkeypatch):
    frames, intr = _sequence()
    jvs = JVisualSystem(JRigConfig.quad(_jintr(intr)),
                        JPipelineConfig(orb=JORBConfig(**SEQ_OCFG),
                                        impl="ref", precision="uint8",
                                        localize=True))
    jr = jvs.run(jnp.asarray(frames))
    rig = RigConfig.quad(intr)
    f32 = VisualSystem(rig, PipelineConfig(orb=ORBConfig(**SEQ_OCFG),
                                           localize=True), device="cpu")
    u8 = VisualSystem(rig, PipelineConfig(orb=ORBConfig(**SEQ_OCFG),
                                          precision="uint8", localize=True),
                      device="cpu")
    want = f32.run(frames.astype(np.float32))
    own = u8.run(frames)
    for grp_got, grp_want in zip((*own.stereo, own.pose),
                                 (*want.stereo, want.pose)):
        for x, y in zip(grp_got, grp_want):
            assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(own.points, want.points)
    feed_jax_pyramid(monkeypatch, JORBConfig(**SEQ_OCFG))
    tr = u8.run(frames)
    for grp in ("features_l", "features_r", "matches", "depth"):
        for name in getattr(jr.stereo, grp)._fields:
            a = np.asarray(getattr(getattr(jr.stereo, grp), name))
            b = np_of(getattr(getattr(tr.stereo, grp), name))
            if name == "theta":
                assert np.abs(a.view(np.int32).astype(np.int64)
                              - b.view(np.int32)).max() <= 1
            elif name == "desc":
                np.testing.assert_array_equal(desc_u32(b), a)
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{grp}.{name}")
    np.testing.assert_array_equal(np_of(tr.pose.valid),
                                  np.asarray(jr.pose.valid))
    for name in ("rotation", "translation"):
        np.testing.assert_allclose(np_of(getattr(tr.pose, name)),
                                   np.asarray(getattr(jr.pose, name)),
                                   rtol=0, atol=POSE_ATOL)
    assert tr.pose.valid.tolist() == [False, True, True, True]


def test_per_level_equals_whole_frame():
    frames = torch.from_numpy(_u8(9, (3, 70, 111)))
    cfg = ORBConfig(height=70, width=111, n_levels=3, max_features=48)
    per = extract_features_per_level(frames, cfg, precision="uint8")
    whole = extract_features_batched(frames, cfg, precision="uint8")
    f32 = extract_features_batched(frames.float(), cfg)
    for name in per._fields:
        a, b, c = getattr(per, name), getattr(whole, name), getattr(f32, name)
        assert a.dtype == b.dtype == c.dtype
        assert torch.equal(a, b) and torch.equal(a, c), name
    assert int(per.valid.sum()) > 0


# -- error contracts (the JAX package's tests/test_precision.py) --------------

def test_precision_config_validation():
    with pytest.raises(ValueError, match="precision"):
        PipelineConfig(precision="fp16")
    with pytest.raises(ValueError, match="quantized"):
        PipelineConfig(orb=ORBConfig(quantized=False), precision="uint8")
    cfg = PipelineConfig(orb=ORBConfig(**OCFG), precision="uint8",
                         localize=True)
    jcfg = JPipelineConfig(orb=JORBConfig(**OCFG), precision="uint8",
                           localize=True, impl="ref")
    assert convert.pipeline_config_from_reference(
        dataclasses.asdict(jcfg)) == cfg


@pytest.mark.parametrize("entry", ["process_frame", "run", "extract"])
def test_dtype_validation_names_precision(entry):
    h, w = 32, 48
    cfg = ORBConfig(height=h, width=w, max_features=8, n_levels=1,
                    max_disparity=16)
    rig = RigConfig.quad(CameraIntrinsics(cx=w / 2.0, cy=h / 2.0))
    vs_u = VisualSystem(rig, PipelineConfig(orb=cfg, precision="uint8"),
                        device="cpu")
    vs_f = VisualSystem(rig, PipelineConfig(orb=cfg), device="cpu")
    lead = (1,) if entry == "run" else ()
    f32 = np.zeros(lead + (4, h, w), np.float32)
    u8 = np.zeros(lead + (4, h, w), np.uint8)
    with pytest.raises(TypeError, match="precision='uint8'"):
        getattr(vs_u, entry)(f32)
    with pytest.raises(TypeError, match="precision='f32'"):
        getattr(vs_f, entry)(u8)
    with pytest.raises(TypeError, match="precision='uint8'"):
        getattr(vs_u, entry)(torch.from_numpy(f32))
    # the happy paths still work after the failed calls
    assert getattr(vs_u, entry)(u8) is not None
    assert getattr(vs_f, entry)(f32) is not None
