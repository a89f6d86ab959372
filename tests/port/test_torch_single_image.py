"""The single-image FE API — ``kernels.ops.fast_score_map`` (K11),
``gaussian_blur7`` (K12) and the orientation-only
``orient_describe_batched`` (K8), ``core.fast.detect`` /
``orientations``, ``core.brief.smooth`` / ``describe``,
``core.pyramid.build_pyramid`` and ``core.orb.extract_features`` —
against the JAX package's (``impl="ref"``) on identical inputs, made
with numpy from a seed: integer-valued and float frames, at 96 x 128 and
at 70 x 100 (not a multiple of the kernels' 32-pixel tiles).

Tolerances are ``parity.py``'s: score maps, blurs, keypoints, scores and
valid flags bit-equal (the same arithmetic in the same order, or
min/max/compares); theta and moments under the sparse-FE rule (equal
moments and theta within 1 ulp on integer-valued frames; on float
frames moments within 2 * gamma_961 * sum|x * p|); descriptors equal
wherever the steering bins agree; pyramid level 1 under the A2 rule of
``test_torch_pyramid.py`` (within 1 grey level, at most 1 differing
pixel in 10,000)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import brief as jbrief
from repro.core import fast as jfast
from repro.core import orb as jorb
from repro.core import pyramid as jpyramid
from repro.core.types import ORBConfig as JORBConfig
from repro.kernels import ops as jops
from repro_torch.core import (ORBConfig, brief, extract_features,
                              extract_features_per_level, fast, frontend,
                              pyramid)
from repro_torch.core.types import CameraIntrinsics
from repro_torch.kernels import (_build, describe_fused, fast_detect,
                                 frontend_fused, gaussian_blur, hamming_match,
                                 ops, sad_rectify)
from repro_torch.kernels.ref import extract_patches, moment_grids

from parity import (assert_sparse_parity, desc_u32, np_of, scene_frames,
                    textured_levels)

SHAPES = [(96, 128), (70, 100)]
KINDS = ["float", "integer"]


def _image(shape, kind, seed=5):
    return textured_levels(seed, [shape], b=1,
                           integer=kind == "integer")[0][0]


def _abs_sums(img, xy):
    """(K, 2) sum|x * p| and sum|y * p| of each keypoint's patch."""
    p = extract_patches(torch.from_numpy(np.array(img)),
                        torch.from_numpy(np.array(xy)))
    xg, yg = moment_grids()
    return torch.stack([(p * xg).abs().sum((-2, -1)),
                        (p * yg).abs().sum((-2, -1))], -1).numpy()


def _zeros_desc(theta):
    return np.zeros((*np.shape(theta), 8), np.uint32)


def _assert_theta_rule(jtheta, jmom, ttheta, tmom, img, xy, integer):
    """Theta and moments (no descriptor) under the sparse-FE rule."""
    return assert_sparse_parity(
        np.asarray(jtheta), np.asarray(jmom), _zeros_desc(jtheta),
        np_of(ttheta), np_of(tmom), _zeros_desc(jtheta),
        _abs_sums(img, xy), integer)


@pytest.mark.parametrize("kind", KINDS + ["uint8"])
@pytest.mark.parametrize("shape", SHAPES, ids=["96x128", "70x100"])
def test_fast_score_map_matches_jax(shape, kind):
    img = _image(shape, "float" if kind == "float" else "integer")
    if kind == "uint8":
        img = img.astype(np.uint8)        # cast to float32 first, as JAX
    want = jops.fast_score_map(jnp.asarray(img), 20.0, impl="ref")
    with ops.launch_audit() as audit:
        got = ops.fast_score_map(torch.from_numpy(img.copy()), 20.0)
    assert audit.count == 0               # the CPU runs the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got > 0).sum()) > 50


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=["96x128", "70x100"])
def test_gaussian_blur7_matches_jax(shape, kind, quantized):
    img = _image(shape, kind)
    want = jops.gaussian_blur7(jnp.asarray(img), quantized=quantized,
                               impl="ref")
    got = ops.gaussian_blur7(torch.from_numpy(img.copy()),
                             quantized=quantized)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", KINDS)
def test_orientation_only_matches_jax(kind):
    """K = 13 (no multiple of the TPU's 8-keypoint block) on 3 images,
    keypoints up to 8 px past every edge (clamped into the image)."""
    h, w = SHAPES[1]
    raw = textured_levels(9, [(h, w)], b=3, integer=kind == "integer")[0]
    rng = np.random.RandomState(4)
    xy = np.stack([rng.randint(-8, w + 8, (3, 13)),
                   rng.randint(-8, h + 8, (3, 13))], -1).astype(np.int32)
    jt, jm, jd = jops.orient_describe_batched(jnp.asarray(raw), None,
                                              jnp.asarray(xy), impl="ref")
    with ops.launch_audit() as audit:
        tt, tm, td = ops.orient_describe_batched(torch.from_numpy(raw),
                                                 None, torch.from_numpy(xy))
    assert audit.count == 0 and jd is None and td is None
    assert tuple(tt.shape) == (3, 13) and tuple(tm.shape) == (3, 13, 2)
    for b in range(3):
        _assert_theta_rule(jt[b], jm[b], tt[b], tm[b], raw[b], xy[b],
                           kind == "integer")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=["96x128", "70x100"])
def test_detect_and_orientations_match_jax(shape, kind):
    img = _image(shape, kind, seed=6)
    h, w = shape
    cfg = dict(height=h, width=w, max_features=48, n_levels=1)
    k = ORBConfig(**cfg).features_per_level()[0]
    jxy, jsc, jth, jv = jfast.detect(jnp.asarray(img), JORBConfig(**cfg), k,
                                     impl="ref")
    timg = torch.from_numpy(img.copy())
    with ops.launch_audit() as audit:
        txy, tsc, tth, tv = fast.detect(timg, ORBConfig(**cfg), k)
        tth2 = fast.orientations(timg, txy)
    assert audit.count == 0
    assert txy.dtype == torch.int32 and tv.dtype == torch.bool
    for a, b in ((txy, jxy), (tsc, jsc), (tv, jv)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(tv.sum()) > 10
    assert torch.equal(tth, tth2)
    _, jm, _ = jops.orient_describe_batched(jnp.asarray(img)[None], None,
                                            jxy[None], impl="ref")
    _, tm, _ = ops.orient_describe_batched(timg[None], None, txy[None])
    _assert_theta_rule(jth, jm[0], tth, tm[0], img, np.asarray(jxy),
                       kind == "integer")


@pytest.mark.parametrize("kind", KINDS)
def test_smooth_and_describe_match_jax(kind):
    img = _image(SHAPES[0], kind, seed=8)
    cfg = dict(height=96, width=128, max_features=48, n_levels=1)
    k = ORBConfig(**cfg).features_per_level()[0]
    jsm = jbrief.smooth(jnp.asarray(img), JORBConfig(**cfg), impl="ref")
    with ops.launch_audit() as audit:
        tsm = brief.smooth(torch.from_numpy(img.copy()), ORBConfig(**cfg))
    assert audit.count == 0
    np.testing.assert_array_equal(tsm.numpy(), np.asarray(jsm))
    xy, _, jth, _ = jfast.detect(jnp.asarray(img), JORBConfig(**cfg), k,
                                 impl="ref")
    txy = torch.from_numpy(np.array(xy))
    jd = jbrief.describe(jsm, xy, jth)
    # the same theta: the same bins, so equal descriptors
    td = brief.describe(tsm, txy, torch.from_numpy(np.array(jth)))
    assert td.dtype == torch.int32 and tuple(td.shape) == (k, 8)
    np.testing.assert_array_equal(desc_u32(td), np.asarray(jd))
    # the port's own theta: equal wherever the bins agree
    tth = fast.orientations(torch.from_numpy(img.copy()), txy)
    _, jm, _ = jops.orient_describe_batched(jnp.asarray(img)[None], None,
                                            xy[None], impl="ref")
    _, tm, _ = ops.orient_describe_batched(torch.from_numpy(img.copy())[None],
                                           None, txy[None])
    assert_sparse_parity(np.asarray(jth), np.asarray(jm[0]), jd, tth, tm[0],
                         brief.describe(tsm, txy, tth),
                         _abs_sums(img, np.asarray(xy)), kind == "integer")


@pytest.mark.parametrize("hw", SHAPES, ids=["96x128", "70x100"])
def test_build_pyramid_matches_jax(hw):
    frame, _ = scene_frames(*hw)
    cfg = dict(height=hw[0], width=hw[1], n_levels=2)
    want = jpyramid.build_pyramid(jnp.asarray(frame[0]), JORBConfig(**cfg))
    with ops.launch_audit() as audit:
        got = pyramid.build_pyramid(torch.from_numpy(frame[0].copy()),
                                    ORBConfig(**cfg))
    assert audit.count == 0
    assert len(got) == 2 and got[0].dtype == torch.float32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    a, b = got[1].numpy(), np.asarray(want[1])
    assert a.shape == b.shape == ORBConfig(**cfg).level_shape(1)
    assert np.abs(a - b).max() <= 1.0
    assert int((a != b).sum()) * 10_000 <= a.size


@pytest.mark.parametrize("kind", KINDS)
def test_extract_features_matches_jax(kind):
    """Level-0 rows bit-equal (theta by rule); level-1 rows too whenever
    the two pyramids' level 1 agree (A2)."""
    frame, _ = scene_frames()
    img = np.round(frame[1]) if kind == "integer" else frame[1]
    cfg = dict(height=96, width=128, max_features=64, n_levels=2)
    jf = jorb.extract_features(jnp.asarray(img), JORBConfig(**cfg),
                               impl="ref")
    tf = extract_features(torch.from_numpy(img.copy()), ORBConfig(**cfg))
    assert tuple(tf.desc.shape) == (64, 8) and tf.desc.dtype == torch.int32
    k0 = ORBConfig(**cfg).features_per_level()[0]
    lv_equal = bool(np.array_equal(
        np.asarray(jpyramid.build_pyramid(jnp.asarray(img),
                                          JORBConfig(**cfg))[1]),
        pyramid.build_pyramid(torch.from_numpy(img.copy()),
                              ORBConfig(**cfg))[1].numpy()))
    rows = slice(None) if lv_equal else slice(0, k0)
    print(f"level 1 of the two pyramids equal: {lv_equal}")
    for name in ("xy", "level", "score", "valid"):
        np.testing.assert_array_equal(np_of(getattr(tf, name))[rows],
                                      np.asarray(getattr(jf, name))[rows])
    jxy = np.asarray(jf.xy)[rows]
    lvl = np.asarray(jf.level)[rows]
    # moments of each row at its own level, from both packages
    jlev = jpyramid.build_pyramid(jnp.asarray(img), JORBConfig(**cfg))
    for l in np.unique(lvl):
        sel = lvl == l
        xy_l = np.round(jxy[sel] / (1.2 ** l)).astype(np.int32)
        lv = np.array(jlev[l])
        _, jm, _ = jops.orient_describe_batched(jnp.asarray(lv)[None], None,
                                                jnp.asarray(xy_l)[None],
                                                impl="ref")
        _, tm, _ = ops.orient_describe_batched(torch.from_numpy(lv)[None],
                                               None,
                                               torch.from_numpy(xy_l)[None])
        assert_sparse_parity(np.asarray(jf.theta)[rows][sel], np.asarray(jm[0]),
                             np.asarray(jf.desc)[rows][sel],
                             np_of(tf.theta)[rows][sel], tm[0],
                             np_of(tf.desc)[rows][sel], _abs_sums(lv, xy_l),
                             kind == "integer")


@pytest.mark.parametrize("kind", KINDS)
def test_detect_pinned_to_extract_features(kind):
    """``detect`` on level 0 of a 1-level config gives
    ``extract_features``' xy and theta bit for bit (the JAX package's
    pin, ``tests/test_describe_fused.py``)."""
    img = _image(SHAPES[0], kind, seed=3)
    cfg = ORBConfig(height=96, width=128, max_features=32, n_levels=1)
    timg = torch.from_numpy(img.copy())
    xy, _, theta, valid = fast.detect(timg, cfg, cfg.features_per_level()[0])
    feats = extract_features(timg, cfg)
    assert torch.equal(xy.float(), feats.xy)
    assert torch.equal(theta, feats.theta)
    assert torch.equal(valid, feats.valid)


def _u8_input():
    """A 48 x 64 integer-valued image as uint8 and as float32, its
    config and 24 keypoints (some outside the image, clamped)."""
    img = torch.from_numpy(_image((48, 64), "integer", seed=11).copy())
    rng = np.random.default_rng(2)
    xy = torch.from_numpy(np.stack([rng.integers(-4, 68, 24),
                                    rng.integers(-4, 52, 24)], -1)
                          .astype(np.int32))[None]
    cfg = ORBConfig(height=48, width=64, max_features=32)
    return img.to(torch.uint8), img, cfg, xy


def _later_cases():
    """Each case: the later slice it belonged to, in brackets, and a
    call, which returns (the later slice's outputs, its reference's).
    A6 (the uint8 datapath): the uint8 call's against the float32
    call's on the same integer-valued image; A5 (the pipelined
    schedule): the legacy pipelined shim's against the sequential
    one's."""
    u8, f32, cfg, xy = _u8_input()

    def both(fn):
        return lambda: (fn(u8), fn(f32))

    def sparse(im):
        blur, _ = ops.fast_blur_nms_batched(im[None], 20.0)
        return ops.orient_describe_batched(im[None], blur, xy)

    return {
        "uint8 orientation (A6)": both(
            lambda im: ops.orient_describe_batched(im[None], None, xy)[:2]),
        "uint8 per-level dense FE (A6)": both(
            lambda im: ops.fast_blur_nms_batched(im[None], 20.0)),
        "uint8 per-level sparse FE (A6)": both(sparse),
        "uint8 extract_features_per_level (A6)": lambda: (
            extract_features_per_level(u8[None], cfg, precision="uint8"),
            extract_features_per_level(f32[None], cfg)),
        "uint8 orientations (A6)": both(
            lambda im: (fast.orientations(im, xy[0]),)),
        "uint8 pyramid (A6)": lambda: (
            pyramid.build_pyramid(u8, cfg, precision="uint8"),
            pyramid.build_pyramid(f32, cfg)),
        "uint8 extract_features (A6)": lambda: (
            extract_features(u8, cfg, precision="uint8"),
            extract_features(f32, cfg)),
        "run_sequence_pipelined (A5)": lambda: _pipelined(cfg, f32),
    }


#: The uint8 datapath's own dtypes, where they differ from float32's.
U8_DTYPES = {
    "uint8 per-level dense FE (A6)": (torch.uint8, torch.int16),
    "uint8 pyramid (A6)": (torch.uint8, torch.uint8),
}


def _pipelined(cfg, img):
    """Every ``StereoOutput`` field of the legacy pipelined shim and of
    the sequential one on a T = 2 quad sequence of ``img`` shifted."""
    frames = torch.stack([torch.stack([torch.roll(img, t + c, -1)
                                       for c in range(4)])
                          for t in range(2)])
    outs = []
    for shim in (frontend.run_sequence_pipelined, frontend.run_sequence):
        with pytest.warns(DeprecationWarning, match=r"^repro_torch\."):
            out = shim(frames, cfg, CameraIntrinsics(), device="cpu")
        outs.append([x for grp in out for x in grp])
    return outs


@pytest.mark.parametrize("case", list(_later_cases()))
def test_later_slices_equal_their_reference(case):
    """The later slices' calls run and equal their reference call value
    for value.  A6: the uint8 call equals the float32 call on the same
    integer-valued image, in the uint8 datapath's dtypes (uint8 levels
    and blur, int16 score) and in float32 for theta, moments and every
    FeatureSet field.  A5: the pipelined shim equals the sequential
    shim, dtypes too."""
    got, want = _later_cases()[case]()
    assert len(got) == len(want) > 0
    dtypes = U8_DTYPES.get(case, [w.dtype for w in want])
    for g, w, dt in zip(got, want, dtypes):
        assert g.dtype == dt
        assert torch.equal(g.to(w.dtype), w)


@pytest.mark.parametrize("call", [pyramid.build_pyramid, extract_features],
                         ids=["build_pyramid", "extract_features"])
def test_unknown_precision_is_an_error(call):
    with pytest.raises(ValueError, match="precision"):
        call(torch.zeros(16, 16), ORBConfig(height=16, width=16),
             precision="bf16")


@pytest.mark.parametrize("name", ["fast_score_map", "gaussian_blur7",
                                  "orient_fused", "hamming_match",
                                  "sad_search", "frontend_fused",
                                  "describe_fused"])
def test_non_cpu_tensor_launches_the_kernel_or_raises(name):
    """A tensor off the CPU never falls back to the plain version: the
    wrapper launches its kernel or raises (here: a "meta" tensor, which
    is no CUDA tensor)."""
    img = torch.zeros(1, 8, 8, device="meta")
    desc = torch.zeros(4, 8, dtype=torch.int32, device="meta")
    meta = torch.zeros(4, 4, device="meta")
    call = {
        "fast_score_map": lambda: fast_detect.fast_score_map(img, 20.0),
        "gaussian_blur7": lambda: gaussian_blur.gaussian_blur7(img, True),
        "orient_fused": lambda: describe_fused.orient_fused(
            img, torch.zeros(1, 2, 2, dtype=torch.int32, device="meta")),
        "hamming_match": lambda: hamming_match.hamming_match(
            desc, meta, desc, meta, row_band=2.0, max_disparity=24.0),
        "sad_search": lambda: sad_rectify.sad_search(
            torch.zeros(4, 11, 11, device="meta"),
            torch.zeros(4, 11, 21, device="meta")),
        "frontend_fused": lambda: frontend_fused.frontend_fused(
            img, threshold=20.0),
        "describe_fused": lambda: describe_fused.describe_fused(
            img, img, torch.zeros(1, 2, 2, dtype=torch.int32, device="meta")),
    }[name]
    kernel = ops.KERNELS[name]
    before = kernel.launches
    with pytest.raises((ValueError, RuntimeError)):
        call()
    assert kernel.launches == before
    assert _build.CSRC.joinpath(f"{kernel.source}.cu").is_file()
